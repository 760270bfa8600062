// Native BLAKE3 for the host hot path (chunk verification, CDC dedup).
//
// Independent implementation from the BLAKE3 spec; a copy of the JAX
// package's host hasher, validated against the pure-Python anchor
// (zest_tpu_torch/cas/blake3.py). It is also the host oracle the CUDA
// kernel (zest_tpu_torch/csrc/blake3.cu) is held to in chip_smoke.py.
//
// Exposed C ABI (consumed via ctypes in zest_tpu_torch/native/__init__.py):
//   zest_blake3(data, len, out32)
//   zest_blake3_keyed(key32, data, len, out32)
//   zest_blake3_batch(data, count, item_len, out32xN)   — many equal-size items
//
// Layout notes: the hot path is an 8-wide AVX2 core that hashes eight
// complete 1 KiB BLAKE3 chunks at once in transposed (SoA) form — one
// chunk per 32-bit lane of a ymm register, the same lanes-carry-chunks
// layout as the JAX package's Pallas kernel (zest_tpu/ops/blake3_pallas.py). The
// scalar core (compiled -O3 -march=native) handles tails, parent folds,
// and non-AVX2 builds, and is the bit-exactness anchor the wide path is
// tested against.

#include <cstdint>
#include <cstring>
#include <cstddef>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr size_t BLOCK_LEN = 64;
constexpr size_t CHUNK_LEN = 1024;
constexpr size_t KEY_WORDS = 8;

constexpr uint32_t CHUNK_START = 1 << 0;
constexpr uint32_t CHUNK_END = 1 << 1;
constexpr uint32_t PARENT = 1 << 2;
constexpr uint32_t ROOT = 1 << 3;
constexpr uint32_t KEYED_HASH = 1 << 4;

constexpr uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

inline uint32_t load32le(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

inline void store32le(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

#define G(a, b, c, d, mx, my)          \
  do {                                 \
    a = a + b + (mx);                  \
    d = rotr32(d ^ a, 16);             \
    c = c + d;                         \
    b = rotr32(b ^ c, 12);             \
    a = a + b + (my);                  \
    d = rotr32(d ^ a, 8);              \
    c = c + d;                         \
    b = rotr32(b ^ c, 7);              \
  } while (0)

// Per-round message-word schedules (the standard permutation advanced r
// times): rounds index the message statically instead of materializing
// a permuted copy per round — shared by the scalar core and (via the
// same table under the SIMD section) the wide cores. Dropping the
// per-round 16-word permute+copy measurably speeds the scalar core,
// which also runs every parent fold in the tree.
constexpr int SCHED[7][16] = {
    { 0,  1,  2,  3,  4,  5,  6,  7,  8,  9, 10, 11, 12, 13, 14, 15},
    { 2,  6,  3, 10,  7,  0,  4, 13,  1, 11, 12,  5,  9, 14, 15,  8},
    { 3,  4, 10, 12, 13,  2,  7, 14,  6,  5,  9,  0, 11, 15,  8,  1},
    {10,  7, 12,  9, 14,  3, 13, 15,  4,  0, 11,  2,  5,  8,  1,  6},
    {12, 13,  9, 11, 15, 10, 14,  8,  7,  2,  5,  3,  0,  1,  6,  4},
    { 9, 14, 11,  5,  8, 12, 15,  1, 13,  3,  0, 10,  2,  6,  4,  7},
    {11, 15,  5,  0,  1,  9,  8,  6, 14, 10,  2, 12,  3,  4,  7, 13},
};

// One full compression. `out16` receives the 16-word extended output.
void compress(const uint32_t cv[8], const uint32_t m[16], uint64_t counter,
              uint32_t block_len, uint32_t flags, uint32_t out16[16]) {
  uint32_t v0 = cv[0], v1 = cv[1], v2 = cv[2], v3 = cv[3];
  uint32_t v4 = cv[4], v5 = cv[5], v6 = cv[6], v7 = cv[7];
  uint32_t v8 = IV[0], v9 = IV[1], v10 = IV[2], v11 = IV[3];
  uint32_t v12 = (uint32_t)counter, v13 = (uint32_t)(counter >> 32);
  uint32_t v14 = block_len, v15 = flags;

  for (int r = 0; r < 7; r++) {
    const int* s = SCHED[r];
    G(v0, v4, v8, v12, m[s[0]], m[s[1]]);
    G(v1, v5, v9, v13, m[s[2]], m[s[3]]);
    G(v2, v6, v10, v14, m[s[4]], m[s[5]]);
    G(v3, v7, v11, v15, m[s[6]], m[s[7]]);
    G(v0, v5, v10, v15, m[s[8]], m[s[9]]);
    G(v1, v6, v11, v12, m[s[10]], m[s[11]]);
    G(v2, v7, v8, v13, m[s[12]], m[s[13]]);
    G(v3, v4, v9, v14, m[s[14]], m[s[15]]);
  }

  out16[0] = v0 ^ v8;
  out16[1] = v1 ^ v9;
  out16[2] = v2 ^ v10;
  out16[3] = v3 ^ v11;
  out16[4] = v4 ^ v12;
  out16[5] = v5 ^ v13;
  out16[6] = v6 ^ v14;
  out16[7] = v7 ^ v15;
  out16[8] = v8 ^ cv[0];
  out16[9] = v9 ^ cv[1];
  out16[10] = v10 ^ cv[2];
  out16[11] = v11 ^ cv[3];
  out16[12] = v12 ^ cv[4];
  out16[13] = v13 ^ cv[5];
  out16[14] = v14 ^ cv[6];
  out16[15] = v15 ^ cv[7];
}

#if defined(__AVX2__)

// ── 8-wide core: eight complete 1 KiB chunks per call, SoA in ymm ──

#if defined(__AVX512VL__)
// AVX-512VL gives a native 32-bit rotate on 256-bit registers: 1 uop
// for every rotate distance.
inline __m256i rotr16v(__m256i x) { return _mm256_ror_epi32(x, 16); }
inline __m256i rotr8v(__m256i x) { return _mm256_ror_epi32(x, 8); }
inline __m256i rotr12v(__m256i x) { return _mm256_ror_epi32(x, 12); }
inline __m256i rotr7v(__m256i x) { return _mm256_ror_epi32(x, 7); }
#else
// Byte-granularity rotates go through vpshufb (1 uop); 12/7 need shifts.
inline __m256i rotr16v(__m256i x) {
  const __m256i tbl = _mm256_setr_epi8(
      2, 3, 0, 1, 6, 7, 4, 5, 10, 11, 8, 9, 14, 15, 12, 13,
      2, 3, 0, 1, 6, 7, 4, 5, 10, 11, 8, 9, 14, 15, 12, 13);
  return _mm256_shuffle_epi8(x, tbl);
}
inline __m256i rotr8v(__m256i x) {
  const __m256i tbl = _mm256_setr_epi8(
      1, 2, 3, 0, 5, 6, 7, 4, 9, 10, 11, 8, 13, 14, 15, 12,
      1, 2, 3, 0, 5, 6, 7, 4, 9, 10, 11, 8, 13, 14, 15, 12);
  return _mm256_shuffle_epi8(x, tbl);
}
inline __m256i rotr12v(__m256i x) {
  return _mm256_or_si256(_mm256_srli_epi32(x, 12),
                         _mm256_slli_epi32(x, 20));
}
inline __m256i rotr7v(__m256i x) {
  return _mm256_or_si256(_mm256_srli_epi32(x, 7),
                         _mm256_slli_epi32(x, 25));
}
#endif

inline void g8(__m256i& a, __m256i& b, __m256i& c, __m256i& d,
               __m256i mx, __m256i my) {
  a = _mm256_add_epi32(_mm256_add_epi32(a, b), mx);
  d = rotr16v(_mm256_xor_si256(d, a));
  c = _mm256_add_epi32(c, d);
  b = rotr12v(_mm256_xor_si256(b, c));
  a = _mm256_add_epi32(_mm256_add_epi32(a, b), my);
  d = rotr8v(_mm256_xor_si256(d, a));
  c = _mm256_add_epi32(c, d);
  b = rotr7v(_mm256_xor_si256(b, c));
}

// In-register 8x8 u32 transpose: rows of 8 words -> word-major vectors.
inline void transpose8(__m256i r[8]) {
  __m256i t0 = _mm256_unpacklo_epi32(r[0], r[1]);
  __m256i t1 = _mm256_unpackhi_epi32(r[0], r[1]);
  __m256i t2 = _mm256_unpacklo_epi32(r[2], r[3]);
  __m256i t3 = _mm256_unpackhi_epi32(r[2], r[3]);
  __m256i t4 = _mm256_unpacklo_epi32(r[4], r[5]);
  __m256i t5 = _mm256_unpackhi_epi32(r[4], r[5]);
  __m256i t6 = _mm256_unpacklo_epi32(r[6], r[7]);
  __m256i t7 = _mm256_unpackhi_epi32(r[6], r[7]);
  __m256i s0 = _mm256_unpacklo_epi64(t0, t2);
  __m256i s1 = _mm256_unpackhi_epi64(t0, t2);
  __m256i s2 = _mm256_unpacklo_epi64(t1, t3);
  __m256i s3 = _mm256_unpackhi_epi64(t1, t3);
  __m256i s4 = _mm256_unpacklo_epi64(t4, t6);
  __m256i s5 = _mm256_unpackhi_epi64(t4, t6);
  __m256i s6 = _mm256_unpacklo_epi64(t5, t7);
  __m256i s7 = _mm256_unpackhi_epi64(t5, t7);
  r[0] = _mm256_permute2x128_si256(s0, s4, 0x20);
  r[1] = _mm256_permute2x128_si256(s1, s5, 0x20);
  r[2] = _mm256_permute2x128_si256(s2, s6, 0x20);
  r[3] = _mm256_permute2x128_si256(s3, s7, 0x20);
  r[4] = _mm256_permute2x128_si256(s0, s4, 0x31);
  r[5] = _mm256_permute2x128_si256(s1, s5, 0x31);
  r[6] = _mm256_permute2x128_si256(s2, s6, 0x31);
  r[7] = _mm256_permute2x128_si256(s3, s7, 0x31);
}

// Compress one 64-byte block of 8 chunks at once. cv: word-major state,
// cv[w] lane L = word w of chunk L. m: 16 word-major message vectors.
inline void compress8(__m256i cv[8], const __m256i m[16],
                      __m256i counter_lo, __m256i counter_hi,
                      uint32_t block_len, uint32_t flags) {
  __m256i v0 = cv[0], v1 = cv[1], v2 = cv[2], v3 = cv[3];
  __m256i v4 = cv[4], v5 = cv[5], v6 = cv[6], v7 = cv[7];
  __m256i v8 = _mm256_set1_epi32((int)IV[0]);
  __m256i v9 = _mm256_set1_epi32((int)IV[1]);
  __m256i v10 = _mm256_set1_epi32((int)IV[2]);
  __m256i v11 = _mm256_set1_epi32((int)IV[3]);
  __m256i v12 = counter_lo;
  __m256i v13 = counter_hi;
  __m256i v14 = _mm256_set1_epi32((int)block_len);
  __m256i v15 = _mm256_set1_epi32((int)flags);

  // Fully unrolled so every SCHED index is a compile-time constant and
  // the message words stay addressable without indirection.
#define B3_ROUND(R)                                                     \
  do {                                                                  \
    g8(v0, v4, v8, v12, m[SCHED[R][0]], m[SCHED[R][1]]);                \
    g8(v1, v5, v9, v13, m[SCHED[R][2]], m[SCHED[R][3]]);                \
    g8(v2, v6, v10, v14, m[SCHED[R][4]], m[SCHED[R][5]]);               \
    g8(v3, v7, v11, v15, m[SCHED[R][6]], m[SCHED[R][7]]);               \
    g8(v0, v5, v10, v15, m[SCHED[R][8]], m[SCHED[R][9]]);               \
    g8(v1, v6, v11, v12, m[SCHED[R][10]], m[SCHED[R][11]]);             \
    g8(v2, v7, v8, v13, m[SCHED[R][12]], m[SCHED[R][13]]);              \
    g8(v3, v4, v9, v14, m[SCHED[R][14]], m[SCHED[R][15]]);              \
  } while (0)
  B3_ROUND(0); B3_ROUND(1); B3_ROUND(2); B3_ROUND(3);
  B3_ROUND(4); B3_ROUND(5); B3_ROUND(6);
#undef B3_ROUND

  cv[0] = _mm256_xor_si256(v0, v8);
  cv[1] = _mm256_xor_si256(v1, v9);
  cv[2] = _mm256_xor_si256(v2, v10);
  cv[3] = _mm256_xor_si256(v3, v11);
  cv[4] = _mm256_xor_si256(v4, v12);
  cv[5] = _mm256_xor_si256(v5, v13);
  cv[6] = _mm256_xor_si256(v6, v14);
  cv[7] = _mm256_xor_si256(v7, v15);
}

// Hash 8 complete, non-final 1 KiB chunks starting at `data` (contiguous,
// counters chunk_counter..+7); writes the 8 chunk CVs row-major.
void hash8_chunks(const uint32_t key[8], uint32_t base_flags,
                  const uint8_t* data, uint64_t chunk_counter,
                  uint32_t out_cvs[8][8]) {
  __m256i cv[8];
  for (int w = 0; w < 8; w++) cv[w] = _mm256_set1_epi32((int)key[w]);

  alignas(32) uint32_t ctr_lo[8], ctr_hi[8];
  for (int i = 0; i < 8; i++) {
    ctr_lo[i] = (uint32_t)(chunk_counter + i);
    ctr_hi[i] = (uint32_t)((chunk_counter + i) >> 32);
  }
  __m256i vlo = _mm256_load_si256((const __m256i*)ctr_lo);
  __m256i vhi = _mm256_load_si256((const __m256i*)ctr_hi);

  constexpr int NBLOCKS = CHUNK_LEN / BLOCK_LEN;  // 16
  for (int b = 0; b < NBLOCKS; b++) {
    __m256i lo[8], hi[8];
    for (int i = 0; i < 8; i++) {
      const uint8_t* p = data + (size_t)i * CHUNK_LEN + (size_t)b * BLOCK_LEN;
      lo[i] = _mm256_loadu_si256((const __m256i*)p);
      hi[i] = _mm256_loadu_si256((const __m256i*)(p + 32));
    }
    transpose8(lo);  // lo[w] = word w (0-7) of each chunk's block
    transpose8(hi);  // hi[w] = word 8+w
    __m256i m[16];
    for (int w = 0; w < 8; w++) { m[w] = lo[w]; m[8 + w] = hi[w]; }

    uint32_t flags = base_flags;
    if (b == 0) flags |= CHUNK_START;
    if (b == NBLOCKS - 1) flags |= CHUNK_END;
    compress8(cv, m, vlo, vhi, BLOCK_LEN, flags);
  }

  transpose8(cv);  // back to chunk-major rows
  for (int i = 0; i < 8; i++)
    _mm256_storeu_si256((__m256i*)out_cvs[i], cv[i]);
}

// Fold 8 parent pairs at once. A parent's 64-byte message is exactly
// its two children's CVs back-to-back, and `cvs_in` is a flat [2*8][8]
// CV array — so pair i IS the 64 contiguous bytes at cvs_in + 16*i,
// loaded lo/hi like one hash8 block. All inputs are read into
// registers before any store, so out_cvs may alias cvs_in (the
// level-order fold writes in place).
void fold8_parents(const uint32_t key[8], uint32_t flags,
                   const uint32_t (*cvs_in)[8], uint32_t (*out_cvs)[8]) {
  __m256i cv[8];
  for (int w = 0; w < 8; w++) cv[w] = _mm256_set1_epi32((int)key[w]);
  __m256i lo[8], hi[8];
  for (int i = 0; i < 8; i++) {
    const uint8_t* p = (const uint8_t*)cvs_in[2 * i];
    lo[i] = _mm256_loadu_si256((const __m256i*)p);
    hi[i] = _mm256_loadu_si256((const __m256i*)(p + 32));
  }
  transpose8(lo);
  transpose8(hi);
  __m256i m[16];
  for (int w = 0; w < 8; w++) { m[w] = lo[w]; m[8 + w] = hi[w]; }
  __m256i zero = _mm256_setzero_si256();
  compress8(cv, m, zero, zero, BLOCK_LEN, flags | PARENT);
  transpose8(cv);
  for (int i = 0; i < 8; i++)
    _mm256_storeu_si256((__m256i*)out_cvs[i], cv[i]);
}

#endif  // __AVX2__

#if defined(__AVX512F__)

// ── 16-wide core: sixteen complete 1 KiB chunks per call ──
// One 64-byte block row per chunk is exactly one zmm load; a 16x16 u32
// transpose turns 16 row loads into the 16 word-major message vectors.

inline void g16(__m512i& a, __m512i& b, __m512i& c, __m512i& d,
                __m512i mx, __m512i my) {
  a = _mm512_add_epi32(_mm512_add_epi32(a, b), mx);
  d = _mm512_ror_epi32(_mm512_xor_si512(d, a), 16);
  c = _mm512_add_epi32(c, d);
  b = _mm512_ror_epi32(_mm512_xor_si512(b, c), 12);
  a = _mm512_add_epi32(_mm512_add_epi32(a, b), my);
  d = _mm512_ror_epi32(_mm512_xor_si512(d, a), 8);
  c = _mm512_add_epi32(c, d);
  b = _mm512_ror_epi32(_mm512_xor_si512(b, c), 7);
}

// Transpose r[i] = 16 words of row i  ->  r[w] = word w of 16 rows.
// Four stages: epi32 unpacks (row pairs), epi64 unpacks (row quads),
// then two rounds of 128-bit-lane shuffles. Derivation: after stage 2,
// s[4g+m] lane k holds word 4k+m of rows 4g..4g+3; the lane shuffles
// regroup lanes by word index.
inline void transpose16(__m512i r[16]) {
  __m512i t[16], s[16];
  for (int i = 0; i < 8; i++) {
    t[2 * i] = _mm512_unpacklo_epi32(r[2 * i], r[2 * i + 1]);
    t[2 * i + 1] = _mm512_unpackhi_epi32(r[2 * i], r[2 * i + 1]);
  }
  for (int g = 0; g < 4; g++) {
    s[4 * g + 0] = _mm512_unpacklo_epi64(t[4 * g + 0], t[4 * g + 2]);
    s[4 * g + 1] = _mm512_unpackhi_epi64(t[4 * g + 0], t[4 * g + 2]);
    s[4 * g + 2] = _mm512_unpacklo_epi64(t[4 * g + 1], t[4 * g + 3]);
    s[4 * g + 3] = _mm512_unpackhi_epi64(t[4 * g + 1], t[4 * g + 3]);
  }
  for (int m = 0; m < 4; m++) {
    __m512i p1 = _mm512_shuffle_i32x4(s[m], s[4 + m], 0x88);
    __m512i p2 = _mm512_shuffle_i32x4(s[m], s[4 + m], 0xdd);
    __m512i p3 = _mm512_shuffle_i32x4(s[8 + m], s[12 + m], 0x88);
    __m512i p4 = _mm512_shuffle_i32x4(s[8 + m], s[12 + m], 0xdd);
    r[m] = _mm512_shuffle_i32x4(p1, p3, 0x88);
    r[8 + m] = _mm512_shuffle_i32x4(p1, p3, 0xdd);
    r[4 + m] = _mm512_shuffle_i32x4(p2, p4, 0x88);
    r[12 + m] = _mm512_shuffle_i32x4(p2, p4, 0xdd);
  }
}

inline void compress16(__m512i cv[8], const __m512i m[16],
                       __m512i counter_lo, __m512i counter_hi,
                       uint32_t block_len, uint32_t flags) {
  __m512i v0 = cv[0], v1 = cv[1], v2 = cv[2], v3 = cv[3];
  __m512i v4 = cv[4], v5 = cv[5], v6 = cv[6], v7 = cv[7];
  __m512i v8 = _mm512_set1_epi32((int)IV[0]);
  __m512i v9 = _mm512_set1_epi32((int)IV[1]);
  __m512i v10 = _mm512_set1_epi32((int)IV[2]);
  __m512i v11 = _mm512_set1_epi32((int)IV[3]);
  __m512i v12 = counter_lo;
  __m512i v13 = counter_hi;
  __m512i v14 = _mm512_set1_epi32((int)block_len);
  __m512i v15 = _mm512_set1_epi32((int)flags);

#define B3_ROUND16(R)                                                   \
  do {                                                                  \
    g16(v0, v4, v8, v12, m[SCHED[R][0]], m[SCHED[R][1]]);               \
    g16(v1, v5, v9, v13, m[SCHED[R][2]], m[SCHED[R][3]]);               \
    g16(v2, v6, v10, v14, m[SCHED[R][4]], m[SCHED[R][5]]);              \
    g16(v3, v7, v11, v15, m[SCHED[R][6]], m[SCHED[R][7]]);              \
    g16(v0, v5, v10, v15, m[SCHED[R][8]], m[SCHED[R][9]]);              \
    g16(v1, v6, v11, v12, m[SCHED[R][10]], m[SCHED[R][11]]);            \
    g16(v2, v7, v8, v13, m[SCHED[R][12]], m[SCHED[R][13]]);             \
    g16(v3, v4, v9, v14, m[SCHED[R][14]], m[SCHED[R][15]]);             \
  } while (0)
  B3_ROUND16(0); B3_ROUND16(1); B3_ROUND16(2); B3_ROUND16(3);
  B3_ROUND16(4); B3_ROUND16(5); B3_ROUND16(6);
#undef B3_ROUND16

  cv[0] = _mm512_xor_si512(v0, v8);
  cv[1] = _mm512_xor_si512(v1, v9);
  cv[2] = _mm512_xor_si512(v2, v10);
  cv[3] = _mm512_xor_si512(v3, v11);
  cv[4] = _mm512_xor_si512(v4, v12);
  cv[5] = _mm512_xor_si512(v5, v13);
  cv[6] = _mm512_xor_si512(v6, v14);
  cv[7] = _mm512_xor_si512(v7, v15);
}

// Hash 16 complete, non-final 1 KiB chunks starting at `data`
// (contiguous, counters chunk_counter..+15); CVs row-major.
void hash16_chunks(const uint32_t key[8], uint32_t base_flags,
                   const uint8_t* data, uint64_t chunk_counter,
                   uint32_t out_cvs[16][8]) {
  __m512i cv[8];
  for (int w = 0; w < 8; w++) cv[w] = _mm512_set1_epi32((int)key[w]);

  alignas(64) uint32_t ctr_lo[16], ctr_hi[16];
  for (int i = 0; i < 16; i++) {
    ctr_lo[i] = (uint32_t)(chunk_counter + i);
    ctr_hi[i] = (uint32_t)((chunk_counter + i) >> 32);
  }
  __m512i vlo = _mm512_load_si512((const void*)ctr_lo);
  __m512i vhi = _mm512_load_si512((const void*)ctr_hi);

  constexpr int NBLOCKS = CHUNK_LEN / BLOCK_LEN;  // 16
  for (int b = 0; b < NBLOCKS; b++) {
    __m512i m[16];
    for (int i = 0; i < 16; i++) {
      m[i] = _mm512_loadu_si512(
          (const void*)(data + (size_t)i * CHUNK_LEN + (size_t)b * BLOCK_LEN));
    }
    transpose16(m);

    uint32_t flags = base_flags;
    if (b == 0) flags |= CHUNK_START;
    if (b == NBLOCKS - 1) flags |= CHUNK_END;
    compress16(cv, m, vlo, vhi, BLOCK_LEN, flags);
  }

  // cv[w] holds word w of 16 chunks; widen to 16 rows for the store.
  __m512i rows[16];
  for (int w = 0; w < 8; w++) rows[w] = cv[w];
  for (int w = 8; w < 16; w++) rows[w] = _mm512_setzero_si512();
  transpose16(rows);
  for (int i = 0; i < 16; i++) {
    alignas(64) uint32_t tmp[16];
    _mm512_store_si512((void*)tmp, rows[i]);
    std::memcpy(out_cvs[i], tmp, 8 * sizeof(uint32_t));
  }
}

// Fold 16 parent pairs at once (see fold8_parents: pair i is the 64
// contiguous bytes at cvs_in + 16*i; in-place safe).
void fold16_parents(const uint32_t key[8], uint32_t flags,
                    const uint32_t (*cvs_in)[8], uint32_t (*out_cvs)[8]) {
  __m512i cv[8];
  for (int w = 0; w < 8; w++) cv[w] = _mm512_set1_epi32((int)key[w]);
  __m512i m[16];
  for (int i = 0; i < 16; i++)
    m[i] = _mm512_loadu_si512((const void*)cvs_in[2 * i]);
  transpose16(m);
  __m512i zero = _mm512_setzero_si512();
  compress16(cv, m, zero, zero, BLOCK_LEN, flags | PARENT);
  __m512i rows[16];
  for (int w = 0; w < 8; w++) rows[w] = cv[w];
  for (int w = 8; w < 16; w++) rows[w] = _mm512_setzero_si512();
  transpose16(rows);
  for (int i = 0; i < 16; i++) {
    alignas(64) uint32_t tmp[16];
    _mm512_store_si512((void*)tmp, rows[i]);
    std::memcpy(out_cvs[i], tmp, 8 * sizeof(uint32_t));
  }
}

#endif  // __AVX512F__

void load_block(const uint8_t* data, size_t len, uint32_t m[16]) {
  uint8_t padded[BLOCK_LEN];
  const uint8_t* src = data;
  if (len < BLOCK_LEN) {
    std::memset(padded, 0, sizeof(padded));
    std::memcpy(padded, data, len);
    src = padded;
  }
  for (int i = 0; i < 16; i++) m[i] = load32le(src + 4 * i);
}

// Hash one complete-or-final chunk; writes the chunk CV. If `root_out` is
// non-null the chunk is the whole tree and the final block carries ROOT.
void hash_chunk(const uint32_t key[8], const uint8_t* data, size_t len,
                uint64_t chunk_counter, uint32_t base_flags, uint32_t cv_out[8],
                uint8_t* root_out) {
  uint32_t cv[8];
  std::memcpy(cv, key, sizeof(cv));
  size_t nblocks = len <= BLOCK_LEN ? 1 : (len + BLOCK_LEN - 1) / BLOCK_LEN;
  uint32_t out16[16];
  for (size_t i = 0; i < nblocks; i++) {
    size_t off = i * BLOCK_LEN;
    size_t blen = (i + 1 == nblocks) ? len - off : BLOCK_LEN;
    uint32_t m[16];
    load_block(data + off, blen, m);
    uint32_t flags = base_flags;
    if (i == 0) flags |= CHUNK_START;
    if (i + 1 == nblocks) {
      flags |= CHUNK_END;
      if (root_out != nullptr) flags |= ROOT;
    }
    compress(cv, m, chunk_counter, (uint32_t)blen, flags, out16);
    std::memcpy(cv, out16, 8 * sizeof(uint32_t));
  }
  std::memcpy(cv_out, cv, 8 * sizeof(uint32_t));
  if (root_out != nullptr) {
    for (int i = 0; i < 8; i++) store32le(root_out + 4 * i, cv[i]);
  }
}

// Full-tree hash. Iterative chunk walk with a CV stack (max depth 54).
void blake3_full(const uint32_t key[8], uint32_t base_flags,
                 const uint8_t* data, size_t len, uint8_t out[32]) {
  if (len <= CHUNK_LEN) {
    uint32_t cv[8];
    hash_chunk(key, data, len, 0, base_flags, cv, out);
    return;
  }

  // Two phases, both SIMD-wide: (1) hash every leaf chunk 16/8 at a
  // time, (2) fold the tree LEVEL-ORDER, pairing adjacent CVs and
  // promoting a trailing odd CV unchanged — which builds exactly the
  // canonical left-full BLAKE3 tree (the standard wide-fold identity;
  // the previous incremental stack built the same tree but ran every
  // parent compression through the scalar core, capping large-input
  // throughput at the scalar rate).
  size_t n_chunks = (len + CHUNK_LEN - 1) / CHUNK_LEN;
  // CV workspace: a stack buffer covers every input up to 256 KiB —
  // all CDC chunks (<= 128 KiB) and the 64 KiB headline shape — so the
  // hot verification path never allocates; larger inputs (multi-MB
  // xorb blobs) amortize one heap allocation over megabytes of hashing.
  uint32_t stack_cvs[256][8];
  uint32_t(*cvs)[8] =
      n_chunks <= 256 ? stack_cvs : new uint32_t[n_chunks][8];

  // Leaves: every COMPLETE chunk rides the widest available path (an
  // exact-multiple input has no partial tail, so even its last chunk
  // does); only a partial final chunk needs the block-wise scalar
  // hash_chunk.
  size_t full = len / CHUNK_LEN;
  size_t rem = len - full * CHUNK_LEN;
  size_t i = 0;
#if defined(__AVX512F__)
  for (; full - i >= 16; i += 16)
    hash16_chunks(key, base_flags, data + i * CHUNK_LEN, i, &cvs[i]);
#endif
#if defined(__AVX2__)
  for (; full - i >= 8; i += 8)
    hash8_chunks(key, base_flags, data + i * CHUNK_LEN, i, &cvs[i]);
#endif
  for (; i < full; i++)
    hash_chunk(key, data + i * CHUNK_LEN, CHUNK_LEN, i, base_flags,
               cvs[i], nullptr);
  if (rem)
    hash_chunk(key, data + full * CHUNK_LEN, rem, full, base_flags,
               cvs[full], nullptr);

  // Level-order fold down to 2 CVs (the root fold is special-cased for
  // the ROOT flag). The wide folds read a full register set before
  // storing, so writing cvs[o] while reading cvs[2p] is safe (o <= 2p).
  uint32_t out16[16];
  size_t n = n_chunks;
  while (n > 2) {
    size_t pairs = n / 2;
    size_t p = 0, o = 0;
#if defined(__AVX512F__)
    for (; pairs - p >= 16; p += 16, o += 16)
      fold16_parents(key, base_flags, &cvs[2 * p], &cvs[o]);
#endif
#if defined(__AVX2__)
    for (; pairs - p >= 8; p += 8, o += 8)
      fold8_parents(key, base_flags, &cvs[2 * p], &cvs[o]);
#endif
    for (; p < pairs; p++, o++) {
      compress(key, cvs[2 * p], 0, BLOCK_LEN, base_flags | PARENT, out16);
      std::memcpy(cvs[o], out16, 8 * sizeof(uint32_t));
    }
    if (n & 1) {  // odd tail: promote unchanged
      std::memcpy(cvs[o], cvs[n - 1], 8 * sizeof(uint32_t));
      o++;
    }
    n = o;
  }

  compress(key, cvs[0], 0, BLOCK_LEN, base_flags | PARENT | ROOT, out16);
  if (cvs != stack_cvs) delete[] cvs;
  for (int k = 0; k < 8; k++) store32le(out + 4 * k, out16[k]);
}

}  // namespace

extern "C" {

void zest_blake3(const uint8_t* data, size_t len, uint8_t out[32]) {
  blake3_full(IV, 0, data, len, out);
}

void zest_blake3_keyed(const uint8_t key[32], const uint8_t* data, size_t len,
                       uint8_t out[32]) {
  uint32_t kw[KEY_WORDS];
  for (size_t i = 0; i < KEY_WORDS; i++) kw[i] = load32le(key + 4 * i);
  blake3_full(kw, KEYED_HASH, data, len, out);
}

// Hash `count` equal-length items laid out contiguously; out = count * 32.
// Independent items — this is the chunk-verification hot loop.
void zest_blake3_batch(const uint8_t* data, size_t count, size_t item_len,
                       uint8_t* out) {
  for (size_t i = 0; i < count; i++) {
    blake3_full(IV, 0, data + i * item_len, item_len, out + i * 32);
  }
}

void zest_blake3_keyed_batch(const uint8_t key[32], const uint8_t* data,
                             size_t count, size_t item_len, uint8_t* out) {
  uint32_t kw[KEY_WORDS];
  for (size_t i = 0; i < KEY_WORDS; i++) kw[i] = load32le(key + 4 * i);
  for (size_t i = 0; i < count; i++) {
    blake3_full(kw, KEYED_HASH, data + i * item_len, item_len, out + i * 32);
  }
}

}  // extern "C"
