// Batched BLAKE3 chunk verifier for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel: zest_tpu/ops/blake3_pallas.py,
// `_make_kernel` launched by `_hash_pallas` (PallasHasher.hash_device /
// hash_batch). Same contract: (B, cap/4) little-endian u32 words plus (B,)
// int32 byte lengths in, (B, 8) u32 digests out, plain or keyed
// (KEYED_HASH; Xet chunk hashes use the CHUNK_KEY domain key), cap a 1 KiB
// multiple of at most 128 KiB (the wrapper, ops/blake3_cuda.py, enforces it).
//
// What bounds it: integer ALU work. One 64-byte block compression is
// 7 rounds x 8 G functions x 12 u32 instructions plus 8 output xors, 680
// per 64 bytes. A G is 14 ops as written (6 adds, 4 xors, 4 rotates), but
// each `a + b + m` issues as one three-input add (IADD3), so 12 issue. A
// chunk of n bytes costs ceil(n/64) leaf-block compressions plus
// (leaves - 1) parent ones. It reads each row once up to its length rounded
// up to 64 bytes (at least one block), plus 4 bytes of length, and writes
// 32 bytes per row, so on an H100 the byte time is below the integer-op
// time at the push path's shapes.
//
// Design (deliberately simple; the TPU kernel's 128-lane tiling and
// sequential leaf-group grid are not carried over):
//   - one thread block per chunk, one thread per 1 KiB leaf (<= 128);
//   - each thread runs its leaf's (up to) 16 compressions with the state,
//     the chaining value and the message block in registers; the message
//     block comes in as four 16-byte loads and bytes past the row's length
//     are masked to zero here, so garbage past a length cannot change a
//     digest;
//   - leaf CVs go to shared memory (128 x 8 x 4 B) and fold pairwise with
//     odd-tail promotion, which is BLAKE3's largest-power-of-two tree; the
//     merge that sees exactly two live nodes carries ROOT;
//   - a one-leaf chunk finishes in its thread: the last block takes ROOT.
// Blocks run in any order on the 132 SMs; nothing carries between them.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kChunkStart = 1u << 0;
constexpr uint32_t kChunkEnd = 1u << 1;
constexpr uint32_t kParent = 1u << 2;
constexpr uint32_t kRoot = 1u << 3;
constexpr int kMaxLeaves = 128;
constexpr int kWordsPerLeaf = 256;

struct KeyWords {
  uint32_t w[8];
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void g(uint32_t (&v)[16], int a, int b, int c,
                                  int d, uint32_t mx, uint32_t my) {
  v[a] = v[a] + v[b] + mx;
  v[d] = rotr(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 12);
  v[a] = v[a] + v[b] + my;
  v[d] = rotr(v[d] ^ v[a], 8);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 7);
}

// m <- m[PERM], PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8).
__device__ __forceinline__ void permute(uint32_t (&m)[16]) {
  const uint32_t t0 = m[2], t1 = m[6], t2 = m[3], t3 = m[10];
  const uint32_t t4 = m[7], t5 = m[0], t6 = m[4], t7 = m[13];
  const uint32_t t8 = m[1], t9 = m[11], t10 = m[12], t11 = m[5];
  const uint32_t t12 = m[9], t13 = m[14], t14 = m[15], t15 = m[8];
  m[0] = t0; m[1] = t1; m[2] = t2; m[3] = t3;
  m[4] = t4; m[5] = t5; m[6] = t6; m[7] = t7;
  m[8] = t8; m[9] = t9; m[10] = t10; m[11] = t11;
  m[12] = t12; m[13] = t13; m[14] = t14; m[15] = t15;
}

// One compression; writes the first 8 output words (the chaining value,
// or the digest when ROOT is set). `m` is consumed (permuted in place).
__device__ __forceinline__ void compress(const uint32_t (&cv)[8],
                                         uint32_t (&m)[16], uint32_t counter,
                                         uint32_t block_len, uint32_t flags,
                                         uint32_t (&out)[8]) {
  uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                    counter, 0u, block_len, flags};
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    g(v, 0, 4, 8, 12, m[0], m[1]);
    g(v, 1, 5, 9, 13, m[2], m[3]);
    g(v, 2, 6, 10, 14, m[4], m[5]);
    g(v, 3, 7, 11, 15, m[6], m[7]);
    g(v, 0, 5, 10, 15, m[8], m[9]);
    g(v, 1, 6, 11, 12, m[10], m[11]);
    g(v, 2, 7, 8, 13, m[12], m[13]);
    g(v, 3, 4, 9, 14, m[14], m[15]);
    if (r < 6) permute(m);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = v[i] ^ v[i + 8];
}

// Keep the first `valid` bytes (0..4) of a little-endian word.
__device__ __forceinline__ uint32_t keep_bytes(uint32_t w, int valid) {
  return valid >= 4 ? w : (valid <= 0 ? 0u : w & ((1u << (8 * valid)) - 1u));
}

__global__ void __launch_bounds__(kMaxLeaves)
blake3_chunks_kernel(const uint32_t* __restrict__ words,
                     const int32_t* __restrict__ lengths,
                     uint32_t* __restrict__ out, int words_per_row,
                     KeyWords key, uint32_t base_flags) {
  __shared__ uint32_t cvs[kMaxLeaves][8];

  const int row = blockIdx.x;
  const int cap_bytes = 4 * words_per_row;
  int len = lengths[row];
  len = len < 0 ? 0 : (len > cap_bytes ? cap_bytes : len);
  const int n_leaves = len > 1024 ? (len + 1023) / 1024 : 1;
  const int leaf = threadIdx.x;
  const uint32_t* row_words = words + static_cast<size_t>(row) * words_per_row;

  uint32_t cv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = key.w[i];

  if (leaf < n_leaves) {
    int leaf_bytes = len - 1024 * leaf;
    leaf_bytes = leaf_bytes > 1024 ? 1024 : leaf_bytes;
    const int n_blocks = leaf_bytes > 0 ? (leaf_bytes + 63) / 64 : 1;
    const uint4* src = reinterpret_cast<const uint4*>(
        row_words + leaf * kWordsPerLeaf);
    for (int b = 0; b < n_blocks; ++b) {
      uint32_t m[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 x = src[4 * b + q];
        m[4 * q + 0] = x.x;
        m[4 * q + 1] = x.y;
        m[4 * q + 2] = x.z;
        m[4 * q + 3] = x.w;
      }
      const int block_base = 64 * b;  // byte offset of the block in the leaf
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        m[i] = keep_bytes(m[i], leaf_bytes - block_base - 4 * i);
      }
      int block_len = leaf_bytes - block_base;
      block_len = block_len < 0 ? 0 : (block_len > 64 ? 64 : block_len);
      const bool last = b == n_blocks - 1;
      uint32_t flags = base_flags | (b == 0 ? kChunkStart : 0u) |
                       (last ? kChunkEnd : 0u);
      if (last && n_leaves == 1) flags |= kRoot;
      uint32_t next[8];
      compress(cv, m, static_cast<uint32_t>(leaf), block_len, flags, next);
#pragma unroll
      for (int i = 0; i < 8; ++i) cv[i] = next[i];
    }
    if (n_leaves == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[8 * row + i] = cv[i];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) cvs[leaf][i] = cv[i];
    }
  }
  if (n_leaves == 1) return;  // uniform across the block
  __syncthreads();

  for (int count = n_leaves; count > 1; count = (count + 1) / 2) {
    const int pairs = count / 2;
    uint32_t node[8];
    bool write = false;
    if (leaf < pairs) {
      uint32_t m[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m[i] = cvs[2 * leaf][i];
        m[8 + i] = cvs[2 * leaf + 1][i];
      }
      const uint32_t flags =
          base_flags | kParent | (count == 2 ? kRoot : 0u);
      uint32_t kcv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) kcv[i] = key.w[i];
      compress(kcv, m, 0u, 64u, flags, node);
      write = true;
    } else if (leaf == pairs && (count & 1)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) node[i] = cvs[count - 1][i];
      write = true;
    }
    __syncthreads();
    if (write) {
#pragma unroll
      for (int i = 0; i < 8; ++i) cvs[leaf][i] = node[i];
    }
    __syncthreads();
  }
  if (leaf < 8) out[8 * row + leaf] = cvs[0][leaf];
}

}  // namespace

// C interface, bound with ctypes by zest_tpu_torch/ops/blake3_cuda.py.
// Launches on `stream` and does not synchronise; returns the launch's
// cudaError_t (0 on success).
extern "C" int zest_blake3_chunks(const uint32_t* words,
                                  const int32_t* lengths, uint32_t* out,
                                  int batch, int words_per_row,
                                  const uint32_t* key_words,
                                  uint32_t base_flags, void* stream) {
  if (batch <= 0) return 0;
  if (words_per_row <= 0 || words_per_row % kWordsPerLeaf ||
      words_per_row > kMaxLeaves * kWordsPerLeaf) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KeyWords key;
  for (int i = 0; i < 8; ++i) key.w[i] = key_words[i];
  int threads = words_per_row / kWordsPerLeaf;
  threads = ((threads + 31) / 32) * 32;
  blake3_chunks_kernel<<<batch, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      words, lengths, out, words_per_row, key, base_flags);
  return static_cast<int>(cudaGetLastError());
}
