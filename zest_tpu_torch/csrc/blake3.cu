// Batched BLAKE3 chunk verifiers for Hopper (sm_90a): one kernel template,
// two message loaders.
//
// Replaces two of the JAX package's Pallas TPU kernels:
//   - zest_tpu/ops/blake3_pallas.py, `_make_kernel` launched by
//     `_hash_pallas` (PallasHasher.hash_device / hash_batch): entry point
//     `zest_blake3_chunks`, which reads (B, cap/4) little-endian u32 row
//     words;
//   - zest_tpu/ops/decode_pallas.py, `_fused_regroup_hash` (the BG4 regroup
//     chained into the BLAKE3 kernel): entry point `zest_blake3_bg4_chunks`,
//     which reads (B, cap/4) u32 planar words, plane k of a row at word
//     k*cap/16 (the quarter-capacity slots ops/bg4.stage_planar fills), and
//     hashes the regrouped bytes, out[4i+k] = plane_k[i], without ever
//     writing them to device memory.
// Both take (B,) int32 byte lengths and give (B, 8) u32 digests, plain or
// keyed (KEYED_HASH; Xet chunk hashes use the CHUNK_KEY domain key), cap a
// 1 KiB multiple of at most 128 KiB (the wrappers, ops/blake3_cuda.py and
// ops/bg4_cuda.py, enforce it). Bytes past each length are masked to zero
// here, so garbage past a length, or past a plane, cannot change a digest.
//
// What bounds it: integer ALU work. One 64-byte block compression is
// 7 rounds x 8 G functions x 12 u32 instructions plus 8 output xors, 680
// per 64 bytes (a G is 14 ops as written, but each `a + b + m` issues as
// one three-input add, IADD3). Compiled for sm_90a, about a sixth of them
// (the two-input adds) issue as IMAD on the FMA pipe, beside the ALU pipe,
// so the ALU pipe's share (chip_smoke.py counts it from the SASS) is what
// bounds the time. A chunk of n bytes costs ceil(n/64) leaf block
// compressions plus (leaves - 1) parent ones; the planar loader adds 8
// byte permutes (PRMT) per 16 bytes. The bytes (each row read once up to
// its length) take about half the integer time on an H100.
//
// Design. The earlier version ran one block per chunk and one thread per
// 1 KiB leaf. It reached 64% of its bound when every chunk was 64 KiB, but
// 42% on CDC chunks (8-128 KiB): whole chunks placed statically left some
// SMs with half again the mean work, and the lanes past a chunk's last
// leaf idled inside live warps (PERF.md has the timed variants that
// showed it). Now:
//   - work items are (chunk, 32-leaf group): one warp, one lane per leaf.
//     Items are equal work but for a chunk's last group. 16 persistent
//     warps an SM (2 blocks of 8) take item w, then items from a ticket
//     counter, so an SM whose items were short takes more; a group past a
//     chunk's last leaf costs one length read. Item t is group t / B of
//     chunk t % B: every first group comes before any second group. More
//     warps an SM measured slower (the first round of items then hands out
//     all the work at once, unevenly, and registers drop to 64);
//   - each lane loads its leaf's block b+1, four 16-byte loads, while it
//     compresses block b. The planar loader's four pieces of a leaf's block
//     are one 16-byte piece of each plane, at plane word 64L + 4b, since
//     message word j of block b of leaf L is regrouped word 256L + 16b + j
//     = 4g + s with g = 64L + 4b + j/4 and s = j%4: byte s of word g of
//     each plane; 8 PRMTs per 16 bytes regroup them in registers. Staging
//     the group's blocks through shared memory with cp.async (coalesced,
//     double-buffered) measured 3.5% slower: its copies, waits and shared
//     reads cost more issue slots than the strided loads' L1 traffic;
//   - only a leaf's last, partial block is masked; full blocks take the
//     branch-free path;
//   - a chunk of one group folds its leaf CVs in the warp with
//     __shfl_down_sync, no barrier. The pairwise fold with odd-tail
//     promotion is BLAKE3's left-balanced tree; the merge that sees exactly
//     two live nodes carries ROOT;
//   - a chunk of 2-4 groups writes its leaf CVs to `scratch` (1 + 1024
//     words a row); each group fences and counts in, and the last to
//     arrive folds the whole tree a level at a time, one merge a lane
//     (level 1 from scratch, then in shared memory). Per-group shuffle
//     folds measured 13% slower: their levels run at 16, 8, 4, 2 and 1
//     live lanes. The last arrival sets the counter back to 0, and so does
//     the last warp for the two work counters, so the wrapper zeroes the
//     scratch once per stream, not per launch. No warp ever waits for
//     another;
//   - a one-leaf chunk finishes in its lane: its last block takes ROOT.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kChunkStart = 1u << 0;
constexpr uint32_t kChunkEnd = 1u << 1;
constexpr uint32_t kParent = 1u << 2;
constexpr uint32_t kRoot = 1u << 3;
constexpr int kMaxLeaves = 128;
constexpr int kWordsPerLeaf = 256;
constexpr int kGroupLeaves = 32;                    // one warp, a leaf a lane
constexpr int kNodeWords = 8 * kMaxLeaves / 2;      // a fold's level 1
constexpr int kControlWords = 2;                    // ticket, warps done
constexpr int kJoinWords = 1 + 8 * kMaxLeaves;   // counter, leaf CVs
// 16 resident warps an SM (24 and 32 measured slower: see the note above).
constexpr int kWarpsPerBlock = 8;
constexpr int kBlocksPerSM = 2;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

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

// Parent node of two chaining values: the key as CV, counter 0, a full
// 64-byte block, PARENT (and ROOT when `flags` has it).
__device__ __forceinline__ void parent(const KeyWords& key,
                                       const uint32_t (&left)[8],
                                       const uint32_t (&right)[8],
                                       uint32_t flags, uint32_t (&out)[8]) {
  uint32_t m[16];
  uint32_t kcv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = left[i];
    m[8 + i] = right[i];
    kcv[i] = key.w[i];
  }
  compress(kcv, m, 0u, 64u, flags | kParent, out);
}

// Keep the first `valid` bytes (0..4) of a little-endian word.
__device__ __forceinline__ uint32_t keep_bytes(uint32_t w, int valid) {
  return valid >= 4 ? w : (valid <= 0 ? 0u : w & ((1u << (8 * valid)) - 1u));
}

// Row words: block b of leaf L is row words 256L + 16b .. 256L + 16b + 15,
// four 16-byte pieces q = 0..3.
struct RowLoader {
  __device__ static const uint32_t* piece(const uint32_t* row, int, int leaf,
                                          int b, int q) {
    return row + leaf * kWordsPerLeaf + 16 * b + 4 * q;
  }
  __device__ static void unpack(const uint4 (&p)[4], uint32_t (&m)[16]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      m[4 * q + 0] = p[q].x;
      m[4 * q + 1] = p[q].y;
      m[4 * q + 2] = p[q].z;
      m[4 * q + 3] = p[q].w;
    }
  }
};

// Word s of the regrouped quad = byte s of each plane's word (p0 the low
// byte): the same eight PRMTs as the regroup kernel, csrc/bg4.cu.
__device__ __forceinline__ void regroup4(uint32_t p0, uint32_t p1,
                                         uint32_t p2, uint32_t p3,
                                         uint32_t* w) {
  const uint32_t lo01 = __byte_perm(p0, p1, 0x5140);
  const uint32_t hi01 = __byte_perm(p0, p1, 0x7362);
  const uint32_t lo23 = __byte_perm(p2, p3, 0x5140);
  const uint32_t hi23 = __byte_perm(p2, p3, 0x7362);
  w[0] = __byte_perm(lo01, lo23, 0x5410);
  w[1] = __byte_perm(lo01, lo23, 0x7632);
  w[2] = __byte_perm(hi01, hi23, 0x5410);
  w[3] = __byte_perm(hi01, hi23, 0x7632);
}

// BG4 planes: piece q of block b of leaf L is plane q's words 64L + 4b ..
// 64L + 4b + 3; message words 4t..4t+3 regroup word t of the four pieces.
struct PlanarLoader {
  __device__ static const uint32_t* piece(const uint32_t* row,
                                          int plane_words, int leaf, int b,
                                          int q) {
    return row + q * plane_words + 64 * leaf + 4 * b;
  }
  __device__ static void unpack(const uint4 (&p)[4], uint32_t (&m)[16]) {
    regroup4(p[0].x, p[1].x, p[2].x, p[3].x, m + 0);
    regroup4(p[0].y, p[1].y, p[2].y, p[3].y, m + 4);
    regroup4(p[0].z, p[1].z, p[2].z, p[3].z, m + 8);
    regroup4(p[0].w, p[1].w, p[2].w, p[3].w, m + 12);
  }
};

// Hash group `group` (32 leaves) of chunk `row` in one warp; `nodes`
// (kNodeWords of shared memory) holds the tree fold of a chunk of more than
// one group. A group past the chunk's last leaf returns at once.
template <class Loader>
__device__ __forceinline__ void hash_group(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ lengths,
    uint32_t* __restrict__ out, int words_per_row, const KeyWords& key,
    uint32_t base_flags, uint32_t* __restrict__ scratch,
    uint32_t* nodes, int lane, int row, int group) {
  const int cap_bytes = 4 * words_per_row;
  int len = lengths[row];
  len = len < 0 ? 0 : (len > cap_bytes ? cap_bytes : len);
  const int n_leaves = len > 1024 ? (len + 1023) / 1024 : 1;
  const int n_groups = (n_leaves + kGroupLeaves - 1) / kGroupLeaves;
  if (group >= n_groups) return;  // the whole warp: no leaf of this chunk

  const int first = group * kGroupLeaves;
  const int live = min(kGroupLeaves, n_leaves - first);  // >= 1
  const int leaf = first + lane;
  int leaf_bytes = len - 1024 * leaf;
  leaf_bytes = leaf_bytes < 0 ? 0 : (leaf_bytes > 1024 ? 1024 : leaf_bytes);
  const int my_blocks =
      lane < live ? (leaf_bytes > 0 ? (leaf_bytes + 63) / 64 : 1) : 0;
  const uint32_t* row_words =
      words + static_cast<size_t>(row) * words_per_row;
  const int plane_words = words_per_row / 4;

  uint32_t cv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = key.w[i];

  // Each lane loads its leaf's next block while it compresses this one.
  uint4 cur[4];
  if (my_blocks > 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cur[q] = __ldg(reinterpret_cast<const uint4*>(
          Loader::piece(row_words, plane_words, leaf, 0, q)));
    }
  }
  for (int b = 0; b < my_blocks; ++b) {
    uint32_t m[16];
    Loader::unpack(cur, m);
    if (b + 1 < my_blocks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cur[q] = __ldg(reinterpret_cast<const uint4*>(
            Loader::piece(row_words, plane_words, leaf, b + 1, q)));
      }
    }
    const int rem = leaf_bytes - 64 * b;  // this block's bytes, if < 64
    uint32_t block_len = 64u;
    if (rem < 64) {  // the leaf's last block, and it is partial
      block_len = rem > 0 ? static_cast<uint32_t>(rem) : 0u;
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = keep_bytes(m[i], rem - 4 * i);
    }
    const bool last = b == my_blocks - 1;
    uint32_t flags = base_flags | (b == 0 ? kChunkStart : 0u) |
                     (last ? kChunkEnd : 0u);
    if (last && n_leaves == 1) flags |= kRoot;
    uint32_t next[8];
    compress(cv, m, static_cast<uint32_t>(leaf), block_len, flags, next);
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = next[i];
  }
  uint32_t* dst = out + 8 * static_cast<size_t>(row);
  if (n_leaves == 1) {  // lane 0 ran the root block
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = cv[i];
    }
    return;
  }

  if (n_groups == 1) {
    // The chunk's tree in registers: at step s the live nodes sit at lanes
    // 0, s, 2s.. (ceil(live/s) of them); lane l merges with lane l+s when
    // that exists, else its node is promoted. With ceil(live/s) == 2 the
    // one merge left is the root.
    for (int s = 1; s < live; s <<= 1) {
      uint32_t right[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        right[i] = __shfl_down_sync(kFullMask, cv[i], s);
      }
      if ((lane & (2 * s - 1)) == 0 && lane + s < live) {
        const bool root = (live + s - 1) / s == 2;
        uint32_t node[8];
        parent(key, cv, right, base_flags | (root ? kRoot : 0u), node);
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = node[i];
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = cv[i];
    }
    return;
  }

  // A chunk of 2-4 groups: its leaf CVs meet in scratch, and the last
  // group to arrive folds the whole tree, a level at a time with a merge a
  // lane.
  uint32_t* join =
      scratch + kControlWords + static_cast<size_t>(row) * kJoinWords;
  const uint32_t* leaves = join + 1;
  if (lane < live) {
#pragma unroll
    for (int i = 0; i < 8; ++i) join[1 + 8 * leaf + i] = cv[i];
  }
  __threadfence();
  __syncwarp();
  unsigned arrived = 0;
  if (lane == 0) arrived = atomicAdd(join, 1u);
  arrived = __shfl_sync(kFullMask, arrived, 0);
  if (arrived != static_cast<unsigned>(n_groups - 1)) return;
  __threadfence();
  // Level 1 from scratch into `nodes`; pairwise with odd-tail promotion,
  // ROOT on the merge of the last two.
  int count = n_leaves;
  for (int j = lane; j < (count + 1) / 2; j += 32) {
    uint32_t node[8];
    if (2 * j + 1 < count) {
      uint32_t l[8], r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        l[i] = __ldcg(leaves + 16 * j + i);
        r[i] = __ldcg(leaves + 16 * j + 8 + i);
      }
      parent(key, l, r, base_flags | (count == 2 ? kRoot : 0u), node);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) node[i] = __ldcg(leaves + 16 * j + i);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) nodes[8 * j + i] = node[i];
  }
  for (count = (count + 1) / 2; count > 1; count = (count + 1) / 2) {
    __syncwarp();
    const bool active = lane < (count + 1) / 2;  // <= 32 nodes from here
    uint32_t node[8];
    if (active && 2 * lane + 1 < count) {
      uint32_t l[8], r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        l[i] = nodes[16 * lane + i];
        r[i] = nodes[16 * lane + 8 + i];
      }
      parent(key, l, r, base_flags | (count == 2 ? kRoot : 0u), node);
    } else if (active) {
#pragma unroll
      for (int i = 0; i < 8; ++i) node[i] = nodes[16 * lane + i];
    }
    __syncwarp();  // every lane has read its pair before any is replaced
    if (active) {
#pragma unroll
      for (int i = 0; i < 8; ++i) nodes[8 * lane + i] = node[i];
    }
  }
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = nodes[i];
    *join = 0u;  // ready for the next launch on this stream
  }
}

// Persistent warps: warp w takes work item w, then items handed out by the
// ticket counter scratch[0] until all B x groups_per_row are taken. Item t
// is group t / B of chunk t % B, so every chunk's first group comes before
// any second group. The last warp to finish (counter scratch[1]) sets both
// counters back to 0.
template <class Loader>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kBlocksPerSM)
chunks_kernel(const uint32_t* __restrict__ words,
              const int32_t* __restrict__ lengths,
              uint32_t* __restrict__ out, int batch, int words_per_row,
              KeyWords key, uint32_t base_flags,
              uint32_t* __restrict__ scratch) {
  __shared__ uint32_t nodes[kWarpsPerBlock][kNodeWords];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = gridDim.x * kWarpsPerBlock;
  const int groups_per_row =
      (words_per_row / kWordsPerLeaf + kGroupLeaves - 1) / kGroupLeaves;
  const int total = batch * groups_per_row;
  int t = blockIdx.x * kWarpsPerBlock + warp;
  while (t < total) {
    hash_group<Loader>(words, lengths, out, words_per_row, key, base_flags,
                       scratch, nodes[warp], lane, t % batch, t / batch);
    unsigned next = 0;
    if (lane == 0) next = atomicAdd(scratch, 1u);
    t = n_warps + static_cast<int>(__shfl_sync(kFullMask, next, 0));
  }
  if (lane == 0) {
    __threadfence();
    if (atomicAdd(scratch + 1, 1u) == static_cast<unsigned>(n_warps - 1)) {
      scratch[0] = 0u;
      scratch[1] = 0u;
    }
  }
}

template <class Loader>
int launch(const uint32_t* words, const int32_t* lengths, uint32_t* out,
           int batch, int words_per_row, const uint32_t* key_words,
           uint32_t base_flags, uint32_t* scratch, void* stream) {
  if (batch <= 0) return 0;
  if (words_per_row <= 0 || words_per_row % kWordsPerLeaf ||
      words_per_row > kMaxLeaves * kWordsPerLeaf ||
      batch > (1 << 28)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KeyWords key;
  for (int i = 0; i < 8; ++i) key.w[i] = key_words[i];
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups_per_row =
      (words_per_row / kWordsPerLeaf + kGroupLeaves - 1) / kGroupLeaves;
  const long long items = static_cast<long long>(batch) * groups_per_row;
  const long long wanted = (items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = static_cast<int>(
      wanted < kBlocksPerSM * sms ? wanted : kBlocksPerSM * sms);
  chunks_kernel<Loader><<<blocks, kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      words, lengths, out, batch, words_per_row, key, base_flags, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by zest_tpu_torch/ops/blake3_cuda.py.
// `scratch` holds kControlWords + batch * kJoinWords = 2 + 1025 * batch
// u32 words (the work-ticket and warps-done counters, then per row the
// counter that joins its 32-leaf groups and its 128 leaf CVs), every
// counter zero before the launch; the kernel leaves them zero again. The
// words (or planes) must be 16-byte aligned for the kernel's uint4 loads.
// Each entry point launches on
// `stream` and does not synchronise; returns the launch's cudaError_t (0
// on success).
extern "C" int zest_blake3_chunks(const uint32_t* words,
                                  const int32_t* lengths, uint32_t* out,
                                  int batch, int words_per_row,
                                  const uint32_t* key_words,
                                  uint32_t base_flags, uint32_t* scratch,
                                  void* stream) {
  return launch<RowLoader>(words, lengths, out, batch, words_per_row,
                           key_words, base_flags, scratch, stream);
}

extern "C" int zest_blake3_bg4_chunks(const uint32_t* planar,
                                      const int32_t* lengths, uint32_t* out,
                                      int batch, int words_per_row,
                                      const uint32_t* key_words,
                                      uint32_t base_flags, uint32_t* scratch,
                                      void* stream) {
  return launch<PlanarLoader>(planar, lengths, out, batch, words_per_row,
                              key_words, base_flags, scratch, stream);
}
