// BG4 regroup (the ByteGrouping4 inverse) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel: zest_tpu/ops/decode_pallas.py
// lines 57-118, `_make_regroup_kernel` launched by `_regroup_pallas`. Same
// contract: (B, W) little-endian u32 planar words in, plane k of a row at
// word offset k*W/4 (the quarter-capacity slots FusedBg4Verifier.stage_planar
// fills), W a multiple of 4 (the wrapper, ops/bg4_cuda.py, enforces it);
// (B, W) u32 words out, where output word 4g+s packs byte s of each plane's
// word g -- in bytes, out[4i+k] = plane_k[i].
//
// What bounds it: bytes. It reads each row's capacity once and writes it
// once, and does eight byte permutes per 16 output bytes; on an H100 the
// memory time (3.35 TB/s) is far above the integer time.
//
// Design (the Pallas tiling -- 128 chunk lanes, 256-word groups, the
// transposes around the call -- is not carried over):
//   - one thread per (row, plane word g), a flat 1-D grid over B * W/4;
//   - four 4-byte loads, word g of each plane: neighbouring threads read
//     neighbouring words of each plane, so a warp's loads coalesce into four
//     128-byte segments;
//   - PRMT (__byte_perm) interleaves the planes' bytes pairwise, then the
//     pairs, into the four output words, which leave as one 16-byte store to
//     words 4g..4g+3 (the rows are 16-byte aligned: W is a multiple of 4).
// Garbage past a plane's size lands only at byte positions >= the chunk's
// length, which the BLAKE3 kernel masks, so it cannot change a digest.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bg4_regroup_kernel(const uint32_t* __restrict__ planar,
                   uint4* __restrict__ out, long long plane_words,
                   long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long row = i / plane_words;
  const long long g = i - row * plane_words;
  const uint32_t* src = planar + row * 4 * plane_words + g;
  const uint32_t p0 = __ldg(src);
  const uint32_t p1 = __ldg(src + plane_words);
  const uint32_t p2 = __ldg(src + 2 * plane_words);
  const uint32_t p3 = __ldg(src + 3 * plane_words);
  // Bytes (low first): lo01 = p0.0 p1.0 p0.1 p1.1, hi01 = p0.2 p1.2 p0.3
  // p1.3, and the same for planes 2 and 3.
  const uint32_t lo01 = __byte_perm(p0, p1, 0x5140);
  const uint32_t hi01 = __byte_perm(p0, p1, 0x7362);
  const uint32_t lo23 = __byte_perm(p2, p3, 0x5140);
  const uint32_t hi23 = __byte_perm(p2, p3, 0x7362);
  uint4 w;  // word s = p0.s p1.s p2.s p3.s
  w.x = __byte_perm(lo01, lo23, 0x5410);
  w.y = __byte_perm(lo01, lo23, 0x7632);
  w.z = __byte_perm(hi01, hi23, 0x5410);
  w.w = __byte_perm(hi01, hi23, 0x7632);
  // Row `row`'s output starts at uint4 index row * plane_words, so words
  // 4g..4g+3 are uint4 index row * plane_words + g == i.
  out[i] = w;
}

}  // namespace

// C interface, bound with ctypes by zest_tpu_torch/ops/bg4_cuda.py.
// Launches on `stream` and does not synchronise; returns the launch's
// cudaError_t (0 on success).
extern "C" int zest_bg4_regroup(const uint32_t* planar, uint32_t* out,
                                long long batch, long long words_per_row,
                                void* stream) {
  if (batch <= 0 || words_per_row == 0) return 0;
  if (words_per_row < 0 || words_per_row % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long plane_words = words_per_row / 4;
  const long long total = batch * plane_words;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  bg4_regroup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      planar, reinterpret_cast<uint4*>(out), plane_words, total);
  return static_cast<int>(cudaGetLastError());
}
