// Native batch decode engine: N chunk frames -> one destination buffer.
//
// The GB-scale landing used to touch every pulled byte with a scalar
// Python core: per-chunk frame parsing, per-chunk LZ4-frame decode, and
// a Python-level copy into the tensor buffer. This engine takes a whole
// batch of decode descriptors in ONE ctypes call (the GIL is released
// for the call's duration) and decodes them across a std::thread pool
// straight into the caller-owned destination — no per-chunk Python
// round-trips, no intermediate bytes objects.
//
// Descriptor i:
//   srcs[i]/src_lens[i]  — the chunk's compressed payload (NOT the frame
//                          header; the Python side strips it)
//   schemes[i]           — cas.compression.Scheme (0 NONE, 1 LZ4,
//                          2 BG4_LZ4, 3 BITSLICE_LZ4)
//   dst_offs[i]/dst_lens[i] — destination range within dst (the chunk's
//                          uncompressed bytes land at dst + dst_offs[i])
//
// The LZ4 payloads are LZ4 *frames* (magic 0x184D2204), exactly what the
// xorb container stores — the frame walk here mirrors
// lz4_frame_decompress in zest_tpu_torch/cas/compression.py (a copy of
// the JAX package's engine, which tests/test_decode_engine.py checks).
//
// C ABI:
//   zest_decode_batch(...) -> 0 on success, i+1 for the first (lowest-
//     index) failing descriptor; the caller names it in its error.

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" size_t zest_lz4_decompress(const uint8_t* src, size_t n,
                                      uint8_t* dst, size_t expected);

namespace {

constexpr uint8_t SCHEME_NONE = 0;
constexpr uint8_t SCHEME_LZ4 = 1;
constexpr uint8_t SCHEME_BG4 = 2;
constexpr uint8_t SCHEME_BITSLICE = 3;

// LZ4 frame walk (spec: magic, FLG/BD, optional content-size/dict-id,
// header-checksum byte, then u32-length blocks; bit 31 = stored).
bool frame_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                      size_t expected) {
  static const uint8_t kMagic[4] = {0x04, 0x22, 0x4d, 0x18};
  if (n < 7 || std::memcmp(src, kMagic, 4) != 0) return false;
  uint8_t flg = src[4], bd = src[5];
  if ((flg >> 6) != 1) return false;
  size_t block_max = (size_t)1 << (8 + 2 * ((bd >> 4) & 0x7));
  size_t pos = 6;
  if (flg & 0x08) pos += 8;  // content size (chunk header is authoritative)
  if (flg & 0x01) pos += 4;  // dictionary id
  pos += 1;                  // header checksum byte
  size_t out = 0;
  for (;;) {
    if (pos + 4 > n) return false;
    uint32_t bsz;
    std::memcpy(&bsz, src + pos, 4);
    pos += 4;
    if (bsz == 0) break;
    bool stored = (bsz & 0x80000000u) != 0;
    bsz &= 0x7FFFFFFFu;
    if (pos + bsz > n) return false;
    const uint8_t* block = src + pos;
    pos += bsz;
    if (flg & 0x10) pos += 4;  // block checksum; ignored
    if (stored) {
      if (out + bsz > expected) return false;
      std::memcpy(dst + out, block, bsz);
      out += bsz;
    } else {
      size_t remaining = expected - out;
      size_t want = remaining < block_max ? remaining : block_max;
      if (zest_lz4_decompress(block, bsz, dst + out, want) != want)
        return false;
      out += want;
    }
  }
  return out == expected;
}

// ByteGrouping4 inverse: planar [plane0 | plane1 | plane2 | plane3]
// (sizes (n-k+3)/4) -> interleaved bytes, dst[4i+k] = plane_k[i].
void bg4_inverse(const uint8_t* src, uint8_t* dst, size_t n) {
  size_t off = 0;
  for (size_t k = 0; k < 4; k++) {
    size_t size_k = (n - k + 3) / 4;
    const uint8_t* plane = src + off;
    for (size_t i = 0; i < size_k; i++) dst[4 * i + k] = plane[i];
    off += size_k;
  }
}

// Bitslice inverse: 8 MSB-first bit planes of (n+7)/8 bytes each
// (numpy packbits order) -> original bytes.
void bitslice_inverse(const uint8_t* src, uint8_t* dst, size_t n) {
  size_t plane_len = (n + 7) / 8;
  std::memset(dst, 0, n);
  for (size_t b = 0; b < 8; b++) {
    const uint8_t* plane = src + b * plane_len;
    for (size_t i = 0; i < n; i++) {
      uint8_t bit = (plane[i >> 3] >> (7 - (i & 7))) & 1;
      dst[i] |= (uint8_t)(bit << b);
    }
  }
}

bool decode_one(const uint8_t* src, size_t src_len, uint8_t scheme,
                uint8_t* dst, size_t dst_len,
                std::vector<uint8_t>& scratch) {
  switch (scheme) {
    case SCHEME_NONE:
      if (src_len != dst_len) return false;
      std::memcpy(dst, src, dst_len);
      return true;
    case SCHEME_LZ4:
      return frame_decompress(src, src_len, dst, dst_len);
    case SCHEME_BG4:
      if (scratch.size() < dst_len) scratch.resize(dst_len);
      if (!frame_decompress(src, src_len, scratch.data(), dst_len))
        return false;
      bg4_inverse(scratch.data(), dst, dst_len);
      return true;
    case SCHEME_BITSLICE: {
      size_t plane_bytes = ((dst_len + 7) / 8) * 8;
      if (scratch.size() < plane_bytes) scratch.resize(plane_bytes);
      if (!frame_decompress(src, src_len, scratch.data(), plane_bytes))
        return false;
      bitslice_inverse(scratch.data(), dst, dst_len);
      return true;
    }
    default:
      return false;
  }
}

}  // namespace

extern "C" {

size_t zest_parse_frames(const uint8_t* data, uint64_t n, uint64_t max_chunks,
                         uint64_t* frame_offs, uint32_t* comp_lens,
                         uint32_t* unc_lens, uint8_t* schemes) {
  // One pass over a xorb frame stream: fills the columnar chunk table
  // (frame offset, compressed len, uncompressed len, scheme) that
  // XorbReader used to build with a per-chunk Python loop. Returns the
  // chunk count, or (size_t)-1 on a malformed stream (truncated header,
  // nonzero frame version, payload past the end, > max_chunks).
  uint64_t pos = 0;
  uint64_t count = 0;
  while (pos < n) {
    if (pos + 8 > n) return (size_t)-1;
    if (data[pos] != 0) return (size_t)-1;  // unknown frame version
    uint32_t comp = (uint32_t)data[pos + 1] | ((uint32_t)data[pos + 2] << 8) |
                    ((uint32_t)data[pos + 3] << 16);
    uint32_t unc = (uint32_t)data[pos + 5] | ((uint32_t)data[pos + 6] << 8) |
                   ((uint32_t)data[pos + 7] << 16);
    uint64_t end = pos + 8 + comp;
    if (end > n) return (size_t)-1;
    if (count >= max_chunks) return (size_t)-1;
    frame_offs[count] = pos;
    comp_lens[count] = comp;
    unc_lens[count] = unc;
    schemes[count] = data[pos + 4];
    count++;
    pos = end;
  }
  return (size_t)count;
}

size_t zest_decode_batch(const uint8_t* const* srcs, const uint64_t* src_lens,
                         const uint8_t* schemes, const uint64_t* dst_offs,
                         const uint64_t* dst_lens, uint64_t n, uint8_t* dst,
                         uint64_t dst_cap, uint64_t workers) {
  if (n == 0) return 0;
  // Bounds are re-checked here so a buggy caller can never make a worker
  // scribble outside dst (the Python layer also validates, with ranges).
  for (uint64_t i = 0; i < n; i++) {
    if (dst_offs[i] + dst_lens[i] > dst_cap ||
        dst_offs[i] + dst_lens[i] < dst_offs[i])
      return (size_t)(i + 1);
  }
  // First (lowest-index) failure wins, so error reporting is
  // deterministic regardless of worker interleaving.
  std::atomic<uint64_t> first_error{n + 1};

  auto run = [&](uint64_t lo, uint64_t hi) {
    std::vector<uint8_t> scratch;
    for (uint64_t i = lo; i < hi; i++) {
      if (first_error.load(std::memory_order_relaxed) <= i) return;
      if (!decode_one(srcs[i], (size_t)src_lens[i], schemes[i],
                      dst + dst_offs[i], (size_t)dst_lens[i], scratch)) {
        uint64_t cur = first_error.load(std::memory_order_relaxed);
        while (i + 1 < cur && !first_error.compare_exchange_weak(
                                  cur, i + 1, std::memory_order_relaxed)) {
        }
      }
    }
  };

  uint64_t nw = workers;
  if (nw > n) nw = n;
  if (nw <= 1) {
    run(0, n);
  } else {
    // Contiguous stripes (not an atomic work queue): descriptors are
    // typically source-ordered, so stripes keep each worker streaming
    // through adjacent payload bytes.
    std::vector<std::thread> threads;
    threads.reserve((size_t)nw);
    uint64_t per = (n + nw - 1) / nw;
    for (uint64_t w = 0; w < nw; w++) {
      uint64_t lo = w * per;
      uint64_t hi = lo + per < n ? lo + per : n;
      if (lo >= hi) break;
      threads.emplace_back(run, lo, hi);
    }
    for (auto& t : threads) t.join();
  }
  uint64_t err = first_error.load();
  return err <= n ? (size_t)err : 0;
}

}  // extern "C"
