// Native LZ4 block codec (independent implementation from the public spec).
//
// The block codec behind zest_tpu_torch/cas/compression.py. A copy of
// the JAX package's codec; tests/test_torch_cas.py holds the port's xorb
// bytes equal to the JAX package's.
//
// C ABI:
//   zest_lz4_compress(src, n, dst, dst_cap) -> compressed size, or 0 on
//     insufficient dst_cap (callers size dst with zest_lz4_bound).
//   zest_lz4_decompress(src, n, dst, expected) -> expected on success,
//     0 on malformed input.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr size_t MIN_MATCH = 4;
constexpr size_t HASH_LOG = 16;
constexpr size_t MAX_OFFSET = 0xFFFF;
// Incompressible-run acceleration (the reference LZ4 "skip trigger"):
// after every 2^SKIP_TRIGGER consecutive match misses the scan step
// grows by one, so random data degenerates to a fast skip + one big
// literal copy instead of a per-byte probe. The JAX package's encoders
// apply the same schedule, so the port's xorb bytes equal its own.
constexpr size_t SKIP_TRIGGER = 6;

inline uint32_t hash4(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return (v * 2654435761u) >> (32 - HASH_LOG);
}

inline uint8_t* emit_varlen(uint8_t* op, size_t v) {
  while (v >= 255) {
    *op++ = 255;
    v -= 255;
  }
  *op++ = (uint8_t)v;
  return op;
}

}  // namespace

extern "C" {

size_t zest_lz4_bound(size_t n) { return n + n / 255 + 16; }

size_t zest_lz4_compress(const uint8_t* src, size_t n, uint8_t* dst,
                         size_t dst_cap) {
  if (dst_cap < zest_lz4_bound(n)) return 0;
  uint8_t* op = dst;
  if (n == 0) {
    *op++ = 0;
    return (size_t)(op - dst);
  }

  int32_t table[1u << HASH_LOG];
  std::memset(table, -1, sizeof(table));

  size_t anchor = 0;
  size_t pos = 0;
  // Spec end conditions: last 5 bytes literals, last match starts >= 12
  // bytes before the end.
  size_t match_limit = n >= 12 ? n - 12 : 0;

  size_t search = 1u << SKIP_TRIGGER;
  while (pos < match_limit) {
    uint32_t h = hash4(src + pos);
    int32_t cand = table[h];
    table[h] = (int32_t)pos;
    if (cand < 0 || pos - (size_t)cand > MAX_OFFSET ||
        std::memcmp(src + cand, src + pos, 4) != 0) {
      pos += search++ >> SKIP_TRIGGER;
      continue;
    }
    search = 1u << SKIP_TRIGGER;
    size_t mlen = 4;
    size_t limit = n - 5;
    while (pos + mlen < limit && src[cand + mlen] == src[pos + mlen]) mlen++;

    size_t lit_len = pos - anchor;
    size_t ml = mlen - MIN_MATCH;
    *op++ = (uint8_t)((lit_len < 15 ? lit_len : 15) << 4 |
                      (ml < 15 ? ml : 15));
    if (lit_len >= 15) op = emit_varlen(op, lit_len - 15);
    std::memcpy(op, src + anchor, lit_len);
    op += lit_len;
    uint16_t offset = (uint16_t)(pos - (size_t)cand);
    *op++ = (uint8_t)offset;
    *op++ = (uint8_t)(offset >> 8);
    if (ml >= 15) op = emit_varlen(op, ml - 15);

    pos += mlen;
    anchor = pos;
  }

  size_t lit_len = n - anchor;
  *op++ = (uint8_t)((lit_len < 15 ? lit_len : 15) << 4);
  if (lit_len >= 15) op = emit_varlen(op, lit_len - 15);
  std::memcpy(op, src + anchor, lit_len);
  op += lit_len;
  return (size_t)(op - dst);
}

size_t zest_lz4_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                           size_t expected) {
  size_t ip = 0;
  size_t out = 0;
  while (ip < n) {
    uint8_t token = src[ip++];
    size_t lit_len = token >> 4;
    if (lit_len == 15) {
      uint8_t b;
      do {
        if (ip >= n) return 0;
        b = src[ip++];
        lit_len += b;
      } while (b == 255);
    }
    if (ip + lit_len > n || out + lit_len > expected) return 0;
    std::memcpy(dst + out, src + ip, lit_len);
    ip += lit_len;
    out += lit_len;
    if (ip == n) break;  // final literals-only sequence
    if (ip + 2 > n) return 0;
    size_t offset = (size_t)src[ip] | ((size_t)src[ip + 1] << 8);
    ip += 2;
    if (offset == 0 || offset > out) return 0;
    size_t mlen = (token & 0xF) + MIN_MATCH;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (ip >= n) return 0;
        b = src[ip++];
        mlen += b;
      } while (b == 255);
    }
    if (out + mlen > expected) return 0;
    // Byte-sequential copy: overlapping matches replicate correctly.
    const uint8_t* match = dst + out - offset;
    for (size_t i = 0; i < mlen; i++) dst[out + i] = match[i];
    out += mlen;
  }
  return out == expected ? expected : 0;
}

}  // extern "C"
