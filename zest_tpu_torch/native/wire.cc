// Native BT wire framing — the seeding server's hot path.
//
// The reference's serving loop frames every CHUNK_RESPONSE through
// src/bt_wire.zig; the concat chain of zest_tpu_torch/p2p/wire.py and
// bep_xet.py is byte-identical but copies the chunk data three times (sub-payload + extended + frame concats). These
// entry points build the complete framed message in one pass into a
// caller-provided buffer, so a 64 KiB chunk is copied exactly once.
//
// Frame layout (BEP 3 + BEP 10 + BEP XET, src/bt_wire.zig:89-146 and
// src/bep_xet.zig:66-124):
//   [4 len BE][1 msg_id=20][1 ext_id][1 kind][...kind-specific...]
//
// Exposed C ABI (consumed via ctypes in zest_tpu_torch/native/__init__.py):
//   zest_wire_response_size(data_len)            -> total framed bytes
//   zest_wire_frame_chunk_response(...)          -> bytes written
//   zest_wire_frame_chunk_request(...)           -> bytes written (51)
//   zest_wire_frame_chunk_not_found(...)         -> bytes written (43)

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr uint8_t MSG_EXTENDED = 20;
constexpr uint8_t XET_CHUNK_REQUEST = 0x01;
constexpr uint8_t XET_CHUNK_RESPONSE = 0x02;
constexpr uint8_t XET_CHUNK_NOT_FOUND = 0x03;

inline uint8_t* put32be(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v >> 24);
  p[1] = (uint8_t)(v >> 16);
  p[2] = (uint8_t)(v >> 8);
  p[3] = (uint8_t)v;
  return p + 4;
}

// Common prefix: [4 len BE][20][ext_id][kind]; returns cursor past kind.
inline uint8_t* put_prefix(uint8_t* p, uint32_t body_len, uint8_t ext_id,
                           uint8_t kind) {
  p = put32be(p, body_len);
  *p++ = MSG_EXTENDED;
  *p++ = ext_id;
  *p++ = kind;
  return p;
}

}  // namespace

extern "C" {

// Total framed size of a CHUNK_RESPONSE carrying data_len payload bytes.
size_t zest_wire_response_size(size_t data_len) {
  return 4 + 2 + 13 + data_len;  // len + [20, ext] + xet hdr + data
}

// [4 len][20][ext][0x02][4 req][4 offset][4 dlen][data]; one memcpy.
size_t zest_wire_frame_chunk_response(uint8_t ext_id, uint32_t req_id,
                                      uint32_t chunk_offset,
                                      const uint8_t* data, size_t data_len,
                                      uint8_t* out) {
  uint8_t* p = put_prefix(out, (uint32_t)(2 + 13 + data_len), ext_id,
                          XET_CHUNK_RESPONSE);
  p = put32be(p, req_id);
  p = put32be(p, chunk_offset);
  p = put32be(p, (uint32_t)data_len);
  if (data_len) std::memcpy(p, data, data_len);
  return (size_t)(p - out) + data_len;
}

// [4 len][20][ext][0x01][4 req][32 hash][4 start][4 end] = 51 bytes.
size_t zest_wire_frame_chunk_request(uint8_t ext_id, uint32_t req_id,
                                     const uint8_t* hash32,
                                     uint32_t range_start, uint32_t range_end,
                                     uint8_t* out) {
  uint8_t* p = put_prefix(out, 2 + 45, ext_id, XET_CHUNK_REQUEST);
  p = put32be(p, req_id);
  std::memcpy(p, hash32, 32);
  p += 32;
  p = put32be(p, range_start);
  p = put32be(p, range_end);
  return (size_t)(p - out);
}

// [4 len][20][ext][0x03][4 req][32 hash] = 43 bytes.
size_t zest_wire_frame_chunk_not_found(uint8_t ext_id, uint32_t req_id,
                                       const uint8_t* hash32, uint8_t* out) {
  uint8_t* p = put_prefix(out, 2 + 37, ext_id, XET_CHUNK_NOT_FOUND);
  p = put32be(p, req_id);
  std::memcpy(p, hash32, 32);
  p += 32;
  return (size_t)(p - out);
}

}  // extern "C"
