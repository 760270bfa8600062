// Native GearHash CDC boundary scanner.
//
// Same algorithm and gear table as zest_tpu_torch/cas/chunking.py (the
// table is passed in from Python so there is exactly one source of truth).
// A byte-identical copy of the JAX package's scanner: the port builds
// its own library and shares no module with that package.
//
// C ABI:
//   zest_gear_cut_points(data, len, gear256, min, max, mask, out, out_cap)
//     -> number of cut points written (chunk end offsets, exclusive).

#include <cstdint>
#include <cstddef>

extern "C" {

size_t zest_gear_cut_points(const uint8_t* data, size_t len,
                            const uint64_t* gear, size_t min_chunk,
                            size_t max_chunk, uint64_t mask, uint64_t* out,
                            size_t out_cap) {
  // h = sum of gear[b_j] << age: contributions older than 64 bytes have
  // shifted out of the u64 entirely, so h at any position depends only
  // on the last 64 bytes. After a cut we therefore skip straight to
  // (min_chunk - 64) and warm the hash over just that window — the
  // sub-min region (usually 8 KiB) costs 64 table lookups, not 8192.
  constexpr size_t WINDOW = 64;
  if (min_chunk < 1) min_chunk = 1;  // a zero-length chunk can never cut
  size_t n_out = 0;
  size_t start = 0;
  while (start < len && n_out < out_cap) {
    size_t end_cap = (len - start > max_chunk) ? start + max_chunk : len;
    size_t check_from = start + min_chunk;  // first admissible cut end
    if (check_from >= end_cap) {
      // No mask cut can fire: either the max cap lands first (only when
      // max <= min, degenerate) or the data ends inside the min region.
      out[n_out++] = end_cap;
      start = end_cap;
      continue;
    }
    uint64_t h = 0;
    size_t warm = check_from > start + WINDOW ? check_from - WINDOW : start;
    for (size_t j = warm; j < check_from; j++) h = (h << 1) + gear[data[j]];

    // Scan: at i the candidate chunk is [start, i); h covers ..i-1.
    // Unrolled 8x so the end-of-range test runs once per 8 bytes; the
    // mask test itself must stay per-byte (cuts land at any offset).
    size_t i = check_from;
    bool cut = false;
#define GEAR_STEP                                                       \
    if ((h & mask) == 0) { cut = true; goto scan_done; }                \
    h = (h << 1) + gear[data[i]];                                       \
    i++
    while (i + 8 <= end_cap) {
      GEAR_STEP; GEAR_STEP; GEAR_STEP; GEAR_STEP;
      GEAR_STEP; GEAR_STEP; GEAR_STEP; GEAR_STEP;
    }
    for (;;) {
      if ((h & mask) == 0) { cut = true; break; }
      if (i == end_cap) break;
      h = (h << 1) + gear[data[i]];
      i++;
    }
#undef GEAR_STEP
  scan_done:
    if (cut) {
      out[n_out++] = i;
      start = i;
    } else {
      // max-size cut, or the final (possibly short) chunk at data end.
      out[n_out++] = end_cap;
      start = end_cap;
    }
  }
  return n_out;
}

}  // extern "C"
