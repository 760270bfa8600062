"""Chunk compression schemes: None, LZ4, ByteGrouping4LZ4, FullBitsliceLZ4.

The port's own copy of the JAX package's codec, byte for byte in what it
writes (tests/test_torch_cas.py holds the minted xorbs equal):

- **LZ4** payloads are the standard LZ4 frame format (magic
  ``0x184D2204``, independent blocks, 256 KiB block max — a chunk is
  always a single block) wrapping LZ4 block data.
- **ByteGrouping4LZ4** regroups bytes into 4 planes (byte k of every
  4-byte group) before LZ4; float tensor bytes compress far better planar.
- **FullBitsliceLZ4** slices each byte into 8 bit-planes first.

``compress_auto`` picks the smallest encoding per chunk, storing the
chunk as None when compression doesn't pay. The LZ4 block codec is the
native library's (``native/lz4.cc``), and so is the batch decoder
(``native/decode.cc``).
"""

from __future__ import annotations

import ctypes
import enum
import struct

import numpy as np

from zest_tpu_torch import native


class Scheme(enum.IntEnum):
    NONE = 0
    LZ4 = 1
    BG4_LZ4 = 2
    BITSLICE_LZ4 = 3


class CompressionError(ValueError):
    pass


# ── LZ4 block format (native codec, lz4.cc) ──


def lz4_compress(data: bytes) -> bytes:
    return native.lib.lz4_compress(data)


def lz4_decompress(data: bytes, expected_len: int) -> bytes:
    return native.lib.lz4_decompress(data, expected_len)


# ── LZ4 frame format (what production xorb payloads actually hold) ──

_LZ4F_MAGIC = b"\x04\x22\x4d\x18"
# FLG 0x60: version 01, independent blocks, no checksums/content-size.
# BD 0x50: 256 KiB block max — every CDC chunk (<= 128 KiB) is one block.
_LZ4F_DESCRIPTOR = b"\x60\x50"

_XXH_P1, _XXH_P2, _XXH_P3, _XXH_P4, _XXH_P5 = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393
)
_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """XXH32 (needed for the LZ4 frame header checksum byte)."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _XXH_P1 + _XXH_P2) & _M32
        v2 = (seed + _XXH_P2) & _M32
        v3 = seed & _M32
        v4 = (seed - _XXH_P1) & _M32
        while i <= n - 16:
            for k, v in enumerate((v1, v2, v3, v4)):
                lane = int.from_bytes(data[i + 4 * k : i + 4 * k + 4], "little")
                v = (v + lane * _XXH_P2) & _M32
                v = (_rotl32(v, 13) * _XXH_P1) & _M32
                if k == 0: v1 = v
                elif k == 1: v2 = v
                elif k == 2: v3 = v
                else: v4 = v
            i += 16
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12)
             + _rotl32(v4, 18)) & _M32
    else:
        h = (seed + _XXH_P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        h = (h + int.from_bytes(data[i:i+4], "little") * _XXH_P3) & _M32
        h = (_rotl32(h, 17) * _XXH_P4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * _XXH_P5) & _M32
        h = (_rotl32(h, 11) * _XXH_P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _XXH_P2) & _M32
    h ^= h >> 13
    h = (h * _XXH_P3) & _M32
    h ^= h >> 16
    return h


def lz4_frame_compress(data: bytes) -> bytes:
    """One-block LZ4 frame (the production chunk-payload shape)."""
    hc = (xxh32(_LZ4F_DESCRIPTOR) >> 8) & 0xFF
    out = bytearray(_LZ4F_MAGIC + _LZ4F_DESCRIPTOR + bytes([hc]))
    if data:
        block = lz4_compress(data)
        if len(block) < len(data):
            out += struct.pack("<I", len(block)) + block
        else:
            out += struct.pack("<I", 0x80000000 | len(data)) + data
    out += b"\x00\x00\x00\x00"  # end mark
    return bytes(out)


def lz4_frame_decompress(data: bytes, expected_len: int) -> bytes:
    """Decode an LZ4 frame to exactly ``expected_len`` bytes."""
    if data[:4] != _LZ4F_MAGIC:
        raise CompressionError("not an LZ4 frame")
    if len(data) < 7:
        raise CompressionError("truncated LZ4 frame header")
    flg, bd = data[4], data[5]
    if flg >> 6 != 1:
        raise CompressionError("unsupported LZ4 frame version")
    block_max = 1 << (8 + 2 * ((bd >> 4) & 0x7))
    pos = 6
    if flg & 0x08:
        pos += 8  # content size (unused; the chunk header is authoritative)
    if flg & 0x01:
        pos += 4  # DictID (FLG bit 0): 4-byte dictionary ID before HC
    # FLG bit 2 (0x04) = content checksum after the end mark; the block
    # loop stops at the end mark, so it needs no skip here.
    pos += 1  # header checksum byte
    out = bytearray()
    while True:
        if pos + 4 > len(data):
            raise CompressionError("truncated LZ4 frame block")
        (bsz,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if bsz == 0:
            break
        stored = bool(bsz & 0x80000000)
        bsz &= 0x7FFFFFFF
        if pos + bsz > len(data):
            raise CompressionError("LZ4 frame block extends past input")
        block = data[pos : pos + bsz]
        pos += bsz
        if flg & 0x10:
            pos += 4  # block checksum; ignored
        if stored:
            out += block
        else:
            # Encoders fill blocks to block_max; only the final block is
            # short, and its size is pinned by expected_len.
            remaining = expected_len - len(out)
            out += lz4_decompress(block, min(block_max, remaining))
    if len(out) != expected_len:
        raise CompressionError(
            f"LZ4 frame decoded {len(out)} bytes, expected {expected_len}"
        )
    return bytes(out)


# ── Byte-grouping and bit-slicing transforms ──


def _bg4(data: bytes) -> bytes:
    a = np.frombuffer(data, dtype=np.uint8)
    return b"".join(a[k::4].tobytes() for k in range(4))


def _bg4_inverse(data: bytes) -> bytes:
    n = len(data)
    sizes = [(n - k + 3) // 4 for k in range(4)]
    out = np.empty(n, dtype=np.uint8)
    pos = 0
    a = np.frombuffer(data, dtype=np.uint8)
    for k in range(4):
        out[k::4] = a[pos : pos + sizes[k]]
        pos += sizes[k]
    return out.tobytes()


def _bitslice(data: bytes) -> bytes:
    a = np.frombuffer(data, dtype=np.uint8)
    planes = [np.packbits((a >> b) & 1) for b in range(8)]
    return b"".join(p.tobytes() for p in planes)


def _bitslice_inverse(data: bytes, orig_len: int) -> bytes:
    plane_len = (orig_len + 7) // 8
    a = np.frombuffer(data, dtype=np.uint8)
    if len(a) != plane_len * 8:
        raise CompressionError("bitslice payload length mismatch")
    out = np.zeros(orig_len, dtype=np.uint8)
    for b in range(8):
        bits = np.unpackbits(a[b * plane_len : (b + 1) * plane_len])[:orig_len]
        out |= bits.astype(np.uint8) << b
    return out.tobytes()


# ── Scheme-level API used by the xorb container ──


def compress(data: bytes, scheme: Scheme) -> bytes:
    if scheme == Scheme.NONE:
        return data
    if scheme == Scheme.LZ4:
        return lz4_frame_compress(data)
    if scheme == Scheme.BG4_LZ4:
        return lz4_frame_compress(_bg4(data))
    if scheme == Scheme.BITSLICE_LZ4:
        return lz4_frame_compress(_bitslice(data))
    raise CompressionError(f"unknown scheme {scheme}")


def decompress(data: bytes, scheme: Scheme, expected_len: int) -> bytes:
    if scheme == Scheme.NONE:
        if len(data) != expected_len:
            raise CompressionError("stored chunk length mismatch")
        return data
    if scheme == Scheme.LZ4:
        return lz4_frame_decompress(data, expected_len)
    if scheme == Scheme.BG4_LZ4:
        return _bg4_inverse(lz4_frame_decompress(data, expected_len))
    if scheme == Scheme.BITSLICE_LZ4:
        plane_bytes = ((expected_len + 7) // 8) * 8
        return _bitslice_inverse(
            lz4_frame_decompress(data, plane_bytes), expected_len
        )
    raise CompressionError(f"unknown scheme {scheme}")


# ── Batch decode engine ──
#
# A decode descriptor is ``(src_buf, src_off, src_len, scheme, dst_off,
# dst_len)``: the chunk's compressed payload is ``src_buf[src_off :
# src_off + src_len]`` and its uncompressed bytes land at ``out[dst_off :
# dst_off + dst_len]``. ``src_buf`` repeats across descriptors drawn from
# the same blob — the native dispatch computes one base pointer per
# unique buffer, so a whole shard's chunks cost one ctypes call total.


def decode_columns_into(groups, out, workers: int = 1) -> int:
    """Decode a columnar batch of chunk payloads — zero Python work
    per chunk. Each group is ``(buf, src_offs, src_lens, schemes,
    dst_offs, dst_lens)`` with numpy arrays (u64/u64/u8/u64/u64) of one
    length, offsets relative to ``buf``/``out``; a whole shard's chunk
    table (XorbReader.decode_columns) flows through a handful of numpy
    ops into ONE native call. Validation (bounds, pairwise-disjoint
    destinations) is vectorized. Returns the byte count written."""
    import numpy as np

    view = memoryview(out).cast("B")
    if view.readonly:
        raise CompressionError("decode destination is read-only")
    groups = [g for g in groups if len(g[1])]
    if not groups:
        return 0
    all_dst_offs = (np.concatenate([g[4] for g in groups])
                    if len(groups) > 1 else groups[0][4])
    all_dst_lens = (np.concatenate([g[5] for g in groups])
                    if len(groups) > 1 else groups[0][5])
    ends = all_dst_offs + all_dst_lens
    if int(ends.max(initial=0)) > view.nbytes or bool(
            (ends < all_dst_offs).any()):
        raise CompressionError(
            f"descriptor dst range outside a {view.nbytes}-byte buffer"
        )
    order = np.argsort(all_dst_offs, kind="stable")
    if bool((all_dst_offs[order][1:] < ends[order][:-1]).any()):
        raise CompressionError("overlapping descriptor dst ranges")
    total = int(all_dst_lens.sum(dtype=np.uint64))
    for buf, src_offs, src_lens, _schemes, _do, _dl in groups:
        nbytes = np.frombuffer(buf, dtype=np.uint8).nbytes
        src_ends = src_offs + src_lens
        if int(src_ends.max(initial=0)) > nbytes or bool(
                (src_ends < src_offs).any()):
            raise CompressionError(
                "descriptor src range outside its buffer")

    ptr_groups, keep_alive = [], []
    for buf, src_offs, src_lens, schemes, dst_offs, dst_lens in groups:
        arr = np.frombuffer(buf, dtype=np.uint8)
        keep_alive.append((buf, arr))
        ptr_groups.append(src_offs.astype(np.uint64)
                          + np.uint64(arr.ctypes.data))
    cat = (lambda xs: np.ascontiguousarray(np.concatenate(xs))
           if len(xs) > 1 else np.ascontiguousarray(xs[0]))
    src_ptrs = cat(ptr_groups)
    src_lens = cat([g[2].astype(np.uint64) for g in groups])
    schemes = cat([g[3].astype(np.uint8) for g in groups])
    dst_offs = cat([g[4].astype(np.uint64) for g in groups])
    dst_lens = cat([g[5].astype(np.uint64) for g in groups])
    dst_ptr = ctypes.addressof(ctypes.c_char.from_buffer(view))
    rc = native.lib.decode_batch(src_ptrs, src_lens, schemes, dst_offs,
                                 dst_lens, dst_ptr, view.nbytes, workers)
    del keep_alive
    if rc:
        i = rc - 1
        raise CompressionError(
            f"chunk payload {i} of the batch (scheme {int(schemes[i])}, "
            f"{int(src_lens[i])} -> {int(dst_lens[i])} bytes) is malformed")
    return total


def compress_auto(data: bytes) -> tuple[Scheme, bytes]:
    """Pick the smallest encoding; None when compression doesn't pay."""
    best_scheme, best = Scheme.NONE, data
    for scheme in (Scheme.LZ4, Scheme.BG4_LZ4):
        candidate = compress(data, scheme)
        if len(candidate) < len(best):
            best_scheme, best = scheme, candidate
    return best_scheme, best
