"""Xorb container format — production XETBLOB.

The port's own copy of the JAX package's container, byte for byte (the
JAX package's tests pin that layout against ``hf_xet``, and
tests/test_torch_cas.py holds this copy to the JAX package). A xorb is a
content-addressed bundle of CDC chunks, identified by the merkle root
over its chunk hashes:

    per chunk frame (8 + compressed_len bytes, integers little-endian):
        u8   version          (0)
        u24  compressed_len
        u8   scheme           (cas.compression.Scheme)
        u24  uncompressed_len
        ...  payload

    full-xorb footer (40*n + 96 bytes):
        "XETBLOB" u8(1)                     ident + version
        32B xorb hash
        "XBLBHSH" u8(0) u32 n  n×32B        chunk hashes
        "XBLBBND" u8(1) u32 n  n×u32 n×u32  serialized / uncompressed
                                            cumulative end offsets
        u32 n, u32 footer_len-40, u32 8n+40, 4×u32 0, u32 footer_len

Chunk frames are self-framed: any contiguous chunk range is a contiguous
byte range, so CDN ``fetch_info.url_range`` byte ranges and partial cache
entries are frame subsequences. The footer travels only with full xorbs.
"""

from __future__ import annotations

import struct
import numpy as np

from zest_tpu_torch import native
from zest_tpu_torch.cas import chunking, compression, hashing

FRAME_HEADER_LEN = 8
FOOTER_IDENT = b"XETBLOB"
_HSH_IDENT = b"XBLBHSH"
_BND_IDENT = b"XBLBBND"
# Cap on the SERIALIZED xorb (frames included) so a full xorb always fits
# in one wire message (wire.MAX_MESSAGE_SIZE = 64 MiB + 1 KiB, minus BEP 10
# and XET framing overhead).
MAX_XORB_BYTES = 64 * 1024 * 1024 - 64
MAX_CHUNKS = 8 * 1024
# Largest single chunk a reader will decode. CDC chunks are <= 128 KiB
# (chunking.MAX_CHUNK); the slack allows hand-built chunks while still
# bounding what an untrusted frame header can make us allocate.
MAX_CHUNK_BYTES = 4 * 1024 * 1024
_MAX_U24 = (1 << 24) - 1


class XorbFormatError(ValueError):
    pass


def encode_frame(data: bytes) -> tuple[bytes, bytes]:
    """Encode one chunk into a frame; returns (frame, chunk_hash)."""
    if len(data) > MAX_CHUNK_BYTES:
        raise XorbFormatError(f"chunk of {len(data)} bytes exceeds cap")
    scheme, payload = compression.compress_auto(data)
    if len(payload) > _MAX_U24:
        raise XorbFormatError("chunk payload too large")
    h = hashing.chunk_hash(data)
    header = (
        bytes([0])
        + len(payload).to_bytes(3, "little")
        + bytes([int(scheme)])
        + len(data).to_bytes(3, "little")
    )
    return header + payload, h


def _encode_footer(
    xorb_hash: bytes,
    hashes: list[tuple[bytes, int]],
    ser_ends: list[int],
) -> bytes:
    n = len(hashes)
    unc_ends, total = [], 0
    for _, size in hashes:
        total += size
        unc_ends.append(total)
    out = bytearray()
    out += FOOTER_IDENT + bytes([1]) + xorb_hash
    out += _HSH_IDENT + bytes([0]) + struct.pack("<I", n)
    for h, _ in hashes:
        out += h
    out += _BND_IDENT + bytes([1]) + struct.pack("<I", n)
    out += struct.pack(f"<{n}I", *ser_ends)
    out += struct.pack(f"<{n}I", *unc_ends)
    footer_len = 40 * n + 92
    out += struct.pack("<8I", n, footer_len - 40, 8 * n + 40, 0, 0, 0, 0,
                       footer_len)
    return bytes(out)


class XorbBuilder:
    """Accumulates chunks into a serialized xorb.

    Compression is chosen per chunk (`compress_auto`); identity is computed
    over the *uncompressed* chunk hashes so the same content always produces
    the same xorb hash regardless of encoding.
    """

    def __init__(self) -> None:
        self._frames: list[bytes] = []
        self._hashes: list[tuple[bytes, int]] = []
        self._uncompressed_total = 0
        self._serialized_total = 0

    def __len__(self) -> int:
        return len(self._frames)

    @property
    def uncompressed_total(self) -> int:
        return self._uncompressed_total

    def would_overflow(self, chunk_len: int) -> bool:
        # Worst case the new chunk stores uncompressed: header + chunk_len.
        return (
            self._serialized_total + FRAME_HEADER_LEN + chunk_len > MAX_XORB_BYTES
            or len(self._frames) + 1 > MAX_CHUNKS
        )

    def add_chunk(self, data: bytes) -> bytes:
        """Append one chunk; returns its hash."""
        if self.would_overflow(len(data)):
            raise XorbFormatError("xorb full")
        frame, h = encode_frame(data)
        self._frames.append(frame)
        self._hashes.append((h, len(data)))
        self._uncompressed_total += len(data)
        self._serialized_total += len(frame)
        return h

    def add_data(self, data: bytes) -> list[bytes]:
        """CDC-chunk ``data`` and append every chunk; returns chunk hashes."""
        return [self.add_chunk(piece) for piece in chunking.chunk_stream(data)]

    def chunk_hashes(self) -> list[tuple[bytes, int]]:
        return list(self._hashes)

    def xorb_hash(self) -> bytes:
        return hashing.xorb_hash(self._hashes)

    def frame_offsets(self) -> list[int]:
        """Byte offset of each frame plus the end offset (len N+1).

        ``offsets[s]:offsets[e]`` is the byte range serving chunk range
        [s, e) — this is what populates CAS ``fetch_info.url_range``.
        """
        offs = [0]
        for f in self._frames:
            offs.append(offs[-1] + len(f))
        return offs

    def serialize(self) -> bytes:
        """Frame stream only — the in-pipeline blob shape."""
        return b"".join(self._frames)

    def serialize_full(self) -> bytes:
        """Frames + XETBLOB footer — the storage/CDN artifact shape."""
        return self.serialize() + _encode_footer(
            self.xorb_hash(), self._hashes, self.frame_offsets()[1:]
        )


def parse_footer(data: bytes | memoryview) -> tuple[int, bytes, list[bytes]]:
    """If ``data`` ends with a XETBLOB footer, return
    (frames_end, xorb_hash, chunk_hashes); raise XorbFormatError otherwise.
    """
    data = memoryview(data)
    if len(data) < 96 + 4:
        raise XorbFormatError("too short for a XETBLOB footer")
    (footer_len,) = struct.unpack("<I", data[-4:])
    start = len(data) - 4 - footer_len
    if footer_len < 92 or start < 0:
        raise XorbFormatError("bad footer length")
    foot = bytes(data[start : len(data) - 4])
    if foot[:7] != FOOTER_IDENT:
        raise XorbFormatError("missing XETBLOB ident")
    xorb_hash = foot[8:40]
    if foot[40:47] != _HSH_IDENT:
        raise XorbFormatError("missing hash section")
    (n,) = struct.unpack_from("<I", foot, 48)
    if footer_len != 40 * n + 92 or n > MAX_CHUNKS:
        raise XorbFormatError("footer length inconsistent with chunk count")
    off = 52
    hashes = [foot[off + 32 * i : off + 32 * (i + 1)] for i in range(n)]
    off += 32 * n
    if foot[off : off + 7] != _BND_IDENT:
        raise XorbFormatError("missing boundary section")
    return start, xorb_hash, hashes


class XorbReader:
    """Parses a frame stream and extracts chunk ranges.

    ``data`` may be a *full* XETBLOB (frames + footer — a CDN storage
    artifact or full-xorb cache entry) or any frame subsequence (a partial
    cache entry, a CDN byte-range response, a BEP XET chunk response).
    Chunk indices here are local to the blob — callers rebase absolute
    term indices by the blob's ``chunk_offset``. With a footer, per-chunk
    hashes are known and extraction verifies them; bare frame streams are
    verified downstream (device BLAKE3 before full-xorb cache writes,
    file-level hashes after reassembly) — the same trust model as the
    production CDN path, whose range responses carry no hashes either.
    """

    def __init__(self, data: bytes | memoryview):
        data = memoryview(data)
        self.xorb_hash_footer: bytes | None = None
        frames_end = len(data)
        footer_hashes: list[bytes] | None = None
        try:
            frames_end, self.xorb_hash_footer, footer_hashes = \
                parse_footer(data)
        except XorbFormatError:
            pass
        self._data = data
        self._footer_hashes = footer_hashes
        # The chunk table is COLUMNAR (numpy arrays), parsed by one
        # native pass: a GB-scale shard walks tens of thousands of
        # frames, which a per-chunk Python loop cannot keep up with.
        cols = native.lib.parse_frames(data, frames_end, MAX_CHUNKS)
        if cols is None:
            raise XorbFormatError(
                "malformed frame stream (truncated or unknown-version "
                "frame, payload past the end, or too many chunks)")
        self._frame_offs, self._comp_lens, self._unc_lens, self._schemes \
            = cols
        self._n = len(self._frame_offs)
        if self._n:
            # Vectorized hostile-header checks (same contracts as the
            # old per-chunk loop; the native parse validates structure
            # only). Untrusted headers must not dictate allocations.
            if int(self._schemes.max()) > int(max(compression.Scheme)):
                bad = int(self._schemes.max())
                raise XorbFormatError(f"unknown scheme {bad}")
            if int(self._unc_lens.max()) > MAX_CHUNK_BYTES:
                raise XorbFormatError(
                    f"chunk claims {int(self._unc_lens.max())} bytes "
                    f"(cap {MAX_CHUNK_BYTES})"
                )
        if footer_hashes is not None and len(footer_hashes) != self._n:
            raise XorbFormatError(
                f"footer lists {len(footer_hashes)} chunks, "
                f"frames hold {self._n}"
            )

    def __len__(self) -> int:
        return self._n

    def frame_offsets(self) -> list[int]:
        """Builder-parity offsets (len N+1): ``offsets[s]:offsets[e]``
        is the byte range serving chunk range [s, e) within this blob —
        what the write path (cas.publish / transfer.push) needs to aim
        referencing terms' ``fetch_info`` at a cached base xorb."""
        offs = [int(o) for o in self._frame_offs.tolist()]
        if not offs:
            return [0]
        end = offs[-1] + FRAME_HEADER_LEN + int(self._comp_lens[-1])
        return offs + [end]

    def chunk_hashes(self) -> list[tuple[bytes, int]]:
        """(hash, uncompressed length) per chunk — from the footer when
        present, else computed by decoding (the authoritative source)."""
        fh = self._footer_hashes
        sizes = self._unc_lens.tolist()
        out = []
        for i in range(self._n):
            h = fh[i] if fh else hashing.chunk_hash(
                self.extract_chunk(i, verify=False)
            )
            out.append((h, sizes[i]))
        return out

    def xorb_hash(self) -> bytes:
        return hashing.xorb_hash(self.chunk_hashes())

    def extract_chunk(self, index: int, verify: bool = True) -> bytes:
        payload_start = int(self._frame_offs[index]) + FRAME_HEADER_LEN
        payload = bytes(
            self._data[payload_start
                       : payload_start + int(self._comp_lens[index])]
        )
        data = compression.decompress(
            payload, compression.Scheme(int(self._schemes[index])),
            int(self._unc_lens[index]),
        )
        h = self._footer_hashes[index] if self._footer_hashes else None
        if verify and h is not None and hashing.chunk_hash(data) != h:
            raise XorbFormatError(f"chunk {index} hash mismatch")
        return data

    def extract_chunk_range(
        self, start: int, end: int, verify: bool = True
    ) -> bytes:
        """Concatenated bytes of chunks [start, end) — the term-fetch shape."""
        self._check_range(start, end)
        return b"".join(
            self.extract_chunk(i, verify=verify) for i in range(start, end)
        )

    @property
    def chunk_sizes(self):
        """Uncompressed chunk lengths as a numpy u32 column — the
        object-free view for consumers that only need sizes (the
        entries list costs a ChunkEntry per frame)."""
        return self._unc_lens

    @property
    def chunk_schemes(self):
        """Per-chunk compression.Scheme values as a numpy u8 column."""
        return self._schemes

    def extract_chunk_planar(self, index: int) -> bytes:
        """A BG4 chunk's PLANAR bytes: the LZ4 frame decoded but the
        byte-grouping inverse NOT applied — the staging form the device's
        fused decode→verify pass takes (``ops/bg4.py``), so the host never
        builds the interleaved bytes. Raises :class:`XorbFormatError` for
        a chunk of another scheme."""
        scheme = compression.Scheme(int(self._schemes[index]))
        if scheme != compression.Scheme.BG4_LZ4:
            raise XorbFormatError(
                f"chunk {index} is scheme {scheme!s}, not BG4")
        p0 = int(self._frame_offs[index]) + FRAME_HEADER_LEN
        payload = bytes(self._data[p0:p0 + int(self._comp_lens[index])])
        return compression.lz4_frame_decompress(
            payload, int(self._unc_lens[index]))

    def slice_range(self, start: int, end: int) -> bytes:
        """Raw frame bytes for chunks [start, end) — what a server sends on
        the wire and what lands in a partial cache entry."""
        self._check_range(start, end)
        first = int(self._frame_offs[start])
        last_end = (int(self._frame_offs[end - 1]) + FRAME_HEADER_LEN
                    + int(self._comp_lens[end - 1]))
        return bytes(self._data[first:last_end])

    def decode_columns(self, start: int, end: int):
        """Columnar batch-decode descriptors for chunks [start, end):
        ``(src_offs u64, src_lens u64, schemes u8, dst_lens u64)`` numpy
        views/arrays, payload offsets view-relative to this reader's
        buffer — the zero-Python-per-chunk shape
        ``compression.decode_columns_into`` consumes. Returns ``None``
        when the blob carries footer hashes (those chunks must verify
        through :meth:`extract_chunk`); raises the usual
        :class:`XorbFormatError` for hostile stored-chunk frames."""
        self._check_range(start, end)
        if self._footer_hashes is not None:
            return None
        comp = self._comp_lens[start:end]
        unc = self._unc_lens[start:end]
        schemes = self._schemes[start:end]
        bad = (schemes == int(compression.Scheme.NONE)) & (comp != unc)
        if bad.any():
            i = start + int(np.argmax(bad))
            # Same contract as compression.decompress's stored path — a
            # hostile frame must raise the module's error type, not a
            # bare memoryview ValueError.
            raise XorbFormatError(
                f"stored chunk {i} claims {int(self._unc_lens[i])} "
                f"bytes but frames {int(self._comp_lens[i])}"
            )
        src_offs = self._frame_offs[start:end] + np.uint64(FRAME_HEADER_LEN)
        return (src_offs, comp.astype(np.uint64), schemes,
                unc.astype(np.uint64))

    def extract_range_into(self, start: int, end: int, out,
                           workers: int = 1) -> int:
        """Decode chunks [start, end) directly into ``out`` (a writable
        buffer of exactly the range's uncompressed size); returns the
        byte count.

        The GB-scale landing path decodes most bytes through here. The
        whole range is submitted as ONE columnar batch
        (``compression.decode_columns_into``): a single GIL-released
        native call decoding every chunk — LZ4, BG4, and stored alike —
        straight into ``out`` across ``workers`` native threads. Chunks
        that carry a footer hash take the verifying
        :meth:`extract_chunk` path and are then copied in."""
        self._check_range(start, end)
        view = memoryview(out).cast("B")
        total = int(self._unc_lens[start:end].sum(dtype=np.uint64))
        if view.nbytes != total:
            raise XorbFormatError(
                f"out buffer is {view.nbytes} bytes for a "
                f"{total}-byte chunk range"
            )
        cols = self.decode_columns(start, end)
        if cols is not None:
            src_offs, src_lens, schemes, dst_lens = cols
            dst_offs = _exclusive_cumsum(dst_lens)
            return compression.decode_columns_into(
                [(self._data, src_offs, src_lens, schemes, dst_offs,
                  dst_lens)],
                view, workers=workers,
            )
        pos = 0
        for i in range(start, end):
            data = self.extract_chunk(i)
            view[pos:pos + len(data)] = data
            pos += len(data)
        return pos

    def _check_range(self, start: int, end: int) -> None:
        if not (0 <= start < end <= self._n):
            raise XorbFormatError(
                f"chunk range [{start},{end}) out of bounds for "
                f"{self._n} chunks"
            )


def _exclusive_cumsum(lens) -> "np.ndarray":
    out = np.empty(len(lens), dtype=np.uint64)
    if len(lens):
        out[0] = 0
        np.cumsum(lens[:-1], dtype=np.uint64, out=out[1:])
    return out

