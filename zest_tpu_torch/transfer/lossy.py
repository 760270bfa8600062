"""The lossy payload tier of the collective exchange: the ZQLS codec and
the staging overlay.

The counterpart of ``zest_tpu/transfer/lossy.py``, byte-compatible with
it: the same container from the same blob. Cross-slice and cross-pod
links are the scarce plane, and most checkpoint bytes are float tensors
whose BG4+LZ4 frames ship close to raw size. Armed by
``ZEST_COLLECTIVE_LOSSY``, a BG4 float chunk crosses such a link as int8
with one float32 scale per 256-value block (about a quarter of its raw
size, the error of each value at most its block's absmax / 127), and
every other chunk rides verbatim.

The trust boundary: a quantized payload can never reproduce the bytes the
merkle tree committed to, so a lossy container goes only into this
module's staging overlay. It never enters the xorb cache, it is re-served
only verbatim to a peer that accepts lossy bytes, and only a landing that
asked for it (``models.direct``'s ``allow_lossy``) reads it; any byte-exact
need refetches through the verified waterfall. The container names itself
(magic ``ZQLS``), and the wire marks it too (``dcn.FLAG_LOSSY``).

Container layout (little-endian)::

    header:    "ZQLS" u8 version(1) u8 rsvd u16 nchunks
               u32 block_values u64 exact_len
    per chunk: u8 kind  u32 payload_len  u32 raw_len
      kind 0 (VERBATIM): payload = the chunk's original frame bytes
      kind 1 (QUANT):    payload = u8 phase  u8 tail_len
                                   + phase head bytes + tail_len tail bytes
                                   + nblocks x f32 scales
                                   + nvals x i8 values

``nvals = (raw_len - phase - tail_len) / 4``: chunk boundaries fall on any
byte of the float stream, so the codec takes the byte phase whose
reading is finite with the best blockwise-int8 SNR and carries the
sub-float head and tail verbatim. ``exact_len`` is the byte-exact blob
length the container replaced (the exchange's ``bits_saved_ratio``).

The codec is host code in numpy, as in the JAX package: the phase choice
compares float32 SNRs, and the containers must match the JAX package's
byte for byte.
"""

from __future__ import annotations

import struct
import threading

import numpy as np

from zest_tpu_torch.cas import compression
from zest_tpu_torch.cas.xorb import XorbFormatError, XorbReader, encode_frame

MAGIC = b"ZQLS"
VERSION = 1
# float32 values per quantization block, one float32 scale each.
BLOCK_VALUES = 256

_HDR = struct.Struct("<4sBBHIQ")
_CHDR = struct.Struct("<BII")

KIND_VERBATIM = 0
KIND_QUANT = 1

# Least blockwise-int8 SNR (signal power over quantization error power)
# for a phase to count as a float stream: float data read at its true
# phase lands far above it, a misphased reading or non-float bytes near
# 0 dB, so one floor both picks the phase and declines the rest.
_MIN_SNR = 100.0


class LossyFormatError(ValueError):
    pass


def is_lossy_container(blob: bytes) -> bool:
    return len(blob) >= _HDR.size and blob[:4] == MAGIC


def _quantize_chunk(raw: bytes) -> bytes | None:
    """The int8 + per-block scale payload of one raw float chunk, or None
    when no byte phase of it reads as a quantizable float stream."""
    if len(raw) < 8:
        return None
    best = None
    for phase in range(4):
        nvals = (len(raw) - phase) // 4
        if nvals <= 0:
            continue
        vals = np.frombuffer(raw, dtype="<f4", offset=phase, count=nvals)
        if not np.isfinite(vals).all():
            continue
        nblocks = -(-nvals // BLOCK_VALUES)
        padded = np.zeros(nblocks * BLOCK_VALUES, dtype=np.float32)
        padded[:nvals] = vals
        blocks = padded.reshape(nblocks, BLOCK_VALUES)
        absmax = np.abs(blocks).max(axis=1)
        scales = (absmax / 127.0).astype("<f4")
        safe = np.where(scales > 0.0, scales, 1.0)
        q = np.rint(blocks / safe[:, None]).clip(-127, 127).astype(np.int8)
        err = float(np.square(q.astype(np.float32) * safe[:, None]
                              - blocks).sum())
        power = float(np.square(blocks).sum())
        snr = power / err if err > 0.0 else float("inf")
        if best is None or snr > best[0]:
            tail = raw[phase + nvals * 4:]
            best = (snr, bytes([phase, len(tail)]) + raw[:phase] + tail
                    + scales.tobytes() + q.reshape(-1)[:nvals].tobytes())
    if best is None or best[0] < _MIN_SNR:
        return None
    return best[1]


def _dequantize_chunk(payload: bytes, raw_len: int) -> bytes:
    if len(payload) < 2:
        raise LossyFormatError("quant payload too short")
    phase, tail_len = payload[0], payload[1]
    body = raw_len - phase - tail_len
    if phase > 3 or body < 0 or body % 4:
        raise LossyFormatError("bad quant phase/tail")
    nvals = body // 4
    nblocks = -(-nvals // BLOCK_VALUES)
    pos = 2
    head = payload[pos:pos + phase]
    pos += phase
    tail = payload[pos:pos + tail_len]
    pos += tail_len
    want = pos + nblocks * 4 + nvals
    if len(payload) != want:
        raise LossyFormatError(
            f"quant payload {len(payload)}B, expected {want}B")
    scales = np.frombuffer(payload, dtype="<f4", offset=pos, count=nblocks)
    q = np.frombuffer(payload, dtype=np.int8, offset=pos + nblocks * 4)
    vals = q.astype(np.float32) * np.repeat(scales, BLOCK_VALUES)[:nvals]
    return bytes(head) + vals.astype("<f4").tobytes() + bytes(tail)


def quantize_blob(blob: bytes) -> bytes | None:
    """A response blob (concatenated xorb frames) as a ZQLS container, or
    None when the blob does not parse as frames, holds no BG4 float chunk
    worth quantizing, or would not shrink: the caller then ships the
    byte-exact blob."""
    try:
        reader = XorbReader(blob)
    except XorbFormatError:
        return None
    n = len(reader)
    if n == 0 or n > 0xFFFF:
        return None
    schemes = reader.chunk_schemes
    if not (schemes == int(compression.Scheme.BG4_LZ4)).any():
        return None
    parts = [b""] * (n + 1)
    parts[0] = _HDR.pack(MAGIC, VERSION, 0, n, BLOCK_VALUES, len(blob))
    gained = False
    for i in range(n):
        frame = reader.slice_range(i, i + 1)
        if int(schemes[i]) == int(compression.Scheme.BG4_LZ4):
            try:
                raw = reader.extract_chunk(i, verify=False)
            except (XorbFormatError, compression.CompressionError):
                return None
            payload = _quantize_chunk(raw)
            if payload is not None \
                    and _CHDR.size + len(payload) < len(frame):
                parts[i + 1] = _CHDR.pack(KIND_QUANT, len(payload),
                                          len(raw)) + payload
                gained = True
                continue
        parts[i + 1] = _CHDR.pack(KIND_VERBATIM, len(frame),
                                  len(frame)) + frame
    if not gained:
        return None
    return b"".join(parts)


def dequantize_blob(container: bytes) -> bytes:
    """The frames blob of a ZQLS container. A quantized chunk is
    re-framed from its dequantized bytes, so the result parses as a
    response blob does, but its chunk hashes no longer match the merkle
    tree: it belongs in staging, never in the cache."""
    if not is_lossy_container(container):
        raise LossyFormatError("not a ZQLS container")
    _magic, version, _rsvd, n, block, _exact = _HDR.unpack_from(container)
    if version != VERSION:
        raise LossyFormatError(f"unsupported ZQLS version {version}")
    if block != BLOCK_VALUES:
        raise LossyFormatError(f"unsupported block size {block}")
    pos = _HDR.size
    frames = []
    for _ in range(n):
        if pos + _CHDR.size > len(container):
            raise LossyFormatError("truncated chunk header")
        kind, plen, raw_len = _CHDR.unpack_from(container, pos)
        pos += _CHDR.size
        payload = container[pos:pos + plen]
        if len(payload) != plen:
            raise LossyFormatError("truncated chunk payload")
        pos += plen
        if kind == KIND_VERBATIM:
            frames.append(payload)
        elif kind == KIND_QUANT:
            frames.append(encode_frame(_dequantize_chunk(payload,
                                                         raw_len))[0])
        else:
            raise LossyFormatError(f"unknown chunk kind {kind}")
    if pos != len(container):
        raise LossyFormatError("trailing bytes after last chunk")
    return b"".join(frames)


def exact_len(container: bytes) -> int:
    """The byte-exact blob length this container replaced."""
    if not is_lossy_container(container):
        raise LossyFormatError("not a ZQLS container")
    return _HDR.unpack_from(container)[5]


class LossyStaging:
    """The landing zone of lossy-admitted exchange units, beside the
    cache: containers keyed by ``(xorb hash, chunk offset)``, looked up
    with the cache's ``get_with_range`` rebasing, so the decode overlay
    reads them where the cache misses without a byte of them reaching the
    merkle-verified cache."""

    def __init__(self) -> None:
        self._blobs: dict[tuple[str, int], bytes] = {}
        self._lock = threading.Lock()

    def put(self, hash_hex: str, chunk_offset: int, blob: bytes) -> None:
        with self._lock:
            self._blobs[(hash_hex, int(chunk_offset))] = blob

    def get_with_range(self, hash_hex: str,
                       range_start: int) -> tuple[bytes, int] | None:
        """``(blob, chunk_offset)`` of the staged entry of ``hash_hex``
        starting last at or before ``range_start``, or None."""
        with self._lock:
            best = None
            for (hh, off), blob in self._blobs.items():
                if hh != hash_hex or off > range_start:
                    continue
                if best is None or off > best[1]:
                    best = (blob, off)
            return best

    def units(self) -> int:
        with self._lock:
            return len(self._blobs)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._blobs.values())

    def clear(self) -> None:
        with self._lock:
            self._blobs.clear()


# One staging per cache directory: the admit path, the DCN server and the
# decode overlay of one host all reach it from the host's cache location,
# and simulated hosts in one process (each its own cache) stay apart.
_STAGINGS: dict[str, LossyStaging] = {}
_STAGINGS_LOCK = threading.Lock()


def staging_for(cache_dir) -> LossyStaging:
    key = str(cache_dir)
    with _STAGINGS_LOCK:
        st = _STAGINGS.get(key)
        if st is None:
            st = _STAGINGS[key] = LossyStaging()
        return st


def reset_stagings() -> None:
    """Drop every registered staging (tests)."""
    with _STAGINGS_LOCK:
        _STAGINGS.clear()
