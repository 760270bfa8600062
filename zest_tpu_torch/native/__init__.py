"""Native (C++) host library: lazy build + ctypes bindings.

The port's own copy of the JAX package's byte-level hot paths: BLAKE3
(``blake3.cc``), gearhash CDC (``gearhash.cc``), the LZ4 block codec
(``lz4.cc``), the batch frame decoder (``decode.cc``) and the BT wire's
one-pass response framer (``wire.cc``). The library is required: there is no
pure-Python path beside it, and a failed build raises with the compiler's
error.

First use compiles ``libzest_torch.so`` with ``g++ -O3 -march=native``
into ``zest_tpu_torch/native/build/`` (listed in ``.gitignore``). The
build writes a temp file and renames it, so concurrent test workers never
load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE / "build"
_SOURCES = ["blake3.cc", "decode.cc", "gearhash.cc", "lz4.cc", "wire.cc"]

_lock = threading.Lock()
_dll: ctypes.CDLL | None = None


def _compile() -> Path:
    sources = [_HERE / s for s in _SOURCES]
    _BUILD_DIR.mkdir(exist_ok=True)
    so_path = _BUILD_DIR / "libzest_torch.so"
    stamp = _BUILD_DIR / "libzest_torch.stamp"
    fingerprint = "|".join(
        f"{s.name}:{s.stat().st_mtime_ns}" for s in sources)
    if so_path.exists() and stamp.exists() and stamp.read_text() == fingerprint:
        return so_path
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, prefix=".tmp-", suffix=".so")
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", "-o", tmp, *[str(s) for s in sources]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (subprocess.SubprocessError, FileNotFoundError) as exc:
        os.unlink(tmp)
        raise RuntimeError(f"native library build failed: {exc}") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so_path)
    stamp.write_text(fingerprint)
    return so_path


def build() -> ctypes.CDLL:
    """Compile (when stale) and load the library, once per process.
    Raises ``RuntimeError`` when g++ is missing or fails."""
    global _dll
    with _lock:
        if _dll is None:
            dll = ctypes.CDLL(str(_compile()))
            _bind(dll)
            _dll = dll
        return _dll


def _bind(dll: ctypes.CDLL) -> None:
    dll.zest_blake3.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                ctypes.c_char_p]
    dll.zest_blake3.restype = None
    dll.zest_blake3_keyed.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_size_t, ctypes.c_char_p]
    dll.zest_blake3_keyed.restype = None
    dll.zest_gear_cut_points.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
    ]
    dll.zest_gear_cut_points.restype = ctypes.c_size_t
    dll.zest_lz4_bound.argtypes = [ctypes.c_size_t]
    dll.zest_lz4_bound.restype = ctypes.c_size_t
    dll.zest_lz4_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_char_p, ctypes.c_size_t]
    dll.zest_lz4_compress.restype = ctypes.c_size_t
    dll.zest_lz4_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_char_p, ctypes.c_size_t]
    dll.zest_lz4_decompress.restype = ctypes.c_size_t
    dll.zest_wire_response_size.argtypes = [ctypes.c_size_t]
    dll.zest_wire_response_size.restype = ctypes.c_size_t
    dll.zest_wire_frame_chunk_response.argtypes = [
        ctypes.c_uint8, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    dll.zest_wire_frame_chunk_response.restype = ctypes.c_size_t
    dll.zest_wire_frame_chunk_request.argtypes = [
        ctypes.c_uint8, ctypes.c_uint32, ctypes.c_char_p,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_char_p,
    ]
    dll.zest_wire_frame_chunk_request.restype = ctypes.c_size_t
    dll.zest_wire_frame_chunk_not_found.argtypes = [
        ctypes.c_uint8, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_char_p,
    ]
    dll.zest_wire_frame_chunk_not_found.restype = ctypes.c_size_t
    dll.zest_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_uint64,
    ]
    dll.zest_decode_batch.restype = ctypes.c_size_t
    dll.zest_parse_frames.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    dll.zest_parse_frames.restype = ctypes.c_size_t


_gear_array = None


def _gear_as_array():
    global _gear_array
    if _gear_array is None:
        from zest_tpu_torch.cas.xet_constants import GEAR_TABLE

        _gear_array = (ctypes.c_uint64 * 256)(*GEAR_TABLE)
    return _gear_array


_scratch_tls = threading.local()


def _scratch(n: int) -> ctypes.Array:
    """Reusable per-thread output buffer of >= n bytes (a fresh
    ``create_string_buffer`` zero-fills on every call, which costs as
    much as the codec itself on 64 KiB chunks)."""
    buf = getattr(_scratch_tls, "buf", None)
    if buf is None or len(buf) < n:
        size = max(128 * 1024, 1 << (n - 1).bit_length())
        buf = _scratch_tls.buf = ctypes.create_string_buffer(size)
    return buf


class lib:
    """Namespace of native entry points with ctypes marshalling."""

    @staticmethod
    def blake3(data: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        build().zest_blake3(data, len(data), out)
        return out.raw

    @staticmethod
    def blake3_keyed(key: bytes, data: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        build().zest_blake3_keyed(key, data, len(data), out)
        return out.raw

    @staticmethod
    def gear_cut_points(data: bytes, min_chunk: int, max_chunk: int,
                        mask: int) -> list[int]:
        cap = len(data) // min_chunk + 2
        out = (ctypes.c_uint64 * cap)()
        n = build().zest_gear_cut_points(
            data, len(data), _gear_as_array(), min_chunk, max_chunk,
            mask, out, cap)
        return list(out[:n])

    @staticmethod
    def lz4_compress(data: bytes) -> bytes:
        dll = build()
        cap = dll.zest_lz4_bound(len(data))
        out = _scratch(cap)
        n = dll.zest_lz4_compress(data, len(data), out, cap)
        if n == 0 and len(data) > 0:
            raise RuntimeError("native lz4 compress failed")
        return ctypes.string_at(out, n)

    @staticmethod
    def lz4_decompress(data: bytes, expected_len: int) -> bytes:
        from zest_tpu_torch.cas.compression import CompressionError

        if expected_len == 0:
            # The native return code can't tell "decoded 0 bytes" from
            # "malformed"; the only well-formed empty blocks are these.
            if bytes(data) not in (b"", b"\x00"):
                raise CompressionError("lz4: malformed empty block")
            return b""
        out = _scratch(expected_len)
        n = build().zest_lz4_decompress(data, len(data), out, expected_len)
        if n != expected_len:
            raise CompressionError("native lz4: malformed input")
        return ctypes.string_at(out, expected_len)

    @staticmethod
    def frame_chunk_response(ext_id: int, req_id: int, chunk_offset: int,
                             data: bytes) -> bytes:
        """Complete framed BEP 10 + XET CHUNK_RESPONSE in one pass."""
        dll = build()
        out = _scratch(dll.zest_wire_response_size(len(data)))
        n = dll.zest_wire_frame_chunk_response(
            ext_id, req_id, chunk_offset,
            data if isinstance(data, bytes) else bytes(data), len(data), out)
        return ctypes.string_at(out, n)

    @staticmethod
    def frame_chunk_request(ext_id: int, req_id: int, chunk_hash: bytes,
                            range_start: int, range_end: int) -> bytes:
        out = ctypes.create_string_buffer(51)
        n = build().zest_wire_frame_chunk_request(
            ext_id, req_id, chunk_hash, range_start, range_end, out)
        return out.raw[:n]

    @staticmethod
    def frame_chunk_not_found(ext_id: int, req_id: int,
                              chunk_hash: bytes) -> bytes:
        out = ctypes.create_string_buffer(43)
        n = build().zest_wire_frame_chunk_not_found(
            ext_id, req_id, chunk_hash, out)
        return out.raw[:n]

    @staticmethod
    def decode_batch(src_ptrs, src_lens, schemes, dst_offs, dst_lens,
                     dst_ptr: int, dst_cap: int, workers: int) -> int:
        """Decode N chunk payloads into a caller-owned buffer in one
        GIL-released call (``decode.cc``). The arrays are C-contiguous
        numpy columns (u64 pointers / u64 / u8 / u64 / u64). Returns 0 on
        success, else ``i + 1`` for the first failing descriptor; callers
        validate ranges first (``cas.compression.decode_columns_into``)."""
        n = len(schemes)
        if n == 0:
            return 0
        return build().zest_decode_batch(
            src_ptrs.ctypes.data, src_lens.ctypes.data, schemes.ctypes.data,
            dst_offs.ctypes.data, dst_lens.ctypes.data, n,
            dst_ptr, dst_cap, max(1, int(workers)))

    @staticmethod
    def parse_frames(buf, frames_end: int, max_chunks: int):
        """Columnar frame-table parse of a xorb frame stream: returns
        ``(frame_offs u64, comp_lens u32, unc_lens u32, schemes u8)``
        numpy arrays, or None for a malformed stream."""
        import numpy as np

        src = np.frombuffer(buf, dtype=np.uint8)
        cap = max(1, min(max_chunks, frames_end // 8 + 1))
        frame_offs = np.empty(cap, dtype=np.uint64)
        comp_lens = np.empty(cap, dtype=np.uint32)
        unc_lens = np.empty(cap, dtype=np.uint32)
        schemes = np.empty(cap, dtype=np.uint8)
        n = build().zest_parse_frames(
            src.ctypes.data, frames_end, cap,
            frame_offs.ctypes.data, comp_lens.ctypes.data,
            unc_lens.ctypes.data, schemes.ctypes.data)
        if n == ctypes.c_size_t(-1).value:
            return None
        return (frame_offs[:n], comp_lens[:n], unc_lens[:n], schemes[:n])

