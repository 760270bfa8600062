"""Minimal safetensors reader/writer on torch tensors.

The counterpart of ``zest_tpu/models/safetensors_io.py``; the format is
``[u64le header_len][JSON header][data]`` with the header mapping
``name -> {"dtype", "shape", "data_offsets": [begin, end)}`` (offsets
relative to the end of the header) and an optional ``__metadata__``.

Dtypes map to torch dtypes without ``ml_dtypes`` (which the card's
machine does not have): sub-word float types are read as their same-size
unsigned storage and viewed as the torch dtype, bit for bit.
"""

from __future__ import annotations

import json
import mmap
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

# safetensors dtype tag -> torch dtype
DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "U64": torch.uint64,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_TAGS = {v: k for k, v in DTYPES.items()}
# Byte-storage carrier of each width (numpy reads the mmap through it).
_CARRIER = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}

_MAX_HEADER = 100 * 1024 * 1024  # upstream parser's sanity cap


@dataclass(frozen=True)
class TensorInfo:
    name: str
    dtype: str                 # safetensors tag, e.g. "F32"
    shape: tuple[int, ...]
    data_offsets: tuple[int, int]   # relative to data section start

    @property
    def nbytes(self) -> int:
        return self.data_offsets[1] - self.data_offsets[0]

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def file_range(self, data_start: int) -> tuple[int, int]:
        """Absolute byte range of this tensor within the file: what the
        landing maps onto reconstruction terms."""
        return (data_start + self.data_offsets[0],
                data_start + self.data_offsets[1])


@dataclass(frozen=True)
class SafetensorsHeader:
    tensors: dict[str, TensorInfo]
    metadata: dict[str, str]
    data_start: int            # file offset where the data section begins

    def names(self) -> list[str]:
        return list(self.tensors)


def parse_header(buf: bytes | memoryview) -> SafetensorsHeader:
    """Parse and validate a header (bounds, overlap, shape/size)."""
    return _parse_tensors(buf, bounded=True)


def parse_header_prefix(buf: bytes | memoryview) -> SafetensorsHeader:
    """Parse a header from the file's head bytes only (the data section
    absent): the same checks as :func:`parse_header` but the data
    section's end bound."""
    return _parse_tensors(buf, bounded=False)


def _parse_tensors(buf: bytes | memoryview,
                   bounded: bool) -> SafetensorsHeader:
    if len(buf) < 8:
        raise ValueError("truncated safetensors: missing header length")
    (hlen,) = struct.unpack_from("<Q", buf, 0)
    if hlen > _MAX_HEADER or 8 + hlen > len(buf):
        raise ValueError(f"safetensors header length {hlen} out of bounds "
                         f"for {len(buf)}-byte buffer")
    data_len = len(buf) - 8 - hlen if bounded else None
    header = json.loads(bytes(buf[8:8 + hlen]).decode("utf-8"))
    metadata = header.pop("__metadata__", {})
    tensors: dict[str, TensorInfo] = {}
    for name, spec in header.items():
        if spec["dtype"] not in DTYPES:
            raise ValueError(f"unsupported dtype {spec['dtype']} for {name}")
        begin, end = (int(v) for v in spec["data_offsets"])
        if begin < 0 or end < begin or (data_len is not None
                                        and end > data_len):
            raise ValueError(
                f"{name}: data_offsets [{begin}, {end}) out of bounds")
        shape = tuple(int(d) for d in spec["shape"])
        info = TensorInfo(name, spec["dtype"], shape, (begin, end))
        expect = (int(np.prod(shape, dtype=np.int64))
                  * info.torch_dtype.itemsize)
        if info.nbytes != expect:
            raise ValueError(f"{name}: data_offsets span {info.nbytes} "
                             f"bytes, shape/dtype need {expect}")
        tensors[name] = info
    spans = sorted(i.data_offsets for i in tensors.values() if i.nbytes)
    for (b0, e0), (b1, _e1) in zip(spans, spans[1:]):
        if b1 < e0:
            raise ValueError(
                f"overlapping tensor data ranges [{b0},{e0}) and [{b1},…)")
    return SafetensorsHeader(tensors, metadata, 8 + hlen)


class SafetensorsFile:
    """mmap-backed lazy reader: header up front, tensor bytes on demand.

    The map is copy-on-write (``ACCESS_COPY``), so tensors are zero-copy
    views that torch may treat as writable without touching the file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_COPY)
        except ValueError:  # zero-length file
            self._f.close()
            raise ValueError(f"{path}: empty file is not safetensors")
        try:
            self.header = parse_header(memoryview(self._mm))
        except Exception:
            self.close()
            raise

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            pass  # views still alive; the map unmaps when they go
        self._f.close()

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def names(self) -> list[str]:
        return self.header.names()

    def tensor(self, name: str) -> torch.Tensor:
        """Zero-copy CPU view (mmap-backed) of one tensor."""
        info = self.header.tensors[name]
        dt = info.torch_dtype
        carrier = np.bool_ if dt == torch.bool else _CARRIER[dt.itemsize]
        arr = np.frombuffer(self._mm, dtype=carrier,
                            count=info.nbytes // dt.itemsize,
                            offset=self.header.data_start
                            + info.data_offsets[0])
        t = torch.from_numpy(arr)
        if t.dtype != dt:
            t = t.view(dt)
        return t.reshape(info.shape)


def tensor_bytes(t: torch.Tensor) -> np.ndarray:
    """A contiguous CPU tensor's raw bytes as a uint8 numpy view."""
    t = t.detach().contiguous().cpu().reshape(-1)
    return t.view(torch.uint8).numpy()


def write_safetensors(path: str | Path, tensors: dict) -> None:
    """Write torch tensors (or numpy arrays) as a safetensors file."""
    header: dict[str, object] = {}
    offset = 0
    blobs: list[np.ndarray] = []
    for name, t in tensors.items():
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        tag = _TAGS.get(t.dtype)
        if tag is None:
            raise ValueError(f"{name}: dtype {t.dtype} not representable")
        raw = tensor_bytes(t)
        header[name] = {"dtype": tag, "shape": list(t.shape),
                        "data_offsets": [offset, offset + raw.nbytes]}
        offset += raw.nbytes
        blobs.append(raw)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * ((8 - (8 + len(blob)) % 8) % 8)  # 8-byte data alignment
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in blobs:
            f.write(raw.data)
