"""GearHash content-defined chunking (min 8 KiB / max 128 KiB).

Roll ``h = (h << 1) + GEAR[byte]`` and cut when the top 16 bits of ``h``
are zero (at >= MIN_CHUNK) or at MAX_CHUNK. The table, mask and limits
are the production Xet constants, so boundaries — and every content
address downstream — match HF's CAS and the JAX package exactly. The
scan runs in the native library (``native/gearhash.cc``);
tests/test_torch_cas.py holds its cuts equal to the JAX package's.
"""

from __future__ import annotations

from typing import Iterator

from zest_tpu_torch import native
from zest_tpu_torch.cas import xet_constants as _xc

MIN_CHUNK = _xc.MIN_CHUNK
MAX_CHUNK = _xc.MAX_CHUNK
MASK = _xc.MASK
GEAR = _xc.GEAR_TABLE

def cut_points(data: bytes | memoryview) -> list[int]:
    """Chunk end offsets (exclusive) covering ``data`` exactly: ``[]``
    for empty input, one cut at ``len(data)`` below MIN_CHUNK, and never
    a trailing zero-length cut."""
    data = memoryview(data)
    if len(data) == 0:
        return []
    return native.lib.gear_cut_points(bytes(data), MIN_CHUNK, MAX_CHUNK,
                                      MASK)


def chunk_stream(data: bytes | memoryview) -> Iterator[bytes]:
    """Yield the chunk bytes covering ``data`` exactly, in order."""
    data = memoryview(data)
    start = 0
    for end in cut_points(data):
        yield bytes(data[start:end])
        start = end
