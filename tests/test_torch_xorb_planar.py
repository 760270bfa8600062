"""The port's planar xorb reads against the JAX package's, on the same bytes.

``chunk_schemes``, ``extract_chunk_planar`` and ``slice_range`` of
``zest_tpu_torch.cas.xorb.XorbReader`` equal ``zest_tpu``'s on a xorb
holding BG4, LZ4 and stored chunks (a bare frame stream and a full
XETBLOB), and ``extract_chunk_planar`` of a non-BG4 chunk raises
``XorbFormatError`` in both.
"""

from __future__ import annotations

import numpy as np
import pytest

from zest_tpu.cas import xorb as j_xorb
from zest_tpu_torch.cas import compression
from zest_tpu_torch.cas.xorb import XorbBuilder, XorbFormatError, XorbReader


def _blob(full: bool) -> bytes:
    rng = np.random.default_rng(21)
    chunks = [
        (rng.standard_normal(2048, dtype=np.float32) * 0.02).tobytes(),
        rng.bytes(5000),                                     # stored
        bytes(3000),                                         # LZ4
        (rng.standard_normal(1000, dtype=np.float32) * 0.02).tobytes()[:3999],
        b"x",
    ]
    b = XorbBuilder()
    for c in chunks:
        b.add_chunk(c)
    return b.serialize_full() if full else b.serialize()


@pytest.mark.parametrize("full", [False, True], ids=["frames", "xetblob"])
def test_planar_reads_match_reference(full):
    blob = _blob(full)
    mine, ref = XorbReader(blob), j_xorb.XorbReader(blob)
    schemes = mine.chunk_schemes.tolist()
    assert schemes == ref.chunk_schemes.tolist()
    assert {compression.Scheme(s) for s in schemes} >= {
        compression.Scheme.BG4_LZ4, compression.Scheme.NONE,
        compression.Scheme.LZ4}
    for i, s in enumerate(schemes):
        if s == int(compression.Scheme.BG4_LZ4):
            planar = mine.extract_chunk_planar(i)
            assert planar == ref.extract_chunk_planar(i)
            assert compression._bg4(mine.extract_chunk(i)) == planar
        else:
            with pytest.raises(XorbFormatError, match="not BG4"):
                mine.extract_chunk_planar(i)
            with pytest.raises(j_xorb.XorbFormatError, match="not BG4"):
                ref.extract_chunk_planar(i)
    n = len(mine)
    for start, end in [(0, n), (0, 1), (1, 4), (n - 1, n)]:
        assert mine.slice_range(start, end) == ref.slice_range(start, end)
        assert len(XorbReader(mine.slice_range(start, end))) == end - start
    for bad in [(0, 0), (2, 1), (0, n + 1), (-1, 2)]:
        with pytest.raises(XorbFormatError):
            mine.slice_range(*bad)
