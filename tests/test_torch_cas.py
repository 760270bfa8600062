"""The port's CAS layer is byte-identical to the JAX package's.

One seeded ~3 MB file (float32 noise, which BG4 compresses, plus a
repetitive run LZ4 takes) goes through both packages: CDC cut points,
chunk/xorb/file hashes, minted xorb blobs and the reconstruction from
``Publisher.publish_file``, every compression scheme and the BG4 inverse,
and ``XorbReader`` extraction across the two packages' blobs.
"""

from __future__ import annotations

import numpy as np
import pytest

from zest_tpu.cas import chunking as j_chunking
from zest_tpu.cas import compression as j_comp
from zest_tpu.cas import hashing as j_hashing
from zest_tpu.cas import reconstruction as j_recon
from zest_tpu.cas import xorb as j_xorb
from zest_tpu.cas.publish import Publisher as JPublisher
from zest_tpu_torch import native
from zest_tpu_torch.cas import chunking, compression, hashing, xorb
from zest_tpu_torch.cas import reconstruction as recon
from zest_tpu_torch.cas.publish import Publisher


@pytest.fixture(scope="module")
def data() -> bytes:
    rng = np.random.default_rng(1234)
    noise = rng.standard_normal(700_000).astype(np.float32).tobytes()
    return noise[:1_500_000] + b"zest-port " * 30_000 + noise[1_500_000:]


@pytest.fixture(scope="module")
def cuts(data) -> list[int]:
    return chunking.cut_points(data)


def test_cdc_cut_points(data, cuts):
    assert len(cuts) > 20
    assert cuts == j_chunking.cut_points(data)


def test_chunk_xorb_and_file_hashes(data, cuts):
    starts = [0] + cuts[:-1]
    pieces = [data[a:b] for a, b in zip(starts, cuts)]
    leaves = [(hashing.chunk_hash(p), len(p)) for p in pieces]
    assert leaves == [(j_hashing.chunk_hash(p), len(p)) for p in pieces]
    assert hashing.xorb_hash(leaves) == j_hashing.xorb_hash(leaves)
    assert hashing.file_hash(leaves) == j_hashing.file_hash(leaves)
    h = leaves[0][0]
    assert hashing.hash_to_hex(h) == j_hashing.hash_to_hex(h)


@pytest.mark.parametrize("chunks_per_xorb", [0, 7])
def test_minted_xorbs_and_reconstruction(data, chunks_per_xorb):
    pf = Publisher(chunks_per_xorb).publish_file("model.safetensors", data)
    jf = JPublisher(chunks_per_xorb).publish_file("model.safetensors", data)
    assert pf.xet_hash == jf.xet_hash
    assert recon.to_json(pf.reconstruction) == j_recon.to_json(
        jf.reconstruction)
    mine = Publisher(chunks_per_xorb)
    theirs = JPublisher(chunks_per_xorb)
    mine.publish_file("a.safetensors", data)
    theirs.publish_file("a.safetensors", data)
    got = [(x.hash_hex, x.blob, x.full, x.frame_offsets)
           for x in mine.drain_new_xorbs()]
    want = [(x.hash_hex, x.blob, x.full, x.frame_offsets)
            for x in theirs.drain_new_xorbs()]
    assert got == want
    assert len(got) == (1 if chunks_per_xorb == 0 else
                        -(-len(chunking.cut_points(data)) // 7))


def test_dedup_against_a_known_xorb(data):
    """A second file sharing most chunks references the first's xorb —
    the same terms in both packages."""
    edited = data[:2_000_000] + b"\x00" * 4096 + data[2_000_000:]
    outs = []
    for pub in (Publisher(), JPublisher()):
        pub.publish_file("a.safetensors", data)
        pf = pub.publish_file("b.safetensors", edited)
        outs.append(([(t.hash_hex, t.range.start, t.range.end,
                       t.unpacked_length) for t in pf.terms],
                     pf.reused_bytes))
    assert outs[0] == outs[1]
    assert outs[0][1] > len(data) // 2


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 1001, 65537])
def test_bg4_and_schemes(n):
    raw = np.random.default_rng(n).bytes(n)
    assert compression._bg4(raw) == j_comp._bg4(raw)
    assert compression._bg4_inverse(compression._bg4(raw)) == raw
    assert compression._bg4_inverse(raw) == j_comp._bg4_inverse(raw)
    for scheme in compression.Scheme:
        enc = compression.compress(raw, scheme)
        assert enc == j_comp.compress(raw, j_comp.Scheme(int(scheme)))
        assert compression.decompress(enc, scheme, n) == raw


def test_xorb_reader_across_packages(data, cuts):
    builder = xorb.XorbBuilder()
    builder.add_data(data[:cuts[12]])
    jbuilder = j_xorb.XorbBuilder()
    jbuilder.add_data(data[:cuts[12]])
    assert builder.serialize_full() == jbuilder.serialize_full()
    for blob in (builder.serialize(), jbuilder.serialize_full()):
        reader = xorb.XorbReader(blob)
        jreader = j_xorb.XorbReader(blob)
        assert reader.chunk_hashes() == jreader.chunk_hashes()
        assert reader.frame_offsets() == jreader.frame_offsets()
        assert reader.extract_chunk_range(3, 9) == \
            jreader.extract_chunk_range(3, 9) == data[cuts[2]:cuts[8]]
        out = bytearray(cuts[11] - cuts[1])
        reader.extract_range_into(2, 12, out)
        assert bytes(out) == data[cuts[1]:cuts[11]]
    assert xorb.XorbReader(jbuilder.serialize_full()).xorb_hash_footer == \
        builder.xorb_hash()


def test_reader_rejects_corrupt_footer_chunk(data, cuts):
    builder = xorb.XorbBuilder()
    builder.add_data(data[:cuts[3]])
    blob = bytearray(builder.serialize_full())
    blob[xorb.FRAME_HEADER_LEN + 5] ^= 0xFF  # inside chunk 0's payload
    with pytest.raises(ValueError):
        xorb.XorbReader(bytes(blob)).extract_chunk_range(0, 3)


def test_xorbs_close_at_the_format_cap(data, monkeypatch):
    """A file whose new chunks outgrow one xorb publishes as several
    (the JAX package's publisher raises "xorb full" there: a recorded
    divergence). Shrinking the cap stands in for a >64 MiB checkpoint."""
    cap = 400_000
    monkeypatch.setattr(xorb, "MAX_XORB_BYTES", cap)
    pub = Publisher()
    pf = pub.publish_file("model.safetensors", data)
    minted = pub.drain_new_xorbs()
    assert len(minted) > 5
    assert all(len(x.blob) <= cap for x in minted)
    assert pf.xet_hash == JPublisher().publish_file("m", data).xet_hash
    blobs = {x.hash_hex: x.blob for x in minted}
    rebuilt = b"".join(
        xorb.XorbReader(blobs[t.hash_hex]).extract_chunk_range(
            t.range.start, t.range.end) for t in pf.terms)
    assert rebuilt == data
    monkeypatch.setattr(j_xorb, "MAX_XORB_BYTES", cap)
    with pytest.raises(j_xorb.XorbFormatError, match="xorb full"):
        JPublisher().publish_file("model.safetensors", data)


@pytest.mark.parametrize("payload,ok", [(b"", True), (b"\x00", True),
                                        (b"\x10", False), (b"\x00\x01\x00", False)])
def test_lz4_empty_block_validation(payload, ok):
    """The native codec cannot tell "0 bytes" from "malformed"; an empty
    block is checked apart, as the JAX package's decoder checks it."""
    if ok:
        assert compression.lz4_decompress(payload, 0) == b""
        assert j_comp.lz4_decompress(payload, 0) == b""
        return
    with pytest.raises(compression.CompressionError):
        compression.lz4_decompress(payload, 0)
    with pytest.raises(j_comp.CompressionError):
        j_comp.lz4_decompress(payload, 0)


@pytest.mark.parametrize("cut", ["truncated_header", "payload_past_end",
                                 "bad_version"])
def test_reader_rejects_malformed_frame_stream(data, cuts, cut):
    builder = xorb.XorbBuilder()
    builder.add_data(data[:cuts[2]])
    blob = bytearray(builder.serialize())
    if cut == "truncated_header":
        blob += b"\x00\x01"
    elif cut == "payload_past_end":
        blob = blob[:-1]
    else:
        blob[0] = 7
    with pytest.raises(xorb.XorbFormatError):
        xorb.XorbReader(bytes(blob))
    with pytest.raises(j_xorb.XorbFormatError):
        j_xorb.XorbReader(bytes(blob))


def test_batch_decode_names_the_malformed_chunk(data, cuts):
    builder = xorb.XorbBuilder()
    builder.add_data(data[:cuts[3]])
    reader = xorb.XorbReader(builder.serialize())
    src_offs, src_lens, schemes, dst_lens = reader.decode_columns(0, 3)
    assert int(schemes[1]) != int(compression.Scheme.NONE)
    blob = bytearray(builder.serialize())
    blob[int(src_offs[1]) + 7:int(src_offs[1]) + 11] = b"\xff" * 4
    dst_offs = np.concatenate([[0], np.cumsum(dst_lens)[:-1]]).astype(np.uint64)
    out = bytearray(int(dst_lens.sum()))
    with pytest.raises(compression.CompressionError, match="payload 1 "):
        compression.decode_columns_into(
            [(bytes(blob), src_offs, src_lens, schemes, dst_offs, dst_lens)],
            out)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """The native library is required: a build that fails raises with the
    compiler's error, and nothing takes a Python path instead."""
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_dll", None)
    monkeypatch.setattr(native, "_HERE", tmp_path)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_SOURCES", ["broken.cc"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
