"""The BG4 regroup and the fused regroup → BLAKE3 pass against the JAX package.

Inputs come from a numpy seed; every comparison is exact (integers):

- the port's ``stage_planar`` is byte-identical to the JAX package's
  ``FusedBg4Verifier.stage_planar`` and raises the same ``ValueError``s;
- the plain ``regroup_words`` equals the Pallas kernel in interpret mode
  (capacities of a few KiB, where the interpreter is quick) and the host
  BG4 inverse ``_bg4_inverse`` (every length up to 128 KiB);
- the plain ``FusedBg4Verifier`` equals the JAX package's (interpret
  mode), plain and keyed, and the host BLAKE3 of the original bytes;
- garbage written past every plane's size changes no regrouped byte
  inside the chunk and no digest;
- a message block gathered from the planar slots with the fused kernel's
  index formula (``csrc/blake3.cu``, ``PlanarLoader``) equals the
  regrouped words, and both equal the Pallas regroup.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from zest_tpu.cas import compression as j_compression
from zest_tpu.ops import decode_pallas as j_decode
from zest_tpu_torch import native
from zest_tpu_torch.cas import compression
from zest_tpu_torch.cas.hashing import CHUNK_KEY
from zest_tpu_torch.ops import bg4
from zest_tpu_torch.ops import blake3 as plain

SMALL = (0, 1, 2, 3, 4, 5, 17, 1023, 1024, 1025, 3000)
LARGE = (65535, 65536, 131072)
KEYS = pytest.mark.parametrize("key", [None, CHUNK_KEY],
                               ids=["plain", "chunk_key"])


def _chunks(lengths, seed=11) -> list[bytes]:
    """Float-like chunks (byte 3 of each word is nearly constant, as in
    N(0, 0.02) float32 weights) so BG4's planes differ from each other."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        w = rng.standard_normal(-(-n // 4), dtype=np.float32) * 0.02
        out.append(w.tobytes()[:n])
    return out


def _planar(chunks) -> list[bytes]:
    return [compression._bg4(c) for c in chunks]


def _row_bytes(words: torch.Tensor) -> np.ndarray:
    return words.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("lengths", [SMALL, SMALL + LARGE],
                         ids=["small", "with_128k"])
def test_stage_planar_matches_reference(lengths):
    chunks = _chunks(lengths)
    words, lens = bg4.stage_planar(_planar(chunks), list(lengths))
    j_words, j_lens = j_decode.FusedBg4Verifier.stage_planar(
        _planar(chunks), list(lengths))
    assert words.dtype == torch.uint32 and lens.dtype == torch.int32
    assert np.array_equal(words.numpy().view(np.uint32), np.asarray(j_words))
    assert np.array_equal(lens.numpy(), np.asarray(j_lens))


@pytest.mark.parametrize("payloads,lengths,match", [
    ([b"abc"], [100], "planar payload 0"),
    ([b"a" * 4], [4, 4], "differ in count"),
    ([bytes(129 * 1024)], [129 * 1024], "128 KiB"),
], ids=["payload_size", "count", "over_cap"])
def test_stage_planar_errors_match_reference(payloads, lengths, match):
    with pytest.raises(ValueError, match=match):
        bg4.stage_planar(payloads, lengths)
    with pytest.raises(ValueError, match=match):
        j_decode.FusedBg4Verifier.stage_planar(payloads, lengths)


def test_regroup_rejects_width_not_multiple_of_4():
    words = np.zeros((2, 6), dtype=np.uint32)
    with pytest.raises(ValueError, match="16-byte multiple"):
        bg4.regroup_words(torch.from_numpy(words.view(np.int32)).view(
            torch.uint32))
    with pytest.raises(ValueError, match="16-byte multiple"):
        j_decode._regroup_pallas(words, interpret=True)


def test_plane_sizes_match_reference():
    for n in range(0, 40):
        assert bg4.bg4_plane_sizes(n) == j_decode.bg4_plane_sizes(n)
        assert sum(bg4.bg4_plane_sizes(n)) == n


def test_regroup_matches_pallas_interpret():
    chunks = _chunks(SMALL)
    words, _ = bg4.stage_planar(_planar(chunks), list(SMALL))
    got = bg4.regroup_words(words)
    want = np.asarray(j_decode._regroup_pallas(
        words.numpy().view(np.uint32), interpret=True))
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("lengths", [SMALL, LARGE], ids=["small", "large"])
def test_regroup_matches_host_inverse(lengths):
    chunks = _chunks(lengths, seed=12)
    planar = _planar(chunks)
    words, _ = bg4.stage_planar(planar, list(lengths))
    rows = _row_bytes(bg4.regroup_words(words))
    for row, c, p in zip(rows, chunks, planar):
        assert row[:len(c)].tobytes() == c
        assert j_compression._bg4_inverse(p) == c


@KEYS
def test_fused_verifier_matches_reference(key):
    chunks = _chunks(SMALL, seed=13)
    planar = _planar(chunks)
    got = bg4.FusedBg4Verifier(key, "cpu").hash_planar_batch(
        planar, list(SMALL))
    want = j_decode.FusedBg4Verifier(key, interpret=True).hash_planar_batch(
        planar, list(SMALL))
    host = [native.lib.blake3(c) if key is None
            else native.lib.blake3_keyed(key, c) for c in chunks]
    assert got == want == host


@KEYS
def test_fused_at_128k_matches_native(key):
    chunks = _chunks(LARGE, seed=14)
    got = bg4.FusedBg4Verifier(key, "cpu").hash_planar_batch(
        _planar(chunks), list(LARGE))
    assert got == [native.lib.blake3(c) if key is None
                   else native.lib.blake3_keyed(key, c) for c in chunks]


@pytest.mark.parametrize("lengths", [SMALL, LARGE], ids=["small", "large"])
def test_garbage_past_planes_changes_nothing(lengths):
    chunks = _chunks(lengths, seed=15)
    words, lens = bg4.stage_planar(_planar(chunks), list(lengths))
    raw = _row_bytes(words).copy()
    slot = raw.shape[1] // 4
    rng = np.random.default_rng(16)
    for i, n in enumerate(lengths):
        for k, size in enumerate(bg4.bg4_plane_sizes(n)):
            tail = raw[i, k * slot + size:(k + 1) * slot]
            tail[:] = rng.integers(0, 256, tail.shape, dtype=np.uint8)
    dirty = torch.from_numpy(raw).view(torch.uint32)
    clean_rows = _row_bytes(bg4.regroup_words(words))
    dirty_rows = _row_bytes(bg4.regroup_words(dirty))
    for i, n in enumerate(lengths):
        assert np.array_equal(dirty_rows[i, :n], clean_rows[i, :n])
    kw, bf = plain.key_params(CHUNK_KEY)
    assert torch.equal(bg4.fused_regroup_hash(dirty, lens, kw, bf),
                       bg4.fused_regroup_hash(words, lens, kw, bf))


def test_planar_extract_of_a_real_frame_feeds_the_verifier():
    """A BG4 chunk's planar bytes decoded from a xorb frame verify to the
    chunk hash the xorb records."""
    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.cas.xorb import XorbBuilder, XorbReader

    chunks = _chunks((4096, 9000, 5), seed=17)
    b = XorbBuilder()
    for c in chunks:
        b.add_chunk(c)
    reader = XorbReader(b.serialize())
    idx = [i for i, s in enumerate(reader.chunk_schemes.tolist())
           if s == int(compression.Scheme.BG4_LZ4)]
    assert idx, "float-like chunks should pick BG4"
    got = bg4.FusedBg4Verifier(CHUNK_KEY, "cpu").hash_planar_batch(
        [reader.extract_chunk_planar(i) for i in idx],
        [len(chunks[i]) for i in idx])
    assert got == [hashing.chunk_hash(chunks[i]) for i in idx]


def _gather_block(row: np.ndarray, leaf: int, b: int) -> np.ndarray:
    """Message block ``b`` of leaf ``leaf`` as the fused kernel loads it
    from one row of planar words: a 16-byte piece of each plane ``k`` at
    word ``k·W/4 + 64·leaf + 4·b``, then message word ``4t + s`` packs
    byte ``s`` of word ``t`` of the four pieces, plane ``k`` in byte ``k``."""
    pw = row.size // 4
    pieces = np.stack([row[k * pw + 64 * leaf + 4 * b:][:4]
                       for k in range(4)])               # (plane, word)
    by = pieces.view(np.uint8).reshape(4, 4, 4)          # plane, word, byte
    return by.transpose(1, 2, 0).copy().view("<u4").reshape(16)


# Every length mod 4 around a block edge, two leaf edges and the capacity.
GATHER_LENGTHS = (tuple(range(60, 69)) + tuple(range(1020, 1029))
                  + tuple(range(2044, 2053)) + (3069, 3070, 3071, 3072))


def test_fused_gather_matches_regroup_and_pallas():
    chunks = _chunks(GATHER_LENGTHS, seed=18)
    words, _ = bg4.stage_planar(_planar(chunks), list(GATHER_LENGTHS))
    raw = _row_bytes(words).copy()
    slot = raw.shape[1] // 4
    rng = np.random.default_rng(19)
    for i, n in enumerate(GATHER_LENGTHS):  # garbage past every plane
        for k, size in enumerate(bg4.bg4_plane_sizes(n)):
            tail = raw[i, k * slot + size:(k + 1) * slot]
            tail[:] = rng.integers(0, 256, tail.shape, dtype=np.uint8)
    rows = raw.view(np.uint32)
    want = bg4.regroup_words(torch.from_numpy(raw).view(
        torch.uint32)).numpy().view(np.uint32)
    assert np.array_equal(
        want, np.asarray(j_decode._regroup_pallas(rows, interpret=True)))
    leaves = rows.shape[1] // 256
    for row, regrouped in zip(rows, want):
        got = np.concatenate([_gather_block(row, leaf, b)
                              for leaf in range(leaves) for b in range(16)])
        assert np.array_equal(got, regrouped)
