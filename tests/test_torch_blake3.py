"""The port's BLAKE3 verifier against the JAX package.

The plain PyTorch version (``zest_tpu_torch/ops/blake3.py``) must equal
the pure-Python anchor (``zest_tpu.cas.blake3``) and the Pallas kernel in
interpret mode (``PallasHasher(interpret=True)``, as
tests/test_ops_blake3_pallas.py runs it), bit for bit, plain and keyed.
The CUDA kernel itself only runs on the card: tests/test_torch_cuda.py
holds it against the plain version there (``chip_smoke.py`` at full size).
Here a plain function that folds each chunk's tree in the kernel's order
(``csrc/blake3.cu``: lane strides in a warp for a chunk of one 32-leaf
group, whole levels for a longer one) is held against both oracles at
every leaf count 1–128.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from zest_tpu.cas import blake3 as jref
from zest_tpu.cas.hashing import CHUNK_KEY
from zest_tpu.ops.blake3_pallas import PallasHasher
from zest_tpu_torch import native
from zest_tpu_torch.cas import blake3 as port_pure
from zest_tpu_torch.cas.blake3 import CHUNK_END, CHUNK_START, PARENT, ROOT
from zest_tpu_torch.ops import CudaHasher, DeviceHasher, unit_verify_hasher
from zest_tpu_torch.ops import blake3 as plain
from zest_tpu_torch.ops import bg4_cuda, blake3_cuda, nvcc

_RNG = np.random.default_rng(7)
_KEY = bytes(range(32))


def _ref(key: bytes | None, data: bytes) -> bytes:
    return jref.blake3(data) if key is None else jref.blake3_keyed(key, data)


@pytest.mark.parametrize("key", [None, _KEY], ids=["plain", "keyed"])
@pytest.mark.parametrize("n_leaves", range(1, 10))
def test_every_leaf_count_through_promotion(n_leaves, key):
    """1–9 leaves cover every odd-tail promotion shape of the tree, each
    with a full, a one-byte and a partial last leaf."""
    base = (n_leaves - 1) * 1024
    chunks = [_RNG.bytes(max(base + tail, 0)) for tail in (1024, 1, 517)]
    got = DeviceHasher(key).hash_batch(chunks)
    assert got == [_ref(key, c) for c in chunks]


def _leaf_cvs(chunks, key_words, base_flags) -> list[list[list[int]]]:
    """Each chunk's leaf chaining values, every leaf of the batch at once
    (the plain version's compression); a one-leaf chunk's leaf takes ROOT
    on its last block, as the kernel's lane does."""
    n_leaves = [max(-(-len(c) // 1024), 1) for c in chunks]
    words, counters, leaf_bytes, single = [], [], [], []
    for c, n in zip(chunks, n_leaves):
        buf = np.zeros(n * 1024, np.uint8)
        buf[:len(c)] = np.frombuffer(c, np.uint8)
        words.append(buf.view("<u4").astype(np.int64).reshape(n, 256))
        counters += range(n)
        leaf_bytes += [min(max(len(c) - 1024 * i, 0), 1024) for i in range(n)]
        single += [n == 1] * n
    w = torch.from_numpy(np.concatenate(words))
    counter = torch.tensor(counters)
    lb = torch.tensor(leaf_bytes)
    blocks = torch.clamp((lb + 63) // 64, min=1)
    last_root = torch.tensor(single)
    cv = torch.tensor(key_words).expand(len(counters), 8)
    for b in range(16):
        last = blocks - 1 == b
        flags = (base_flags | (CHUNK_START if b == 0 else 0)
                 | torch.where(last, CHUNK_END, 0)
                 | torch.where(last & last_root, ROOT, 0))
        out = plain.compress(cv, w[:, 16 * b:16 * b + 16], counter,
                             (lb - 64 * b).clamp(0, 64), flags)
        cv = torch.where((b < blocks)[:, None], out[:, :8], cv)
    rows = cv.tolist()
    starts = np.cumsum([0] + n_leaves)
    return [rows[starts[i]:starts[i + 1]] for i in range(len(chunks))]


def _group_order_root(cvs, key_words, base_flags) -> list[int]:
    """The chunk's digest words, folded in the kernel's order. One group
    (<= 32 leaves): at step s lane l merges with lane l + s, ROOT when
    ceil(live / s) == 2. Longer: a level at a time, pairwise with the odd
    tail promoted, ROOT on the merge of the last two."""

    def parent(left, right, root):
        flags = base_flags | PARENT | (ROOT if root else 0)
        return port_pure.compress(key_words, left + right, 0, 64, flags)[:8]

    live = len(cvs)
    if live == 1:
        return cvs[0]
    nodes = list(cvs)
    if live <= 32:
        s = 1
        while s < live:
            for lane in range(0, live - s, 2 * s):
                nodes[lane] = parent(nodes[lane], nodes[lane + s],
                                     -(-live // s) == 2)
            s *= 2
        return nodes[0]
    while len(nodes) > 1:
        count = len(nodes)
        nodes = [parent(nodes[j], nodes[j + 1], count == 2)
                 if j + 1 < count else nodes[j] for j in range(0, count, 2)]
    return nodes[0]


def _group_order_digests(chunks, key) -> list[bytes]:
    kw, bf = plain.key_params(key)
    return [np.asarray(_group_order_root(cvs, kw, bf), "<u4").tobytes()
            for cvs in _leaf_cvs(chunks, kw, bf)]


# Leaf counts 1-128, the last leaf full, one byte or partial in turn.
_ALL_LEAF_COUNTS = [_RNG.bytes(1024 * (n - 1) + (1024, 1, 517)[n % 3])
                    for n in range(1, 129)]


@pytest.mark.parametrize("key", [None, _KEY], ids=["plain", "keyed"])
def test_group_order_fold_every_leaf_count(key):
    got = _group_order_digests(_ALL_LEAF_COUNTS, key)
    assert got == [_ref(key, c) for c in _ALL_LEAF_COUNTS]


@pytest.mark.parametrize("key", [None, CHUNK_KEY], ids=["plain", "chunk_key"])
def test_group_order_fold_matches_pallas_interpret(key):
    """One interpret-mode call per key over all 128 leaf counts."""
    want = PallasHasher(key, interpret=True).hash_batch(_ALL_LEAF_COUNTS)
    assert _group_order_digests(_ALL_LEAF_COUNTS, key) == want


@pytest.mark.parametrize("key", [None, CHUNK_KEY], ids=["plain", "chunk_key"])
def test_plain_matches_pallas_interpret(key):
    """One interpret-mode kernel call per key (each costs seconds): leaf
    shapes up to a 3-leaf tree in a 6-row batch, not a tile multiple."""
    chunks = [_RNG.bytes(n) for n in (0, 1, 64, 1024, 1025, 3000)]
    want = PallasHasher(key, interpret=True).hash_batch(chunks)
    assert DeviceHasher(key).hash_batch(chunks) == want
    assert want == [_ref(key, c) for c in chunks]


def test_batch_not_a_tile_multiple():
    chunks = [_RNG.bytes(100 + i) for i in range(5)]
    assert DeviceHasher().hash_batch(chunks) == [jref.blake3(c)
                                                 for c in chunks]


def test_garbage_past_length_is_masked():
    chunks = [_RNG.bytes(n) for n in (0, 3, 1023, 2050)]
    words, lengths = plain.stage_batch(chunks, torch.device("cpu"))
    raw = words.view(torch.uint8).clone()
    junk = torch.from_numpy(_RNG.integers(0, 256, raw.shape, np.uint8))
    past = torch.arange(raw.shape[1])[None, :] >= lengths[:, None]
    dirty = torch.where(past, junk, raw).view(torch.uint32)
    h = DeviceHasher(CHUNK_KEY)
    assert torch.equal(h.hash_device(dirty, lengths),
                       h.hash_device(words, lengths))


@pytest.mark.parametrize("hasher", [DeviceHasher, CudaHasher])
def test_capacity_validation(hasher):
    h = hasher(device="cpu")
    with pytest.raises(ValueError, match="1 KiB multiple"):
        h.hash_device(torch.zeros((1, 100), dtype=torch.uint32),
                      torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="128 KiB"):
        h.hash_device(torch.zeros((1, 129 * 256), dtype=torch.uint32),
                      torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="uint32"):
        h.hash_device(torch.zeros((1, 256), dtype=torch.int64),
                      torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("hasher", [DeviceHasher, CudaHasher])
def test_bad_key_length(hasher):
    with pytest.raises(ValueError, match="32 bytes"):
        hasher(key=b"short")


@pytest.mark.parametrize("hasher", [DeviceHasher, CudaHasher])
def test_empty_batch(hasher):
    assert hasher(device="cpu").hash_batch([]) == []


def test_cpu_tensor_never_launches_the_kernel():
    blake3_cuda.COUNTER.reset()
    chunks = [_RNG.bytes(n) for n in (5, 2000)]
    h = CudaHasher(CHUNK_KEY, device="cpu")
    assert h.hash_batch(chunks) == [jref.blake3_keyed(CHUNK_KEY, c)
                                    for c in chunks]
    assert (blake3_cuda.COUNTER.launches, blake3_cuda.COUNTER.rows) == (0, 0)


def _unbuildable(mod, tmp_path, monkeypatch) -> None:
    """Give ``mod`` a fresh, unbuilt library whose nvcc always fails."""
    monkeypatch.setattr(mod, "LIBRARY", nvcc.KernelLibrary(
        mod.SOURCE.name, mod.LIBRARY.lib_name, lambda dll: None))
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc, "nvcc", lambda: "false")


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel that does not build raises; nothing falls back."""
    _unbuildable(blake3_cuda, tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="nvcc failed on blake3.cu"):
        blake3_cuda.build()


def test_failed_bg4_build_raises(tmp_path, monkeypatch):
    _unbuildable(bg4_cuda, tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="nvcc failed on bg4.cu"):
        bg4_cuda.build()


def test_unit_verify_hasher_cpu_is_plain():
    assert isinstance(unit_verify_hasher(CHUNK_KEY, "cpu"), DeviceHasher)



@pytest.mark.parametrize("n", [0, 1, 64, 1024, 1025, 5000])
@pytest.mark.parametrize("key", [None, CHUNK_KEY], ids=["plain", "chunk_key"])
def test_host_hashers_match_reference(n, key):
    """The port's pure BLAKE3 and its native host hasher (the host oracle
    the kernel is held to on the card) equal the JAX package's."""
    data = _RNG.bytes(n)
    if key is None:
        got = (port_pure.blake3(data), native.lib.blake3(data))
    else:
        got = (port_pure.blake3_keyed(key, data),
               native.lib.blake3_keyed(key, data))
    assert got == (_ref(key, data),) * 2
