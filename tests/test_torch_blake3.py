"""The port's BLAKE3 verifier against the JAX package.

The plain PyTorch version (``zest_tpu_torch/ops/blake3.py``) must equal
the pure-Python anchor (``zest_tpu.cas.blake3``) and the Pallas kernel in
interpret mode (``PallasHasher(interpret=True)``, as
tests/test_ops_blake3_pallas.py runs it), bit for bit, plain and keyed.
The CUDA kernel itself only runs on the card: tests/test_torch_cuda.py
holds it against the plain version there (``chip_smoke.py`` at full size).
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
