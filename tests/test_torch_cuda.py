"""The port on the card: the CUDA BLAKE3 kernel and the slice on ``cuda``.

Every test here needs a CUDA device (``cuda`` marker) and skips with a
reason where there is none. This file imports nothing of jax or the JAX
package, so it runs on the card's machine, which has neither:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: tests/conftest.py configures jax for the JAX
package's tests.) ``chip_smoke.py`` runs the same slice at full GPT-2
width.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from zest_tpu_torch import native
from zest_tpu_torch.cas.hashing import CHUNK_KEY
from zest_tpu_torch.config import Config
from zest_tpu_torch.ops import CudaHasher, DeviceHasher, unit_verify_hasher
from zest_tpu_torch.ops import blake3 as plain
from zest_tpu_torch.ops import blake3_cuda

pytestmark = pytest.mark.cuda

_RNG = np.random.default_rng(17)
_LENGTHS = (0, 1, 63, 64, 1023, 1024, 1025, 2049, 7 * 1024 + 3, 65536,
            131071, 131072)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("key", [None, CHUNK_KEY], ids=["plain", "chunk_key"])
def test_kernel_matches_plain_and_native(cuda_device, key):
    chunks = [_RNG.bytes(n) for n in _LENGTHS]
    got = CudaHasher(key, cuda_device).hash_batch(chunks)
    assert got == DeviceHasher(key).hash_batch(chunks)
    assert got == [native.lib.blake3(c) if key is None
                   else native.lib.blake3_keyed(key, c) for c in chunks]


def test_kernel_masks_garbage_past_length(cuda_device):
    chunks = [_RNG.bytes(n) for n in _LENGTHS]
    words, lengths = plain.stage_batch(chunks, cuda_device)
    raw = words.view(torch.uint8)
    junk = torch.randint(0, 256, raw.shape, device=cuda_device,
                         dtype=torch.uint8)
    past = (torch.arange(raw.shape[1], device=cuda_device)[None, :]
            >= lengths[:, None])
    dirty = torch.where(past, junk, raw).contiguous().view(torch.uint32)
    h = CudaHasher(CHUNK_KEY, cuda_device)
    assert torch.equal(h.hash_device(dirty, lengths),
                       h.hash_device(words, lengths))


def test_launch_count(cuda_device):
    blake3_cuda.COUNTER.reset()
    h = unit_verify_hasher(CHUNK_KEY)
    assert isinstance(h, CudaHasher)
    assert h.hash_batch([]) == []
    h.hash_batch([b"abc", b"x" * 5000])
    torch.cuda.synchronize()
    assert (blake3_cuda.COUNTER.launches, blake3_cuda.COUNTER.chunks) == (1, 2)


def test_kernel_rejects_bad_capacity_on_card(cuda_device):
    h = CudaHasher(device=cuda_device)
    with pytest.raises(ValueError, match="128 KiB"):
        h.hash_device(
            torch.zeros((1, 129 * 256), dtype=torch.uint32,
                        device=cuda_device),
            torch.zeros(1, dtype=torch.int32, device=cuda_device))


def _tiny_gpt2(root):
    from zest_tpu_torch.models.safetensors_io import write_safetensors

    rng = np.random.default_rng(5)
    E, L, V, C = 64, 2, 256, 64
    cfg = dict(model_type="gpt2", vocab_size=V, n_positions=C, n_ctx=C,
               n_embd=E, n_layer=L, n_head=4, layer_norm_epsilon=1e-5)
    t = {"wte.weight": rng.normal(0, 0.02, (V, E)),
         "wpe.weight": rng.normal(0, 0.01, (C, E)),
         "ln_f.weight": np.ones(E), "ln_f.bias": np.zeros(E)}
    shapes = {"ln_1.weight": (E,), "ln_1.bias": (E,), "ln_2.weight": (E,),
              "ln_2.bias": (E,), "attn.c_attn.weight": (E, 3 * E),
              "attn.c_attn.bias": (3 * E,), "attn.c_proj.weight": (E, E),
              "attn.c_proj.bias": (E,), "mlp.c_fc.weight": (E, 4 * E),
              "mlp.c_fc.bias": (4 * E,), "mlp.c_proj.weight": (4 * E, E),
              "mlp.c_proj.bias": (E,)}
    for i in range(L):
        for leaf, shape in shapes.items():
            t[f"h.{i}.{leaf}"] = rng.normal(0, 0.02, shape)
    root.mkdir()
    (root / "config.json").write_text(json.dumps(cfg))
    write_safetensors(root / "model.safetensors",
                      {k: v.astype(np.float32) for k, v in t.items()})
    return root


def test_slice_on_card(cuda_device, tmp_path):
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    ckpt = _tiny_gpt2(tmp_path / "ckpt")
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest", push_chunks_per_xorb=2)
    blake3_cuda.COUNTER.reset()
    pushed = push_checkpoint(cfg_a, "org/tiny", ckpt)
    assert blake3_cuda.COUNTER.launches == pushed.new_xorbs > 1
    assert blake3_cuda.COUNTER.chunks == pushed.minted_chunks
    with PublisherServer(cfg_a) as server:
        res = pull_model(Config(hf_home=tmp_path / "b" / "hf",
                                cache_dir=tmp_path / "b" / "zest",
                                endpoint=server.url), "org/tiny")
    assert all(t.device == cuda_device for t in res.params.values())
    assert params_digest(res.params) == params_digest(
        load_checkpoint(res.snapshot_dir, "cpu"))
    _, gen = load_generator(res.snapshot_dir, tensors=res.params)
    _, gen_cpu = load_generator(res.snapshot_dir, device="cpu")
    prompts = [[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]]
    assert np.array_equal(gen(prompts, 16), gen_cpu(prompts, 16))
