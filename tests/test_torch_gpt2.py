"""The port's GPT-2 against the JAX package's, in float32 on the CPU.

Both read the same seeded checkpoint (tests/fixtures.gpt2_checkpoint_files,
4 heads, 2 layers, 64 wide). Logits agree within rtol 1e-4 / atol 1e-5:
XLA and ATen sum the matrix products in different orders. Greedy tokens
agree exactly, and so do sampled ones under the JAX package's own Gumbel
noise (injected: the port draws its noise from a ``torch.Generator``).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import gpt2_checkpoint_files
from zest_tpu.models import generate as j_generate
from zest_tpu.models import gpt2 as j_gpt2
from zest_tpu.models.safetensors_io import SafetensorsFile as JSafetensors
from zest_tpu_torch.models import generate, gpt2
from zest_tpu_torch.models.safetensors_io import SafetensorsFile

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("gpt2")
    cfg_json = None
    for name, data in gpt2_checkpoint_files(n_embd=64, n_layer=2,
                                            seed=5).items():
        if name == "config.json":
            cfg_json = json.loads(data)
            cfg_json["eos_token_id"] = 7
            data = json.dumps(cfg_json).encode()
        (root / name).write_bytes(data)
    return root


@pytest.fixture(scope="module")
def models(snapshot):
    cfg_json = json.loads((snapshot / "config.json").read_text())
    with JSafetensors(snapshot / "model.safetensors") as sf:
        host = {n: np.array(sf.tensor(n)) for n in sf.names()}
    jcfg = j_gpt2.GPT2Config.from_hf(cfg_json)
    jparams = j_gpt2.params_from_hf(host, jcfg)
    cfg = gpt2.GPT2Config.from_hf(cfg_json)
    params = gpt2.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, params


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def test_params_from_jax_carries_weights(snapshot, models):
    _, jparams, cfg, params = models
    with SafetensorsFile(snapshot / "model.safetensors") as sf:
        from_hf = gpt2.params_from_hf({n: sf.tensor(n) for n in sf.names()},
                                      cfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == 16
    for path, leaf in flat_j:
        keys = [k.key for k in path]
        mine, hf = params, from_hf
        for k in keys:
            mine, hf = mine[k], hf[k]
        assert mine.dtype == torch.float32
        assert np.array_equal(mine.numpy(), np.asarray(leaf))
        assert torch.equal(mine, hf)


def test_forward_logits_match(models):
    jcfg, jparams, cfg, params = models
    ids = _ids((2, 11))
    want = np.asarray(j_gpt2.forward(jparams, jnp.asarray(ids), jcfg))
    got = gpt2.forward(params, torch.from_numpy(ids).long(), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("last_only", [False, True])
def test_decode_window_logits_match(models, last_only):
    jcfg, jparams, cfg, params = models
    ids = _ids((2, 6), seed=1)
    jcache = j_gpt2.init_kv_cache(jcfg, 2, 16)
    want, jcache = j_gpt2.decode_window(jparams, jcache, jnp.asarray(ids), 0,
                                        jcfg, last_only=last_only)
    cache = gpt2.init_kv_cache(cfg, 2, 16)
    got, cache = gpt2.decode_window(params, cache, torch.from_numpy(ids).long(),
                                    0, cfg, last_only=last_only)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=RTOL, atol=ATOL)


def test_decode_step_matches_full_forward(models):
    _, _, cfg, params = models
    ids = torch.from_numpy(_ids((2, 9), seed=2)).long()
    full = gpt2.forward(params, ids, cfg)
    cache = gpt2.init_kv_cache(cfg, 2, 9)
    for pos in range(9):
        logits, cache = gpt2.decode_step(params, cache, ids[:, pos], pos, cfg)
        torch.testing.assert_close(logits, full[:, pos], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batch", [1, 2])
def test_greedy_tokens_equal(models, batch):
    jcfg, jparams, cfg, params = models
    prompt = _ids((batch, 5), seed=3)
    if batch == 1:
        prompt = prompt[0]
    want = np.asarray(j_gpt2.generate_cached(jparams, jcfg, prompt, 12))
    got = gpt2.generate_cached(params, cfg, prompt, 12).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_one_token_prompt_and_eos_freeze(models):
    jcfg, jparams, cfg, params = models
    for prompt, eos in (([3], None), ([[3, 9], [4, 1]], (7, 11))):
        want = np.asarray(j_gpt2.generate_cached(
            jparams, jcfg, np.asarray(prompt, np.int32), 10, eos_id=eos))
        got = gpt2.generate_cached(params, cfg, prompt, 10,
                                   eos_id=eos).numpy()
        assert np.array_equal(got, want)


def test_load_generator_matches_reference(snapshot):
    _, jgen = j_generate.load_generator(snapshot)
    _, gen = generate.load_generator(snapshot, device="cpu")
    for prompt in ([1, 2, 3], [[1, 2, 3], [9, 8, 7]]):
        want = jgen(prompt, 15)
        assert np.array_equal(gen(prompt, 15), want)
        assert np.array_equal(gen(prompt, 15, stop_at_eos=False),
                              jgen(prompt, 15, stop_at_eos=False))


def test_trim_at_eos_matches_reference():
    rows = np.array([[1, 7, 2, 7, 3], [1, 2, 3, 4, 5]])
    for out, n in ((rows, 1), (rows[0], 1), (rows[0], 2), (rows[1], 1)):
        assert np.array_equal(generate.trim_at_eos(out, n, 7),
                              j_generate.trim_at_eos(out, n, 7))


def _jax_gumbel(key, positions: int, batch: int, vocab: int) -> np.ndarray:
    """The Gumbel noise the JAX package's decode loop draws with ``key``:
    one (vocab,) draw per (position, row) of its key grid."""
    keys = jax.random.split(key, positions * batch).reshape(positions, batch)
    return np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.gumbel(k, (vocab,), jnp.float32)))(keys))


def test_sampling_is_refused(models):
    """Sampling is no longer refused: GPT-2 samples, and under the JAX
    package's own Gumbel noise it picks the reference's tokens, single
    and batched."""
    jcfg, jparams, cfg, params = models
    for prompt in (_ids(5, seed=4), _ids((2, 5), seed=4)):
        batch = 1 if prompt.ndim == 1 else 2
        key = jax.random.key(11)
        kw = dict(temperature=0.7, top_k=40, top_p=0.9)
        want = np.asarray(j_gpt2.generate_cached(jparams, jcfg, prompt, 9,
                                                 rng=key, **kw))
        noise = torch.from_numpy(_jax_gumbel(key, 5 + 9 - 1, batch,
                                             cfg.vocab_size))
        got = gpt2.generate_cached(params, cfg, prompt, 9, noise=noise,
                                   **kw).numpy()
        assert np.array_equal(got, want)
        greedy = gpt2.generate_cached(params, cfg, prompt, 9).numpy()
        assert not np.array_equal(got, greedy)
