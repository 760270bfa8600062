"""The port's Llama family against the JAX package's, on the CPU.

Both sides read the same seeded numpy weights under HF names (each
side's ``params_from_hf``, or the JAX tree carried over by
``params_from_jax``): untied, tied, llama3-scaled rope, a ``head_dim``
override, ``attention_bias`` (with ``o_b``), Qwen2's q/k/v biases, and
Llama-3.2-1B's rope at a narrow width, plus the fixture checkpoint
(tests/fixtures.llama_checkpoint_files). Mirrors the decode and
``from_hf`` cases of tests/test_llama.py; the training, tensor- and
context-parallel cases are not ported.

Tolerances, float32 throughout: logits within rtol 1e-4 / atol 1e-5 (XLA
and ATen sum the products in other orders); ``_inv_freq`` bit-equal;
``_rope`` at positions up to 131071 within atol 2e-5 of unit-scale
inputs (the float32 angles are formed alike; the two libraries' cos and
sin of an angle near 1.3e5 rad differ by a few ulps of it); greedy tokens
exactly.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import llama_checkpoint_files
from zest_tpu.models import llama as j_llama
from zest_tpu_torch.models import llama

RTOL, ATOL = 1e-4, 1e-5

BASE = dict(model_type="llama", vocab_size=256, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64, rms_norm_eps=1e-5,
            rope_theta=10000.0, tie_word_embeddings=False)
LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 16}
# Llama-3.2-1B's rope (theta, scaling, head_dim 64, GQA 4:1) at a
# narrow width.
LLAMA32 = dict(BASE, hidden_size=256, intermediate_size=512,
               num_attention_heads=4, num_key_value_heads=1,
               max_position_embeddings=131072, rope_theta=500000.0,
               tie_word_embeddings=True,
               rope_scaling={"rope_type": "llama3", "factor": 32.0,
                             "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                             "original_max_position_embeddings": 8192})
CONFIGS = {
    "untied": BASE,
    "tied": dict(BASE, tie_word_embeddings=True),
    "llama3_rope": dict(BASE, rope_scaling=LLAMA3),
    "head_dim": dict(BASE, head_dim=24),
    "attention_bias": dict(BASE, attention_bias=True),
    "qwen2": dict(BASE, model_type="qwen2"),
    "llama32_rope": LLAMA32,
}


def _hf_tensors(cfg_json: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded HF-named float32 tensors for ``cfg_json``: weights
    N(0, 0.02), norms 1 + N(0, 0.02), biases N(0, 0.5)."""
    cfg = j_llama.LlamaConfig.from_hf(cfg_json)
    rng = np.random.default_rng(seed)
    E, F, V = cfg.n_embd, cfg.d_ff, cfg.vocab_size
    qE, kvE = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim

    def w(*shape, scale=0.02):
        return rng.normal(0, scale, shape).astype(np.float32)

    t = {"model.embed_tokens.weight": w(V, E),
         "model.norm.weight": 1 + w(E)}
    if not cfg.tie_embeddings:
        t["lm_head.weight"] = w(V, E)
    for i in range(cfg.n_layer):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + w(E)
        t[p + "post_attention_layernorm.weight"] = 1 + w(E)
        for name, shape in (("q_proj", (qE, E)), ("k_proj", (kvE, E)),
                            ("v_proj", (kvE, E)), ("o_proj", (E, qE))):
            t[f"{p}self_attn.{name}.weight"] = w(*shape)
        for name, shape in (("gate_proj", (F, E)), ("up_proj", (F, E)),
                            ("down_proj", (E, F))):
            t[f"{p}mlp.{name}.weight"] = w(*shape)
        if cfg.attn_bias:
            for name, n in (("q_proj", qE), ("k_proj", kvE), ("v_proj", kvE)):
                t[f"{p}self_attn.{name}.bias"] = w(n, scale=0.5)
        if cfg.o_bias:
            t[p + "self_attn.o_proj.bias"] = w(E, scale=0.5)
    return t


def _models(cfg_json: dict, seed: int = 0):
    """``(jax cfg, jax params, port cfg, port params)`` from the same
    seeded HF tensors."""
    host = _hf_tensors(cfg_json, seed)
    jcfg = j_llama.LlamaConfig.from_hf(cfg_json)
    cfg = llama.LlamaConfig.from_hf(cfg_json)
    jparams = j_llama.params_from_hf(host, jcfg)
    params = llama.params_from_hf(
        {n: torch.from_numpy(v) for n, v in host.items()}, cfg)
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    return (request.param,) + _models(CONFIGS[request.param])


def _ids(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_config_matches_reference(models):
    _, jcfg, _, cfg, _ = models
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.head_dim == jcfg.head_dim


def test_params_match_reference_both_ways(models):
    """``params_from_hf`` gives the reference's tree leaf for leaf, and
    ``params_from_jax`` carries the reference's tree to the same one."""
    name, jcfg, jparams, cfg, params = models
    carried = llama.params_from_jax(jax.tree.map(np.asarray, jparams))
    mine = dict(_leaves(params))
    theirs = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    assert mine.keys() == theirs.keys() == dict(_leaves(carried)).keys()
    assert ("lm_head",) in mine or name in ("tied", "llama32_rope")
    for key, leaf in theirs.items():
        assert mine[key].dtype == torch.float32
        assert np.array_equal(mine[key].numpy(), leaf), key
        assert torch.equal(dict(_leaves(carried))[key], mine[key]), key


def test_forward_logits_match(models):
    name, jcfg, jparams, cfg, params = models
    # Positions past original_max_position_embeddings (16) exercise the
    # llama3 scaling.
    ids = _ids((2, 48 if name == "llama3_rope" else 13), seed=1)
    want = np.asarray(j_llama.forward(jparams, jnp.asarray(ids), jcfg))
    got = llama.forward(params, torch.from_numpy(ids).long(), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("last_only", [False, True])
def test_decode_window_logits_and_cache_match(models, last_only):
    _, jcfg, jparams, cfg, params = models
    ids = _ids((2, 6), seed=2)
    jcache = j_llama.init_kv_cache(jcfg, 2, 16)
    want, jcache = j_llama.decode_window(jparams, jcache, jnp.asarray(ids),
                                         jnp.int32(3), jcfg,
                                         last_only=last_only)
    cache = llama.init_kv_cache(cfg, 2, 16)
    got, cache = llama.decode_window(params, cache,
                                     torch.from_numpy(ids).long(), 3, cfg,
                                     last_only=last_only)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=RTOL, atol=ATOL)


def test_decode_step_positions_match_forward(models):
    """``decode_step`` at position p gives column p of the full forward
    (held to the reference's above) at every position."""
    _, _, _, cfg, params = models
    ids = torch.from_numpy(_ids((2, 10), seed=3)).long()
    full = llama.forward(params, ids, cfg)
    cache = llama.init_kv_cache(cfg, 2, 10)
    for pos in range(10):
        logits, cache = llama.decode_step(params, cache, ids[:, pos], pos,
                                          cfg)
        torch.testing.assert_close(logits, full[:, pos], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("batch", [1, 2])
def test_generate_cached_tokens_equal_reference_and_greedy(models, batch):
    _, jcfg, jparams, cfg, params = models
    prompt = _ids((batch, 6), seed=4)
    if batch == 1:
        prompt = prompt[0]
    want = np.asarray(j_llama.generate_cached(jparams, jcfg, prompt, 9))
    got = llama.generate_cached(params, cfg, prompt, 9).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    if batch == 1:
        assert np.array_equal(
            llama.generate_greedy(params, cfg, prompt, 9).numpy(), got)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_inv_freq_bit_equal(name):
    cfg = llama.LlamaConfig.from_hf(CONFIGS[name])
    mine = llama._inv_freq(cfg)
    theirs = j_llama._inv_freq(j_llama.LlamaConfig.from_hf(CONFIGS[name]))
    assert mine.dtype == np.float32
    assert mine.tobytes() == theirs.tobytes()
    assert llama._inv_freq(cfg) is mine  # cached on the config


@pytest.mark.parametrize("pos0", [0, 8191, 65536, 131072 - 16])
def test_rope_at_large_positions(pos0):
    """Llama-3.2-1B's rope (theta 500000, llama3 factor 32, head_dim 64)
    at positions up to 131071: the reference's rotation within atol
    2e-5 of unit-scale inputs."""
    cfg = llama.LlamaConfig.from_hf(LLAMA32)
    jcfg = j_llama.LlamaConfig.from_hf(LLAMA32)
    x = np.random.default_rng(pos0).normal(0, 1, (2, 16, 4, 64)).astype(
        np.float32)
    want = np.asarray(j_llama._rope(jnp.asarray(x), jcfg, pos0))
    got = llama._rope(torch.from_numpy(x), cfg, pos0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_fixture_checkpoint_logits_match(tmp_path):
    """The fixture hub's Llama checkpoint (untied, GQA 4:2), each
    package reading the snapshot with its own ``snapshot_tensors``."""
    from zest_tpu.models.generate import snapshot_tensors as j_snapshot
    from zest_tpu_torch.models.generate import snapshot_tensors

    for name, blob in llama_checkpoint_files(seed=3).items():
        (tmp_path / name).write_bytes(blob)
    cfg_json = json.loads((tmp_path / "config.json").read_text())
    jcfg = j_llama.LlamaConfig.from_hf(cfg_json)
    cfg = llama.LlamaConfig.from_hf(cfg_json)
    jparams = j_llama.params_from_hf(j_snapshot(tmp_path), jcfg)
    params = llama.params_from_hf(snapshot_tensors(tmp_path), cfg)
    ids = _ids((2, 12), seed=5)
    want = np.asarray(j_llama.forward(jparams, jnp.asarray(ids), jcfg))
    got = llama.forward(params, torch.from_numpy(ids).long(), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_attention_bias_cached_equals_full_recompute():
    _, _, cfg, params = _models(CONFIGS["attention_bias"])
    assert "o_b" in params["blocks"]["attn"]
    full = llama.generate_greedy(params, cfg, [1, 2, 3], steps=6)
    cached = llama.generate_cached(params, cfg, [1, 2, 3], steps=6)
    assert torch.equal(full, cached)


def test_generate_rejects_overflow():
    _, _, cfg, params = _models(BASE)
    for fn in (llama.generate_greedy, llama.generate_cached):
        with pytest.raises(ValueError, match="exceeds"):
            fn(params, cfg, [1] * 60, 10)


def test_from_hf_rejections_and_fallbacks():
    small = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4)
    for bad, match in ((dict(small, rope_scaling={"rope_type": "yarn",
                                                   "factor": 4.0}), "yarn"),
                       (dict(small, mlp_bias=True), "mlp_bias")):
        for mod in (llama, j_llama):
            with pytest.raises(ValueError, match=match):
                mod.LlamaConfig.from_hf(bad)
    cfg = llama.LlamaConfig.from_hf(small)
    assert (cfg.rope_theta, cfg.rms_eps, cfg.n_ctx, cfg.n_kv_head) == (
        10000.0, 1e-6, 2048, 4)
    assert cfg.rope_scaling_factor is None
    assert cfg == llama.LlamaConfig(**dataclasses.asdict(
        j_llama.LlamaConfig.from_hf(small)))
    qwen = llama.LlamaConfig.from_hf(dict(small, model_type="qwen2"))
    assert qwen.attn_bias and not qwen.o_bias


def test_presets_match_reference():
    for preset in ("tiny", "llama3_8b", "llama3_70b"):
        assert dataclasses.asdict(getattr(llama.LlamaConfig, preset)()) == \
            dataclasses.asdict(getattr(j_llama.LlamaConfig, preset)())
    assert llama.LlamaConfig.llama3_8b().rope_scaling_factor == 8.0
    c70 = llama.LlamaConfig.llama3_70b()
    assert (c70.n_embd, c70.n_layer, c70.n_kv_head, c70.head_dim) == (
        8192, 80, 8, 128)
    assert llama.LlamaConfig.tiny().rope_scaling_factor is None


def test_params_from_hf_raises_on_missing_tensors():
    host = {n: torch.from_numpy(v) for n, v in _hf_tensors(BASE).items()}
    cfg = llama.LlamaConfig.from_hf(BASE)
    for name in ("lm_head.weight", "model.layers.1.mlp.down_proj.weight"):
        partial = {n: t for n, t in host.items() if n != name}
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            llama.params_from_hf(partial, cfg)
    # A tied config ignores a serialized lm_head.weight.
    tied = llama.LlamaConfig.from_hf(dict(BASE, tie_word_embeddings=True))
    assert "lm_head" not in llama.params_from_hf(host, tied)


@pytest.mark.parametrize("name", ["untied", "tied", "attention_bias",
                                  "qwen2"])
def test_params_to_hf_round_trip(name):
    host = _hf_tensors(CONFIGS[name])
    cfg = llama.LlamaConfig.from_hf(CONFIGS[name])
    params = llama.params_from_hf(
        {n: torch.from_numpy(v) for n, v in host.items()}, cfg)
    back = llama.params_to_hf(params, cfg)
    assert back.keys() == host.keys()
    for n, v in host.items():
        assert np.array_equal(back[n].numpy(), v), n
    theirs = j_llama.params_to_hf(j_llama.params_from_hf(
        host, j_llama.LlamaConfig.from_hf(CONFIGS[name])),
        j_llama.LlamaConfig.from_hf(CONFIGS[name]))
    assert theirs.keys() == back.keys()
