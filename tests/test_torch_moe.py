"""The port's Mixtral family against ``zest_tpu.models.moe``, on the CPU.

The same numpy trees go through both packages: ``MoEConfig`` and
``from_hf``, ``expert_of_tensor``, ``params_from_hf`` (experts stacked
``[layer, expert, ...]``, every HF ``[out, in]`` transposed), the router
and the capacity semantics of ``_moe_block`` (forced routing, overflow
dropping to the residual, the aux loss), then ``forward``,
``decode_window`` and ``generate_cached`` (greedy, and sampled under the
JAX key grid's Gumbel noise). Logits must be within 1e-5 in float32 and
tokens equal.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import mixtral_checkpoint_files
from zest_tpu import telemetry as j_telemetry
from zest_tpu.models import generate as j_generate
from zest_tpu.models import hbm_pool as j_pool
from zest_tpu.models import moe as j_moe
from zest_tpu_torch import telemetry
from zest_tpu_torch.models import generate, hbm_pool, moe

TOL = 1e-5


@pytest.fixture(autouse=True)
def clean():
    for reset in (hbm_pool.reset, j_pool.reset, telemetry.reset_all,
                  j_telemetry.reset_all):
        reset()
    yield
    for reset in (hbm_pool.reset, j_pool.reset, telemetry.reset_all,
                  j_telemetry.reset_all):
        reset()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """A tiny MoE (the JAX package's ``init_params``) on both sides."""
    jcfg = j_moe.MoEConfig.tiny()
    jparams = j_moe.init_params(jax.random.key(0), jcfg)
    return jcfg, jparams, moe.MoEConfig.tiny(), moe.params_from_jax(
        _np(jparams))


def _hf_tensors(cfg, seed=0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    E, F, X = cfg.n_embd, cfg.d_ff, cfg.n_experts
    kvE = cfg.n_kv_head * cfg.head_dim

    def w(*shape):
        return rng.normal(0, 0.05, shape).astype(np.float32)

    t = {"model.embed_tokens.weight": w(cfg.vocab_size, E),
         "model.norm.weight": 1 + w(E),
         "lm_head.weight": w(cfg.vocab_size, E)}
    for i in range(cfg.n_layer):
        pre = f"model.layers.{i}."
        t[pre + "input_layernorm.weight"] = 1 + w(E)
        t[pre + "post_attention_layernorm.weight"] = 1 + w(E)
        t[pre + "self_attn.q_proj.weight"] = w(E, E)
        t[pre + "self_attn.k_proj.weight"] = w(kvE, E)
        t[pre + "self_attn.v_proj.weight"] = w(kvE, E)
        t[pre + "self_attn.o_proj.weight"] = w(E, E)
        t[pre + "block_sparse_moe.gate.weight"] = w(X, E)
        for x in range(X):
            ep = f"{pre}block_sparse_moe.experts.{x}."
            t[ep + "w1.weight"] = w(F, E)
            t[ep + "w3.weight"] = w(F, E)
            t[ep + "w2.weight"] = w(E, F)
    return t


def test_config_matches_reference():
    assert dataclasses.asdict(moe.MoEConfig.mixtral_8x7b()) == \
        dataclasses.asdict(j_moe.MoEConfig.mixtral_8x7b())
    assert dataclasses.asdict(moe.MoEConfig.tiny(top_k=1)) == \
        dataclasses.asdict(j_moe.MoEConfig.tiny(top_k=1))
    cfg_json = json.loads(mixtral_checkpoint_files()["config.json"])
    for over in ({}, {"rope_theta": 5e5, "num_experts_per_tok": 1},
                 {"num_key_value_heads": None}):
        doc = {**cfg_json, **over}
        if over.get("num_key_value_heads", 0) is None:
            del doc["num_key_value_heads"]
        ours, theirs = moe.MoEConfig.from_hf(doc), \
            j_moe.MoEConfig.from_hf(doc)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.head_dim == theirs.head_dim


@pytest.mark.parametrize("name,want", [
    ("model.layers.3.block_sparse_moe.experts.5.w1.weight", 5),
    ("model.layers.0.block_sparse_moe.experts.12.w2.weight", 12),
    ("model.layers.3.self_attn.q_proj.weight", None),
    ("model.layers.3.block_sparse_moe.gate.weight", None),
    ("model.embed_tokens.weight", None),
    ("experts.7", 7),
    ("subexperts.7.w1", None),
])
def test_expert_of_tensor(name, want):
    assert moe.expert_of_tensor(name) == want == j_moe.expert_of_tensor(name)


def test_params_from_hf_matches_reference():
    cfg = moe.MoEConfig.tiny(n_layer=2, n_experts=4)
    jcfg = j_moe.MoEConfig.tiny(n_layer=2, n_experts=4)
    hf = _hf_tensors(cfg)
    ours = moe.params_from_hf({n: torch.from_numpy(a) for n, a in
                               hf.items()}, cfg)
    theirs = _np(j_moe.params_from_hf(hf, jcfg))
    assert ours["blocks"]["moe"]["w1"].shape == (2, 4, cfg.n_embd, cfg.d_ff)
    assert ours["blocks"]["moe"]["w2"].shape == (2, 4, cfg.d_ff, cfg.n_embd)
    np.testing.assert_array_equal(
        ours["blocks"]["moe"]["w1"][1, 3].numpy(),
        hf["model.layers.1.block_sparse_moe.experts.3.w1.weight"].T)
    flat_o = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), ours))[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
    assert len(flat_o) == len(flat_t) == 13
    for path, leaf in flat_o:
        np.testing.assert_array_equal(leaf, flat_t[path])
    # bf16 checkpoint tensors become a float32 tree.
    bf = moe.params_from_hf({n: torch.from_numpy(a).to(torch.bfloat16)
                             for n, a in hf.items()}, cfg)
    assert bf["blocks"]["moe"]["w3"].dtype == torch.float32


def test_params_from_hf_missing_tensor_raises():
    cfg = moe.MoEConfig.tiny(n_layer=1, n_experts=2)
    hf = {n: torch.from_numpy(a) for n, a in _hf_tensors(cfg).items()}
    del hf["model.layers.0.block_sparse_moe.experts.1.w2.weight"]
    with pytest.raises(ValueError, match="experts.1.w2"):
        moe.params_from_hf(hf, cfg)


def _layer_moe(params, jparams):
    return ({k: v[0] for k, v in params["blocks"]["moe"].items()},
            jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"]))


@pytest.mark.parametrize("forced", [2, 1])
def test_router_forced_expert_and_overflow(forced):
    """All tokens forced onto one expert: with room for them every token
    goes through its SwiGLU at gate 1; with one slot (``capacity_factor``
    tiny) only the first keeps an output and the rest drop to the
    residual, as the JAX package drops them."""
    factor = 4.0 if forced == 2 else 0.01
    jcfg = j_moe.MoEConfig.tiny(n_experts=4, top_k=1,
                                capacity_factor=factor)
    cfg = moe.MoEConfig.tiny(n_experts=4, top_k=1, capacity_factor=factor)
    jp = jax.tree.map(lambda a: a[0], j_moe.init_params(
        jax.random.key(1), jcfg)["blocks"]["moe"])
    router = np.zeros((cfg.n_embd, cfg.n_experts), np.float32)
    router[:, forced] = 1.0
    jp["router_w"] = jnp.asarray(router)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(3).uniform(0.1, 1.0, (1, 8, cfg.n_embd)) \
        .astype(np.float32)
    out, aux = moe._moe_block(torch.from_numpy(x), p, cfg)
    jout, jaux = j_moe._moe_block(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
    rows = np.abs(out.numpy()).sum(-1)[0]
    if forced == 2:
        flat = x.reshape(-1, cfg.n_embd)
        w1, w3, w2 = (np.asarray(jp[k][2]) for k in ("w1", "w3", "w2"))
        h = flat @ w1
        want = ((h / (1 + np.exp(-h))) * (flat @ w3)) @ w2
        np.testing.assert_allclose(out.numpy()[0], want, atol=TOL)
        assert (rows > 0).all()
    else:
        assert (rows > 0).sum() == 1 and rows[0] > 0
        assert moe._capacity(8, cfg) == j_moe._capacity(8, jcfg) == 1


def test_capacity_matches_reference():
    for factor in (0.01, 1.0, 2.0, 4.0):
        for k in (1, 2):
            cfg = moe.MoEConfig.tiny(top_k=k, capacity_factor=factor)
            jcfg = j_moe.MoEConfig.tiny(top_k=k, capacity_factor=factor)
            for n in (1, 3, 8, 40):
                assert moe._capacity(n, cfg) == j_moe._capacity(n, jcfg)


def test_batch_dispatch_overflow_matches_reference(tiny):
    """The whole-batch dispatch at a capacity where some expert
    overflows: the port drops the same tokens."""
    jcfg, jparams, cfg, params = tiny
    jcfg = dataclasses.replace(jcfg, capacity_factor=1.0)
    cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    x = np.random.default_rng(5).normal(size=(2, 24, cfg.n_embd)) \
        .astype(np.float32)
    p, jp = _layer_moe(params, jparams)
    out, aux = moe._moe_block(torch.from_numpy(x), p, cfg)
    jout, jaux = j_moe._moe_block(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
    # Some token lost an expert slot at this capacity.
    C = moe._capacity(48, cfg)
    _, _, idx = moe._route(torch.from_numpy(x).reshape(48, -1),
                           p["router_w"], cfg)
    assert torch.bincount(idx.flatten(), minlength=8).max() > C


@pytest.mark.parametrize("shape", [(2, 12), (1, 5), (3, 1)])
def test_forward_matches_reference(tiny, shape):
    jcfg, jparams, cfg, params = tiny
    ids = np.random.default_rng(sum(shape)).integers(0, cfg.vocab_size,
                                                      shape)
    logits, aux = moe.forward(params, torch.from_numpy(ids), cfg)
    jlogits, jaux = j_moe.forward(jparams, jnp.asarray(ids, jnp.int32),
                                  jcfg)
    assert logits.shape == (*shape, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)


def test_rope_matches_reference():
    x = np.random.default_rng(2).normal(size=(2, 6, 4, 16)) \
        .astype(np.float32)
    for theta, pos in ((1e6, 0), (1e4, 7), (5e5, 4093)):
        np.testing.assert_allclose(
            moe._rope(torch.from_numpy(x), theta, pos).numpy(),
            np.asarray(j_moe._rope(jnp.asarray(x), theta, pos)),
            atol=1e-5)


def test_decode_window_and_step_match_reference(tiny):
    jcfg, jparams, cfg, params = tiny
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 10))
    jcache = j_moe.init_kv_cache(jcfg, 2, 12)
    cache = moe.init_kv_cache(cfg, 2, 12)
    jl, jcache = j_moe.decode_window(jparams, jcache,
                                     jnp.asarray(ids[:, :6], jnp.int32), 0,
                                     jcfg)
    logits, cache = moe.decode_window(params, cache,
                                      torch.from_numpy(ids[:, :6]), 0, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL)
    for pos in range(6, 10):
        jl, jcache = j_moe.decode_step(
            jparams, jcache, jnp.asarray(ids[:, pos], jnp.int32), pos, jcfg)
        logits, cache = moe.decode_step(
            params, cache, torch.from_numpy(ids[:, pos]), pos, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=TOL)
    # The windowed decode equals the uncached forward at full capacity
    # (every token dispatched alone drops nothing).
    full = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.top_k)
    want, _ = moe.forward(params, torch.from_numpy(ids), full)
    cache = moe.init_kv_cache(cfg, 2, 10)
    got, _ = moe.decode_window(params, cache, torch.from_numpy(ids), 0, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)
    last, _ = moe.decode_window(params, moe.init_kv_cache(cfg, 2, 10),
                                torch.from_numpy(ids), 0, cfg,
                                last_only=True)
    np.testing.assert_allclose(last.numpy(), got.numpy()[:, -1:], atol=TOL)


def _jax_gumbel(key, positions: int, batch: int, vocab: int):
    keys = jax.random.split(key, positions * batch).reshape(positions, batch)
    return torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.gumbel(k, (vocab,), jnp.float32)))(keys)))


@pytest.mark.parametrize("batch", [1, 3])
def test_generate_cached_matches_reference(tiny, batch):
    jcfg, jparams, cfg, params = tiny
    prompt = np.random.default_rng(batch).integers(
        0, cfg.vocab_size, (batch, 5)).tolist()
    if batch == 1:
        prompt = prompt[0]
    want = np.asarray(j_moe.generate_cached(jparams, jcfg, prompt, 7))
    got = moe.generate_cached(params, cfg, prompt, 7).numpy()
    np.testing.assert_array_equal(got, want)
    # Sampled, under the JAX package's own key grid's noise.
    key = jax.random.key(11)
    kw = dict(temperature=0.9, top_k=30, top_p=0.95)
    want = np.asarray(j_moe.generate_cached(jparams, jcfg, prompt, 7,
                                            rng=key, **kw))
    noise = _jax_gumbel(key, 5 + 7 - 1, batch, cfg.vocab_size)
    got = moe.generate_cached(params, cfg, prompt, 7, noise=noise,
                              **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_load_generator_mixtral_matches_reference(tmp_path):
    for name, blob in mixtral_checkpoint_files(seed=3).items():
        (tmp_path / name).write_bytes(blob)
    assert "mixtral" in generate.GENERATE_FAMILIES
    assert generate.GENERATE_FAMILIES == j_generate.GENERATE_FAMILIES
    mt, gen = generate.load_generator(tmp_path, device="cpu")
    jmt, jgen = j_generate.load_generator(tmp_path)
    assert mt == jmt == "mixtral"
    for prompt in ([1, 2, 3], [[4, 5], [6, 7]]):
        np.testing.assert_array_equal(gen(prompt, 6), jgen(prompt, 6))
    assert gen.eos_ids == jgen.eos_ids
