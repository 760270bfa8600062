"""The port's training plane against the JAX package's, on the CPU.

The families' ``loss_fn`` and its gradients (GPT-2, Llama untied / tied
/ ``attn_bias``, Mixtral-style MoE, with and without ``remat``) against
``jax.value_and_grad`` of the reference's; ``decay_mask`` leaf for leaf;
the warmup+cosine schedule at every step; AdamW steps of
``make_train_step`` against optax's, with and without clipping, and from
a state the reference trained mid-run; the families' SGD ``train_step``;
``init_params`` shapes, dtypes and scales; the one-batch overfit of
tests/test_training.py and an unmarked mirror of its slow
``test_composes_with_all_families``.

Tolerances, float32 throughout. Losses and gradients rtol 1e-5 / atol
1e-6 (the frameworks sum products in other orders). The optimizer is held
to 1e-6 per leaf through ``make_train_step`` on a loss whose gradient is
elementwise (the same bits on both sides). Through a model's loss the
parameters are held to 1e-5 instead: Adam's early update g / (|g| + eps)
has slope ~1/eps where |g| is near eps = 1e-8, so the last-ulp gradient
differences of a few such elements move them by up to ~3e-6 at lr 1e-3
(measured: 2.8e-6 on Llama tiny after two steps); the losses stay within
1e-5.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zest_tpu.models import gpt2 as j_gpt2
from zest_tpu.models import llama as j_llama
from zest_tpu.models import moe as j_moe
from zest_tpu.models import training as j_training
from zest_tpu_torch.models import gpt2, llama, moe, training
from zest_tpu_torch.models.training import tree_leaves

RTOL, ATOL = 1e-5, 1e-6

FAMILIES = {
    "gpt2": (j_gpt2, gpt2, j_gpt2.GPT2Config.tiny()),
    "llama": (j_llama, llama, j_llama.LlamaConfig.tiny()),
    "llama_tied": (j_llama, llama,
                   j_llama.LlamaConfig.tiny(tie_embeddings=True)),
    "llama_attn_bias": (j_llama, llama,
                        j_llama.LlamaConfig.tiny(attn_bias=True,
                                                 o_bias=True)),
    "moe": (j_moe, moe, j_moe.MoEConfig.tiny()),
}


def port_cfg(mod, cfg):
    """The port's config of the same fields as the reference's."""
    return getattr(mod, type(cfg).__name__)(**dataclasses.asdict(cfg))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree) -> dict[str, np.ndarray]:
    """A dict tree (either package's) as {"a/b/c": numpy array}."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + (k,))
        else:
            out["/".join(prefix)] = np.asarray(
                t.detach().numpy() if isinstance(t, torch.Tensor) else t)

    walk(tree, ())
    return out


def assert_trees_close(got, want, rtol, atol):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def batch_of(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _j_value_and_grad(jmod):
    return jax.jit(jax.value_and_grad(jmod.loss_fn), static_argnums=(2, 3))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(family, remat):
    jmod, mod, jcfg = FAMILIES[family]
    jparams = jmod.init_params(jax.random.key(0), jcfg)
    batch = batch_of(jcfg, (2, 17), 1)
    jloss, jgrads = _j_value_and_grad(jmod)(jparams, jnp.asarray(batch),
                                            jcfg, remat)
    cfg = port_cfg(mod, jcfg)
    params = mod.params_from_jax(to_np(jparams))
    loss, grads = training.value_and_grad(
        mod.loss_fn, params, torch.from_numpy(batch).long(), cfg, remat)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    assert_trees_close(grads, to_np(jgrads), RTOL, ATOL)


@pytest.mark.parametrize("family", ["gpt2", "llama", "moe"])
def test_sgd_train_step_matches_reference(family):
    jmod, mod, jcfg = FAMILIES[family]
    jparams = jmod.init_params(jax.random.key(1), jcfg)
    batch = batch_of(jcfg, (2, 9), 2)
    jnew, jloss = jax.jit(jmod.train_step, static_argnums=(2,))(
        jparams, jnp.asarray(batch), jcfg)
    params = mod.params_from_jax(to_np(jparams))
    before = flat(params)
    new, loss = mod.train_step(params, torch.from_numpy(batch).long(),
                               port_cfg(mod, jcfg))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert_trees_close(new, to_np(jnew), RTOL, ATOL)
    assert all(np.array_equal(before[k], v)  # functional, as the reference
               for k, v in flat(params).items())


@pytest.mark.parametrize("family", ["gpt2", "llama_attn_bias", "moe"])
def test_decay_mask_matches_reference(family):
    jmod, mod, jcfg = FAMILIES[family]
    jparams = jmod.init_params(jax.random.key(2), jcfg)
    want = flat(j_training.decay_mask(jparams))
    got = flat(training.decay_mask(mod.params_from_jax(to_np(jparams))))
    assert {k: bool(v) for k, v in got.items()} == \
        {k: bool(v) for k, v in want.items()}
    assert not got["ln_f/g"] and got["wte"]


@pytest.mark.parametrize("lr,warmup,total", [
    (1e-4, 1, 1000), (3e-4, 100, 10_000), (1e-2, 2, 100), (1e-3, 0, 10),
    (1e-3, 7, 8)])
def test_schedule_matches_optax(lr, warmup, total):
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=warmup,
        decay_steps=total)
    counts = sorted({*range(0, min(total, 64)), warmup, total - 1, total,
                     total + 5})
    got = np.array([training.warmup_cosine(c, lr, warmup, total)
                    for c in counts], np.float32)
    want = np.array([float(sched(c)) for c in counts], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    if warmup:
        assert got[0] == 0.0  # the first step's rate is init_value


def quadratic_loss(params, batch, backend):
    """0.5 Σ (p - t)² + Σ c·p over the tree: its gradient, p - t + c, is
    elementwise, so both packages see the same bits. ``batch`` holds the
    targets and the linear terms, a tree each."""
    targets, lin = batch
    xp = jnp if backend == "jax" else torch
    total = 0.0
    for p, t, c in zip(*(jax.tree.leaves(x) if backend == "jax"
                         else tree_leaves(x)
                         for x in (params, targets, lin))):
        total = total + 0.5 * xp.sum((p - t) ** 2) + xp.sum(c * p)
    return total


def _quadratic_case(scale, seed):
    jcfg = j_llama.LlamaConfig.tiny(attn_bias=True)
    jparams = to_np(j_llama.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    targets = jax.tree.map(lambda p: (p + rng.normal(
        0, scale, p.shape)).astype(np.float32), jparams)
    lin = jax.tree.map(lambda p: rng.normal(
        0, scale / 10, p.shape).astype(np.float32), jparams)
    return jparams, (targets, lin)


def _run_both(jparams, batch, steps, tx_kw, carry_after=0):
    """k AdamW steps on each side; with ``carry_after`` the port takes
    the reference's state (params and optax's mu/nu) after that many of
    the reference's steps and continues from it."""
    tx = j_training.adamw(**tx_kw)
    jstep = jax.jit(j_training.make_train_step(
        tx, lambda p, b: quadratic_loss(p, b, "jax")))
    jstate = j_training.create_state(jax.tree.map(jnp.asarray, jparams), tx)
    ttx = training.adamw(**tx_kw)
    tstep = training.make_train_step(
        ttx, lambda p, b: quadratic_loss(p, b, "torch"))
    tbatch = tuple(llama.params_from_jax(x) for x in batch)
    jbatch = jax.tree.map(jnp.asarray, batch)
    state = training.create_state(llama.params_from_jax(jparams), ttx)
    jlosses, losses = [], []
    for k in range(steps):
        if carry_after and k == carry_after:
            adam = jstate.opt_state[1][0]
            state = training.TrainState(
                int(jstate.step), llama.params_from_jax(
                    to_np(jstate.params)),
                training.opt_state_from_jax(adam.count, to_np(adam.mu),
                                            to_np(adam.nu)))
        jstate, jloss = jstep(jstate, jbatch)
        jlosses.append(float(jloss))
        state, loss = tstep(state, tbatch)
        losses.append(float(loss))
    return jstate, state, jlosses, losses


@pytest.mark.parametrize("clip_norm,clipped", [(50.0, False), (1.0, True)],
                         ids=["below_clip", "clip_triggers"])
def test_adamw_steps_match_optax(clip_norm, clipped):
    jparams, batch = _quadratic_case(0.02, 3)
    norm = math.sqrt(sum(float(np.sum((p - t + c) ** 2)) for p, t, c in zip(
        *(jax.tree.leaves(x) for x in (jparams, *batch)))))
    assert (norm >= clip_norm) == clipped, norm  # ~6.6 at the first step
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20, clip_norm=clip_norm)
    jstate, state, jlosses, losses = _run_both(jparams, batch, 5, kw)
    assert state.step == int(jstate.step) == 5
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    assert_trees_close(state.params, to_np(jstate.params), 0, 1e-6)
    adam = jstate.opt_state[1][0]
    assert state.opt_state.count == int(adam.count)
    assert_trees_close(state.opt_state.mu, to_np(adam.mu), 0, 1e-6)
    assert_trees_close(state.opt_state.nu, to_np(adam.nu), 0, 1e-6)


def test_adamw_continues_a_reference_state():
    """Two optax steps, then the port continues from the reference's
    params and moments: the next three steps equal optax's."""
    jparams, batch = _quadratic_case(0.5, 4)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, clip_norm=5.0)
    jstate, state, jlosses, losses = _run_both(jparams, batch, 5, kw,
                                               carry_after=2)
    np.testing.assert_allclose(losses[2:], jlosses[2:], rtol=1e-6)
    assert state.step == 5 and state.opt_state.count == 5
    assert_trees_close(state.params, to_np(jstate.params), 0, 1e-6)


def test_adamw_llama_steps_match_optax():
    """Through Llama tiny's own loss: the losses within 1e-5, the params
    within 1e-5 (Adam's eps-scale gradients, see the module docstring)."""
    jcfg = j_llama.LlamaConfig.tiny()
    jparams = j_llama.init_params(jax.random.key(1), jcfg)
    batch = batch_of(jcfg, (4, 17), 1)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    tx = j_training.adamw(**kw)
    jstep = j_training.make_train_step(
        tx, functools.partial(j_llama.loss_fn, cfg=jcfg))
    jstate = j_training.create_state(jax.tree.map(jnp.array, jparams), tx)
    ttx = training.adamw(**kw)
    step = training.make_train_step(
        ttx, functools.partial(llama.loss_fn, cfg=port_cfg(llama, jcfg)))
    state = training.create_state(llama.params_from_jax(to_np(jparams)),
                                  ttx)
    for _ in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(batch))
        state, loss = step(state, torch.from_numpy(batch).long())
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_trees_close(state.params, to_np(jstate.params), 0, 1e-5)


def test_loss_decreases_overfitting_one_batch():
    """tests/test_training.py's case: 15 AdamW steps on one batch take
    the loss below 0.7 of its first value."""
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    batch = torch.from_numpy(batch_of(cfg, (4, 17), 0)).long()
    tx = training.adamw(lr=1e-2, warmup_steps=2, total_steps=100)
    step = training.make_train_step(
        tx, functools.partial(llama.loss_fn, cfg=cfg))
    state = training.create_state(params, tx)
    first = None
    for _ in range(15):
        state, loss = step(state, batch)
        first = float(loss) if first is None else first
    assert state.step == 15
    assert float(loss) < first * 0.7, (first, float(loss))


def test_composes_with_all_families():
    """Mirror of tests/test_training.py's slow case: one AdamW step of
    each family from its own init, finite, a TrainState back."""
    tx = training.adamw(warmup_steps=1, total_steps=10)
    for mod, cfg in ((gpt2, gpt2.GPT2Config.tiny()),
                     (llama, llama.LlamaConfig.tiny()),
                     (moe, moe.MoEConfig.tiny())):
        params = mod.init_params(torch.Generator().manual_seed(2), cfg,
                                 device="cpu")
        batch = torch.from_numpy(batch_of(cfg, (2, 9), 1)).long()
        step = training.make_train_step(
            tx, functools.partial(mod.loss_fn, cfg=cfg))
        state, loss = step(training.create_state(params, tx), batch)
        assert math.isfinite(float(loss)), mod.__name__
        assert isinstance(state, training.TrainState) and state.step == 1


@pytest.mark.parametrize("family", ["gpt2", "llama_attn_bias", "moe"])
def test_init_params_shapes_dtypes_scales(family):
    """Shapes and dtypes are the reference's; each leaf's spread is its
    scale (0.02; ``wpe`` 0.01; the output projections 0.02/sqrt(2L)),
    norm gains are ones and biases zeros. The draws themselves differ
    (``torch.Generator``, not ``jax.random``)."""
    jmod, mod, jcfg = FAMILIES[family]
    jcfg = dataclasses.replace(jcfg, n_layer=4)
    want = flat(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda: jmod.init_params(jax.random.key(0), jcfg))))
    params = mod.init_params(torch.Generator().manual_seed(0),
                             port_cfg(mod, jcfg), device="cpu")
    got = flat(params)
    assert sorted(got) == sorted(want)
    out_scale = 0.02 / math.sqrt(2 * jcfg.n_layer)
    for name, arr in got.items():
        assert arr.shape == want[name].shape and arr.dtype == np.float32
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("g",):
            assert np.all(arr == 1.0), name
        elif leaf == "b" or leaf.endswith("_b"):
            assert np.all(arr == 0.0), name
        else:
            scale = (0.01 if name == "wpe" else out_scale
                     if name.endswith(("attn/o_w", "attn/proj_w",
                                       "mlp/proj_w", "down_w", "moe/w2"))
                     else 0.02)
            assert abs(arr.std() / scale - 1) < 0.05, (name, arr.std())
            assert abs(arr.mean()) < 0.1 * scale, name
    again = mod.init_params(torch.Generator().manual_seed(0),
                            port_cfg(mod, jcfg), device="cpu")
    assert all(np.array_equal(v, flat(again)[k]) for k, v in got.items())


def test_inference_trees_are_copied_out_for_training():
    """A tree made under inference mode cannot be saved for backward:
    ``value_and_grad`` refuses it with a clear error, ``create_state``
    copies it out once, and ``forward`` keeps inference mode."""
    cfg = llama.LlamaConfig.tiny()
    with torch.inference_mode():
        params = llama.init_params(torch.Generator().manual_seed(3), cfg,
                                  device="cpu")
    batch = torch.from_numpy(batch_of(cfg, (2, 9), 3)).long()
    with pytest.raises(ValueError, match="inference_mode"):
        training.value_and_grad(llama.loss_fn, params, batch, cfg)
    tx = training.adamw(warmup_steps=0, total_steps=10)
    state = training.create_state(params, tx)
    assert not any(t.is_inference() for t in tree_leaves(state.params))
    state, loss = training.make_train_step(
        tx, functools.partial(llama.loss_fn, cfg=cfg))(state, batch)
    assert math.isfinite(float(loss))
    logits = llama.forward(state.params, batch[:, :-1], cfg)
    assert logits.is_inference()
    np.testing.assert_array_equal(
        logits.numpy(), llama._forward(state.params, batch[:, :-1],
                                       cfg).detach().numpy())


def test_init_params_default_to_cuda_and_raise():
    """``init_params`` makes a tree on ``cuda`` unless asked for the
    CPU, and raises without a card, as every entry point of the port."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no CUDA device")
    for mod, cfg in ((gpt2, gpt2.GPT2Config.tiny()),
                     (llama, llama.LlamaConfig.tiny()),
                     (moe, moe.MoEConfig.tiny())):
        with pytest.raises(RuntimeError, match="cuda"):
            mod.init_params(torch.Generator().manual_seed(0), cfg)
