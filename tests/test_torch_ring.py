"""The port's ring attention and Llama's context parallelism, on the CPU.

Ring attention over a ``["cpu"] * n`` slot mesh against plain dense
attention and against the JAX package's ``ring_attention`` on its
8-device virtual mesh (tests/conftest.py): causal and not, GQA, every
head its own kv head, a 4-slot ring with one kv head in bf16, and the
gradients (the reverse ring) against dense gradients, with no NaN from
the blocks that causality masks whole. Mirrors tests/test_ring.py,
its slow cases unmarked.

Llama's ``cp_forward`` / ``cp_train_step`` over ``{"data": 2, "seq": 4}``
on ``["cpu"] * 8`` against the port's ``forward`` / ``train_step`` and
the reference's ``cp_train_step`` on the same mesh shape; a ``model`` axis
that the FFN columns do not divide over raises ``MeshUnsupported``.

Tolerances, float32: attention within atol/rtol 1e-5 (1e-4 rtol on the
gradients, as tests/test_ring.py); bf16 inputs 3e-2; the context-parallel
loss within 1e-5 of the single-device one (the VERIFY skill's bar) and
the updated params within 1e-5.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from zest_tpu.models import llama as j_llama
from zest_tpu.parallel.ring import ring_attention as j_ring_attention
from zest_tpu_torch.models import llama
from zest_tpu_torch.models.training import tree_paths
from zest_tpu_torch.parallel.mesh import model_mesh
from zest_tpu_torch.parallel.ring import ring_attention, ring_self_attention
from zest_tpu_torch.parallel.sharding import MeshUnsupported


def dense_reference(q, k, v, causal):
    """Straightforward float32 attention over (B, T, H, D), GQA repeat."""
    B, T, H, D = q.shape
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    scores = qf @ kf.transpose(-1, -2) / math.sqrt(D)
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    return (torch.softmax(scores, -1) @ vf).transpose(1, 2).to(q.dtype)


def make_qkv(seed=0, B=2, T=32, H=4, Hkv=2, D=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))


def seq_mesh(n=8):
    return model_mesh({"seq": n}, ["cpu"] * n)


def j_seq_mesh(n=8):
    return Mesh(np.asarray(jax.devices()[:n]), ("seq",))


@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_dense_and_reference(causal, heads):
    H, Hkv = heads
    arrays = make_qkv(seed=3 + Hkv, H=H, Hkv=Hkv)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = ring_attention(q, k, v, seq_mesh(), causal=causal)
    np.testing.assert_allclose(got.numpy(),
                               dense_reference(q, k, v, causal).numpy(),
                               atol=1e-5, rtol=1e-5)
    want = j_ring_attention(*(jnp.asarray(a) for a in arrays), j_seq_mesh(),
                            causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_ring_smaller_axis_one_kv_head_bf16():
    """4 slots, 1 kv head, bf16 inputs (float32 inside), as
    tests/test_ring.py's slow case."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in make_qkv(seed=5, T=16, H=4, Hkv=1, D=16))
    got = ring_attention(q, k, v, seq_mesh(4), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), dense_reference(q, k, v, True).float().numpy(),
        atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_gradients_match_dense_without_nan(causal):
    """The reverse ring (autograd through the rotations' ``.to``) gives
    the dense gradients; causal slot 0 folds three wholly masked blocks
    (each block's max is -inf), and no NaN reaches a gradient."""
    arrays = make_qkv(seed=7, T=16)

    def grads(fn):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
        (fn(q, k, v) ** 2).sum().backward()
        return [t.grad for t in (q, k, v)]

    mesh = seq_mesh(4)
    g_ring = grads(lambda q, k, v: ring_attention(q, k, v, mesh,
                                                  causal=causal))
    g_dense = grads(lambda q, k, v: dense_reference(q, k, v, causal))
    for gr, gd in zip(g_ring, g_dense):
        assert not torch.isnan(gr).any()
        np.testing.assert_allclose(gr.numpy(), gd.numpy(), atol=1e-5,
                                   rtol=1e-4)


def test_ring_rejects_bad_head_ratio_and_uneven_sequence():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(H=4, Hkv=3))
    with pytest.raises(ValueError, match="multiple"):
        ring_self_attention(list(q.chunk(4, 1)), list(k.chunk(4, 1)),
                            list(v.chunk(4, 1)))
    q, k, v = (torch.from_numpy(a) for a in make_qkv(T=30))
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(q, k, v, seq_mesh(4))


def test_ring_blocks_stay_on_their_slots():
    """ring_self_attention returns each slot's block in its query's
    dtype, shape and device."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(T=16))
    outs = ring_self_attention(list(q.chunk(4, 1)), list(k.chunk(4, 1)),
                               list(v.chunk(4, 1)))
    assert [tuple(o.shape) for o in outs] == [(2, 4, 4, 8)] * 4
    assert all(o.device.type == "cpu" and o.dtype == q.dtype for o in outs)


# ── Llama context parallelism ──


def _cp_case(seed, **over):
    jcfg = j_llama.LlamaConfig.tiny(**over)
    jparams = j_llama.init_params(jax.random.key(seed), jcfg)
    batch = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (4, 33)).astype(np.int32)
    cfg = llama.LlamaConfig(**dataclasses.asdict(jcfg))
    params = llama.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, params, batch


def cp_mesh():
    return model_mesh({"data": 2, "seq": 4}, ["cpu"] * 8)


def test_cp_forward_matches_forward():
    _, _, cfg, params, batch = _cp_case(0, n_layer=3)
    ids = torch.from_numpy(batch[:, :-1]).long()
    got = llama.cp_forward(params, ids, cfg, cp_mesh())
    np.testing.assert_allclose(got.detach().numpy(),
                               llama.forward(params, ids, cfg).numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("over", [{}, {"attn_bias": True, "o_bias": True},
                                  {"tie_embeddings": True}],
                         ids=["untied", "attn_bias", "tied"])
def test_cp_train_step_matches_train_step_and_reference(over):
    jcfg, jparams, cfg, params, batch = _cp_case(1, **over)
    tbatch = torch.from_numpy(batch).long()
    want, loss = llama.train_step(params, tbatch, cfg)
    got, cp_loss = llama.cp_train_step(params, tbatch, cfg, cp_mesh())
    assert abs(float(cp_loss) - float(loss)) <= 1e-5
    jmesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "seq"))
    jnew, jloss = jax.jit(j_llama.cp_train_step, static_argnums=(2, 3))(
        jparams, jnp.asarray(batch), jcfg, jmesh)
    assert abs(float(cp_loss) - float(jloss)) <= 1e-5
    jflat = dict(tree_paths(jax.tree.map(np.asarray, jnew)))
    mine = dict(tree_paths(want))
    for path, t in tree_paths(got):
        np.testing.assert_allclose(t.numpy(), mine[path].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=str(path))
        np.testing.assert_allclose(t.numpy(), jflat[path], atol=1e-5,
                                   rtol=1e-5, err_msg=str(path))


def test_cp_remat_equals_plain_and_model_axis_raises():
    _, _, cfg, params, batch = _cp_case(2)
    tbatch = torch.from_numpy(batch).long()
    plain, loss = llama.cp_train_step(params, tbatch, cfg, cp_mesh())
    remat, rloss = llama.cp_train_step(params, tbatch, cfg, cp_mesh(),
                                       remat=True)
    assert torch.equal(loss, rloss)
    for (path, a), (_, b) in zip(tree_paths(plain), tree_paths(remat)):
        assert torch.equal(a, b), path
    # TP×CP runs (tests/test_torch_sharded_training.py holds it to the
    # dense step); a model axis its FFN columns do not divide over raises.
    tp_cp = model_mesh({"seq": 2, "model": 3}, ["cpu"] * 6)
    with pytest.raises(MeshUnsupported, match="'model' axis"):
        llama.cp_train_step(params, tbatch, cfg, tp_cp)
    with pytest.raises(ValueError, match="divide"):
        llama.cp_forward(params, tbatch[:, :30], cfg, cp_mesh())


def test_cp_loss_equals_reference_cp_loss():
    jcfg, jparams, cfg, params, batch = _cp_case(3)
    jmesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "seq"))
    inputs, targets = batch[:, :-1], batch[:, 1:]
    want = jax.jit(functools.partial(j_llama.cp_loss_fn, cfg=jcfg,
                                     mesh=jmesh))(jparams, inputs, targets)
    got = llama.cp_loss_fn(params, torch.from_numpy(inputs).long(),
                           torch.from_numpy(targets).long(), cfg, cp_mesh())
    assert abs(float(got) - float(want)) <= 1e-5
