"""Training on a tree sharded over a slot mesh, against the JAX package's
GSPMD-sharded training, on the CPU.

Mirrors the reference's sharded-training tests on ``["cpu"] * 8`` slot
meshes (its 8-device virtual mesh, tests/conftest.py):

- tests/test_training.py ``test_opt_state_inherits_param_sharding`` and
  ``test_sharded_step_matches_unsharded`` on ``{"data": 2, "model": 4}``:
  ``create_state`` gives the moments each parameter's spec, and an AdamW
  step on the sharded state with the batch cut over ``data`` equals the
  unsharded step; a clip-active case (``clip_norm`` 1e-3) pins the global
  norm that counts each element once (the replicas do not count again);
  the data replicas are bit-equal after every step;
- tests/test_llama.py ``test_tp_train_step_matches_single_device``,
  ``test_cp_tp_train_step_matches_dense`` (slow there; held here in a
  smaller case, against the dense step) and
  ``test_cp_tp_forward_tied_embeddings`` on ``{"data": 2, "seq": 2,
  "model": 2}``;
- tests/test_moe.py ``test_train_step_on_data_expert_mesh`` on
  ``{"data": 2, "expert": 4}``, also held to the unsharded step;
- a sharded train-state checkpoint round trip (the files equal the
  gathered state's; the restore lays each array out under its spec and
  continues bit-equal) and the sharded export, byte-equal to the export
  of the gathered tree;
- the training tree of a mesh landing (``params_from_hf``, which takes no
  ``train=`` flag) equals ``shard_tree`` of the unsharded tree shard for
  shard, and the ``TPParams`` decode tree is built from it;
- GPT-2's sharded step over ``{"data": 2, "model": 4}`` against the
  reference's GSPMD step on its 8 virtual devices (loss 1e-6, params
  1e-5), and a sharded GPT-2 train state saved and exported equal to the
  gathered one (the export read back through ``params_from_hf``).

Tolerances (the reference tests'): the sharded loss within 1e-6 of the
unsharded one and 1e-5 of the reference's; SGD-updated params 1e-5 abs /
1e-4 rel; forwards 1e-4. AdamW params are held to 1e-5, for the reason
tests/test_torch_training.py gives (Adam's g / (|g| + eps) near eps).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from tests.fixtures import llama_checkpoint_files
from zest_tpu.models import gpt2 as j_gpt2
from zest_tpu.models import llama as j_llama
from zest_tpu.models import moe as j_moe
from zest_tpu.models import training as j_training
from zest_tpu_torch.models import gpt2, llama, loader, moe, training
from zest_tpu_torch.models import tensor_parallel as tp
from zest_tpu_torch.models.checkpoint import (export_hf_safetensors,
                                              restore_train_state,
                                              save_train_state)
from zest_tpu_torch.models.training import tree_leaves, tree_paths
from zest_tpu_torch.parallel.mesh import model_mesh
from zest_tpu_torch.parallel.ring import ring_self_attention
from zest_tpu_torch.parallel.sharding import (P, ShardedTensor, shard_tree,
                                              sum_replicas)

DM = {"data": 2, "model": 4}
CONFIGS = {"tiny": {}, "heads8": {"n_head": 8, "n_kv_head": 4}}


def _mesh(axes):
    return model_mesh(axes, ["cpu"] * math.prod(axes.values()))


def _jmesh(axes):
    return Mesh(np.asarray(jax.devices()).reshape(*axes.values()),
                tuple(axes))


def _case(seed, mod=llama, jmod=j_llama, cfg_cls="LlamaConfig", **over):
    """The reference's tiny config, its init params, and the same tree and
    config in the port."""
    jcfg = getattr(jmod, cfg_cls).tiny(**over)
    jparams = jmod.init_params(jax.random.key(seed), jcfg)
    cfg = getattr(mod, cfg_cls)(**dataclasses.asdict(jcfg))
    params = mod.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, params


def _batch(seed, vocab, shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _clone(tree):
    return training.tree_map(lambda t: t.clone(), tree)


def _full(tree):
    return training.tree_map(
        lambda t: t.full() if isinstance(t, ShardedTensor) else t, tree)


def _assert_replicas_equal(tree):
    for path, t in tree_paths(tree):
        for group in t.replica_groups():
            for slot in group[1:]:
                assert torch.equal(t.shards[group[0]], t.shards[slot]), \
                    (path, group)


def _assert_close(got, want, atol, rtol):
    want = dict(tree_paths(want))
    for path, t in tree_paths(got):
        w = want[path]
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_allclose(t.detach().numpy(), w, atol=atol,
                                   rtol=rtol, err_msg="/".join(path))


def _jax_state_mu(state):
    def find(s):
        if hasattr(s, "mu"):
            return s.mu
        if isinstance(s, (tuple, list)):
            for inner in s:
                found = find(inner)
                if found is not None:
                    return found
        return None
    return find(state.opt_state)


def test_opt_state_inherits_param_sharding():
    """The moments take each parameter's mesh and spec, shard for shard,
    as the reference's take each ``NamedSharding``."""
    jcfg, jparams, cfg, params = _case(3)
    specs = llama.param_specs(cfg)
    state = training.create_state(shard_tree(params, specs, _mesh(DM)),
                                  training.adamw())
    jsharded = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(_jmesh(DM), s)),
        jparams, j_llama.param_specs(jcfg),
        is_leaf=lambda v: isinstance(v, JP))
    jmu = _jax_state_mu(j_training.create_state(jsharded,
                                                j_training.adamw()))
    jspecs = dict(tree_paths(jax.tree.map(lambda a: a.sharding.spec, jmu)))
    for moment in (state.opt_state.mu, state.opt_state.nu):
        for (path, m), (_, p) in zip(tree_paths(moment),
                                     tree_paths(state.params)):
            assert isinstance(m, ShardedTensor), path
            assert m.spec == p.spec and m.mesh is p.mesh, path
            assert tuple(m.spec) == tuple(jspecs[path]), path
            assert set(m.shards) == set(p.shards)
            for s, t in m.shards.items():
                assert t.shape == p.shards[s].shape and not t.any(), path
    assert state.opt_state.mu["blocks"]["attn"]["q_w"].spec == \
        P(None, None, "model")


@pytest.mark.parametrize("clip", [1.0, 1e-3], ids=["clip_1", "clip_active"])
@pytest.mark.parametrize("over", list(CONFIGS.values()), ids=list(CONFIGS))
def test_sharded_step_matches_unsharded(over, clip):
    jcfg, jparams, cfg, params = _case(4, **over)
    batch = _batch(5, cfg.vocab_size, (4, 17))
    tx = training.adamw(lr=1e-3, warmup_steps=1, total_steps=10,
                        clip_norm=clip)
    step = training.make_train_step(tx, functools.partial(llama.loss_fn,
                                                          cfg=cfg))
    ref = training.create_state(_clone(params), tx)
    sharded = training.create_state(
        shard_tree(params, llama.param_specs(cfg), _mesh(DM)), tx)
    tb = torch.from_numpy(batch).long()
    jtx = j_training.adamw(lr=1e-3, warmup_steps=1, total_steps=10,
                           clip_norm=clip)
    jstep = j_training.make_train_step(
        jtx, functools.partial(j_llama.loss_fn, cfg=jcfg))
    jstate = j_training.create_state(jparams, jtx)
    for _ in range(2):  # the second step is the first with lr > 0
        ref, loss = step(ref, tb)
        sharded, s_loss = step(sharded, tb)
        jstate, j_loss = jstep(jstate, jnp.asarray(batch))
        np.testing.assert_allclose(float(s_loss), float(loss), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(float(s_loss), float(j_loss), atol=1e-5,
                                   rtol=1e-5)
        _assert_replicas_equal(sharded.params)
        _assert_replicas_equal(sharded.opt_state.mu)
        _assert_close(_full(sharded.params), ref.params, 1e-5, 1e-5)
        # The first moment after a step is (1 - b1) * the clipped
        # gradient: it shows the clip scale, so the global norm. Held to
        # 1e-5 of each leaf's largest magnitude (gradient sums in other
        # orders differ where they cancel).
        want_mu = dict(tree_paths(ref.opt_state.mu))
        for path, m in tree_paths(_full(sharded.opt_state.mu)):
            w = want_mu[path]
            assert float((m - w).abs().max()) <= 1e-5 * float(
                w.abs().max()), path
    assert sharded.step == 2 and sharded.opt_state.count == 2


def test_global_norm_counts_each_element_once():
    """The sharded gradients' global norm equals the unsharded one's,
    though wte is held by all eight slots and q_w twice over ``data``."""
    _, _, cfg, params = _case(6)
    batch = torch.from_numpy(_batch(7, cfg.vocab_size, (4, 17))).long()
    _, grads = training.value_and_grad(llama.loss_fn, params, batch, cfg)
    sharded = shard_tree(params, llama.param_specs(cfg), _mesh(DM))
    _, sgrads = training.value_and_grad(llama.loss_fn, sharded, batch, cfg)
    norm = math.sqrt(sum(float(training._square_sum(g))
                         for g in tree_leaves(grads)))
    snorm = math.sqrt(sum(float(training._square_sum(g))
                          for g in tree_leaves(sgrads)))
    assert abs(snorm - norm) <= 1e-6 * norm
    wte = sgrads["wte"]
    assert len(wte.shards) == 8 and wte.distinct_slots() == [0]
    dense = math.sqrt(sum(float((t.float() ** 2).sum())
                          for g in tree_leaves(sgrads)
                          for t in g.shards.values()))
    assert dense > 1.5 * norm  # what counting every replica would give


@pytest.mark.parametrize("over", list(CONFIGS.values()), ids=list(CONFIGS))
def test_tp_train_step_matches_single_device(over):
    jcfg, jparams, cfg, params = _case(0, **over)
    batch = _batch(1, cfg.vocab_size, (4, 18))
    j_new, j_loss = jax.jit(functools.partial(j_llama.train_step, cfg=jcfg))(
        jparams, jnp.asarray(batch))
    sharded = shard_tree(params, llama.param_specs(cfg), _mesh(DM))
    new, loss = llama.train_step(sharded, torch.from_numpy(batch).long(),
                                 cfg)
    np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(
        new["blocks"]["attn"]["q_w"].full().numpy(),
        np.asarray(j_new["blocks"]["attn"]["q_w"]), atol=1e-5, rtol=1e-4)
    _assert_close(_full(new), jax.tree.map(np.asarray, j_new), 1e-5, 1e-4)
    _assert_replicas_equal(new)
    assert new["blocks"]["mlp"]["down_w"].spec == P(None, "model", None)


@pytest.mark.parametrize("axes", [{"data": 2, "seq": 2, "model": 2},
                                  {"seq": 2, "model": 4}],
                         ids=["data2_seq2_model2", "seq2_model4"])
def test_cp_tp_train_step_matches_dense(axes):
    """TP×CP: Megatron cuts, local heads in the ring, the o/down sums on
    each model row's lead; the loss and ``down_w`` after one SGD step
    equal the dense step's (the reference holds its own to the same
    tolerances, slow-marked). Over ``{"model": 4}`` the two kv heads do
    not divide, so attention runs whole on each lead, as the sharded
    train step's does, and only the MLP and head are cut."""
    jcfg, jparams, cfg, params = _case(11)
    batch = _batch(12, cfg.vocab_size, (2, 17))
    mesh = _mesh(axes)
    tb = torch.from_numpy(batch).long()
    cp_new, cp_loss = llama.cp_train_step(params, tb, cfg, mesh)
    new, loss = llama.train_step(params, tb, cfg)
    j_new, j_loss = jax.jit(functools.partial(j_llama.train_step, cfg=jcfg))(
        jparams, jnp.asarray(batch))
    for want, want_loss in ((new, loss), (jax.tree.map(np.asarray, j_new),
                                          j_loss)):
        np.testing.assert_allclose(float(cp_loss), float(want_loss),
                                   atol=1e-5, rtol=1e-5)
        _assert_close({"d": cp_new["blocks"]["mlp"]["down_w"]},
                      {"d": want["blocks"]["mlp"]["down_w"]}, 1e-5, 1e-4)
        _assert_close(cp_new, want, 1e-5, 1e-4)


def test_cp_tp_forward_tied_embeddings():
    """TP×CP with a tied tree: the head stays replicated (full vocabulary
    out of each lead), attention and MLP cut over ``model``."""
    jcfg, jparams, cfg, params = _case(13, tie_embeddings=True)
    assert "lm_head" not in params
    ids = _batch(14, cfg.vocab_size, (2, 16))
    mesh = _mesh({"data": 2, "seq": 2, "model": 2})
    got = llama.cp_forward(params, torch.from_numpy(ids).long(), cfg, mesh)
    want = jax.jit(functools.partial(j_llama.forward, cfg=jcfg))(
        jparams, jnp.asarray(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        got.detach().numpy(),
        llama.forward(params, torch.from_numpy(ids).long(), cfg).numpy(),
        atol=1e-4, rtol=1e-4)


def test_ring_over_local_heads_on_a_data_seq_model_grid():
    """On a ``{data, seq, model}`` grid every ``(data, model)`` row of seq
    slots runs ``ring_self_attention`` over its rows of the batch and its
    local heads (whole GQA groups); joined, the rows give dense
    attention's output."""
    rng = np.random.default_rng(15)
    q = torch.from_numpy(rng.standard_normal((2, 16, 4, 8),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 8),
                                                 dtype=np.float32))
            for _ in range(2))
    mesh = _mesh({"data": 2, "seq": 2, "model": 2})
    rows = []
    for d in range(2):
        cols = []
        for m in range(2):
            devs = mesh.axis_devices("seq", {"data": d, "model": m})

            def cut(x, d=d, m=m, devs=devs):
                h = x.shape[2] // 2
                blk = x[d:d + 1, :, m * h:(m + 1) * h]
                return [b.to(dev) for b, dev in zip(blk.chunk(2, dim=1),
                                                    devs)]

            out = ring_self_attention(cut(q), cut(k), cut(v), causal=True)
            cols.append(torch.cat(out, dim=1))
        rows.append(torch.cat(cols, dim=2))
    got = torch.cat(rows, dim=0)
    kk, vv = (t.repeat_interleave(2, dim=2) for t in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(8)
    scores = scores.masked_fill(~torch.ones(16, 16, dtype=torch.bool).tril(),
                                float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), vv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("zeros", [True, False], ids=["zeros", "random"])
def test_train_step_on_data_expert_mesh(zeros):
    """Expert-parallel SGD on ``{data, expert}``: the whole batch routed as
    one group (capacity and aux loss as unsharded), each row's tokens run
    on the slots that own their experts; equal to the unsharded step and
    the reference's loss; each expert's gradient and update stay on its
    slot's shard."""
    jcfg, jparams, cfg, params = _case(0, moe, j_moe, "MoEConfig",
                                       n_experts=8, top_k=2)
    batch = (np.zeros((4, 17), np.int32) if zeros
             else _batch(16, cfg.vocab_size, (4, 17)))
    tb = torch.from_numpy(batch).long()
    mesh = _mesh({"data": 2, "expert": 4})
    sharded = shard_tree(params, moe.param_specs(cfg), mesh)
    new, loss = moe.train_step(sharded, tb, cfg)
    dense, d_loss = moe.train_step(params, tb, cfg)
    _, j_loss = jax.jit(functools.partial(j_moe.train_step, cfg=jcfg))(
        jparams, jnp.asarray(batch))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(d_loss), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-5,
                               rtol=1e-5)
    _assert_close(_full(new), dense, 1e-5, 1e-4)
    _assert_replicas_equal(new)
    w2, w2_0 = new["blocks"]["moe"]["w2"], sharded["blocks"]["moe"]["w2"]
    assert float((w2.full() - w2_0.full()).abs().max()) > 0
    for slot, t in w2.shards.items():
        assert t.shape[1] == 2, slot  # the slot's two experts only
        x0 = mesh.coords(slot)["expert"] * 2
        np.testing.assert_allclose(
            t.numpy(), dense["blocks"]["moe"]["w2"][:, x0:x0 + 2].numpy(),
            atol=1e-5, rtol=1e-4)


def test_shard_grads_and_replica_sums():
    """Each shard carries ``requires_grad`` and a ``.grad`` (zeros where
    the forward read no replica); ``sum_replicas`` of those gradients is
    the global gradient on every replica."""
    mesh = _mesh(DM)
    st = shard_tree({"w": torch.arange(32.0).reshape(4, 8)},
                    {"w": P(None, "model")}, mesh)["w"].requires_grad_()
    assert st.grad is None
    rows = [torch.cat([st.shards[s] for s in range(r * 4, r * 4 + 4)], 1)
            for r in range(2)]
    (rows[0] * 2.0).sum().backward()
    g = st.grad
    for slot, t in g.shards.items():
        assert torch.equal(t, torch.full((4, 2), 2.0 if slot < 4 else 0.0))
    summed = sum_replicas(g)
    assert all(torch.equal(t, torch.full((4, 2), 2.0))
               for t in summed.shards.values())
    assert summed.spec == st.spec and len(summed.replica_groups()) == 4


def test_sum_replicas_gives_every_replica_the_sum():
    mesh = _mesh(DM)
    st = shard_tree({"w": torch.zeros(4, 8)}, {"w": P(None, "model")},
                    mesh)["w"]
    for slot, t in st.shards.items():
        t.fill_(slot + 1.0)
    out = sum_replicas(st)
    for slot, t in out.shards.items():
        m = mesh.coords(slot)["model"]
        assert torch.equal(t, torch.full((4, 2), float(m + 1 + m + 5)))
        assert t.data_ptr() != st.shards[slot].data_ptr()


def test_sharded_train_state_round_trip(tmp_path):
    """``save_train_state`` of a sharded state writes each leaf gathered
    once: its arrays file equals the gathered state's byte for byte;
    ``restore_train_state`` lays every array out under the template's
    spec, and two more steps equal an uninterrupted run bit for bit."""
    _, _, cfg, params = _case(17, n_head=8, n_kv_head=4)
    batch = torch.from_numpy(_batch(18, cfg.vocab_size, (4, 17))).long()
    tx = training.adamw(lr=1e-3, warmup_steps=1, total_steps=10)
    step = training.make_train_step(tx, functools.partial(llama.loss_fn,
                                                          cfg=cfg))
    specs, mesh = llama.param_specs(cfg), _mesh(DM)

    def fresh():
        return training.create_state(shard_tree(params, specs, mesh), tx)

    whole = fresh()
    for _ in range(4):
        whole, _ = step(whole, batch)
    part = fresh()
    for _ in range(2):
        part, _ = step(part, batch)
    save_train_state(tmp_path / "sharded", part)
    gathered = training.TrainState(part.step, _full(part.params),
                                   training.AdamWState(
                                       part.opt_state.count,
                                       _full(part.opt_state.mu),
                                       _full(part.opt_state.nu)))
    save_train_state(tmp_path / "gathered", gathered)
    assert (tmp_path / "sharded" / "arrays.safetensors").read_bytes() == \
        (tmp_path / "gathered" / "arrays.safetensors").read_bytes()
    back = restore_train_state(tmp_path / "sharded", fresh())
    assert back.step == 2 and back.opt_state.count == 2
    for (path, a), (_, b) in zip(tree_paths(back.params),
                                 tree_paths(part.params)):
        assert a.spec == b.spec and set(a.shards) == set(b.shards), path
        for s in a.shards:
            assert torch.equal(a.shards[s], b.shards[s]), (path, s)
    for _ in range(2):
        back, _ = step(back, batch)
    for tree in ("params", "mu", "nu"):
        got = back.params if tree == "params" else getattr(back.opt_state,
                                                           tree)
        want = whole.params if tree == "params" else getattr(
            whole.opt_state, tree)
        for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
            for s in a.shards:
                assert torch.equal(a.shards[s], b.shards[s]), (tree, path)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_sharded_export_equals_gathered_export(tmp_path, tied):
    _, _, cfg, params = _case(19, tie_embeddings=tied)
    sharded = shard_tree(params, llama.param_specs(cfg), _mesh(DM))
    export_hf_safetensors(tmp_path / "s.safetensors", sharded, cfg)
    export_hf_safetensors(tmp_path / "g.safetensors", _full(sharded), cfg)
    export_hf_safetensors(tmp_path / "p.safetensors", params, cfg)
    data = (tmp_path / "s.safetensors").read_bytes()
    assert data == (tmp_path / "g.safetensors").read_bytes() == \
        (tmp_path / "p.safetensors").read_bytes()


def test_training_tree_of_a_mesh_landing(tmp_path):
    """``params_from_hf`` of a landing over ``{data, model}`` (no
    ``train=`` flag) equals ``shard_tree`` of the unsharded tree, shard
    for shard (slot-local where the landing cut a tensor as
    ``param_specs`` wants it, gathered where not: the embedding and the
    norms), and it trains; the ``TPParams`` decode tree is built from
    it."""
    files = llama_checkpoint_files(seed=21)
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    cfg = llama.LlamaConfig.from_hf(json.loads(files["config.json"]))
    mesh = _mesh({"data": 2, "model": 2})
    landed = loader.load_checkpoint(tmp_path, mesh=mesh,
                                    rules=llama.checkpoint_shard_rules())
    plain = llama.params_from_hf(loader.load_checkpoint(tmp_path, "cpu"),
                                 cfg)
    tree = llama.params_from_hf(landed, cfg)
    want = shard_tree(plain, llama.param_specs(cfg), mesh)
    for (path, a), (_, b) in zip(tree_paths(tree), tree_paths(want)):
        assert a.spec == b.spec and a.shape == b.shape, path
        for s in a.shards:
            assert torch.equal(a.shards[s], b.shards[s]), (path, s)
    assert landed["model.layers.0.self_attn.q_proj.weight"].spec == \
        P("model", None)
    batch = torch.from_numpy(_batch(22, cfg.vocab_size, (2, 9))).long()
    np.testing.assert_allclose(float(llama.loss_fn(tree, batch, cfg)),
                               float(llama.loss_fn(plain, batch, cfg)),
                               atol=1e-6, rtol=1e-6)
    dec = tp.decode_params(tree, cfg)
    assert isinstance(dec, tp.TPParams)
    q_w = tree["blocks"]["attn"]["q_w"]
    assert dec.local[0]["attn"]["q_w"].data_ptr() == \
        q_w.shard(dec.group.slots[0]).data_ptr()


def _gpt2_case(seed):
    jcfg = j_gpt2.GPT2Config.tiny()
    jparams = j_gpt2.init_params(jax.random.key(seed), jcfg)
    cfg = gpt2.GPT2Config(**dataclasses.asdict(jcfg))
    return jcfg, jparams, cfg, gpt2.params_from_jax(
        jax.tree.map(np.asarray, jparams))


def test_gpt2_sharded_step_matches_gspmd_reference():
    """Two AdamW steps on GPT-2's tree laid out by ``gpt2.param_specs``
    over ``{"data": 2, "model": 4}`` (the q|k|v blocks joined on each
    row's lead, the MLP split) against the reference's GSPMD step on the
    same layout of its 8 virtual devices and the port's unsharded step."""
    jcfg, jparams, cfg, params = _gpt2_case(41)
    batch = _batch(42, cfg.vocab_size, (4, 17))
    tx = training.adamw(lr=1e-3, warmup_steps=1, total_steps=10)
    step = training.make_train_step(tx, functools.partial(gpt2.loss_fn,
                                                          cfg=cfg))
    ref = training.create_state(_clone(params), tx)
    sharded = training.create_state(
        shard_tree(params, gpt2.param_specs(cfg), _mesh(DM)), tx)
    jtx = j_training.adamw(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = j_training.make_train_step(
        jtx, functools.partial(j_gpt2.loss_fn, cfg=jcfg))
    jmesh = _jmesh(DM)
    jstate = j_training.create_state(jax.tree.map(
        lambda x, sp: jax.device_put(x, NamedSharding(jmesh, sp)),
        jparams, j_gpt2.param_specs(jcfg),
        is_leaf=lambda v: isinstance(v, JP)), jtx)
    jbatch = jax.device_put(jnp.asarray(batch),
                            NamedSharding(jmesh, JP("data", None)))
    tb = torch.from_numpy(batch).long()
    for _ in range(2):
        ref, loss = step(ref, tb)
        sharded, s_loss = step(sharded, tb)
        jstate, j_loss = jstep(jstate, jbatch)
        np.testing.assert_allclose(float(s_loss), float(j_loss), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(float(s_loss), float(loss), atol=1e-6,
                                   rtol=1e-6)
        _assert_replicas_equal(sharded.params)
        _assert_close(_full(sharded.params),
                      jax.tree.map(np.asarray, jstate.params), 1e-5, 0)
        _assert_close(_full(sharded.params), ref.params, 1e-5, 0)
    assert sharded.params["blocks"]["attn"]["qkv_w"].spec == \
        P(None, None, "model")


def test_sharded_gpt2_state_saves_and_exports_as_the_gathered_one(tmp_path):
    """A sharded GPT-2 train state saves byte-equal to the gathered state
    and restores under the template's specs; its export equals the
    gathered tree's and the unsharded tree's, and reads back through
    ``params_from_hf`` leaf for leaf."""
    _, _, cfg, params = _gpt2_case(43)
    batch = torch.from_numpy(_batch(44, cfg.vocab_size, (4, 17))).long()
    tx = training.adamw(lr=1e-3, warmup_steps=1, total_steps=10)
    step = training.make_train_step(tx, functools.partial(gpt2.loss_fn,
                                                          cfg=cfg))
    specs, mesh = gpt2.param_specs(cfg), _mesh(DM)
    state = training.create_state(shard_tree(params, specs, mesh), tx)
    for _ in range(2):
        state, _ = step(state, batch)
    save_train_state(tmp_path / "sharded", state)
    gathered = training.TrainState(state.step, _full(state.params),
                                   training.AdamWState(
                                       state.opt_state.count,
                                       _full(state.opt_state.mu),
                                       _full(state.opt_state.nu)))
    save_train_state(tmp_path / "gathered", gathered)
    assert (tmp_path / "sharded" / "arrays.safetensors").read_bytes() == \
        (tmp_path / "gathered" / "arrays.safetensors").read_bytes()
    back = restore_train_state(tmp_path / "sharded", training.create_state(
        shard_tree(params, specs, mesh), tx))
    for (path, a), (_, b) in zip(tree_paths(back.params),
                                 tree_paths(state.params)):
        assert a.spec == b.spec, path
        for sl in a.shards:
            assert torch.equal(a.shards[sl], b.shards[sl]), (path, sl)
    export_hf_safetensors(tmp_path / "s.safetensors", state.params, cfg)
    export_hf_safetensors(tmp_path / "g.safetensors", gathered.params, cfg)
    assert (tmp_path / "s.safetensors").read_bytes() == \
        (tmp_path / "g.safetensors").read_bytes()
    from zest_tpu_torch.models.safetensors_io import SafetensorsFile

    with SafetensorsFile(tmp_path / "s.safetensors") as sf:
        back = gpt2.params_from_hf({n: sf.tensor(n).clone()
                                    for n in sf.names()}, cfg)
    want = dict(tree_paths(gathered.params))
    for path, a in tree_paths(back):
        assert torch.equal(a, want[path]), path
