"""Ring attention, the GPipe pipeline and the sharded train step across two
gloo processes, against the one-process run and the JAX package, on the
CPU.

Each case starts two ``tests/_torch_mp_worker.py`` processes joined in a
gloo group on loopback:

- ``ring``: ``ring_attention`` over ``{"seq": 4}``, two CPU slots a
  process, so two of the four K/V rotations cross the process boundary
  (``parallel/sends.exchange``); the output equals the one-process ring's
  over ``["cpu"] * 4`` bit for bit and the reference's ``ring_attention``
  on its virtual mesh within 1e-5, and the two processes' gradients sum
  to the one-process gradients within 1e-6;
- ``pipe``: ``pipeline_blocks`` over ``{"pipe": 2}``, one stage a
  process, two microbatches: the output bit-equal to the one-process
  pipeline's, the gradients (each stage's on its process, the input's on
  stage 0's) equal to its within 1e-6;
- ``train``: the sharded step over ``{"data": 2, "model": 4}``, a data row
  a process, for Llama and GPT-2: the gathered gradients equal the
  one-process run's within 1e-6, the loss and two AdamW steps' losses
  within 1e-6, the params within 1e-6 (1e-5 against the reference's
  GSPMD step on its 8 virtual devices, as tests/test_torch_training.py
  holds Adam's eps-scale ulps), and a mesh whose ``model`` row spans both
  processes raises ``MeshUnsupported`` naming the split.
"""

from __future__ import annotations

import functools
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from zest_tpu.models import gpt2 as j_gpt2
from zest_tpu.models import llama as j_llama
from zest_tpu.models import training as j_training
from zest_tpu.parallel.ring import ring_attention as j_ring_attention
from zest_tpu_torch.models import gpt2, llama, training
from zest_tpu_torch.models.training import tree_paths
from zest_tpu_torch.parallel.mesh import model_mesh
from zest_tpu_torch.parallel.pipeline import pipeline_blocks
from zest_tpu_torch.parallel.ring import ring_attention
from zest_tpu_torch.parallel.sharding import ShardedTensor, shard_tree

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(mode: str, root: Path) -> None:
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_mp_worker.py"),
         str(rank), "2", str(port), str(root), mode], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out


def test_ring_attention_across_two_processes(tmp_path):
    rng = np.random.default_rng(31)
    q = rng.standard_normal((2, 16, 4, 8), dtype=np.float32)
    k, v = (rng.standard_normal((2, 16, 2, 8), dtype=np.float32)
            for _ in range(2))
    w = rng.standard_normal((2, 16, 4, 8), dtype=np.float32)
    np.savez(tmp_path / "ring.npz", q=q, k=k, v=v, w=w)
    _run_pair("ring", tmp_path)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    want = ring_attention(tq, tk, tv, model_mesh({"seq": 4}, ["cpu"] * 4))
    (want * torch.from_numpy(w)).sum().backward()
    jmesh = Mesh(np.asarray(jax.devices()[:4]), ("seq",))
    ref = np.asarray(j_ring_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jmesh))
    got = [np.load(tmp_path / f"ring_{r}.npz") for r in range(2)]
    for g in got:
        assert np.array_equal(g["out"], want.detach().numpy())
        np.testing.assert_allclose(g["out"], ref, atol=1e-5, rtol=1e-5)
    for name, t in (("dq", tq), ("dk", tk), ("dv", tv)):
        np.testing.assert_allclose(got[0][name] + got[1][name],
                                   t.grad.numpy(), atol=1e-6, rtol=0)
    # Each process holds the query gradient of its own blocks only.
    assert not got[0]["dq"][:, 8:].any() and not got[1]["dq"][:, :8].any()


def test_pipeline_across_two_processes(tmp_path):
    rng = np.random.default_rng(32)
    stack = {"w": (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal((4, 16)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((8, 16)).astype(np.float32)
    g = rng.standard_normal((8, 16)).astype(np.float32)
    np.savez(tmp_path / "pipe.npz", x=x, g=g, m=2, **stack)
    _run_pair("pipe", tmp_path)

    def block(h, p):
        return torch.tanh(h @ p["w"] + p["b"]), None

    params = {n: torch.from_numpy(a).requires_grad_()
              for n, a in stack.items()}
    tx = torch.from_numpy(x).requires_grad_()
    want = pipeline_blocks(block, params, tx,
                           model_mesh({"pipe": 2}, ["cpu"] * 2), 2)
    (want * torch.from_numpy(g)).sum().backward()
    got = [np.load(tmp_path / f"pipe_{r}.npz") for r in range(2)]
    for r in range(2):
        assert np.array_equal(got[r]["out"], want.detach().numpy())
    np.testing.assert_allclose(got[0]["dx"] + got[1]["dx"],
                               tx.grad.numpy(), atol=1e-6, rtol=0)
    assert not got[1]["dx"].any()  # stage 1 never reads the input
    for n in "wb":
        d = got[0][f"d{n}"] + got[1][f"d{n}"]
        np.testing.assert_allclose(d, params[n].grad.numpy(), atol=1e-6,
                                   rtol=0)
        # Stage s's process holds the gradient of layers [2s, 2s + 2).
        assert not got[0][f"d{n}"][2:].any()
        assert not got[1][f"d{n}"][:2].any()


def _flat(tree) -> dict:
    return {"/".join(p): (t.full() if isinstance(t, ShardedTensor) else t)
            .detach().numpy() for p, t in tree_paths(tree)}


FAMILIES = {
    "llama": (llama, j_llama, "LlamaConfig", {"n_head": 8, "n_kv_head": 4}),
    "gpt2": (gpt2, j_gpt2, "GPT2Config", {}),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_step_across_two_processes(tmp_path, family):
    mod, jmod, cls, over = FAMILIES[family]
    jcfg = getattr(jmod, cls).tiny(**over)
    jparams = jmod.init_params(jax.random.key(33), jcfg)
    spec = {k: v for k, v in vars(jcfg).items()}
    cfg = getattr(mod, cls)(**spec)
    params = mod.params_from_jax(jax.tree.map(np.asarray, jparams))
    batch = np.random.default_rng(34).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32)
    np.savez(tmp_path / "params.npz", **_flat(params))
    np.save(tmp_path / "batch.npy", batch)
    (tmp_path / "cfg.json").write_text(json.dumps({"family": family,
                                                   **spec}))
    _run_pair("train", tmp_path)

    # The one-process run of the same step over ["cpu"] * 8.
    mesh = model_mesh({"data": 2, "model": 4}, ["cpu"] * 8)
    tb = torch.from_numpy(batch).long()
    sharded = shard_tree(params, mod.param_specs(cfg), mesh)
    loss, grads = training.value_and_grad(mod.loss_fn, sharded, tb, cfg)
    tx = training.adamw(lr=1e-3, warmup_steps=1, total_steps=10)
    step = training.make_train_step(tx, functools.partial(mod.loss_fn,
                                                          cfg=cfg))
    state = training.create_state(sharded, tx)
    losses = [float(loss)]
    for _ in range(2):
        state, step_loss = step(state, tb)
        losses.append(float(step_loss))
    want_grads, want_params = _flat(grads), _flat(state.params)
    # The reference's GSPMD step on its 8 virtual devices.
    jmesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
    jsharded = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(jmesh, s)),
        jparams, jmod.param_specs(jcfg), is_leaf=lambda v: isinstance(v, JP))
    jtx = j_training.adamw(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = j_training.make_train_step(
        jtx, functools.partial(jmod.loss_fn, cfg=jcfg))
    jstate = j_training.create_state(jsharded, jtx)
    jbatch = jax.device_put(jnp.asarray(batch),
                            NamedSharding(jmesh, JP("data", None)))
    j_losses = []
    for _ in range(2):
        jstate, j_loss = jstep(jstate, jbatch)
        j_losses.append(float(j_loss))
    j_params = {"/".join(p): np.asarray(t) for p, t in tree_paths(
        jax.tree.map(np.asarray, jstate.params))}

    for rank in range(2):
        doc = json.loads((tmp_path / f"train_{rank}.json").read_text())
        np.testing.assert_allclose(doc["losses"], losses, atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(doc["losses"][1:], j_losses, atol=1e-6,
                                   rtol=1e-6)
        assert "split across processes" in doc["refused"]
        got = np.load(tmp_path / f"grads_{rank}.npz")
        for name, want in want_grads.items():
            np.testing.assert_allclose(got[name], want, atol=1e-6, rtol=0,
                                       err_msg=name)
        got = np.load(tmp_path / f"params_{rank}.npz")
        for name, want in want_params.items():
            np.testing.assert_allclose(got[name], want, atol=1e-6, rtol=0,
                                       err_msg=name)
            np.testing.assert_allclose(got[name], j_params[name], atol=1e-5,
                                       rtol=0, err_msg=name)
    assert all(math.isfinite(x) for x in losses)
