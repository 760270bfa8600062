"""The port's GPipe pipeline against the plain layer loop and the JAX
package's ``pipeline_blocks``, on the CPU.

``pipeline_blocks`` over ``model_mesh({"pipe": S}, ["cpu"] * S)`` for S
stages × M microbatches in {1, 2, 4} × {1, 2, 4}: forward and gradients
against the plain loop over the stacked layers, forward against the
reference's ``pipeline_blocks`` on its virtual mesh; GPT-2 and Llama
blocks drop in as they are; a pipe axis inside a ``{data, pipe}`` mesh;
the microbatch round trip; indivisible layers and batches raise. Mirrors
tests/test_pipeline.py, its slow gradient case unmarked.

Tolerances, float32: 1e-6 where the microbatch is the whole batch (the
same products), 1e-5 otherwise (a matmul over fewer rows may sum in
another order); gradients atol 1e-5 / rtol 1e-4, as tests/test_pipeline.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from zest_tpu.parallel.pipeline import pipeline_blocks as j_pipeline_blocks
from zest_tpu_torch.models import gpt2, llama
from zest_tpu_torch.models.training import tree_leaves, tree_map
from zest_tpu_torch.parallel.mesh import model_mesh
from zest_tpu_torch.parallel.pipeline import (microbatch, pipeline_blocks,
                                              pipeline_spmd, unmicrobatch)


def pipe_mesh(n):
    return model_mesh({"pipe": n}, ["cpu"] * n)


def linear_block(x, p):
    """Toy layer, the scan-body signature: tanh(x @ w + b)."""
    return torch.tanh(x @ p["w"] + p["b"]), None


def j_linear_block(x, p):
    return jnp.tanh(x @ p["w"] + p["b"]), None


def make_stack(L=8, E=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((L, E, E)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((L, E)) * 0.1).astype(np.float32)}


def layer_loop(block_fn, params, x):
    for i in range(tree_leaves(params)[0].shape[0]):
        x, _ = block_fn(x, tree_map(lambda p, i=i: p[i], params))
    return x


def torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def test_microbatch_roundtrip():
    x = torch.arange(24.0).reshape(12, 2)
    mb = microbatch(x, 4)
    assert mb.shape == (4, 3, 2)
    assert torch.equal(unmicrobatch(mb), x)
    with pytest.raises(ValueError, match="divisible"):
        microbatch(x, 5)


@pytest.mark.parametrize("microbatches", [1, 2, 4])
@pytest.mark.parametrize("stages", [1, 2, 4])
def test_pipeline_matches_loop_and_reference(stages, microbatches):
    stack = make_stack()
    x = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    params = torch_tree(stack)
    got = pipeline_blocks(linear_block, params, torch.from_numpy(x),
                          pipe_mesh(stages), microbatches)
    tol = 1e-6 if microbatches == 1 else 1e-5
    want = layer_loop(linear_block, params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol,
                               rtol=tol)
    jmesh = Mesh(np.asarray(jax.devices()[:stages]), ("pipe",))
    ref = j_pipeline_blocks(j_linear_block,
                            jax.tree.map(jnp.asarray, stack),
                            jnp.asarray(x), jmesh, microbatches)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("microbatches", [1, 2, 4])
@pytest.mark.parametrize("stages", [1, 2, 4])
def test_pipeline_gradients_match_loop(stages, microbatches):
    """Autograd back through the stage-to-stage sends gives the loop's
    gradients for the params and the input."""
    stack = make_stack(L=4, E=8, seed=3)
    x0 = np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32)

    def grads(run):
        params = tree_map(lambda t: t.requires_grad_(), torch_tree(stack))
        x = torch.from_numpy(x0.copy()).requires_grad_()
        (run(params, x) ** 2).sum().backward()
        return [t.grad for t in tree_leaves(params)] + [x.grad]

    mesh = pipe_mesh(stages)
    got = grads(lambda p, x: pipeline_blocks(linear_block, p, x, mesh,
                                             microbatches))
    want = grads(lambda p, x: layer_loop(linear_block, p, x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_pipeline_runs_family_blocks(family):
    """The families' stacked blocks drop straight in; GPT-2 against the
    reference's pipeline of its own blocks too."""
    gen = torch.Generator().manual_seed(0)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 256,
                                                             (4, 16)))
    if family == "gpt2":
        cfg = gpt2.GPT2Config.tiny(n_layer=4)
        params = gpt2.init_params(gen, cfg, device="cpu")
        x = params["wte"][ids] + params["wpe"][:16]

        def block(x, lp):
            return gpt2._block(x, lp, cfg), None
    else:
        cfg = llama.LlamaConfig.tiny(n_layer=4)
        params = llama.init_params(gen, cfg, device="cpu")
        x = params["wte"][ids]

        def block(x, lp):
            return llama._block(x, lp, cfg,
                                lambda h, p: llama._attention(h, p, cfg)), None
    want = layer_loop(block, params["blocks"], x)
    got = pipeline_blocks(block, params["blocks"], x, pipe_mesh(4), 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    if family == "gpt2":
        from zest_tpu.models import gpt2 as j_gpt2

        jcfg = j_gpt2.GPT2Config.tiny(n_layer=4)
        jblocks = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                               params["blocks"])
        ref = j_pipeline_blocks(
            lambda x, lp: (j_gpt2._block(x, lp, jcfg), None), jblocks,
            jnp.asarray(x.numpy()),
            Mesh(np.asarray(jax.devices()[:4]), ("pipe",)), 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_pipeline_spmd_over_each_data_row():
    """A ``{data, pipe}`` mesh: each data row's pipe slots run their own
    pipeline over its half of the batch (the reference's
    ``test_pipeline_spmd_composes_with_data_axis``)."""
    params = torch_tree(make_stack(L=4))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (8, 16)).astype(np.float32))
    mesh = model_mesh({"data": 2, "pipe": 4}, ["cpu"] * 8)
    outs = []
    for row, half in enumerate(x.chunk(2)):
        devices = mesh.axis_devices("pipe", {"data": row})
        stages = [tree_map(lambda p, s=s: p[s:s + 1], params)
                  for s in range(4)]
        outs.append(unmicrobatch(pipeline_spmd(
            linear_block, stages, microbatch(half, 2), devices)))
    want = layer_loop(linear_block, params, x)
    np.testing.assert_allclose(torch.cat(outs).numpy(), want.numpy(),
                               atol=1e-6, rtol=1e-6)


def test_pipeline_rejects_indivisible_layers():
    params = torch_tree(make_stack(L=6))
    with pytest.raises(ValueError, match="divide"):
        pipeline_blocks(linear_block, params, torch.zeros(4, 16),
                        pipe_mesh(4), 2)
    with pytest.raises(ValueError, match="divisible"):
        pipeline_blocks(linear_block, params, torch.zeros(5, 16),
                        pipe_mesh(2), 2)
