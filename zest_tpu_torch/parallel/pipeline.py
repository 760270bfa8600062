"""Pipeline parallelism: GPipe microbatch pipelining over the slots of a
``pipe`` mesh axis.

The counterpart of ``zest_tpu/parallel/pipeline.py``. The model's
per-layer params are stacked on a leading layer axis (the families'
layout), so stage ``s`` of ``S`` takes the contiguous block of ``L/S``
layers ``[s·L/S, (s+1)·L/S)``, moved onto its slot's device. The schedule
is the reference's: ``M + S - 1`` ticks, at tick ``t`` stage ``s`` runs
microbatch ``t - s``; a stage outside ``[0, M)`` (the bubble) runs on
zeros, as every device of the reference's single SPMD program does, and
its output is discarded; activations move stage to stage with
``.to(next stage's device)``, so the backward flows back through the
sends; the last stage's bank is the output.

The JAX package runs one program per device under ``shard_map``; here
one process runs every stage's work for a tick in turn.
``zest_tpu/parallel/spmd.py`` (``pvary_over``) only types ``shard_map``
carries and has no counterpart.
"""

from __future__ import annotations

from typing import Callable

import torch

from zest_tpu_torch.models.training import tree_leaves, tree_map

PIPE_AXIS = "pipe"


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """(B, ...) → (M, B/M, ...). The batch must divide evenly."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(
            f"batch {B} not divisible into {n_microbatches} microbatches")
    return x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """(M, mb, ...) → (M*mb, ...)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _run_stage(block_fn: Callable, params, act):
    for i in range(tree_leaves(params)[0].shape[0]):
        act, _ = block_fn(act, tree_map(lambda p, i=i: p[i], params))
    return act


def pipeline_spmd(block_fn: Callable, stage_params: list, xs: torch.Tensor,
                  devices: list) -> torch.Tensor:
    """The GPipe schedule over ``len(stage_params)`` stages.

    - ``block_fn(carry, layer_params) -> (carry, None)``: one layer, the
      signature of the reference's ``lax.scan`` bodies.
    - ``stage_params[s]``: stage ``s``'s stacked layer slice, on
      ``devices[s]``.
    - ``xs``: (M, mb, ...), the microbatched input; stage 0 reads it.

    Returns (M, mb, ...) on the last stage's device."""
    S, M = len(stage_params), xs.shape[0]
    zeros = [torch.zeros(xs.shape[1:], dtype=xs.dtype, device=d)
             for d in devices]
    recv: list = [None] * S
    bank: list = [None] * M
    for t in range(M + S - 1):
        sent: list = [None] * S
        for s in range(S):
            mb = t - s
            if not 0 <= mb < M:
                # The bubble: the stage computes on zeros, and what it
                # sends is never read (the next stage is in its bubble
                # at the next tick too).
                with torch.no_grad():
                    _run_stage(block_fn, stage_params[s], zeros[s])
                continue
            act = xs[mb].to(devices[0]) if s == 0 else recv[s]
            act = _run_stage(block_fn, stage_params[s], act)
            if s == S - 1:
                bank[mb] = act
            else:
                sent[s + 1] = act.to(devices[s + 1])
        recv = sent
    return torch.stack(bank)


def pipeline_blocks(block_fn: Callable, stacked_params, x: torch.Tensor,
                    mesh, n_microbatches: int,
                    axis_name: str = PIPE_AXIS) -> torch.Tensor:
    """Run stacked layers over ``x`` (B, ...) through the pipeline over
    ``mesh``'s ``axis_name`` slots (a ``SlotMesh``; other axes at index 0).

    ``stacked_params``: a dict tree with the leading layer dim L on every
    leaf, L divisible by the axis size. Returns (B, ...) on ``x``'s
    device, what the plain layer loop over ``stacked_params`` gives."""
    devices = mesh.axis_devices(axis_name)
    S = len(devices)
    L = tree_leaves(stacked_params)[0].shape[0]
    if L % S:
        raise ValueError(f"{L} layers do not divide over {S} pipeline "
                         "stages")
    per = L // S
    stages = [tree_map(lambda p, s=s, d=d: p[s * per:(s + 1) * per].to(d),
                       stacked_params) for s, d in enumerate(devices)]
    out = pipeline_spmd(block_fn, stages, microbatch(x, n_microbatches),
                        devices)
    return unmicrobatch(out).to(x.device)
