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
one process runs its stages' work for a tick in turn. Where the stages
span processes, an activation crosses a process boundary as a
``torch.distributed`` send and receive (``parallel/sends``), whose
backward sends the gradient back; a process runs only its own stages,
and skips the bubble's messages. The last stage's output then goes to
every process (outside autograd, tied to the process's sends), so each
can take the same loss of it and run its backward.
``zest_tpu/parallel/spmd.py`` (``pvary_over``) only types ``shard_map``
carries and has no counterpart.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from zest_tpu_torch.models.training import tree_leaves, tree_map
from zest_tpu_torch.parallel import sends
from zest_tpu_torch.parallel.mesh import host_index

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
                  devices: list, ranks: list | None = None) -> torch.Tensor:
    """The GPipe schedule over ``len(stage_params)`` stages.

    - ``block_fn(carry, layer_params) -> (carry, None)``: one layer, the
      signature of the reference's ``lax.scan`` bodies.
    - ``stage_params[s]``: stage ``s``'s stacked layer slice, on
      ``devices[s]``.
    - ``xs``: (M, mb, ...), the microbatched input; stage 0 reads it.
    - ``ranks[s]``: the process running stage ``s`` (default: this one
      runs every stage); another process's stage needs no params or
      device here.

    Returns (M, mb, ...) on the last stage's device (on a process
    without the last stage, on the device of its own last stage)."""
    S, M = len(stage_params), xs.shape[0]
    me = host_index()
    ranks = list(ranks) if ranks is not None else [me] * S
    mine = [s for s in range(S) if ranks[s] == me]
    like = xs.shape[1:]
    base = sends.next_tags() if len(set(ranks)) > 1 else 0
    recv: list = [None] * S
    bank: list = [None] * M
    ties: list = []
    for t in range(M + S - 1):
        sent: list = [None] * S
        for s in mine:
            mb = t - s
            if not 0 <= mb < M:
                # The bubble: the stage computes on zeros, and what it
                # sends is never read (the next stage is in its bubble
                # at the next tick too).
                with torch.no_grad():
                    _run_stage(block_fn, stage_params[s],
                               torch.zeros(like, dtype=xs.dtype,
                                           device=devices[s]))
                continue
            if s == 0:
                act = xs[mb].to(devices[0])
            elif ranks[s - 1] == me:
                act = recv[s]
            else:
                act = sends.recv((like, xs.dtype, devices[s]),
                                 ranks[s - 1], base + mb * S + s)
            act = _run_stage(block_fn, stage_params[s], act)
            if s == S - 1:
                bank[mb] = act
            elif ranks[s + 1] == me:
                sent[s + 1] = act.to(devices[s + 1])
            else:
                ties.append(sends.send(act, ranks[s + 1],
                                       base + mb * S + s + 1))
        recv = sent
    if len(set(ranks)) == 1:
        return torch.stack(bank)
    last = ranks[S - 1] == me
    out = (torch.stack(bank) if last else
           torch.empty((M, *like), dtype=xs.dtype,
                       device=devices[mine[-1]] if mine else xs.device))
    shared = out.detach().clone() if last else out
    dist.broadcast(shared, ranks[S - 1])
    if last:
        return out
    # Tied to this process's sends, so a backward from the shared output
    # runs theirs (each receives its gradient from the next stage).
    return shared + sum(ties, torch.zeros((), device=shared.device)) * 0.0


def pipeline_blocks(block_fn: Callable, stacked_params, x: torch.Tensor,
                    mesh, n_microbatches: int,
                    axis_name: str = PIPE_AXIS) -> torch.Tensor:
    """Run stacked layers over ``x`` (B, ...) through the pipeline over
    ``mesh``'s ``axis_name`` slots (a ``SlotMesh``; other axes at this
    process's first slot's index; the stages may span processes, each
    passing the whole ``stacked_params`` and ``x``).

    ``stacked_params``: a dict tree with the leading layer dim L on every
    leaf, L divisible by the axis size. Returns (B, ...) on ``x``'s
    device, what the plain layer loop over ``stacked_params`` gives."""
    at = mesh.coords(mesh.local_slots()[0])
    slots = mesh.axis_slots(axis_name, {a: c for a, c in at.items()
                                        if a != axis_name})
    per_proc = len(mesh.local_slots())
    ranks = [slot // per_proc for slot in slots]
    devices = [mesh.devices.flat[slot] for slot in slots]
    S = len(slots)
    L = tree_leaves(stacked_params)[0].shape[0]
    if L % S:
        raise ValueError(f"{L} layers do not divide over {S} pipeline "
                         "stages")
    per = L // S
    stages = [tree_map(lambda p, s=s, d=d: p[s * per:(s + 1) * per].to(d),
                       stacked_params) if d is not None else None
              for s, d in enumerate(devices)]
    out = pipeline_spmd(block_fn, stages, microbatch(x, n_microbatches),
                        devices, ranks)
    return unmicrobatch(out).to(x.device)
