"""Differentiable point-to-point moves between processes.

Within one process a block moves slot to slot with ``.to(device)``, and
autograd's backward moves its gradient back. Between processes the move
is a ``torch.distributed`` send on one side and a receive on the other
(gloo on the CPU; NCCL across GPUs waits for a machine with more than
one). :func:`exchange` is one such step as an autograd op: it sends each
of its inputs and returns what it receives, and its backward sends each
received block's gradient back to where the block came from and receives
each sent block's gradient from where it went.

Every message carries a tag. Both sides of a move derive it from the same
count of moves (``next_tags``) and the block's place in the step, so a
block's forward and backward messages match whatever order the two
processes' autograd engines run their backward in; a mismatch hangs
(bounded by the process group's timeout) instead of swapping blocks.
"""

from __future__ import annotations

import itertools
import threading

import torch
import torch.distributed as dist

# Tags of one step: [base, base + _SPAN) forward, the next _SPAN backward.
_SPAN = 1 << 12
_counter = itertools.count()
_counter_lock = threading.Lock()


def next_tags() -> int:
    """The tag base of the next move. Every process must call it once for
    each move, in the same order (the same code path on every side)."""
    with _counter_lock:
        return (next(_counter) % (1 << 16)) * 2 * _SPAN


def _p2p(sends, dsts, send_tags, recv_like, srcs, recv_tags):
    """Post every send and receive, then wait for all of them."""
    outs = [torch.empty(shape, dtype=dtype, device=device)
            for shape, dtype, device in recv_like]
    work = [dist.isend(t.contiguous(), int(d), tag=int(tag))
            for t, d, tag in zip(sends, dsts, send_tags)]
    work += [dist.irecv(o, int(s), tag=int(tag))
             for o, s, tag in zip(outs, srcs, recv_tags)]
    for w in work:
        w.wait()
    return outs


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *sends):
        dsts, send_tags, recv_like, srcs, recv_tags = plan
        ctx.plan = plan
        ctx.send_like = [(t.shape, t.dtype, t.device) for t in sends]
        return tuple(_p2p(sends, dsts, send_tags, recv_like, srcs,
                          recv_tags))

    @staticmethod
    def backward(ctx, *grads):
        dsts, send_tags, recv_like, srcs, recv_tags = ctx.plan
        grads = [g if g is not None else torch.zeros(shape, dtype=dtype,
                                                     device=device)
                 for g, (shape, dtype, device) in zip(grads, recv_like)]
        back = _p2p(grads, srcs, [t + _SPAN for t in recv_tags],
                    ctx.send_like, dsts, [t + _SPAN for t in send_tags])
        return (None, *back)


def exchange(sends: list, dsts: list, send_tags: list, recv_like: list,
             srcs: list, recv_tags: list) -> list:
    """Send ``sends[i]`` to rank ``dsts[i]`` under ``send_tags[i]`` and
    receive one ``(shape, dtype, device)`` of ``recv_like[j]`` from rank
    ``srcs[j]`` under ``recv_tags[j]``, as one differentiable step (the
    tags within ``[next_tags(), next_tags() + 4096)``). Returns the
    received tensors; the sent ones get their gradients from their
    destinations in the backward."""
    plan = (list(dsts), list(send_tags), list(recv_like), list(srcs),
            list(recv_tags))
    return list(_Exchange.apply(plan, *sends))


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dst, tag, x):
        ctx.meta = (dst, tag, x.shape, x.dtype, x.device)
        dist.send(x.contiguous(), int(dst), tag=int(tag))
        return torch.zeros((), dtype=x.dtype, device=x.device)

    @staticmethod
    def backward(ctx, _g):
        dst, tag, shape, dtype, device = ctx.meta
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, int(dst), tag=int(tag) + _SPAN)
        return None, None, g


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, tag, like, _anchor):
        # ``_anchor`` requires grad, so the output joins the graph.
        shape, dtype, device = like
        ctx.meta = (src, tag)
        out = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(out, int(src), tag=int(tag))
        return out

    @staticmethod
    def backward(ctx, g):
        src, tag = ctx.meta
        dist.send(g.contiguous(), int(src), tag=int(tag) + _SPAN)
        return None, None, None, None


def send(x: torch.Tensor, dst: int, tag: int) -> torch.Tensor:
    """Send ``x`` to rank ``dst`` as a differentiable op: returns a zero
    scalar tied to ``x``; a backward that reaches it receives ``x``'s
    gradient from ``dst`` (whatever gradient reaches the scalar)."""
    return _Send.apply(dst, tag, x)


def recv(like: tuple, src: int, tag: int) -> torch.Tensor:
    """Receive a ``(shape, dtype, device)`` block from rank ``src`` as a
    differentiable op (where grad mode is on) whose backward sends the
    block's gradient back."""
    return _Recv.apply(src, tag, like,
                       torch.zeros((), requires_grad=True))
