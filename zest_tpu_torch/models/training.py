"""Optimizer-equipped training over the family models, in plain PyTorch.

The counterpart of ``zest_tpu/models/training.py``: AdamW with a linear
warmup and cosine decay, global-norm clipping, a :class:`TrainState`, and
a step factory that works with any family's ``loss_fn`` (gpt2, llama,
moe). Gradients are autograd's; the optimizer is written out here so that
three of its semantics are optax 0.2.6's, which ``torch.optim`` and
``torch.nn.utils.clip_grad_norm_`` do not give:

- clipping leaves the gradients alone when the global norm is below
  ``clip_norm`` and otherwise scales each by ``(g / norm) * clip_norm``
  (``clip_grad_norm_`` divides by ``norm + 1e-6``);
- the schedule is evaluated at the count *before* the step, so with a
  warmup the first step's learning rate is 0; the cosine decays over
  ``total_steps - warmup_steps`` steps to 0;
- the update is ``mu_hat / (sqrt(nu_hat) + eps)``, plus ``wd * p`` on the
  leaves :func:`decay_mask` selects, times ``-lr``.

The step updates the parameters and the moments in place where the
reference donates its state: the state passed in is the state returned,
advanced. Parameters are float32 leaves of a dict tree; a tree built
under ``torch.inference_mode`` cannot be trained (autograd refuses to
save inference tensors), so :func:`create_state` copies such a tree out
of it once.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from zest_tpu_torch.parallel.sharding import (ShardedTensor, map_shards,
                                              sum_replicas, zeros_like)


# ── Dict trees ──


def tree_leaves(tree) -> list[torch.Tensor]:
    """The leaves of a dict tree, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs of a dict tree, in insertion order."""
    if isinstance(tree, dict):
        return [pair for k, v in tree.items()
                for pair in tree_paths(v, prefix + (k,))]
    return [(prefix, tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of one or more dict trees of one shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _inputs(leaf) -> list[torch.Tensor]:
    """The tensors autograd differentiates for one leaf: a sharded leaf's
    shards, in slot order."""
    if isinstance(leaf, ShardedTensor):
        return [leaf.shards[s] for s in sorted(leaf.shards)]
    return [leaf]


def value_and_grad(loss_fn: Callable, params: dict, *args, **kwargs):
    """``(loss, grads)`` of ``loss_fn(params, *args, **kwargs)`` with
    respect to every leaf of ``params`` (the counterpart of
    ``jax.value_and_grad``). The leaves are not changed; the loss comes
    back detached.

    A sharded leaf's gradient is a ``ShardedTensor`` of its layout whose
    every replica holds the sum of the replicas' gradients
    (:func:`~zest_tpu_torch.parallel.sharding.sum_replicas`): the
    gradient of the global tensor, cut as the leaf is."""
    if any(t.is_inference() for t in tree_leaves(params)):
        raise ValueError(
            "the tree was built under torch.inference_mode and cannot be "
            "trained: copy it out first (training.create_state does)")
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    sharded = any(isinstance(t, ShardedTensor) for t in leaves)
    with torch.enable_grad():
        loss = loss_fn(live, *args, **kwargs)
        # A replica the forward never read (a norm gain off the row's
        # lead slot) has no gradient (None): it takes the others' sum.
        grads = list(torch.autograd.grad(
            loss, [x for t in leaves for x in _inputs(t)],
            allow_unused=sharded))
    grads.reverse()

    def take(leaf):
        if not isinstance(leaf, ShardedTensor):
            return grads.pop()
        # Popped leaf by leaf: a replica's raw gradient is freed once its
        # group's sum is formed, so the sums never sit beside every raw
        # gradient at once.
        shards = {s: grads.pop() for s in sorted(leaf.shards)}
        return sum_replicas(ShardedTensor(shards, leaf.shape, leaf.dtype,
                                          leaf.spec, leaf.mesh),
                            like=leaf)

    return loss.detach(), tree_map(take, params)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token cross entropy of (B, T, V) logits against (B, T)
    ids, in float32: the families' ``loss_fn`` core."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


def sgd(params: dict, grads: dict, lr: float) -> dict:
    """``p - lr * g`` over the tree: the families' inline SGD update (a
    sharded leaf shard by shard, in its layout)."""
    def step(p, g):
        return p - lr * g.to(p.dtype)

    return tree_map(lambda p, g: map_shards(step, p, g)
                    if isinstance(p, ShardedTensor) else step(p, g),
                    params, grads)


def _square_sum(g) -> torch.Tensor:
    """The float32 sum of squares of a gradient leaf, each block of a
    sharded one once (replicas are not counted again), on its first
    block's device."""
    if not isinstance(g, ShardedTensor):
        return torch.sum(g.float() * g.float())
    parts = [g.shards[s] for s in g.distinct_slots()]
    dev = parts[0].device
    total = torch.sum(parts[0].float() * parts[0].float())
    for t in parts[1:]:
        total = total + torch.sum(t.float() * t.float()).to(dev)
    return total


def _pairs(*leaves):
    """The matching tensors of a parameter, its gradient and moments: the
    leaves themselves, or each slot's shards of sharded ones."""
    if not isinstance(leaves[0], ShardedTensor):
        return [leaves]
    return [tuple(t.shards[s] for t in leaves)
            for s in sorted(leaves[0].shards)]


# ── The optimizer ──


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


class AdamWState(NamedTuple):
    """optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``); the
    schedule's own count is always equal to it."""

    count: int
    mu: Any
    nu: Any


def decay_mask(params) -> Any:
    """True for leaves weight decay applies to, keyed on the leaf name:
    norm gains and offsets (``g``/``b``) and biases (``*_b``) are
    excluded; matmul weights and embeddings are decayed. The family trees
    stack layers on a leading axis, so dimensionality cannot tell a norm
    gain from a weight."""
    if isinstance(params, dict):
        return {k: (decay_mask(v) if isinstance(v, dict)
                    else not (k in ("g", "b") or k.endswith("_b")))
                for k, v in params.items()}
    raise TypeError("decay_mask takes a dict tree")


def warmup_cosine(count: int, peak: float, warmup_steps: int,
                  total_steps: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    total_steps)`` at ``count``, in float32 as optax forms it."""
    f32 = np.float32
    if warmup_steps > 0 and count < warmup_steps:
        frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(
            warmup_steps)
        return float(f32(0.0 - peak) * frac + f32(peak))
    decay_steps = total_steps - warmup_steps
    if not decay_steps > 0:
        raise ValueError("the cosine decay needs total_steps > warmup_steps")
    c = min(f32(count - warmup_steps), f32(decay_steps))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps),
                                         dtype=f32))
    return float(f32(peak) * cosine)


class AdamW:
    """The standard LLM recipe: global-norm clipping, then AdamW with a
    warmup+cosine learning rate, weight decay masked by leaf name."""

    def __init__(self, lr: float, weight_decay: float, warmup_steps: int,
                 total_steps: int, clip_norm: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.weight_decay = lr, weight_decay
        self.warmup_steps, self.total_steps = warmup_steps, total_steps
        self.clip_norm, self.b1, self.b2, self.eps = clip_norm, b1, b2, eps

    def schedule(self, count: int) -> float:
        return warmup_cosine(count, self.lr, self.warmup_steps,
                             self.total_steps)

    def init(self, params) -> AdamWState:
        return AdamWState(0, tree_map(zeros_like, params),
                          tree_map(zeros_like, params))

    @torch.no_grad()
    def update_(self, grads, state: AdamWState, params) -> AdamWState:
        """One step: ``params``, ``state.mu`` and ``state.nu`` in place
        (a sharded leaf on every shard, so replicas stay equal); returns
        the state with its count advanced."""
        gs = tree_leaves(grads)
        # optax: the square root of the sum of every leaf's sum of squares;
        # at or above clip_norm each leaf becomes (g / norm) * clip_norm.
        squares = [_square_sum(g) for g in gs]
        lead = squares[0].device
        norm = torch.sqrt(sum(x.to(lead) for x in squares))
        clip = not bool(norm < self.clip_norm)
        lr = self.schedule(state.count)
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        mask = tree_leaves(decay_mask(params))
        for leaf, decay in zip(zip(gs, tree_leaves(params),
                                   tree_leaves(state.mu),
                                   tree_leaves(state.nu)), mask):
            for g, p, mu, nu in _pairs(*leaf):
                if clip:
                    g = (g / norm.to(g.device, g.dtype)) * self.clip_norm
                mu.mul_(self.b1).add_((1 - self.b1) * g)
                # The temporaries are updated in place (the same products
                # in the same order): a leaf's update holds about two of
                # its size at a time.
                nu.mul_(self.b2).add_((g * g).mul_(1 - self.b2))
                u = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
                if decay:
                    u.add_(self.weight_decay * p)
                p.add_(u.mul_(-lr))
        return AdamWState(count, state.mu, state.nu)


def adamw(lr: float = 3e-4, weight_decay: float = 0.01,
          warmup_steps: int = 100, total_steps: int = 10_000,
          clip_norm: float = 1.0) -> AdamW:
    """Linear warmup → cosine decay, AdamW, global-norm clipping; the
    reference's defaults."""
    return AdamW(lr, weight_decay, warmup_steps, total_steps, clip_norm)


def create_state(params, tx: AdamW) -> TrainState:
    """A fresh state; the moments are zeros on each leaf's device and
    dtype (a sharded leaf's in its mesh and spec, shard for shard). Leaves
    made under ``torch.inference_mode`` are copied out of it, once."""
    params = tree_map(
        lambda t: t.clone() if t.is_inference() else t.detach(), params)
    return TrainState(0, params, tx.init(params))


def make_train_step(tx: AdamW, loss_fn: Callable) -> Callable:
    """``step(state, batch) -> (state, loss)``.

    ``loss_fn(params, batch) -> scalar``: partial in the family module's
    config first (``functools.partial(llama.loss_fn, cfg=cfg)``). The
    step updates the state's parameters and moments in place and returns
    the state advanced; keep no other reference to the old one."""

    def step(state: TrainState, batch) -> tuple[TrainState, torch.Tensor]:
        loss, grads = value_and_grad(loss_fn, state.params, batch)
        opt_state = tx.update_(grads, state.opt_state, state.params)
        return TrainState(state.step + 1, state.params, opt_state), loss

    return step


def opt_state_from_jax(count, mu, nu, device="cpu",
                       dtype: torch.dtype = torch.float32) -> AdamWState:
    """optax's AdamW state (its ``ScaleByAdamState`` ``count``, ``mu`` and
    ``nu``, as numpy arrays in the param tree's layout) → the port's, so
    a run the reference began continues here. Numpy only, so the port
    never imports jax."""
    def conv(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return AdamWState(int(np.asarray(count)), tree_map(conv, mu),
                      tree_map(conv, nu))
