"""Tensors laid out over a named slot mesh.

The port's counterpart of ``jax.sharding``: :class:`P` is a partition
spec with ``PartitionSpec``'s semantics (one entry per leading dim: None,
an axis name, or a tuple of names, the first the major one), and a
:class:`ShardedTensor` is one tensor's global shape and dtype, its spec,
its mesh and one tensor per slot this process owns. A slot's shard is its
own allocation even where several slots share a device, so writing one
slot's shard leaves every other slot's unchanged.

With several processes (``torch.distributed`` initialised) a process
holds only its own slots' shards; :meth:`ShardedTensor.full` gathers the
rest over the process group.

A sharded tree trains as a plain one does (``models/training.py``): the
shards carry ``requires_grad`` and a ``.grad``, :func:`zeros_like` and
:func:`map_shards` keep the layout, :func:`sum_replicas` gives every
replica of a block the sum of the replicas' gradients (so the replicas
stay bit-equal through an update), and :meth:`ShardedTensor.distinct_slots`
names each block once (a global norm counts every element once).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from zest_tpu_torch.parallel.mesh import SlotMesh, world_size


class P(tuple):
    """A partition spec: ``P("model", None)`` shards dim 0 over the
    ``model`` axis and keeps dim 1 whole; ``P()`` replicates. Equality is
    the tuple's, as ``PartitionSpec``'s is (``P() != P(None)``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else \
            f"P({self[0]!r})"


class MeshUnsupported(ValueError):
    """The operation does not take a tree sharded over a mesh."""


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_index(shape: tuple[int, ...], mesh: SlotMesh, spec: P,
                slot: int) -> tuple[slice, ...]:
    """The global index of ``slot``'s shard of a ``shape`` tensor."""
    coords = mesh.coords(slot)
    sizes = mesh.shape
    index = []
    for d, n in enumerate(shape):
        axes = _axes(spec[d]) if d < len(spec) else ()
        if not axes:
            index.append(slice(0, n))
            continue
        parts, pos = 1, 0
        for ax in axes:
            parts *= sizes[ax]
            pos = pos * sizes[ax] + int(coords[ax])
        step = n // parts
        index.append(slice(pos * step, (pos + 1) * step))
    return tuple(index)


class ShardedTensor:
    """One tensor over a :class:`SlotMesh`: ``shards`` maps each local
    slot to its shard (on that slot's device)."""

    __slots__ = ("shape", "dtype", "spec", "mesh", "shards", "__weakref__")

    def __init__(self, shards: dict[int, torch.Tensor], shape, dtype,
                 spec: P, mesh: SlotMesh):
        self.shards = dict(shards)
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.spec = spec
        self.mesh = mesh

    def shard(self, slot: int) -> torch.Tensor:
        return self.shards[slot]

    def index(self, slot: int) -> tuple[slice, ...]:
        return shard_index(tuple(self.shape), self.mesh, self.spec, slot)

    @property
    def nbytes(self) -> int:
        """Bytes of the global tensor."""
        return math.prod(self.shape) * torch.empty(
            (), dtype=self.dtype).element_size()

    @property
    def device(self) -> torch.device:
        """The first local slot's device."""
        return self.shards[min(self.shards)].device

    def full(self, device=None) -> torch.Tensor:
        """The global tensor, gathered into a new allocation on ``device``
        (default the first local slot's). With several processes every
        process must call it: the shards of other processes come over the
        process group."""
        device = torch.device(device) if device is not None else self.device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        shards = dict(self.shards)
        if world_size() > 1:
            shards = self._gather_remote(shards)
        seen = set()
        for slot in sorted(shards):
            idx = self.index(slot)
            key = tuple((s.start, s.stop) for s in idx)
            if key in seen:
                continue  # a replica along another axis
            seen.add(key)
            out[idx].copy_(shards[slot])
        return out

    def replica_groups(self) -> list[list[int]]:
        """The local slots grouped by the block they hold (a group's slots
        are replicas), each group in slot order, the groups in the order
        of their first slot."""
        groups: dict[tuple, list[int]] = {}
        for slot in sorted(self.shards):
            key = tuple((s.start, s.stop) for s in self.index(slot))
            groups.setdefault(key, []).append(slot)
        return list(groups.values())

    def distinct_slots(self) -> list[int]:
        """One local slot of each block (the first of its replicas)."""
        return [g[0] for g in self.replica_groups()]

    # Autograd and the tensor methods a training tree's leaves need.

    def requires_grad_(self, flag: bool = True) -> "ShardedTensor":
        for t in self.shards.values():
            t.requires_grad_(flag)
        return self

    @property
    def grad(self) -> "ShardedTensor | None":
        """Each shard's ``.grad`` (zeros where autograd gave that shard
        none: a replica the forward did not read), or None when no shard
        has one. Replicas are not summed: :func:`sum_replicas` does."""
        if all(t.grad is None for t in self.shards.values()):
            return None
        return ShardedTensor(
            {s: t.grad if t.grad is not None else torch.zeros_like(t)
             for s, t in self.shards.items()},
            self.shape, self.dtype, self.spec, self.mesh)

    def detach(self) -> "ShardedTensor":
        return map_shards(torch.Tensor.detach, self)

    def clone(self) -> "ShardedTensor":
        return map_shards(torch.Tensor.clone, self)

    def is_inference(self) -> bool:
        return any(t.is_inference() for t in self.shards.values())

    def _gather_remote(self, shards: dict) -> dict:
        """Every process's shards, over the default process group (each
        process owns the same number of slots, so the stacks agree)."""
        local = sorted(shards)
        stack = torch.stack([shards[s] for s in local])
        parts = [torch.empty_like(stack) for _ in range(world_size())]
        dist.all_gather(parts, stack)
        k = len(local)
        out = {}
        for rank, part in enumerate(parts):
            for j in range(k):
                out[rank * k + j] = part[j]
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, spec={self.spec!r}, "
                f"mesh={self.mesh!r})")


def shard_tensor(t: torch.Tensor, mesh: SlotMesh, spec: P
                 ) -> ShardedTensor:
    """``t`` laid out under ``spec``: each local slot's shard copied into
    its own contiguous allocation on its device."""
    shards = {}
    for slot in mesh.local_slots():
        dev = mesh.device_of(slot)
        piece = t[shard_index(tuple(t.shape), mesh, spec, slot)]
        shards[slot] = (piece.clone(memory_format=torch.contiguous_format)
                        if piece.device == dev else
                        piece.to(dev).contiguous())
    return ShardedTensor(shards, t.shape, t.dtype, spec, mesh)


def map_shards(fn, first: ShardedTensor, *rest: ShardedTensor
               ) -> ShardedTensor:
    """``fn`` over the matching shards of ``first`` and ``rest`` (one
    layout: the same mesh, spec and shape), slot by slot: a
    :class:`ShardedTensor` of the results in ``first``'s layout, its
    dtype the results'."""
    for other in rest:
        if (other.spec != first.spec or other.shape != first.shape
                or not same_mesh(other.mesh, first.mesh)):
            raise ValueError(f"map_shards over unlike layouts: {first!r} "
                             f"and {other!r}")
    out = {s: fn(t, *(o.shards[s] for o in rest))
           for s, t in first.shards.items()}
    dtype = next(iter(out.values())).dtype
    return ShardedTensor(out, first.shape, dtype, first.spec, first.mesh)


def zeros_like(t):
    """Zeros in ``t``'s layout: a :class:`ShardedTensor` of zero shards in
    its spec over its mesh, or ``torch.zeros_like`` of a plain tensor."""
    if isinstance(t, ShardedTensor):
        return map_shards(torch.zeros_like, t)
    return torch.zeros_like(t)


def sum_replicas(t: ShardedTensor, like: ShardedTensor | None = None
                 ) -> ShardedTensor:
    """Every replica of a block given the sum of that block's replicas:
    the sum is formed once, in slot order on the group's first device (it
    becomes the first replica's shard), and each other replica takes its
    own copy of it, so replicas stay bit-equal. A sharded leaf's gradient
    is the sum of the gradients its replicas got (a ``data`` replica each
    row of the batch, say). A None shard (no gradient reached that
    replica) adds nothing; a group of None shards sums to zeros of
    ``like``'s shards. Where the mesh spans processes each local sum is
    then all-reduced over the default group: every process must hold the
    same blocks (whole rows of the tensor-parallel axis, as the sharded
    train step lays them out), and every replica ends with the same
    sum."""
    ref = like if like is not None else t
    remote = world_size() > 1 and len(t.mesh.local_slots()) < t.mesh.size
    out = {}
    for group in t.replica_groups():
        dev = ref.shards[group[0]].device
        total = None
        for slot in group:
            g = t.shards[slot]
            if g is not None:
                total = g.to(dev) if total is None else total + g.to(dev)
        if total is None:
            total = torch.zeros_like(ref.shards[group[0]])
        if remote:
            # A raw gradient may be a strided view (a slice of the
            # gradient of a join): reduce a contiguous copy.
            total = total.contiguous()
            dist.all_reduce(total)
        out[group[0]] = total
        for slot in group[1:]:
            d = ref.shards[slot].device
            out[slot] = total.clone() if d == dev else total.to(d)
    return ShardedTensor(out, t.shape, t.dtype, t.spec, t.mesh)


def same_mesh(a: SlotMesh, b: SlotMesh) -> bool:
    """Two slot meshes with the same axes in the same order, the same
    sizes and the same device in every slot (two ``model_mesh`` calls of
    one layout are the same mesh)."""
    if a is b:
        return True
    return (a.axis_names == b.axis_names
            and a.devices.shape == b.devices.shape
            and all(x == y for x, y in zip(a.devices.flat, b.devices.flat)))


def shard_tree(tree, specs, mesh: SlotMesh):
    """A dict tree of tensors laid out over ``mesh`` by a matching tree of
    specs (``param_specs``): the counterpart of ``jax.device_put`` of each
    leaf with ``NamedSharding(mesh, spec)``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard_tensor(tree, mesh, specs)


def is_sharded_tree(tensors: dict) -> bool:
    return any(isinstance(t, ShardedTensor) for t in tensors.values())


def gather_tree(tensors: dict) -> dict:
    """``tensors`` with every :class:`ShardedTensor` gathered
    (:meth:`ShardedTensor.full`, onto its first slot's device); plain
    tensors pass through."""
    if not is_sharded_tree(tensors):
        return tensors
    return {n: t.full() if isinstance(t, ShardedTensor) else t
            for n, t in tensors.items()}
