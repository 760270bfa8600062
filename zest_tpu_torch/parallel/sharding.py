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

    __slots__ = ("shape", "dtype", "spec", "mesh", "shards")

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
