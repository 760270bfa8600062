"""Slot meshes: the devices a pod round distributes bytes over, and the
named mesh a pull lands its tree on.

The counterpart of ``zest_tpu/parallel/mesh.py``'s 1-D ``pod`` mesh. A
slot mesh is an ordered list of ``torch.device``s, one a slot: a slot owns
a share of the round's fetch units and holds a replica of the gathered
pool. Unlike a jax mesh, a device may stand in more than one slot (four
slots on one card exercise the round's plan, bands and replicas where
only one card exists).

With several processes (``torch.distributed`` initialised), each process
passes its own slots and every process passes the same number: the round
spans ``world_size × len(mesh)`` slots, process ``r`` owning slots
``r*k .. r*k + k - 1``.

:class:`SlotMesh` is the counterpart of the JAX package's N-D
``model_mesh``: named axes (``{"data": 2, "model": 4}``, order
significant: the last axis is the tensor-parallel one) over the same
slots, laid out row-major. ``parallel/sharding.py`` lays tensors out over
it. As in the 1-D mesh, one device may stand in several slots.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from zest_tpu_torch.config import MeshConfig

POD_AXIS = "pod"


def pod_mesh(devices=None) -> list[torch.device]:
    """The slot mesh over ``devices`` (names or ``torch.device``s), by
    default every CUDA device of this process. Without a card the default
    raises: pass ``devices`` (``["cpu"] * 8``) for a CPU round."""
    if devices is None:
        devices = _cuda_devices("pod_mesh()")
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a slot mesh needs at least one device")
    return mesh


def _cuda_devices(what: str) -> list[str]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} spans every cuda device, and "
            "torch.cuda.is_available() is False; pass devices= (for "
            "example ['cpu'] * 8) for a CPU mesh")
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True, eq=False)
class SlotMesh:
    """A named N-D mesh of slots. ``devices`` is an object array of the
    mesh's shape: slot ``i`` (row-major) holds its ``torch.device`` where
    this process owns it, None where another process does."""

    axis_names: tuple[str, ...]
    devices: np.ndarray

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, in axis order (as a jax ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local_slots(self) -> list[int]:
        """The flat slot indices this process owns, ascending."""
        return [i for i, d in enumerate(self.devices.flat) if d is not None]

    def device_of(self, slot: int) -> torch.device:
        d = self.devices.flat[slot]
        if d is None:
            raise ValueError(f"slot {slot} belongs to another process")
        return d

    def local_devices(self) -> list[torch.device]:
        """This process's slot devices in slot order (a device repeats
        where it stands in several slots): the 1-D slot mesh of the pod
        pre-pass."""
        return [self.devices.flat[i] for i in self.local_slots()]

    def distinct_devices(self) -> list[torch.device]:
        """Each local device once, in first-slot order."""
        out: list[torch.device] = []
        for d in self.local_devices():
            if d not in out:
                out.append(d)
        return out

    def axis_devices(self, axis: str,
                     at: dict[str, int] | None = None) -> list[torch.device]:
        """The devices of the slots along ``axis``, in axis order, every
        other axis at its index in ``at`` (0 where ``at`` names none)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        at = at or {}
        index = tuple(slice(None) if a == axis else at.get(a, 0)
                      for a in self.axis_names)
        row = self.devices[index]
        if any(d is None for d in row):
            raise ValueError(f"the {axis!r} axis spans other processes' "
                             "slots")
        return list(row)

    def axis_slots(self, axis: str,
                   at: dict[str, int] | None = None) -> list[int]:
        """The flat indices of the slots along ``axis``, in axis order,
        every other axis at its index in ``at`` (0 where ``at`` names
        none); they may belong to other processes."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        at = at or {}
        index = tuple(slice(None) if a == axis else at.get(a, 0)
                      for a in self.axis_names)
        flat = np.arange(self.size).reshape(self.devices.shape)
        return [int(s) for s in flat[index]]

    def coords(self, slot: int) -> dict[str, int]:
        """The slot's index along each axis."""
        return dict(zip(self.axis_names,
                        np.unravel_index(slot, self.devices.shape)))

    def __repr__(self) -> str:
        return (f"SlotMesh({self.shape}, "
                f"{[str(d) for d in self.local_devices()]})")


def model_mesh(axes: dict[str, int] | None = None, devices=None):
    """The named mesh ``axes`` (e.g. ``{"data": 2, "model": 4}``) over
    ``devices`` (names or ``torch.device``s; default every CUDA device,
    which raises without a card). Without axes it is the 1-D
    :func:`pod_mesh`. With several processes each passes its own devices
    and the mesh spans ``world_size() * len(devices)`` slots. Raises the
    JAX package's ``ValueError`` when the axes' product differs from the
    slot count."""
    if devices is None:
        devices = _cuda_devices("model_mesh()")
    if not axes:
        return pod_mesh(devices)
    local = [torch.device(d) for d in devices]
    sizes = [int(n) for n in axes.values()]
    n = math.prod(sizes)
    have = len(local) * world_size()
    if n != have:
        raise ValueError(f"mesh axes {axes} need {n} devices, have {have}")
    flat = np.empty(n, dtype=object)
    base = host_index() * len(local)
    flat[base:base + len(local)] = local
    return SlotMesh(tuple(axes), flat.reshape(sizes))


def mesh_from_config(mesh_cfg: MeshConfig, devices=None):
    """The landing mesh ``ZEST_TPU_MESH`` names over this process's
    ``devices`` (default every CUDA device, which raises without a card).

    With ``ZEST_TPU_NUM_PROCESSES`` above 1 the mesh spans the processes:
    a process not yet in a ``torch.distributed`` group first joins the one
    at ``ZEST_TPU_COORDINATOR`` (``host:port``, rendezvous over TCP) as
    rank ``ZEST_TPU_PROCESS_ID``, over ``nccl`` for CUDA slots and
    ``gloo`` otherwise; a process already in a group must be that rank of
    that many. Either miss raises ``ValueError``."""
    if devices is None:
        devices = _cuda_devices("mesh_from_config()")
    if mesh_cfg.is_distributed:
        _join_process_group(mesh_cfg, devices)
    return model_mesh(mesh_cfg.mesh_axes or None, devices)


def _join_process_group(mesh_cfg: MeshConfig, devices) -> None:
    n, rank = mesh_cfg.num_processes, mesh_cfg.process_id
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (n, rank):
            raise ValueError(
                f"the mesh config names process {rank} of {n}, but this "
                f"process is rank {dist.get_rank()} of "
                f"{dist.get_world_size()} in its torch.distributed group")
        return
    if not mesh_cfg.coordinator:
        raise ValueError(f"{n} processes need a coordinator address "
                         "(ZEST_TPU_COORDINATOR=host:port)")
    if not 0 <= rank < n:
        raise ValueError(f"process id {rank} is not in 0..{n - 1}")
    cuda = any(torch.device(d).type == "cuda" for d in devices)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{mesh_cfg.coordinator}",
                            rank=rank, world_size=n)


def replicated(mesh: SlotMesh):
    """The spec of a tensor every slot holds whole."""
    from zest_tpu_torch.parallel.sharding import P

    return P()


def row_sharded(mesh: SlotMesh, axis: str = POD_AXIS):
    """First-dimension sharding over ``axis``: the pool layout."""
    from zest_tpu_torch.parallel.sharding import P

    return P(axis)


def world_size() -> int:
    """Processes in the default ``torch.distributed`` group (1 without
    one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def num_slots(mesh) -> int:
    """Slots of the whole round: the ``num_hosts`` a ``DistributionPlan``
    for ``PodDistributor(mesh)`` is built with."""
    return len(mesh) * world_size()


def local_slots(mesh) -> list[int]:
    """The round's slot indices this process's ``mesh`` stands for."""
    base = host_index() * len(mesh)
    return list(range(base, base + len(mesh)))
