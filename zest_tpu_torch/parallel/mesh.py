"""The slot mesh: the devices a pod round distributes bytes over.

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
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def pod_mesh(devices=None) -> list[torch.device]:
    """The slot mesh over ``devices`` (names or ``torch.device``s), by
    default every CUDA device of this process. Without a card the default
    raises: pass ``devices`` (``["cpu"] * 8``) for a CPU round."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pod_mesh() spans every cuda device, and "
                "torch.cuda.is_available() is False; pass devices= (for "
                "example ['cpu'] * 8) for a CPU round")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a slot mesh needs at least one device")
    return mesh


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
