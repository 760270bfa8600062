"""Two-tier distribution for multi-pod pulls: across pods, then in a pod.

The counterpart of ``zest_tpu/parallel/hierarchy.py``. At multi-pod scale
the fabric has two tiers: a fast one inside each pod (NVLink between the
GPUs of a node, ICI on a TPU pod) and a slower one between pods (the data
center network). A flat rendezvous plan balances CDN ingress over hosts
but says nothing about what crosses the slow tier, so this module adds
two levels:

- **Two-level ownership**: a fetch unit is rendezvous-hashed first to an
  owning pod (balancing CDN and cross-pod ingress per pod), then to an
  owning host in that pod. Every process computes the same (pod, host)
  with no coordination, and the two draws are independent.
- **Two-stage gather** over a ``(pods, hosts)`` slot mesh: stage 1 gives
  slot ``(p, h)`` the bands of every ``(p', h)`` (the cross-pod tier: each
  unit crosses it once per destination pod); stage 2 gives it its pod's
  other hosts' bands (the in-pod tier). Each stage is timed on its own
  (CUDA events on a card), which is what the per-tier metrics read; staged
  or fused, the bytes moved are the same.

Slots are ``torch.device``s and one device may stand in several slots, as
in the rest of the port's slot meshes, so both stages are device copies on
one card where only one card exists. With several processes
(``torch.distributed`` initialised), each process packs the bands of its
own slots, stage 1 is one all-gather over the default group (gloo on the
CPU, NCCL for CUDA slots) from which each slot takes its column, and stage
2 fills each slot's remaining bands from its pod's local slots or the
gathered rows.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.reconstruction import Reconstruction
from zest_tpu_torch.parallel.collectives import (
    GatheredPool,
    PoolLayout,
    _all_gather,
    _host_rows,
    _synchronize,
    fetch_owned_blobs,
    pack_global_rows,
    pack_rows,
)
from zest_tpu_torch.parallel.mesh import SlotMesh, model_mesh, world_size
from zest_tpu_torch.parallel.plan import (
    DistributionPlan,
    FetchAssignment,
    collect_units,
    owner_host,
)

PODS_AXIS = "pods"
HOSTS_AXIS = "hosts"

# Domain-separation salts: the pod draw and the host draw are independent.
_POD_SALT = b"zest-hier-pod"
_HOST_SALT = b"zest-hier-host"


def hier_mesh(n_pods: int, hosts_per_pod: int, devices=None) -> SlotMesh:
    """The ``(pods, hosts)`` slot mesh over ``devices`` (default every
    CUDA device, which raises without a card; a device may repeat).
    Consecutive slots share a pod. Raises ``ValueError`` when the slot
    count is not ``n_pods * hosts_per_pod``."""
    return model_mesh({PODS_AXIS: n_pods, HOSTS_AXIS: hosts_per_pod},
                      devices)


def owner_pod_host(xorb_hash: bytes, range_start: int, n_pods: int,
                   hosts_per_pod: int) -> tuple[int, int]:
    """Two independent rendezvous draws: the owning pod, then the host in
    the pod."""
    pod = owner_host(_POD_SALT + xorb_hash, range_start, n_pods)
    host = owner_host(_HOST_SALT + xorb_hash, range_start, hosts_per_pod)
    return pod, host


@dataclass
class HierarchicalPlan:
    """A :class:`DistributionPlan` over ``n_pods * hosts_per_pod`` global
    slots whose owners encode (pod, host) pod-major (slot = pod *
    hosts_per_pod + host), so the pool layout and packing of
    ``parallel/collectives.py`` apply unchanged; only the owners
    differ."""

    n_pods: int
    hosts_per_pod: int
    flat: DistributionPlan

    @staticmethod
    def build(recs: list[Reconstruction], n_pods: int,
              hosts_per_pod: int) -> "HierarchicalPlan":
        assignments = []
        for (hh, start), fi in collect_units(recs):
            pod, host = owner_pod_host(hashing.hex_to_hash(hh), start,
                                       n_pods, hosts_per_pod)
            assignments.append(FetchAssignment(
                hh, fi, pod * hosts_per_pod + host))
        return HierarchicalPlan(n_pods, hosts_per_pod, DistributionPlan(
            n_pods * hosts_per_pod, assignments))

    def bytes_per_pod(self) -> list[int]:
        """CDN and cross-pod ingress per pod: the first level's balance."""
        out = [0] * self.n_pods
        for a in self.flat.assignments:
            out[a.owner // self.hosts_per_pod] += a.est_bytes
        return out

    def summary(self) -> dict:
        per_pod = self.bytes_per_pod()
        peak = max(per_pod) if per_pod else 0
        mean = sum(per_pod) / self.n_pods if self.n_pods else 0
        s = self.flat.summary()
        s["pods"] = self.n_pods
        s["bytes_per_pod"] = per_pod
        s["pod_balance"] = round(mean / peak, 4) if peak else 1.0
        return s


class _StageTimer:
    """Wall seconds of one stage: CUDA events on every slot device when
    all slots are on cards (the longest device), else the host clock
    around synchronised work."""

    def __init__(self, devices) -> None:
        self.devices = list(dict.fromkeys(devices))
        self.cuda = all(d.type == "cuda" for d in self.devices)

    def __enter__(self):
        _synchronize(self.devices)
        if self.cuda:
            self._events = []
            for d in self.devices:
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(d))
                self._events.append((d, start))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.cuda:
            ends = []
            for d, start in self._events:
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(d))
                ends.append((start, end))
            _synchronize(self.devices)
            self.seconds = max(s.elapsed_time(e) for s, e in ends) / 1e3
        else:
            _synchronize(self.devices)
            self.seconds = time.perf_counter() - self._t0


class HierarchicalDistributor:
    """One multi-pod distribution round over a ``(pods, hosts)`` slot
    mesh: pack the owner bands, gather across pods, gather in each pod.

    One process drives every slot (``local_shards`` may pre-supply other
    slots' blobs, as in the tests); with several processes each fetches
    and packs the bands of the slots it owns."""

    def __init__(self, mesh: SlotMesh):
        if tuple(mesh.axis_names) != (PODS_AXIS, HOSTS_AXIS):
            raise ValueError(
                f"expected a (pods, hosts) mesh, got {mesh.axis_names}")
        self.mesh = mesh
        self.n_pods = mesh.shape[PODS_AXIS]
        self.hosts_per_pod = mesh.shape[HOSTS_AXIS]
        # Filled by distribute(): each stage's seconds and the layout.
        self.stage_seconds: dict[str, float] = {}
        self._layout: PoolLayout | None = None

    def distribute(self, plan: HierarchicalPlan, fetch_fn,
                   slot: int | None = None,
                   local_shards: dict[int, dict[tuple[str, int], bytes]]
                   | None = None) -> GatheredPool:
        """Run the round; ``fetch_fn(assignment) -> bytes`` is called for
        the units this process's slots own (``slot`` alone, when given, in
        one process). Returns the pool with one replica of every row per
        local slot; a failed fetch leaves a zero row (a miss)."""
        if (plan.n_pods, plan.hosts_per_pod) != (self.n_pods,
                                                 self.hosts_per_pod):
            raise ValueError(
                f"plan is {plan.n_pods}×{plan.hosts_per_pod}, mesh is "
                f"{self.n_pods}×{self.hosts_per_pod}")
        flat = plan.flat
        layout = PoolLayout.from_plan(flat)
        self._layout = layout
        slots = self.mesh.local_slots()
        devices = self.mesh.local_devices()
        if layout.total_rows == 0:
            return GatheredPool(layout, [
                torch.zeros((0, layout.row_len or 128), dtype=torch.uint8,
                            device=d) for d in devices])
        P, H = self.n_pods, self.hosts_per_pod
        R, L = layout.rows_per_host, layout.row_len
        pin = any(d.type == "cuda" for d in devices)

        def band(rows: torch.Tensor, s: int) -> torch.Tensor:
            return rows[s * R:(s + 1) * R]

        owned: dict[int, torch.Tensor] = {}
        gathered: torch.Tensor | None = None

        def source(s: int) -> torch.Tensor:
            """Slot ``s``'s owner band: on its own device in one process,
            in the gathered rows with several."""
            return owned[s] if gathered is None else band(gathered, s)

        multi = world_size() > 1
        if not multi:
            rows = pack_global_rows(layout, flat, fetch_fn, slot,
                                    local_shards, pin=pin)
            owned = {s: band(rows, s).to(d, non_blocking=True)
                     for s, d in zip(slots, devices)}
        else:
            local = _host_rows(len(slots) * R, L, pin)
            view = local.numpy()
            for j, s in enumerate(slots):
                pack_rows(layout, fetch_owned_blobs(flat, fetch_fn, s), s,
                          view[j * R:(j + 1) * R])

        after_dcn: dict[int, torch.Tensor] = {}
        with _StageTimer(devices) as dcn:   # stage 1: across pods
            if multi:
                gathered = _all_gather(devices, local, layout.total_rows)
            for s, d in zip(slots, devices):
                h = s % H
                col = torch.empty((P, R, L), dtype=torch.uint8, device=d)
                for p in range(P):
                    col[p].copy_(source(p * H + h), non_blocking=True)
                after_dcn[s] = col
        with _StageTimer(devices) as ici:   # stage 2: inside each pod
            replicas = []
            for s, d in zip(slots, devices):
                p0 = s // H
                out = torch.empty((P, H, R, L), dtype=torch.uint8, device=d)
                for h in range(H):
                    peer = after_dcn.get(p0 * H + h)
                    if peer is not None:
                        out[:, h].copy_(peer, non_blocking=True)
                    else:  # the pod's host h is another process's slot
                        for p in range(P):
                            out[p, h].copy_(source(p * H + h),
                                            non_blocking=True)
                replicas.append(out.view(P * H * R, L))
        self.stage_seconds = {"dcn": dcn.seconds, "ici": ici.seconds}
        return GatheredPool(layout, replicas)

    def stage_stats(self) -> dict:
        """Bytes each stage moved and its measured seconds and rate.

        The basis is ``layout.pool_bytes``, what the stages carry
        (fixed-capacity rows, padded), summed over receiving slots: stage
        1 gives each of P·H slots (P-1) owner bands of pool/(P·H), stage 2
        gives each (H-1) pod bands of pool/H."""
        if self._layout is None:
            raise RuntimeError("stage_stats before distribute()")
        pool = self._layout.pool_bytes
        out = {
            "pool_bytes": pool,
            "dcn_bytes": pool * (self.n_pods - 1),
            "ici_bytes": pool * self.n_pods * (self.hosts_per_pod - 1),
        }
        for name, secs in self.stage_seconds.items():
            out[f"{name}_seconds"] = round(secs, 6)
            moved = out[f"{name}_bytes"]
            out[f"{name}_gbps"] = (round(moved / secs / 1e9, 3)
                                   if secs > 0 else 0.0)
        return out
