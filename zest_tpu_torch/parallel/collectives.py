"""The pod round's byte distribution: stage → gather → replicate → read.

The counterpart of ``zest_tpu/parallel/collectives.py``. Each slot stages
the blobs it owns (per the rendezvous plan, ``parallel/plan.py``) into
rows of a pool, and every slot ends with every row. Row protocol: each
fetch unit gets one fixed-capacity row ``[u32le length][blob bytes][zero
padding]``; the capacity comes from the plan (identical on every host, no
negotiation) and rows are grouped by owner, so band *h* of the pool is
exactly slot *h*'s contribution.

- One process: the global rows are packed in host memory (pinned when a
  slot is a CUDA device), each slot's band goes to its device, and the
  replicate step copies every band onto every slot device — where the
  JAX package lets XLA emit the all-gather of a sharded → replicated
  resharding.
- Several processes (``torch.distributed`` initialised, world size > 1):
  each packs the bands of its own slots, equal in shape on every rank
  (``PoolLayout`` pads every slot to the same rows), and
  ``dist.all_gather_into_tensor`` over the default group (NCCL for cuda,
  gloo on the CPU) gathers them; the result is copied to each local slot.

:class:`GatheredPool` reads a wave back with one device-to-host copy and
hands each blob to a range-aware cache (disk, HBM staging or tiered).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from zest_tpu_torch.parallel.mesh import local_slots, num_slots, world_size
from zest_tpu_torch.parallel.plan import DistributionPlan, FetchAssignment
from zest_tpu_torch.transfer.bridge import FETCH_ERRORS

_LEN_HEADER = 4
_ROW_ALIGN = 128
# The reference's 16-way concurrent fetcher.
FETCH_WORKERS = 16

UnitKey = tuple[str, int]


def _round_up(n: int, align: int) -> int:
    return (n + align - 1) // align * align


@dataclass(frozen=True)
class PoolLayout:
    """The plan's row layout, computed the same everywhere: ``rows_per_host``
    rows per slot (padded to the largest share so bands are equal); unit
    *i* of slot *h* lives at row ``h * rows_per_host + i``."""

    num_hosts: int
    rows_per_host: int
    row_len: int
    # (hash_hex, range start) -> (row, chunk_offset)
    index: dict[UnitKey, tuple[int, int]]
    # per slot: its unit keys in row order
    host_keys: tuple[tuple[UnitKey, ...], ...]
    # hashes whose one planned unit starts at chunk 0: provably whole xorbs
    full_xorbs: frozenset[str]

    @property
    def total_rows(self) -> int:
        return self.num_hosts * self.rows_per_host

    @property
    def pool_bytes(self) -> int:
        return self.total_rows * self.row_len

    @staticmethod
    def from_plan(plan: DistributionPlan) -> "PoolLayout":
        by_owner = plan.by_owner()
        per_host = [by_owner.get(h, []) for h in range(plan.num_hosts)]
        rows_per_host = max((len(u) for u in per_host), default=0)
        max_blob = max((a.est_bytes for a in plan.assignments), default=0)
        index: dict[UnitKey, tuple[int, int]] = {}
        host_keys = []
        starts_by_hash: dict[str, list[int]] = {}
        for h, units in enumerate(per_host):
            keys = []
            for i, a in enumerate(units):
                start = a.fetch_info.range.start
                index[(a.hash_hex, start)] = (h * rows_per_host + i, start)
                keys.append((a.hash_hex, start))
                starts_by_hash.setdefault(a.hash_hex, []).append(start)
            host_keys.append(tuple(keys))
        # The bridge's evidence rule: whole only when the hash has exactly
        # one planned range and it starts at chunk 0.
        full = frozenset(hh for hh, starts in starts_by_hash.items()
                         if starts == [0])
        return PoolLayout(plan.num_hosts, rows_per_host,
                          _round_up(_LEN_HEADER + max_blob, _ROW_ALIGN),
                          index, tuple(host_keys), full)


def split_waves(plan: DistributionPlan, budget_bytes: int,
                pad_factor: int = 4) -> list[DistributionPlan]:
    """Split a plan into waves whose staged pool fits ``budget_bytes``.

    Units sorted by descending size set each wave's ``row_len`` by its
    first unit; a wave closes before its pool would pass the budget, or
    when a unit would pay more than ``pad_factor``× row padding. Every
    host computes the same split. A unit larger than the budget gets a
    wave of its own; ``budget_bytes <= 0`` is one wave."""
    if budget_bytes <= 0 or len(plan.assignments) <= 1:
        return [plan]
    units = sorted(plan.assignments, key=lambda a: (
        -a.est_bytes, a.hash_hex, a.fetch_info.range.start))
    waves: list[DistributionPlan] = []
    cur: list[FetchAssignment] = []
    counts: dict[int, int] = {}
    rows_per_host = row_len = 0
    for a in units:
        need = _round_up(_LEN_HEADER + a.est_bytes, _ROW_ALIGN)
        if cur:
            new_rows = max(rows_per_host, counts.get(a.owner, 0) + 1)
            if (plan.num_hosts * new_rows * row_len > budget_bytes
                    or need * pad_factor < row_len):
                waves.append(DistributionPlan(plan.num_hosts, cur))
                cur, counts, rows_per_host = [], {}, 0
        if not cur:
            row_len = need
        cur.append(a)
        counts[a.owner] = counts.get(a.owner, 0) + 1
        rows_per_host = max(rows_per_host, counts[a.owner])
    if cur:
        waves.append(DistributionPlan(plan.num_hosts, cur))
    return waves


def pack_rows(layout: PoolLayout, blobs: dict[UnitKey, bytes], host: int,
              out: np.ndarray | None = None) -> np.ndarray:
    """Slot ``host``'s band of the pool: its owned blobs in row order,
    written into ``out`` (zeroed, ``(rows_per_host, row_len)``) or a new
    array. A missing or over-capacity blob leaves a zero row, which
    readers take as a miss: the waterfall serves that unit later."""
    if out is None:
        out = np.zeros((layout.rows_per_host, layout.row_len), np.uint8)
    base = host * layout.rows_per_host
    for key in layout.host_keys[host]:
        blob = blobs.get(key)
        if blob is None or _LEN_HEADER + len(blob) > layout.row_len:
            continue
        r = layout.index[key][0] - base
        out[r, :_LEN_HEADER] = np.frombuffer(
            len(blob).to_bytes(_LEN_HEADER, "little"), np.uint8)
        out[r, _LEN_HEADER:_LEN_HEADER + len(blob)] = np.frombuffer(
            blob, np.uint8)
    return out


def fetch_owned_blobs(plan: DistributionPlan, fetch_fn, slot: int,
                      workers: int = FETCH_WORKERS) -> dict[UnitKey, bytes]:
    """Fetch every unit ``slot`` owns, ``workers`` at once. A fetch that
    fails through the waterfall (``FETCH_ERRORS``) leaves its key out, so
    one bad unit never aborts a round; any other error raises."""
    owned = plan.for_host(slot)

    def one(a):
        try:
            return (a.hash_hex, a.fetch_info.range.start), fetch_fn(a)
        except FETCH_ERRORS:
            return None

    if len(owned) <= 1 or workers <= 1:
        results = [one(a) for a in owned]
    else:
        with ThreadPoolExecutor(min(workers, len(owned)),
                                thread_name_prefix="zest-pod") as pool:
            results = list(pool.map(one, owned))
    return dict(r for r in results if r is not None)


def _host_rows(n_rows: int, row_len: int, pin: bool) -> torch.Tensor:
    return torch.zeros((n_rows, row_len), dtype=torch.uint8, pin_memory=pin)


def _pins(mesh) -> bool:
    return any(d.type == "cuda" for d in mesh)


def pack_global_rows(layout: PoolLayout, plan: DistributionPlan, fetch_fn,
                     slot: int | None,
                     local_shards: dict[int, dict[UnitKey, bytes]] | None
                     = None, pin: bool = False) -> torch.Tensor:
    """One process's whole pool in host memory (pinned with ``pin``).

    ``slot=None``: this process drives every slot and fetches every band.
    An explicit ``slot`` stands for one host of a multi-host pod: only
    that band is fetched, the others come from ``local_shards`` (tests)
    or stay zero."""
    rows = _host_rows(layout.total_rows, layout.row_len, pin)
    view = rows.numpy()
    per = layout.rows_per_host
    for h in range(plan.num_hosts):
        band = view[h * per:(h + 1) * per]
        if local_shards and h in local_shards:
            pack_rows(layout, local_shards[h], h, band)
        elif slot is None or h == slot:
            pack_rows(layout, fetch_owned_blobs(plan, fetch_fn, h), h, band)
    return rows


def _synchronize(mesh) -> None:
    for d in {d for d in mesh if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def _replicate(mesh, bands: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every band copied, in order, onto every slot device: one replica of
    the whole pool per slot."""
    n_rows = sum(b.shape[0] for b in bands)
    replicas = []
    for d in mesh:
        out = torch.empty((n_rows, bands[0].shape[1]), dtype=torch.uint8,
                          device=d)
        row = 0
        for b in bands:
            out[row:row + b.shape[0]].copy_(b, non_blocking=True)
            row += b.shape[0]
        replicas.append(out)
    _synchronize(mesh)
    return replicas


def _all_gather(mesh, local: torch.Tensor, n_rows: int) -> torch.Tensor:
    """This process's bands gathered with every other rank's, in rank
    order, over the default group (on the first slot's card under NCCL,
    in host memory under gloo)."""
    comm = mesh[0] if dist.get_backend() == "nccl" else torch.device("cpu")
    out = torch.empty((n_rows, local.shape[1]), dtype=torch.uint8,
                      device=comm)
    dist.all_gather_into_tensor(out, local.to(comm))
    return out


class GatheredPool:
    """The pool after the gather: every slot holds every row
    (``replicas``, one tensor per slot)."""

    def __init__(self, layout: PoolLayout, replicas: list[torch.Tensor]):
        self.layout = layout
        self.replicas = replicas
        self._host_view: np.ndarray | None = None

    def _rows(self) -> np.ndarray:
        if self._host_view is None:
            self._host_view = self.replicas[0].cpu().numpy()
        return self._host_view

    def blob(self, hash_hex: str,
             range_start: int) -> tuple[bytes, int] | None:
        """``(blob bytes, chunk_offset)`` of a fetch unit, or None."""
        loc = self.layout.index.get((hash_hex, range_start))
        if loc is None:
            return None
        row, chunk_offset = loc
        raw = self._rows()[row]
        n = int.from_bytes(raw[:_LEN_HEADER].tobytes(), "little")
        if n == 0 or _LEN_HEADER + n > self.layout.row_len:
            return None
        return raw[_LEN_HEADER:_LEN_HEADER + n].tobytes(), chunk_offset

    def fill_cache(self, cache, verify=None) -> tuple[int, int]:
        """Seed a range-aware cache with every gathered blob; afterwards
        the waterfall's cache tier serves every planned unit.

        ``verify(hash_hex, data)`` gates full-key writes (a partial blob's
        chunks are checked at extraction); a blob it rejects is not
        cached. Only a blob proven whole (``layout.full_xorbs``) takes the
        full key. Returns ``(filled, rejected)``."""
        filled = rejected = 0
        for hash_hex, range_start in self.layout.index:
            got = self.blob(hash_hex, range_start)
            if got is None:
                continue
            data, chunk_offset = got
            if chunk_offset == 0 and hash_hex in self.layout.full_xorbs:
                if verify is not None and not verify(hash_hex, data):
                    rejected += 1
                    continue
                cache.put(hash_hex, data)
            else:
                cache.put_partial(hash_hex, chunk_offset, data)
            filled += 1
        return filled, rejected


class PodDistributor:
    """One distribution round over a slot mesh: stage → gather → index.

    ``fetch_fn(assignment) -> bytes`` is called only for units a local slot
    owns and must return exactly the unit's chunk range; a unit whose
    fetch fails leaves a zero row, and readers fall through the waterfall
    for it."""

    def __init__(self, mesh):
        self.mesh = list(mesh)

    def local_slots(self) -> list[int]:
        return local_slots(self.mesh)

    def distribute(self, plan: DistributionPlan, fetch_fn,
                   host: int | None = None,
                   local_shards: dict[int, dict[UnitKey, bytes]] | None
                   = None) -> GatheredPool:
        """Run the round. One process: ``host=None`` fetches every slot's
        band; an explicit ``host`` stands for one host of a multi-host
        pod, ``local_shards`` pre-supplying other slots (tests). Several
        processes: each packs the bands of its own slots."""
        n = num_slots(self.mesh)
        if plan.num_hosts != n:
            raise ValueError(f"plan built for {plan.num_hosts} hosts, the "
                             f"mesh has {n} slots")
        layout = PoolLayout.from_plan(plan)
        if layout.total_rows == 0:
            return GatheredPool(layout, [
                torch.zeros((0, layout.row_len or _ROW_ALIGN),
                            dtype=torch.uint8, device=d) for d in self.mesh])
        pin = _pins(self.mesh)
        per = layout.rows_per_host
        if world_size() == 1:
            rows = pack_global_rows(layout, plan, fetch_fn, host,
                                    local_shards, pin=pin)
            bands = [rows[h * per:(h + 1) * per].to(d, non_blocking=True)
                     for h, d in enumerate(self.mesh)]
        else:
            local = _host_rows(len(self.mesh) * per, layout.row_len, pin)
            view = local.numpy()
            for j, slot in enumerate(self.local_slots()):
                pack_rows(layout, fetch_owned_blobs(plan, fetch_fn, slot),
                          slot, view[j * per:(j + 1) * per])
            bands = [_all_gather(self.mesh, local, layout.total_rows)]
        replicas = _replicate(self.mesh, bands)
        return GatheredPool(layout, replicas)


def all_gather_throughput(mesh, mbytes_per_device: int = 64,
                          iters: int = 5) -> float:
    """GB/s of the round's gather + replicate over ``mesh``: bytes that
    reach a slot from another slot, ``per_slot × (n - 1) × n``, over the
    wall time of one step (synchronised)."""
    n = num_slots(mesh)
    per_dev = mbytes_per_device * 1024 * 1024
    shape = (per_dev // _ROW_ALIGN, _ROW_ALIGN)
    if world_size() == 1:
        bands = [torch.zeros(shape, dtype=torch.uint8, device=d)
                 for d in mesh]

        def step():
            return _replicate(mesh, bands)
    else:
        local = _host_rows(len(mesh) * shape[0], _ROW_ALIGN, _pins(mesh))

        def step():
            return _replicate(mesh, [_all_gather(mesh, local,
                                                 n * shape[0])])
    step()  # warm: allocator, NCCL communicator
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    dt = (time.perf_counter() - t0) / iters
    return per_dev * (n - 1) * n / dt / 1e9
