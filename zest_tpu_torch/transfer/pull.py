"""``pull``: download a model repo into the HF cache and land it on a device.

The counterpart of ``zest_tpu/transfer/pull.py`` for one host: resolve the
revision, list files, then land the checkpoint on ``device`` straight from
the xorb cache (:func:`_try_direct_stage`), before any file is written:

- a warm fetch fills the cache through the cache → peer → CDN waterfall,
  one shard ahead, its units in layer order (``_PipelinedWarm``);
- the streaming landing (``models.loader.stage_cached_to_hbm``) decodes
  each tensor as soon as its units are cached into a pinned ring slot and
  commits embedding and layer 0 first (``time_to_first_layer_s``);
- the HF-cache file of each shard is written from the same ring slots
  (``_StreamFileSink``: no second decode), and every other file goes
  through a bounded file pipeline (``_FilePipeline``) whose writes commit
  (fsync + rename) at the pull's end. A file whose units are cached is
  written by the copy-range cache lane (:func:`_write_file_from_cache`:
  stored runs move with ``copy_file_range``, the rest decodes in place);
  the reconstruction waterfall writes the rest: first the
  ``ParallelDownloader`` (``transfer/parallel.py``) over one term-fetch
  pool of ``max_concurrent_downloads`` threads that the whole pull
  shares, its temp file committed at the same barrier; then the bridge's
  ``reconstruct_to_file``; last the plain download of the whole file.

The disk-staging landing (files first, then
``models.loader.stage_snapshot_to_hbm``) runs only where the JAX package
runs it: when the snapshot's safetensors files are already complete, or a
shard is not a xet file. Any other error of the direct landing — a torch
or CUDA error, an out-of-memory, a fault in the ring or the commit —
fails the pull; a corrupt cache entry heals through the per-term
waterfall.

``device`` is ``cuda`` unless the caller passes ``cpu``; there is no
silent fallback. The stats keep the JAX package's names and meaning:
``elapsed_s`` (whole pull), ``time_to_hbm_s`` (pull start → every tensor
resident), ``time_to_first_layer_s`` (→ embedding and first layer
resident; streaming only), ``stages`` (per-stage wall seconds, the union
of each stage's intervals), ``stages_busy`` (summed thread-seconds),
``stages_gbps``, ``files_pipeline`` (bytes per file lane: ``tensors``
from the landing's slots, ``waterfall`` through the reconstruction),
``files_after_hbm_s``, ``files_hbm_span_s`` and ``hbm`` (the landing's
block). ``fallback_files`` counts xet files whose reconstruction failed
and that came whole from ``resolve`` instead.

**Tracing**: the pull runs in a ``pull`` span, every stage in a
``stage.<name>`` span; with a tracer installed (``ZEST_TRACE`` or
``telemetry.trace.install``) the stats carry ``critical_path``, the
blame-attributed path through this pull's window
(:mod:`~zest_tpu_torch.telemetry.critpath`). The pull-path metrics
(``zest_pulls_total``, ``zest_stage_seconds``, ``zest_time_to_hbm_seconds``,
the ``zest_last_pull_*`` gauges, ...) carry the JAX package's names.

**Delta pull and hot-swap** (``Config.delta_pull``, ``ZEST_DELTA``): a
pull of revision B over a locally evidenced revision A diffs B's term
lists against A's manifest before any byte moves
(:mod:`~zest_tpu_torch.transfer.delta`), and the warm fetch and the
cooperative round move only the changed units. With ``base_params`` (A's
tree resident on ``device``) and ``base_revision``, every tensor whose
chunk cover is unchanged is reused as the same tensor, only the changed
tensors land, and the base dict is consumed as their replacements commit
(``stats["hbm"]["swap"]``, ``stats["delta"]``, ``time_to_swap_s``).
Missing evidence degrades to a full pull, says so on stderr and records a
``delta_degraded`` flight event (``telemetry.record``).

**Cooperative pull** (``coop=True`` with ``coop_hosts``, ``coop_index``
and the other hosts' DCN addresses, or ``ZEST_COOP*``): before the
landing, ``transfer/coop.coop_round`` fetches this host's share of the
deduplicated xorb units and pulls the rest from their owners over the DCN
chunk RPC (the collective exchange first), verifying every received
whole xorb on ``device``, both phases in layer order; the landing then
reads the cache. ``stats["coop"]`` is the round's block and
``stats["peer_served_ratio"]`` its headline. Without explicit addresses
the hosts find each other's DCN endpoints, and a shared trace nonce,
through the ``torch.distributed`` store (``coop.exchange_addrs_via_kv``).
Only a missing topology
(:class:`~zest_tpu_torch.transfer.coop.CoopUnavailable`) or a connection
failure degrades the pull to the per-host waterfall; any other error of
the round — a kernel that does not build or launch — fails the pull.

**Federated pull** (``pods``, ``pod_index``, ``pod_addrs``: pods that are
separate processes or jobs): after the cooperative round and before the
pod round, ``transfer/federated.federated_round`` fetches this pod's share
of the units through the waterfall and every other pod's from its owner
over the DCN chunk RPC (``pod_addrs``: pod index → its DCN address; a pod
without one degrades to the waterfall), so the pod round spreads a warm
cache (``stats["federated"]``). A fetch error degrades the pull to the
per-host waterfall.

**Pod round** (``pod``; on by default for ``cuda``, forced with
``ZEST_TPU_POD=1/0``): after the cooperative round,
``transfer/pod.pod_round`` distributes the units over the slot mesh of
every CUDA device and fills the cache before the landing
(``stats["pod"]``; on one card ``{"slots": 1, ..., "skipped": true}``).
An expert-sharded family (Mixtral, ``models.registry``) takes the
expert-routed round instead (``transfer/pod.expert_pod_round``): the
shared units through the plain round, each expert's private units fetched
only by the slots that own it (``stats["pod"]["expert_routed"]``). Its
pre-pass (the safetensors headers) degrades to the plain round only on a
fetch or header-parse error. With several processes they agree first,
over ``torch.distributed``, that every one has its reconstructions and
its expert pre-pass.

**Mesh landing** (``mesh=``, a ``parallel.mesh.SlotMesh``; without it on
``cuda``, ``Config.mesh`` (``ZEST_TPU_MESH``) over every CUDA device):
every tensor lands as a ``ShardedTensor`` laid out by the family's shard
rules (``models.registry``; config.json is fetched before the landing),
through the direct landing and the disk staging alike, and the pod
pre-pass runs over the mesh's slots. ``stats["hbm"]["sharded"]`` is true
and ``stats["mesh"]`` the mesh's shape; ``params_digest`` of the tree is
the unsharded landing's. A sharded tree hot-swaps in place as a plain
one does (``base_params`` a tree landed over the mesh): a base
``ShardedTensor`` is reused only when its mesh, its spec (what the
family's rules give the tensor over this mesh now), its global shape and
its landed dtype are this landing's, and a delta pull runs the pod
pre-pass over the mesh's slots, so the kernels verify the units the round
fills.

**Peer tier** (``swarm=``): a ``transfer.swarm.SwarmDownloader`` whose
direct peers (``--peer HOST:PORT``) the bridge asks before the CDN, for
every unit the warm fetches, every head term of the header fetch and
every term of the waterfall; each peer blob is checked at the trust
boundary (``transfer/bridge.py``). Without one, the pull builds a swarm
with no candidates (:func:`_default_swarm`) unless ``no_p2p``. The
swarm's block is ``stats["swarm"]``; a pull with ``cfg.pull_deadline_s``
also reports ``stats["deadline"]``.
"""

from __future__ import annotations

import contextlib
import errno
import gc
import mmap
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import (
    FIRST_EXCEPTION,
    ThreadPoolExecutor,
    wait,
)
from pathlib import Path

import numpy as np
import torch

from zest_tpu_torch import storage, telemetry
from zest_tpu_torch.cas.client import CasError
from zest_tpu_torch.cas.xorb import XorbReader
from zest_tpu_torch.cas.hub import HubClient, HubError
from zest_tpu_torch.config import DEFAULT_DEVICE, Config, resolve_device
from zest_tpu_torch.models.direct import (
    CachedFileReader,
    DirectLandingError,
    tensor_unit_keys,
    unit_layer_priorities,
    unit_priority_sort_key,
)
from zest_tpu_torch.models.loader import (
    resolve_dtype,
    spec_for,
    stage_cached_to_hbm,
    stage_snapshot_to_hbm,
)
from zest_tpu_torch.models.safetensors_io import tensor_bytes
from zest_tpu_torch.parallel.mesh import (
    SlotMesh,
    mesh_from_config,
    num_slots,
    pod_mesh,
    world_size,
)
from zest_tpu_torch.parallel.sharding import ShardedTensor, same_mesh
from zest_tpu_torch.parallel.plan import collect_units
from zest_tpu_torch.resilience import Deadline
from zest_tpu_torch.telemetry.fleet import mint_trace_id
from zest_tpu_torch.transfer import delta
from zest_tpu_torch.transfer import pod as pod_mod
from zest_tpu_torch.transfer.bridge import FETCH_ERRORS, XetBridge
from zest_tpu_torch.transfer.coop import (
    CoopUnavailable,
    coop_round,
    exchange_addrs_via_kv,
    share_nonce_via_kv,
)
from zest_tpu_torch.transfer.dcn import DcnServer
from zest_tpu_torch.transfer.parallel import ParallelDownloader
from zest_tpu_torch.transfer.federated import (
    _entries_by_hash,
    federated_round,
    warm_units_parallel,
)
from zest_tpu_torch.transfer.pod import (
    expert_pod_round,
    fetch_file_header,
    fetch_header_probe,
    pod_round,
)
from zest_tpu_torch.transfer import tenancy
from zest_tpu_torch.transfer.tenancy import (  # noqa: F401 - re-export
    ByteBudget,
    CancelToken,
    PullCancelled,
)

_M_PULLS = telemetry.counter(
    "zest_pulls_total", "Pulls finished, by outcome", ("outcome",))
_M_PULL_SECONDS = telemetry.histogram(
    "zest_pull_seconds", "End-to-end pull wall time")
_M_TTH_SECONDS = telemetry.histogram(
    "zest_time_to_hbm_seconds", "Pull start → weights resident in HBM")
_M_TTFL_SECONDS = telemetry.histogram(
    "zest_time_to_first_layer_seconds",
    "Pull start → first-token-capable set (embedding + layer 0) "
    "resident in HBM (streaming landing)")
# Last-pull gauges: how the most recent landing did (the histograms
# aggregate every pull).
_M_LAST_TTFL = telemetry.gauge(
    "zest_last_pull_first_layer_seconds",
    "time_to_first_layer_s of the most recent streaming landing")
_M_LAST_TTH = telemetry.gauge(
    "zest_last_pull_hbm_seconds",
    "time_to_hbm_s of the most recent --device pull")
_M_LAST_RING_STALLS = telemetry.gauge(
    "zest_last_pull_ring_stalls",
    "Ring producer stalls during the most recent streaming landing "
    "(the cumulative zest_land_ring_stalls_total would misattribute "
    "earlier pulls' stalls to the last one)")
_M_LAST_DELTA_RATIO = telemetry.gauge(
    "zest_last_pull_delta_ratio",
    "Network-fetched fraction of the most recent pull's checkpoint "
    "bytes when a delta plan ran (0.0 = fully reused from the local "
    "cache); -1 when the last pull was not a delta")
_M_LAST_SWAP = telemetry.gauge(
    "zest_last_pull_swap_seconds",
    "time_to_swap_s of the most recent in-place hot-swap delta pull "
    "(0 when the last pull was not a hot-swap)")
_M_STAGE_SECONDS = telemetry.histogram(
    "zest_stage_seconds", "Per-entry stage wall time", ("stage",))
_M_STAGE_BYTES = telemetry.counter(
    "zest_stage_bytes_total", "Payload bytes attributed per stage",
    ("stage",))
_M_FILES_BYTES = telemetry.counter(
    "zest_files_bytes_total",
    "HF-cache bytes materialized by the background files lane, by lane",
    ("lane",))
_M_SLO_BREACHES = telemetry.counter(
    "zest_slo_breaches_total",
    "Pulls that breached an armed SLO budget (ZEST_SLO_TTHBM_S / "
    "ZEST_SLO_TTFL_S)", ("slo",))


class PullResult:
    """The snapshot path, stats, and the landed name→tensor tree. The
    result owns the device buffers: drop it to release them."""

    def __init__(self, snapshot_dir: Path, stats: dict, params=None):
        self.snapshot_dir = snapshot_dir
        self.stats = stats
        self.params = params

    def __fspath__(self) -> str:
        return str(self.snapshot_dir)

    def __str__(self) -> str:
        return str(self.snapshot_dir)


class StageClock:
    """Per-stage timing of one pull from raw ``(start, end)`` intervals,
    recorded from any thread: :meth:`summary` is each stage's wall time
    (the union of its intervals, so concurrent entries count once),
    :meth:`busy_summary` its summed thread-seconds (``busy > wall`` shows
    parallelism within a stage), :meth:`span` the union over several
    stages, and :meth:`gbps_summary` the rate of stages with noted
    bytes.

    Every stage entry opens a ``stage.<name>`` span, so a trace shows the
    intervals the stats report, and observes ``zest_stage_seconds``;
    noted bytes go to ``zest_stage_bytes_total``. The summaries come from
    the same intervals whether telemetry is on or off."""

    def __init__(self):
        self._lock = threading.Lock()
        self._intervals: dict[str, list[tuple[float, float]]] = {}
        self._bytes: dict[str, int] = {}
        # Stage entry/exit observer (the pull session's live ``phase``):
        # a handful of calls per pull, never per chunk, and never allowed
        # to break the pull.
        self.observer = None

    def _notify(self, stage: str, entered: bool) -> None:
        obs = self.observer
        if obs is not None:
            try:
                obs(stage, entered)
            except Exception:  # noqa: BLE001 - observers are advisory
                pass

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.monotonic()
        self._notify(stage, True)
        try:
            with telemetry.span(f"stage.{stage}"):
                yield
        finally:
            self.note_interval(stage, t0, time.monotonic())
            self._notify(stage, False)

    def ensure(self, stage: str) -> None:
        """Report ``stage`` (as 0.0) even when nothing entered it."""
        with self._lock:
            self._intervals.setdefault(stage, [])

    def note_interval(self, stage: str, t0: float, t1: float) -> None:
        """Record an interval measured elsewhere (monotonic seconds)."""
        if t1 < t0:
            t0, t1 = t1, t0
        with self._lock:
            self._intervals.setdefault(stage, []).append((t0, t1))
        _M_STAGE_SECONDS.observe(t1 - t0, stage=stage)

    def note_bytes(self, stage: str, nbytes: int) -> None:
        with self._lock:
            self._bytes[stage] = self._bytes.get(stage, 0) + int(nbytes)
        _M_STAGE_BYTES.inc(int(nbytes), stage=stage)

    @staticmethod
    def _coverage(intervals: list[tuple[float, float]]) -> float:
        total, end = 0.0, float("-inf")
        for s, e in sorted(intervals):
            if s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def span(self, *stages: str) -> float:
        """Union wall coverage of several stages together."""
        with self._lock:
            ivs = [iv for s in stages for iv in self._intervals.get(s, [])]
        return self._coverage(ivs)

    def coverage_after(self, stage: str, t: float) -> float:
        """``stage``'s union coverage after monotonic time ``t``: the
        ``files`` work that ran after the landing finished."""
        with self._lock:
            ivs = [(max(s, t), e)
                   for s, e in self._intervals.get(stage, []) if e > t]
        return self._coverage(ivs)

    def summary(self) -> dict[str, float]:
        with self._lock:
            items = {k: list(v) for k, v in self._intervals.items()}
        return {k: round(self._coverage(v), 4) for k, v in items.items()}

    def busy_summary(self) -> dict[str, float]:
        with self._lock:
            return {k: round(sum(e - s for s, e in v), 4)
                    for k, v in self._intervals.items()}

    def gbps_summary(self) -> dict[str, float]:
        """Effective GB/s of the stages with noted bytes (wall-based)."""
        walls = self.summary()
        with self._lock:
            noted = dict(self._bytes)
        return {k: round(n / walls[k] / 1e9, 3)
                for k, n in noted.items() if walls.get(k, 0.0) > 1e-3}


def _resolve_files_workers(n: int | None) -> int:
    """File-writer pool width: explicit value, else 2–4 by core count."""
    if n and n > 0:
        return int(n)
    return max(2, min(4, os.cpu_count() or 1))


def _hdr_fan(fn, items):
    """Map ``fn`` over independent KB-scale metadata fetches with one
    bounded pool (serialized they put shards × RTT on the first-layer
    path)."""
    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(min(8, len(items)),
                            thread_name_prefix="zest-hdr") as pool:
        return list(pool.map(fn, items))


def _is_complete(snapshot_dir: Path, entry) -> bool:
    """The one definition of "this file is already pulled"."""
    dest = snapshot_dir / entry.path
    return dest.exists() and dest.stat().st_size == entry.size


class _FilePipeline:
    """Bounded worker pool writing the HF-cache files.

    ``submit(entry)`` (deduplicated by path) runs ``work(entry)`` on one
    of ``width`` workers under a :class:`ByteBudget` of in-flight file
    bytes. The landing's write-behind hands a shard over with
    :meth:`submit_held` once it holds the shard's budget
    (:meth:`acquire_for`, which with ``async_handoff`` declines instead of
    waiting, so file writes never stall the landing); those jobs run on a
    separate ``materialize_workers`` pool, write under temp names and
    register with :meth:`defer_commit`. The streaming landing's
    per-tensor writes run on a third pool (:meth:`write_behind`), which
    no job ever waits in. :meth:`join` waits for every job, then fsyncs
    and renames every temp file: a pull killed before that leaves no
    complete-named partial file. The first error cancels queued work and
    re-raises from :meth:`join`.

    ``budget`` is the pull service's shared :class:`ByteBudget`: every
    acquire then clears both this pull's ``budget_bytes`` and the shared
    bound (``tenancy.StackedBudget``). ``cancel``, the session's token, is
    checked before each file: a fired token is the first error."""

    def __init__(self, width: int, budget_bytes: int, clock: StageClock,
                 work, skip_check=None, materialize_workers: int = 1,
                 async_handoff: bool = True, term_executor=None,
                 budget: ByteBudget | None = None,
                 cancel: CancelToken | None = None):
        self.width = max(1, int(width))
        local = ByteBudget(budget_bytes)
        self.budget = (local if budget is None
                       else tenancy.StackedBudget(local, budget))
        self.cancel_token = cancel
        # Worker threads stamp their recorder events with the session of
        # the pull that built the pipeline.
        self._session_id = telemetry.session.current_id()
        self.clock = clock
        self.work = work  # work(entry) -> "downloaded" | "skipped"
        self.skip_check = skip_check
        # The shared term-fetch pool the per-file ParallelDownloader
        # rides (bounds the fetch streams across concurrent files);
        # owned here, shut down with the other pools.
        self.term_executor = term_executor
        self.async_handoff = async_handoff
        self.materialize_workers = max(1, int(materialize_workers))
        self.downloaded = 0
        self.skipped = 0
        self.declined = 0
        # Bytes written per lane: "tensors" (from the landing's decoded
        # slots or host tensors), "waterfall" (reconstruction through
        # the cache → CDN chain, and regular files).
        self.lane_bytes: dict[str, int] = {}
        self._pending_commits: list[tuple[str, Path]] = []
        self._lock = threading.Lock()
        self._cancel = threading.Event()
        self._futures: dict[str, object] = {}
        self._pool = ThreadPoolExecutor(
            self.width, thread_name_prefix="zest-pull-file")
        # Held jobs own budget bytes from enqueue time, so they never
        # queue behind workers waiting for budget.
        self._prepared_pool = ThreadPoolExecutor(
            self.materialize_workers,
            thread_name_prefix="zest-pull-writeback")
        self._write_pool = ThreadPoolExecutor(
            self.materialize_workers,
            thread_name_prefix="zest-pull-tensor-write")

    def note_lane(self, lane: str, nbytes: int) -> None:
        with self._lock:
            self.lane_bytes[lane] = self.lane_bytes.get(lane, 0) + int(nbytes)
        _M_FILES_BYTES.inc(int(nbytes), lane=lane)

    def defer_commit(self, tmp: str, dest: Path) -> None:
        """Register a fully written temp file for the exit barrier."""
        with self._lock:
            self._pending_commits.append((tmp, dest))

    def submit(self, entry) -> None:
        with self._lock:
            if entry.path in self._futures:
                return
            self._futures[entry.path] = self._pool.submit(self._run, entry)

    def acquire_for(self, entry) -> bool:
        """Take ``entry.size`` budget bytes in the caller's thread; with
        ``async_handoff`` a full budget declines (False) instead."""
        if self.async_handoff:
            if not self.budget.try_acquire(entry.size):
                with self._lock:
                    self.declined += 1
                return False
        else:
            self.budget.acquire(entry.size)
        return True

    def write_behind(self, fn, *args):
        """Run one piece of a held shard's file write; returns its
        future."""
        return self._write_pool.submit(fn, *args)

    def submit_held(self, entry, prepared):
        """Queue ``prepared(entry)`` whose budget bytes the caller holds;
        returns its future. A duplicate path releases them and returns
        None (the caller then drops what it kept). ``prepared`` returns a
        status, or None to fall back to ``work``."""
        with self._lock:
            if entry.path in self._futures:
                self.budget.release(entry.size)
                return None
            fut = self._prepared_pool.submit(self._run_prepared, entry,
                                             prepared)
            # A job cancelled before it ran never reaches its own release.
            fut.add_done_callback(
                lambda f, n=entry.size:
                self.budget.release(n) if f.cancelled() else None)
            self._futures[entry.path] = fut
        return fut

    def _count(self, status) -> None:
        with self._lock:
            if status == "skipped":
                self.skipped += 1
            else:
                self.downloaded += 1

    def _run_prepared(self, entry, prepared) -> None:
        telemetry.session.use(self._session_id)
        try:
            if self._cancel.is_set():
                return
            if self.cancel_token is not None:
                self.cancel_token.check()
            with self.clock("files"):
                status = prepared(entry)
                if status is None:
                    status = self.work(entry)
        finally:
            self.budget.release(entry.size)
        self._count(status)

    def _run(self, entry) -> None:
        telemetry.session.use(self._session_id)
        if self._cancel.is_set():
            return
        if self.cancel_token is not None:
            # The session's cancel is this pipeline's first error: queued
            # files drop, and join re-raises it.
            self.cancel_token.check()
        if self.skip_check is not None and self.skip_check(entry):
            self._count("skipped")
            return
        self.budget.acquire(entry.size)  # queueing, outside the clock
        try:
            if self._cancel.is_set():
                return
            if self.cancel_token is not None:
                self.cancel_token.check()
            with self.clock("files"):
                status = self.work(entry)
        finally:
            self.budget.release(entry.size)
        self._count(status)

    def _commit_barrier(self) -> None:
        """fsync + rename every deferred temp file, fanned over the
        writer pool; failed files' temps are removed and the first error
        re-raises."""
        with self._lock:
            pending, self._pending_commits = self._pending_commits, []
        if not pending:
            return
        with self.clock("files"), telemetry.span("files.commit",
                                                 files=len(pending)):
            futures = [self._prepared_pool.submit(storage.durable_replace,
                                                  tmp, dest)
                       for tmp, dest in pending]
            first_error: BaseException | None = None
            for fut, (tmp, _dest) in zip(futures, pending):
                try:
                    fut.result()
                except BaseException as exc:  # noqa: BLE001 - re-raised
                    first_error = first_error or exc
                    with contextlib.suppress(OSError):
                        os.unlink(tmp)
            if first_error is not None:
                raise first_error

    def _discard_commits(self) -> None:
        with self._lock:
            pending, self._pending_commits = self._pending_commits, []
        for tmp, _dest in pending:
            with contextlib.suppress(OSError):
                os.unlink(tmp)

    def join(self) -> tuple[int, int]:
        """Wait for every job, then the commit barrier; returns
        ``(downloaded, skipped)``."""
        with self._lock:
            futures = list(self._futures.values())
        try:
            done, not_done = wait(futures, return_when=FIRST_EXCEPTION)
            first_error = next(
                (f.exception() for f in done if f.exception()), None)
            if first_error is not None:
                self._cancel.set()
                for f in not_done:
                    f.cancel()
                wait(not_done)
                raise first_error
            self._commit_barrier()
        except BaseException:
            self._cancel.set()
            for f in futures:
                f.cancel()
            raise
        finally:
            self._shutdown_pools()
            self._discard_commits()  # error paths only
        return self.downloaded, self.skipped

    def _shutdown_pools(self) -> None:
        # A held job waits for its shard's writes: the write pool, then
        # the term pool the file jobs submit to, last.
        for pool in (self._pool, self._prepared_pool, self._write_pool,
                     self.term_executor):
            if pool is not None:
                pool.shutdown(wait=True)

    def abort(self) -> None:
        """Cancel queued work, drain running jobs, discard temps;
        idempotent, never raises."""
        self._cancel.set()
        with self._lock:
            futures = list(self._futures.values())
        for f in futures:
            f.cancel()
        self._shutdown_pools()
        self._discard_commits()

    def summary(self) -> dict:
        with self._lock:
            lanes = dict(sorted(self.lane_bytes.items()))
        out = {
            "width": self.width,
            "budget_bytes": self.budget.budget_bytes,
            "inflight_peak_bytes": self.budget.peak_bytes,
            "async": self.async_handoff,
            "materialize_workers": self.materialize_workers,
            "lane_bytes": lanes,
        }
        if self.declined:
            out["handoffs_declined"] = self.declined
        return out


def _tensors_tile(header, size: int) -> bool:
    """True iff the header's tensor ranges tile the data section exactly:
    the condition for assembling the file from its tensors."""
    pos = header.data_start
    for lo, hi in sorted(info.file_range(header.data_start)
                         for info in header.tensors.values()):
        if lo != pos:
            return False
        pos = hi
    return pos == size


class _StreamFileSink:
    """Write-behind consumer of one shard of the streaming landing: each
    tensor's bytes go from its ring slot into the shard's temp file as
    soon as it decodes (``offer`` never blocks: a job on the pipeline's
    write pool holds the slot, detached from the ring's accounting, until
    its write is done, so the slot soon returns to the ring and no copy
    of the shard is kept). The shard's whole size is taken from the file
    budget up front; a full budget, a complete file or a shard whose
    tensors do not tile its data section leaves the sink inert and the
    file to the pipeline's tail pass. ``done_decoding`` queues the job
    that finishes the file after its writes: the header bytes from the
    cache, then the commit deferred to the pipeline's barrier. A shard
    that misses a tensor or a write is discarded and rebuilt through the
    waterfall."""

    def __init__(self, pipeline: _FilePipeline, bridge, entry, rec,
                 header, snapshot_dir: Path, clock: StageClock):
        self.pipeline = pipeline
        self.bridge = bridge
        self.entry = entry
        self.rec = rec
        self.header = header
        self.dest = snapshot_dir / entry.path
        self.clock = clock
        self.writes: list = []
        self.names: set[str] = set()
        self.committed = False
        self.active = (not _is_complete(snapshot_dir, entry)
                       and _tensors_tile(header, rec.total_bytes)
                       and pipeline.acquire_for(entry))
        self.tmp = None
        if self.active:
            self.dest.parent.mkdir(parents=True, exist_ok=True)
            fd, self.tmp = tempfile.mkstemp(
                dir=self.dest.parent, prefix=f".tmp-{self.dest.name}.")
            try:
                _preallocate(fd, entry.size)
            finally:
                os.close(fd)

    def offer(self, name: str, info, raw, slot) -> None:
        """Producer thread, right after tensor ``name`` decoded into
        ``slot`` (``raw`` its bytes)."""
        if not self.active:
            return
        self.names.add(name)
        if not raw.nbytes:
            return
        slot.addref()
        slot.detach()
        offset = info.file_range(self.header.data_start)[0]
        self.writes.append(self.pipeline.write_behind(
            self._write, raw, offset, slot))

    def _write(self, raw, offset: int, slot) -> None:
        try:
            with self.clock("files"):
                fd = os.open(self.tmp, os.O_WRONLY)
                try:
                    _pwritev_all(fd, [raw], offset)
                finally:
                    os.close(fd)
        finally:
            slot.release()

    def done_decoding(self) -> None:
        """Producer thread, after the shard's last tensor or on the
        landing's error path: queue the job that finishes the file."""
        if not self.active:
            return
        self.active = False
        fut = self.pipeline.submit_held(self.entry, self._finish)
        if fut is None:
            self._cleanup()
        else:
            fut.add_done_callback(self._cleanup)

    def _finish(self, entry):
        """The held job: None (the waterfall) unless every tensor was
        written."""
        wait(self.writes)
        if (any(f.exception() for f in self.writes)
                or self.names != set(self.header.tensors)):
            return None
        fd = os.open(self.tmp, os.O_WRONLY)
        try:
            _write_head(self.bridge, self.rec, self.header, fd)
        finally:
            os.close(fd)
        self.pipeline.defer_commit(self.tmp, self.dest)
        self.committed = True
        self.pipeline.note_lane("tensors", entry.size)
        self.clock.note_bytes("files", entry.size)
        return "downloaded"

    def _cleanup(self, _fut=None) -> None:
        """The temp file goes unless the barrier owns it; never while a
        write may still reach it."""
        wait(self.writes)
        if not self.committed:
            with contextlib.suppress(OSError):
                os.unlink(self.tmp)


def _write_tensors_lane(pipeline, bridge, rec, header, host, snapshot_dir,
                        entry, clock):
    """The ``tensors`` lane job: the file from decoded host bytes, its
    commit deferred to the barrier; None declines to the waterfall."""
    dest = snapshot_dir / entry.path
    if _is_complete(snapshot_dir, entry):
        return "skipped"
    tmp = _write_file_from_tensors(bridge, rec, header, host, dest)
    if tmp is None:
        return None
    pipeline.defer_commit(tmp, dest)
    pipeline.note_lane("tensors", entry.size)
    clock.note_bytes("files", entry.size)
    return "downloaded"


def pull_model(cfg: Config, repo_id: str, revision: str = "main",
               device=DEFAULT_DEVICE, coop: bool | None = None,
               coop_hosts: int | None = None, coop_index: int | None = None,
               coop_addrs: dict[int, tuple[str, int]] | None = None,
               coop_server=None, base_params: dict | None = None,
               base_revision: str | None = None, swarm=None,
               no_p2p: bool = False, land: bool = True,
               pod: bool | None = None, mesh: SlotMesh | None = None,
               pods: int | None = None, pod_index: int | None = None,
               pod_addrs: dict[int, tuple[str, int]] | None = None,
               tenant: str | None = None,
               cancel: CancelToken | None = None,
               log=print) -> PullResult:
    """Pull ``repo_id@revision`` and land it on ``device`` (see module
    docstring). ``coop_server`` is this host's running ``DcnServer`` over
    ``cfg``'s cache, which then answers the peers for as long as its
    caller keeps it up; without one the round starts its own listener,
    which closes when this pull returns.

    ``base_params`` is a tree of a previously pulled revision of this
    repo, resident on ``device``, and ``base_revision`` (a ref or a sha,
    required with it) names that revision: reuse is judged against its
    manifest, and a guessed base could reuse wrong bytes. The caller
    hands the tree over: the dict is emptied by a swap, and a superseded
    tensor's memory goes back only once nothing else refers to it. A
    degraded delta leaves the dict untouched.

    ``swarm`` is the peer tier (a ``SwarmDownloader``; the caller keeps
    and closes it). Without one the pull builds its own, with no
    candidates, unless ``no_p2p``.

    ``land=False`` writes the snapshot's files and lands nothing (the
    serving pool lands from the snapshot itself): the stats then carry no
    ``hbm``, ``time_to_hbm_s`` or ``time_to_first_layer_s`` and
    ``params`` is None.

    ``pod`` runs the pod round before the landing (None: on for ``cuda``
    unless ``ZEST_TPU_POD`` says otherwise).

    ``mesh`` (a ``SlotMesh``, e.g. ``model_mesh({"model": 4},
    ["cuda:0"] * 4)``) lands the tree sharded over it, by the family's
    shard rules; without it a ``cuda`` pull lands over ``cfg.mesh``'s
    axes when they are set. The pod pre-pass then runs over the mesh's
    slots. With ``base_params`` too (a tree landed over an equal mesh)
    the swap reuses base shards in place.

    ``pods`` > 1 with ``pod_index`` runs the federated round (see module
    docstring) with the other pods' DCN addresses ``pod_addrs``.

    **Pull service** (``transfer/tenancy.py``; off with ``ZEST_TENANCY=0``):
    the pull is admitted through the process-global controller — it may
    wait in the fair per-tenant queue (session phase ``queued``) or be
    rejected with :class:`~zest_tpu_torch.transfer.tenancy.
    AdmissionRejected` when the queue is full — and then runs over the
    shared pools: the singleflight fetch table, the aggregate in-flight
    byte budget, and the pinned cache eviction. A landed tree pins the
    xorbs its next hot-swap will diff against (``tree:<repo>``).

    **Cancel**: ``cancel`` (a :class:`CancelToken`; one is made when
    absent, so ``DELETE /v1/pulls/<id>`` always works) stops the pull at
    the next stage boundary, term, unit, file or landing group, and the
    pull raises :class:`PullCancelled`: the session ends ``cancelled``,
    its admission slot, byte shares and pins are released, shared flights
    are left unharmed, no thread of the pull is left running, no
    complete-named partial file is written, and the device memory of the
    groups it committed goes back.

    **Session**: every pull registers in the session table
    (``telemetry.session``: phase, byte progress and ETA while running,
    terminal status ``ok|error|cancelled|rejected`` and the stats after)
    behind ``GET /v1/pulls`` and ``zest ps``. ``tenant`` labels it (else
    ``cfg.tenant``, ``ZEST_TENANT``). With ``ZEST_TELEMETRY=0`` no session
    is registered."""
    # The process sampler and the remediation engine run for the life of
    # the process from the first pull on; each is one flag check, and
    # with ZEST_TIMELINE=0 / ZEST_REMEDIATE=0 nothing starts. Their
    # threads' start is the process's, not this pull's: it precedes t0.
    telemetry.timeline.ensure_started()
    telemetry.remediate.ensure_started()
    t0 = time.monotonic()
    tenant_label = tenant or cfg.tenant
    if cancel is None:
        cancel = CancelToken()
    sess = telemetry.session.begin(
        repo_id, revision, tenant=tenant_label,
        device=str(device) if land else None)
    if sess is not None:
        sess.cancel_token = cancel
    # A coop pull installs its trace context (host, trace id): the
    # previous one comes back at exit, so a daemon's next pull never
    # records under a stale identity.
    prev_ctx = telemetry.trace.base_context()
    # The root span: every stage.*, fetch and landing span nests in it,
    # and its window is what the critical path is computed over.
    with telemetry.session.bind(sess.id if sess else None), \
            telemetry.span("pull", repo=repo_id, revision=revision,
                           device=str(device) if land else "") as root:
        try:
            with tenancy.admit(cfg, tenant_label, cancel=cancel,
                               session=sess) as ticket:
                result = _pull_model(
                    cfg, repo_id, revision, device, coop, coop_hosts,
                    coop_index, coop_addrs, coop_server, base_params,
                    base_revision, swarm, no_p2p, land, pod, mesh, pods,
                    pod_index, pod_addrs, log, t0, session=sess,
                    cancel=cancel, ticket=ticket)
        except BaseException as exc:
            cancelled = isinstance(exc, PullCancelled)
            rejected = isinstance(exc, tenancy.AdmissionRejected)
            # A deliberate abort and typed backpressure are not errors.
            status = ("cancelled" if cancelled
                      else "rejected" if rejected else "error")
            try:
                _M_PULLS.inc(outcome=status)
                telemetry.record(
                    "pull_cancelled" if cancelled
                    else "pull_rejected" if rejected else "pull_failed",
                    repo=repo_id, reason=str(exc),
                    error=type(exc).__name__)
            finally:
                telemetry.session.finish(
                    sess, status, error=f"{type(exc).__name__}: {exc}")
            raise
        finally:
            telemetry.trace.replace_context(prev_ctx)
    # A traced pull's stats carry the critical path, computed after the
    # root span closed and pinned to this pull's own root, so a daemon's
    # long-lived tracer never hands it another pull's window.
    try:
        tracer = telemetry.trace.active()
        if tracer is not None and telemetry.enabled():
            try:
                cp = telemetry.critpath.analyze_tracer(tracer,
                                                       root_span=root)
            except Exception:  # noqa: BLE001 - attribution is advisory
                cp = None
            if cp is not None:
                result.stats["critical_path"] = cp
        _check_slos(cfg, repo_id, result.stats, sess)
        _M_PULLS.inc(outcome="ok")
        _M_PULL_SECONDS.observe(time.monotonic() - t0)
        tth = result.stats.get("time_to_hbm_s")
        if tth is not None:
            _M_TTH_SECONDS.observe(tth)
    finally:
        telemetry.session.finish(sess, "ok", stats=result.stats)
    return result


def _check_slos(cfg: Config, repo_id: str, stats: dict, sess) -> None:
    """Per-session SLO check: the pull's time to HBM and to the first
    layer against ``ZEST_SLO_TTHBM_S`` / ``ZEST_SLO_TTFL_S``. A breach
    bumps ``zest_slo_breaches_total{slo}`` and records an ``slo_breach``
    event with the session id and ``blamed_stage``, the largest stage of
    the pull's critical path (None when it ran untraced); the burn counts
    live on the session table (``/v1/pulls``' ``slo`` block)."""
    budgets = (("tthbm", cfg.slo_tthbm_s, stats.get("time_to_hbm_s")),
               ("ttfl", cfg.slo_ttfl_s, stats.get("time_to_first_layer_s")))
    cp_stages = (stats.get("critical_path") or {}).get("stages") or {}
    blamed = max(cp_stages, key=cp_stages.get) if cp_stages else None
    for slo, budget, actual in budgets:
        if not budget or actual is None:
            continue
        breached = actual > budget
        if sess is not None:
            telemetry.session.SESSIONS.note_slo(slo, breached)
            sess.note_slo(slo, {"budget_s": budget, "actual_s": actual,
                                "breached": breached})
        if breached:
            _M_SLO_BREACHES.inc(slo=slo)
            telemetry.record(
                "slo_breach", slo=slo, repo=repo_id, budget_s=budget,
                actual_s=actual,
                session=sess.id if sess is not None else None,
                blamed_stage=blamed)


def _pull_model(cfg: Config, repo_id: str, revision: str, device, coop,
                coop_hosts, coop_index, coop_addrs, coop_server,
                base_params, base_revision, swarm, no_p2p: bool,
                land: bool, pod, mesh, pods, pod_index, pod_addrs, log,
                t0: float, session=None, cancel: CancelToken | None = None,
                ticket=None) -> PullResult:
    if not land and base_params is not None:
        raise ValueError("base_params needs a landing (land=True)")
    if base_params is not None and not base_revision:
        raise ValueError(
            "base_params requires base_revision: tensor reuse is only "
            "sound against the manifest of the revision the resident "
            "tree actually holds")
    dev = resolve_device(device)  # fail before any network work
    if mesh is None and cfg.mesh.mesh_axes and dev.type == "cuda":
        mesh = mesh_from_config(cfg.mesh)
    if mesh is not None and not isinstance(mesh, SlotMesh):
        raise TypeError(f"mesh must be a SlotMesh (model_mesh), got "
                        f"{type(mesh).__name__}")
    land_dtype = resolve_dtype(cfg.land_dtype)
    hub = HubClient(cfg)
    clock = StageClock()
    if session is not None:
        # The session watches the pull's own instrumentation: the clock's
        # stage observer drives its phase.
        session.attach(clock=clock)

    def cancel_point() -> None:
        """Stage-boundary cancel check."""
        if cancel is not None:
            cancel.check()

    cancel_point()
    with clock("resolve"):
        commit_sha = hub.resolve_revision(repo_id, revision)
        files = hub.list_files(repo_id, revision)
    cancel_point()
    snapshot_dir = cfg.model_snapshot_dir(repo_id, commit_sha)
    if session is not None:
        session.set_revision(commit_sha)
        session.set_total_bytes(sum(
            e.size for e in files if not _is_complete(snapshot_dir, e)))
    own_swarm = None
    if swarm is None and not no_p2p:
        swarm = own_swarm = _default_swarm(cfg)
    bridge = XetBridge(cfg, swarm=swarm)
    # The pull service's shared pools: the singleflight table, the
    # eviction pins of every plan this pull resolves, and the aggregate
    # in-flight byte budget. All absent with ZEST_TENANCY=0.
    shared_budget = None
    if tenancy.enabled(cfg):
        tstate = tenancy.state(cfg)
        bridge.flights = tstate.flights
        shared_budget = tstate.byte_budget
        if ticket is not None:
            bridge.on_reconstruction = (
                lambda rec: ticket.pin(rec.fetch_info.keys()))
    bridge.cancel = cancel
    if session is not None:
        session.attach(fetch_stats=bridge.stats)
    # ONE term-fetch pool shared by every concurrent file reassembly:
    # in-flight fetch streams stay at the configured budget however many
    # files are written at once. Owned by the file pipeline below.
    term_pool = ThreadPoolExecutor(max(1, cfg.max_concurrent_downloads),
                                   thread_name_prefix="zest-term-fetch")
    par = ParallelDownloader(bridge, executor=term_pool)
    # The pull's wall-clock budget, armed before authenticate() so the
    # CAS client inherits it; the swarm gets it per call from the bridge.
    deadline = Deadline.after(cfg.pull_deadline_s)
    bridge.deadline = deadline
    auth_lock = threading.Lock()
    fallbacks = []

    def ensure_auth() -> None:
        """Idempotent, thread-safe CAS authentication."""
        with auth_lock:
            if bridge.cas is None:
                bridge.authenticate(repo_id, revision, hub=hub)

    def file_work(entry) -> str:
        try:
            return _file_work(entry)
        except OSError as exc:
            # ENOSPC on an HF-cache write surfaces typed: the writers
            # removed their temps; this records the pressure, runs the
            # eviction pass and raises CacheFullError.
            if (exc.errno == errno.ENOSPC
                    and not isinstance(exc, storage.CacheFullError)):
                dest = snapshot_dir / entry.path
                storage.note_disk_full(dest)
                raise storage.CacheFullError(
                    f"HF-cache write of {entry.path} hit ENOSPC",
                    dest) from exc
            raise

    def _file_work(entry) -> str:
        dest = snapshot_dir / entry.path
        if _is_complete(snapshot_dir, entry):
            return "skipped"
        if entry.is_xet:
            ensure_auth()
            # The cache lane first: a file whose units the landing, the
            # warm fetch or a base revision put in the cache is written
            # without a fetch and without decoding its stored chunks.
            tmp = _write_file_from_cache(bridge, entry.xet_hash, dest,
                                         lane_note=file_pipeline.note_lane)
            if tmp is None:
                tmp = _waterfall_chain(bridge, par, hub, repo_id, revision,
                                       entry, dest, log, fallbacks)
                file_pipeline.note_lane("waterfall", entry.size)
            if tmp is not None:
                file_pipeline.defer_commit(tmp, dest)
            clock.note_bytes("files", entry.size)
            return "downloaded"
        else:
            hub.download_regular_file(repo_id, revision, entry.path, dest)
        file_pipeline.note_lane("waterfall", entry.size)
        clock.note_bytes("files", entry.size)
        return "downloaded"

    early: list = []

    def early_cfg() -> dict | None:
        """config.json, read once before the landing (the family dispatch
        of the rules and the expert round needs it first): the landing's
        background read, else a read now."""
        if not early:
            early.append(early_read.result() if early_read is not None
                         else _early_config(hub, repo_id, revision, files,
                                            snapshot_dir))
        return early[0]

    early_read = headers_read = None

    file_pipeline = _FilePipeline(
        1, cfg.pull_inflight_bytes, clock, file_work,
        skip_check=lambda e: _is_complete(snapshot_dir, e),
        materialize_workers=_resolve_files_workers(cfg.files_workers),
        async_handoff=cfg.files_async, term_executor=term_pool,
        budget=shared_budget, cancel=cancel)
    hbm_params = hbm_stats = None
    time_to_hbm = hbm_done_at = time_to_first_layer = None
    delta_plan = delta_base = delta_net_before = None
    if pod is None:
        env = os.environ.get("ZEST_TPU_POD")
        pod = env == "1" if env in ("0", "1") else dev.type == "cuda"
    fed = pods is not None and pods > 1 and pod_index is not None
    # The remediation target: a stall or throughput-collapse anomaly on
    # this session arms a mid-flight hedge on its bridge (no deadline
    # needed). Bound once, since the unregister checks identity; taken
    # back before the bridge closes, so a late anomaly never arms a
    # closed bridge. With ZEST_REMEDIATE=0 nothing is kept.
    hedge_target = hedge_fn = None
    if session is not None:
        hedge_target, hedge_fn = f"hedge:{session.id}", bridge.arm_hedge
        telemetry.remediate.register_target(hedge_target, hedge_fn)
    released = []

    def release() -> None:
        """Take the hedge target back, then close the bridge and the
        pull's own swarm: once, on success or error."""
        if released:
            return
        released.append(True)
        if hedge_target is not None:
            telemetry.remediate.unregister_target(hedge_target, hedge_fn)
        bridge.close()
        if own_swarm is not None:
            own_swarm.close()

    try:
        coop_stats = pod_stats = fed_stats = recs = None
        coop_cfg = _resolve_coop(cfg, coop, coop_hosts, coop_index,
                                 coop_addrs, log)
        # A pull that lands on the card reads config.json and fans the
        # safetensors headers out on the term pool from here, so the pod
        # pre-pass and the landing's header pass find them in hand. A
        # cooperative or federated round fetches each head unit once
        # across hosts, so there the landing reads the headers from what
        # the round cached. A CPU landing has no pre-pass to hide them
        # under and reads both where it needs them.
        if land and _background_metadata(dev):
            early_read = term_pool.submit(_early_config, hub, repo_id,
                                          revision, files, snapshot_dir)
            if not (coop_cfg or fed):
                headers_read = term_pool.submit(_prefetch_headers, bridge,
                                                files, ensure_auth)
        pending = [e for e in files
                   if e.is_xet and not _is_complete(snapshot_dir, e)]
        if cfg.delta_pull:
            delta_base, delta_plan = _delta_stage(
                cfg, bridge, repo_id, commit_sha, pending, base_params,
                base_revision, clock, ensure_auth, log)
            if delta_plan is not None:
                delta_net_before = (bridge.stats.bytes_from_peer
                                    + bridge.stats.bytes_from_cdn)
        elif base_params is not None:
            log("delta disabled (ZEST_DELTA=0); base params ignored, "
                "running a full pull", file=sys.stderr)
        if delta_plan is None:
            base_params = None
        elif session is not None:
            # Progress counts the bytes this pull moves: unchanged units
            # never reach the fetch counters.
            session.set_total_bytes(delta_plan.changed_bytes
                                    + delta_plan.stale_bytes)
        cancel_point()
        if (coop_cfg or pod or fed) and pending:
            try:
                with clock("cas_metadata"):
                    ensure_auth()
                    recs = [bridge.get_reconstruction(e.xet_hash)
                            for e in pending]
            except FETCH_ERRORS as exc:
                log(f"distribution rounds unavailable ({exc}); continuing "
                    "with the per-host waterfall", file=sys.stderr)
        if coop_cfg and recs:
            try:
                with clock("cas_metadata"):
                    prio = _coop_priorities(cfg, bridge, pending, recs)
                with clock("coop"):
                    coop_stats = _coop_stage(
                        bridge, recs, cfg, coop_cfg, repo_id, commit_sha,
                        dev, coop_server, clock, log, priorities=prio,
                        units=(delta_plan.changed_units
                               if delta_plan is not None
                               and delta_plan.changed_units else None))
            except (CoopUnavailable, CasError, ConnectionError) as exc:
                log(f"cooperative pull unavailable ({exc}); continuing "
                    "with the per-host waterfall", file=sys.stderr)
        # The cross-pod stage before the in-pod round, which then spreads
        # a warm cache.
        if fed and recs:
            try:
                fed_stats = federated_round(bridge, recs, pod_index, pods,
                                            pod_addrs or {}, log=log)
            except FETCH_ERRORS as exc:
                log(f"federated round unavailable ({exc}); continuing "
                    "with the per-host waterfall", file=sys.stderr)
        cancel_point()
        if pod and pending:
            if headers_read is not None:
                headers_read.result()
            pod_stats = _pod_stage(bridge, pending, recs, dev, log,
                                   early_cfg, mesh)
        cancel_point()
        rules = _landing_rules(early_cfg) if mesh is not None else None
        # Files the landing does not write ride the pipeline under it.
        # The submits start its workers: files-stage work, traced as such.
        with clock("files"):
            for entry in files:
                if not entry.path.endswith(".safetensors"):
                    file_pipeline.submit(entry)
        if land:
            hbm_params, hbm_stats = _try_direct_stage(
                bridge, files, snapshot_dir, dev, land_dtype, log, clock,
                file_pipeline, ensure_auth,
                delta_state=((delta_base, base_params, delta_plan)
                             if delta_plan is not None else None),
                mesh=mesh, rules=rules, cancel=cancel,
                headers_read=headers_read)
        if hbm_stats is not None:
            hbm_done_at = time.monotonic()
            time_to_hbm = hbm_done_at - t0
            clock.note_bytes("hbm_commit", hbm_stats["bytes"])
            fl_at = hbm_stats.pop("first_layer_at", None)
            if fl_at is not None:
                time_to_first_layer = fl_at - t0
                clock.note_interval("first_layer", t0, fl_at)
        cancel_point()
        # The rest of the files, the join and the pull's bookkeeping are
        # files-stage work: the submits start workers, the join wakes
        # this thread, and the bridge's close, the ref and the manifest
        # follow, all inside the stage. (The JAX package leaves the
        # stretch after its join untraced.)
        with clock("files"):
            for entry in files:
                file_pipeline.submit(entry)
            downloaded, skipped = file_pipeline.join()
            release()
            storage.write_ref(cfg, repo_id, revision, commit_sha)
            if cfg.delta_pull:
                _save_manifest(cfg, bridge, repo_id, commit_sha, files,
                               delta_base, log)
    except BaseException:
        file_pipeline.abort()
        raise
    finally:
        release()

    if land and hbm_stats is None:
        # Disk staging: a resumed pull (complete files) or a shard that
        # is not a xet file; the files are on disk now.
        cancel_point()
        with clock("hbm_commit"):
            hbm_params, hbm_stats = stage_snapshot_to_hbm(
                snapshot_dir, dev, land_dtype, mesh=mesh, rules=rules)
        clock.note_bytes("hbm_commit", hbm_stats["bytes"])
        time_to_hbm = time.monotonic() - t0
    elapsed = time.monotonic() - t0
    stats = {
        "repo": repo_id,
        "revision": commit_sha,
        "device": str(dev),
        "files_downloaded": downloaded,
        "files_skipped": skipped,
        "fallback_files": len(fallbacks),
        "elapsed_s": round(elapsed, 3),
        "stages": clock.summary(),
        "stages_busy": clock.busy_summary(),
        "stages_gbps": clock.gbps_summary(),
        "files_pipeline": file_pipeline.summary(),
        "files_hbm_span_s": round(clock.span("files", "hbm_commit"), 4),
        "fetch": bridge.stats.summary(),
        # Files work after the tensors were resident; the disk staging
        # lands after the file barrier, so none.
        "files_after_hbm_s": (round(clock.coverage_after("files",
                                                         hbm_done_at), 4)
                              if hbm_done_at is not None else 0.0),
    }
    if land:
        stats["time_to_hbm_s"] = round(time_to_hbm, 3)
        _M_LAST_TTH.set(time_to_hbm)
        stats["hbm"] = hbm_stats
        if mesh is not None:
            stats["mesh"] = mesh.shape
    if time_to_first_layer is not None:
        stats["time_to_first_layer_s"] = round(time_to_first_layer, 3)
        _M_TTFL_SECONDS.observe(time_to_first_layer)
        _M_LAST_TTFL.set(time_to_first_layer)
        _M_LAST_RING_STALLS.set(float(
            ((hbm_stats or {}).get("ring") or {}).get("stalls", 0)))
    elif land:
        # A landing that did not stream: no stale first-layer or stall
        # figure of an earlier pull may sit beside this pull's.
        _M_LAST_TTFL.set(0.0)
        _M_LAST_RING_STALLS.set(0.0)
    if delta_plan is not None:
        dsum = delta_plan.summary()
        # Measured, not planned: the bytes that crossed the network
        # (FetchStats' CDN and peer bytes; the cooperative exchange books
        # its wire bytes as peer bytes there).
        fetched = (bridge.stats.bytes_from_peer
                   + bridge.stats.bytes_from_cdn) - delta_net_before
        dsum["fetched_bytes"] = fetched
        if delta_plan.total_bytes:
            dsum["fetched_ratio"] = round(
                fetched / delta_plan.total_bytes, 4)
        swap = hbm_stats.get("swap") if hbm_stats else None
        if swap:
            dsum["tensors"] = {"reused": swap["reused_tensors"],
                               "landed": swap["landed_tensors"]}
            stats["time_to_swap_s"] = stats["time_to_hbm_s"]
            _M_LAST_SWAP.set(time_to_hbm)
            if base_params:
                # Tensors the new revision dropped: the base dict is
                # empty when a swap returns.
                base_params.clear()
        else:
            _M_LAST_SWAP.set(0.0)
        stats["delta"] = dsum
        _M_LAST_DELTA_RATIO.set(
            dsum.get("fetched_ratio", dsum["delta_bytes_ratio"]))
    else:
        _M_LAST_DELTA_RATIO.set(-1.0)
        _M_LAST_SWAP.set(0.0)
    if coop_stats is not None:
        stats["coop"] = coop_stats
        stats["peer_served_ratio"] = coop_stats.get("peer_served_ratio")
    if fed_stats is not None:
        stats["federated"] = fed_stats
    if pod_stats is not None:
        stats["pod"] = pod_stats
    if deadline is not None:
        stats["deadline"] = {
            "budget_s": deadline.total_s,
            "remaining_s": round(max(0.0, deadline.remaining()), 3),
        }
    if swarm is not None:
        stats["swarm"] = swarm.summary()
    if ticket is not None and hbm_params is not None:
        # The tree on the device pins the xorbs its next delta or
        # hot-swap will diff against, past this session's own pins; a
        # newer revision of the repo replaces the set.
        ticket.pin_tree(repo_id, bridge.resolved_xorb_hashes())
    return PullResult(snapshot_dir, stats, params=hbm_params)


def _waterfall_chain(bridge, par, hub, repo_id, revision, entry, dest, log,
                     fallbacks) -> str | None:
    """The rungs after the cache lane (reference: main.zig:232-256): the
    ``ParallelDownloader`` over the pull's term pool, whose temp file is
    returned for the pipeline's commit barrier; then the bridge's
    ``reconstruct_to_file`` and last the plain download of the whole
    file, which both write ``dest`` themselves (None). A file that takes
    the last rung is listed in ``fallbacks``."""
    try:
        return par.write_plan_to_temp(
            bridge.get_reconstruction(entry.xet_hash), dest)
    except PullCancelled:
        raise  # a cancel is no tier failure: no later rung runs
    except Exception as exc:  # noqa: BLE001 - any failure falls through
        log(f"parallel fetch of {entry.path} failed ({exc}); "
            "retrying sequentially", file=sys.stderr)
    try:
        bridge.reconstruct_to_file(entry.xet_hash, dest)
        return None
    except PullCancelled:
        raise
    except Exception as exc:  # noqa: BLE001 - reference chain
        log(f"sequential fetch of {entry.path} failed ({exc}); "
            "falling back to plain download", file=sys.stderr)
    fallbacks.append(entry.path)
    hub.download_regular_file(repo_id, revision, entry.path, dest)
    return None


def _default_swarm(cfg: Config):
    """A swarm with no discovery source, as the JAX package's default is
    (``cli._build_swarm`` adds the tracker and the DHT): its stats block
    is the JAX package's; None when it cannot start."""
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    try:
        return SwarmDownloader(cfg)
    except (OSError, ValueError):
        return None


def _delta_stage(cfg, bridge, repo_id, commit_sha, pending, base_params,
                 base_revision, clock, ensure_auth, log):
    """The delta plan of this pull over its base manifest: ``(base
    manifest, plan)``, the plan None when there is nothing to plan
    against or the evidence cannot be read (the pull then runs in full
    and says so). Only the errors that mean "no plan" degrade: a failed
    metadata fetch or a manifest or plan that does not parse."""
    base = delta.find_base_manifest(cfg, repo_id, commit_sha, base_revision)
    if base is None:
        if base_params is not None or base_revision:
            telemetry.record("delta_degraded", repo=repo_id,
                             revision=commit_sha,
                             reason="missing rev-A manifest")
            log("delta: no base-revision manifest — running a full pull",
                file=sys.stderr)
        return None, None
    if not pending:
        if base_params is not None:
            telemetry.record("delta_degraded", repo=repo_id,
                             revision=commit_sha,
                             reason="snapshot already complete")
            log("delta: snapshot already materialized — hot-swap skipped "
                "(disk staging), base params left untouched",
                file=sys.stderr)
        return base, None
    try:
        with clock("cas_metadata"):
            ensure_auth()
            recs = _hdr_fan(lambda e: bridge.get_reconstruction(e.xet_hash),
                            pending)
        units = [(hh, fi) for (hh, _s), fi in collect_units(recs)]
        plan = delta.build_plan(
            base, [(e.path, delta.terms_of(r)) for e, r in zip(pending, recs)],
            units=units, cache=bridge.cache)
    except (*FETCH_ERRORS, ValueError) as exc:
        log(f"delta plan unavailable ({exc}); running a full pull",
            file=sys.stderr)
        return base, None
    return base, plan


def _save_manifest(cfg, bridge, repo_id, commit_sha, files, delta_base,
                   log) -> None:
    """This revision's manifest, complete or not at all, with the
    revision it diffed against as its ``parent``. A fully skipped resume
    pull never authenticated (its first pull wrote the manifest); a
    partly resumed one fetches the reconstructions it did not need."""
    def rec_of(entry):
        rec = bridge.known_reconstruction(entry.xet_hash)
        if rec is not None or bridge.cas is None:
            return rec
        try:
            return bridge.get_reconstruction(entry.xet_hash)
        except FETCH_ERRORS:
            return None

    try:
        delta.save_manifest(cfg, repo_id, commit_sha, files, rec_of,
                            parent=(delta_base or {}).get("revision"))
    except OSError as exc:
        log(f"delta manifest not saved ({exc})", file=sys.stderr)


def _landed_dtype(info, dtype: torch.dtype | None) -> torch.dtype:
    """The dtype the landing commits a tensor at: ``cast_floating``'s rule
    (floating tensors take the landing dtype; int and bool keep theirs)."""
    src = info.torch_dtype
    if dtype is None or not src.is_floating_point:
        return src
    return dtype


def _chunk_table(cache, hash_hex: str):
    """A cached xorb's chunk sizes (its full entry, or a partial one from
    chunk 0), read from the frame headers; None when not cached."""
    got = cache.get_with_range_mapped(hash_hex, 0)
    if got is None:
        return None
    try:
        return XorbReader(got.data).chunk_sizes.astype(np.int64)
    except ValueError:
        return None


def _fits_landing(t, name: str, info, dev, dtype, mesh, rules) -> bool:
    """Whether base tensor ``t`` is what this landing would give ``name``:
    the global shape and landed dtype, and the device (without a mesh) or
    the mesh and spec (with one: an equal mesh, and the spec the family's
    rules give the tensor over it now)."""
    if (tuple(t.shape) != tuple(info.shape)
            or t.dtype != _landed_dtype(info, dtype)):
        return False
    if mesh is None:
        return not isinstance(t, ShardedTensor) and t.device == dev
    return (isinstance(t, ShardedTensor) and same_mesh(t.mesh, mesh)
            and t.spec == spec_for(name, tuple(info.shape), mesh, rules))


def _reused_tensors(cache, st, recs_with_headers, base_manifest,
                    base_params, dev, dtype, mesh=None, rules=None) -> dict:
    """The tensors of the base tree that the landing reuses as they are:
    bytes proven unchanged (the reference's fingerprints, and the chunk
    alignment the cached xorbs' chunk tables show), and the layout this
    landing would give them (:func:`_fits_landing`). A base tree landed at
    another dtype or shape, on another device, or over another mesh or
    spec reuses nothing there, so the swapped tree equals a cold
    landing."""
    base_files = base_manifest.get("files") or {}
    reused: dict = {}
    for entry, (rec, header) in zip(st, recs_with_headers):
        bf = base_files.get(entry.path)
        if not bf:
            continue
        same = delta.unchanged_tensor_names(bf["terms"], rec, header)
        same |= delta.aligned_tensor_names(
            bf["terms"], rec, header, lambda hh: _chunk_table(cache, hh))
        for name in same:
            t = base_params.get(name)
            if t is None:
                continue
            if _fits_landing(t, name, header.tensors[name], dev, dtype,
                             mesh, rules):
                reused[name] = t
    return reused


def _swap_span(preloaded):
    """The ``delta.swap`` span around a landing that reuses base tensors
    in place; nothing for a landing that reuses none."""
    if not preloaded:
        return contextlib.nullcontext()
    return telemetry.span("delta.swap", reused=len(preloaded))


def _try_direct_stage(bridge, files, snapshot_dir, dev, dtype, log,
                      clock: StageClock, file_pipeline: _FilePipeline,
                      ensure_auth, delta_state=None, mesh=None, rules=None,
                      cancel: CancelToken | None = None, headers_read=None):
    """Land every safetensors file straight from the cache, before any
    file write; the HF-cache files are written from the landing's decoded
    bytes. Returns ``(None, None)``, before any work, when ineligible: a
    shard that is not a xet file (nothing to land from) or a shard already
    complete on disk (reading it beats refetching). Any other error
    raises.

    ``delta_state`` is ``(base manifest, base tree, plan)``: the warm
    fetch skips the plan's ``reused_local_keys``, and with a base tree the
    landing is a hot-swap. A delta shard decodes only its changed tensors,
    so its file is left to the cache lane.

    A landing that raises during a swap gives the caller back what it
    still has: every reused tensor returns to the base dict (the same
    objects), and the error, a :class:`delta.DeltaSwapError` raised from
    the landing's, names the base tensors a committed replacement had
    already superseded."""
    st = [e for e in files if e.path.endswith(".safetensors")]
    if not st or not all(e.is_xet for e in st):
        return None, None
    if any(_is_complete(snapshot_dir, e) for e in st):
        return None, None
    cfg = bridge.cfg
    with clock("cas_metadata"):
        ensure_auth()

        def rec_with_header(e):
            rec = bridge.get_reconstruction(e.xet_hash)
            return rec, fetch_file_header(bridge, rec)

        if headers_read is not None:
            # The prefetch put the head units in the cache: this pass
            # reads them there.
            headers_read.result()
        recs_with_headers = _hdr_fan(rec_with_header, st)
        # The full-vs-partial cache-key evidence must see every reference
        # to a xorb: resolve the other xet files too (memoized for the
        # file pipeline). A file that cannot be resolved makes the
        # evidence incomplete for the rest of the pull.
        evidence_recs = [r for r, _h in recs_with_headers]
        for e in files:
            if e.is_xet and not e.path.endswith(".safetensors"):
                try:
                    evidence_recs.append(bridge.get_reconstruction(
                        e.xet_hash))
                except FETCH_ERRORS:
                    bridge.mark_evidence_incomplete()
    recs_only = [r for r, _h in recs_with_headers]
    preloaded: dict = {}
    swap_from = None
    base_names: frozenset = frozenset()
    skip_keys: frozenset = frozenset()
    if delta_state is not None:
        d_base, d_params, d_plan = delta_state
        skip_keys = d_plan.reused_local_keys
        if d_params:
            swap_from = d_params
            base_names = frozenset(d_params)
            preloaded = _reused_tensors(bridge.cache, st,
                                        recs_with_headers, d_base,
                                        d_params, dev, dtype, mesh, rules)
            for name in preloaded:
                d_params.pop(name)  # moved into the new tree

    def delta_shard(i) -> bool:
        return bool(preloaded) and any(
            n in preloaded for n in recs_with_headers[i][1].tensors)

    pipeline = None
    try:
        if cfg.land_stream and cfg.land_decode_ahead:
            # The warm fetch's plan and its threads' start are fetch-stage
            # work, as the stream-off path's first ``ensure`` is.
            with clock("fetch"):
                priorities = unit_layer_priorities(recs_with_headers)
                required = [tensor_unit_keys(rec, header)
                            for rec, header in recs_with_headers]
                pipeline = _PipelinedWarm(bridge, recs_only,
                                          evidence_recs=evidence_recs,
                                          unit_priorities=priorities,
                                          streaming=True, clock=clock,
                                          skip_keys=skip_keys)
                pipeline.poke(0)

            def tensor_gate(i, name, cancel=None):
                keys = required[i].get(name)
                if keys:
                    pipeline.wait_units(i, keys, cancel=cancel)

            first_layer_at: list[float] = []

            def stream_file_sink(i):
                if delta_shard(i):
                    return None
                rec, header = recs_with_headers[i]
                return _StreamFileSink(file_pipeline, bridge, st[i], rec,
                                       header, snapshot_dir, clock)

            with clock("hbm_commit"), _swap_span(preloaded):
                params, hbm_stats = stage_cached_to_hbm(
                    bridge, recs_with_headers, dev, dtype=dtype,
                    prefetch_next=pipeline.poke, clock=clock, stream=True,
                    tensor_gate=tensor_gate,
                    on_first_layer=lambda: first_layer_at.append(
                        time.monotonic()),
                    stream_file_sink=stream_file_sink,
                    preloaded=preloaded or None, swap_from=swap_from,
                    mesh=mesh, rules=rules, cancel=cancel)
            if first_layer_at:
                hbm_stats["first_layer_at"] = first_layer_at[0]
        else:
            def on_host_ready(i, host):
                if delta_shard(i):
                    return
                rec, header = recs_with_headers[i]
                entry = st[i]
                if not file_pipeline.acquire_for(entry):
                    return
                file_pipeline.submit_held(
                    entry, lambda e: _write_tensors_lane(
                        file_pipeline, bridge, rec, header, host,
                        snapshot_dir, e, clock))

            pipeline = _PipelinedWarm(bridge, recs_only,
                                      evidence_recs=evidence_recs,
                                      skip_keys=skip_keys)
            with clock("fetch"):
                pipeline.ensure(0)
            with clock("hbm_commit"), _swap_span(preloaded):
                params, hbm_stats = stage_cached_to_hbm(
                    bridge, recs_with_headers, dev, dtype=dtype,
                    prefetch_next=pipeline.ensure,
                    on_host_ready=on_host_ready, clock=clock, stream=False,
                    preloaded=preloaded or None, swap_from=swap_from,
                    mesh=mesh, rules=rules, cancel=cancel)
    except BaseException as exc:
        if swap_from is None:
            raise
        swap_from.update(preloaded)
        if not isinstance(exc, Exception) or isinstance(exc, PullCancelled):
            raise
        raise delta.DeltaSwapError(
            exc, sorted(base_names - swap_from.keys()),
            len(preloaded)) from exc
    finally:
        # Join the warm threads, on success before reading their stats and
        # on error before the pull tears down: none may keep writing cache
        # entries after the landing.
        if pipeline is not None:
            pipeline.drain()
    warm = pipeline.summary()
    if warm["failed"] or warm.get("prefetch_errors"):
        log(f"warm fetch: {warm['failed']} unit(s) + "
            f"{warm.get('prefetch_errors', 0)} whole-shard prefetch(es) "
            "failed; the landing fetched them per term", file=sys.stderr)
    hbm_stats["warm"] = warm
    return params, hbm_stats


class _PipelinedWarm:
    """The landing's warm fetch, one shard ahead.

    ``ensure(i)`` joins shard ``i``'s warm (starting it if none has) and
    then starts shard ``i + 1``'s. In streaming mode ``poke(i)`` only
    starts it, units go in layer-priority order, each unit is published
    the moment it resolves (:meth:`wait_units` is the tensor gate), each
    shard's fetch is clocked as ``fetch``, and a finished shard starts the
    next: at most one shard fetches at a time (two racing shards could
    both fetch a unit they share). A failed unit is left to the landing's
    per-term waterfall. ``skip_keys`` (a delta plan's unchanged units
    present in the cache) are never fetched or tested: their gates
    release at once, and one evicted since the plan comes through the
    landing's per-term waterfall."""

    _COUNTER_KEYS = ("units", "bytes", "failed", "retried")

    def __init__(self, bridge, recs, evidence_recs=None,
                 unit_priorities=None, streaming: bool = False,
                 clock: StageClock | None = None,
                 skip_keys: frozenset | None = None):
        self.bridge = bridge
        self.recs = recs
        # Built once over every known xet reconstruction: the whole-xorb
        # evidence of a cache write must see references from all files.
        self.entries_map = _entries_by_hash(
            evidence_recs if evidence_recs is not None else recs)
        self.unit_priorities = unit_priorities
        self.streaming = streaming
        self.clock = clock
        self.skip_keys = frozenset(skip_keys or ())
        self.threads: dict[int, threading.Thread] = {}
        self.stats: list[dict] = []
        self.cancelled = False
        self._cv = threading.Condition()
        self._units_done: set[tuple[str, int]] = set()
        self._shards_done: set[int] = set()

    def _spawn(self, i: int) -> None:
        with self._cv:
            if (self.cancelled or not 0 <= i < len(self.recs)
                    or i in self.threads):
                return
            t = threading.Thread(target=self._run, args=(i,), daemon=True,
                                 name=f"zest-warm-{i}")
            self.threads[i] = t
            t.start()

    def _shard_units(self, i: int):
        units = [(key[0], fi) for key, fi in collect_units([self.recs[i]])
                 if key not in self.skip_keys]
        if self.unit_priorities:
            units.sort(key=unit_priority_sort_key(self.unit_priorities))
        return units

    def _mark_skipped(self, i: int) -> None:
        """Resolve shard ``i``'s skipped units without reading them."""
        for key, _fi in collect_units([self.recs[i]]):
            if key in self.skip_keys:
                self._mark_unit(key)

    def _mark_unit(self, key) -> None:
        with self._cv:
            self._units_done.add(key)
            self._cv.notify_all()

    def _run(self, i: int) -> None:
        try:
            if self.streaming:
                if self.skip_keys:
                    self._mark_skipped(i)
                with self.clock("fetch") if self.clock is not None \
                        else contextlib.nullcontext():
                    self.stats.append(warm_units_parallel(
                        self.bridge, [self.recs[i]],
                        entries_map=self.entries_map,
                        units=self._shard_units(i),
                        on_unit=self._mark_unit))
            else:
                self.stats.append(warm_units_parallel(
                    self.bridge, [self.recs[i]],
                    entries_map=self.entries_map,
                    units=(self._shard_units(i) if self.skip_keys
                           else None)))
        except (*FETCH_ERRORS, ValueError, PullCancelled):
            # The landing's per-term waterfall serves what is missing (a
            # cancelled pull stops there too).
            self.stats.append({"units": 0, "bytes": 0, "failed": 0,
                               "prefetch_error": True})
        finally:
            # Always: gates parked on this shard release.
            with self._cv:
                self._shards_done.add(i)
                self._cv.notify_all()
            if self.streaming:
                self._spawn(i + 1)

    def drain(self) -> None:
        """Stop spawning and join every warm thread (idempotent)."""
        with self._cv:
            self.cancelled = True
            threads = list(self.threads.values())
        for t in threads:
            t.join()
        with self._cv:
            self._shards_done.update(range(len(self.recs)))
            self._cv.notify_all()

    def ensure(self, i: int) -> None:
        """Block until shard ``i`` is warm, then start shard ``i + 1``."""
        self._spawn(i)
        t = self.threads.get(i)
        if t is not None:
            t.join()
        self._spawn(i + 1)

    def poke(self, i: int) -> None:
        """Start shard ``i``'s warm and return."""
        self._spawn(i)

    def wait_units(self, i: int, keys: frozenset, cancel=None) -> None:
        """Block until every unit of ``keys`` is resolved, shard ``i``'s
        warm has finished, or ``cancel`` is set."""
        with self._cv:
            while not (keys <= self._units_done
                       or i in self._shards_done
                       or (cancel is not None and cancel.is_set())):
                self._cv.wait(0.05)

    def summary(self) -> dict:
        out = {"units": 0, "bytes": 0, "failed": 0,
               "pipelined_shards": len(self.threads)}
        for s in self.stats:
            for k in self._COUNTER_KEYS:
                if k in s:
                    out[k] = out.get(k, 0) + s[k]
        errors = sum(1 for s in self.stats if s.get("prefetch_error"))
        if errors:
            out["prefetch_errors"] = errors
        return out


def _resolve_coop(cfg, coop, coop_hosts, coop_index, coop_addrs, log):
    """The cooperative topology: explicit arguments, else ``ZEST_COOP*``,
    else the process topology of ``ZEST_TPU_NUM_PROCESSES`` and
    ``ZEST_TPU_PROCESS_ID``. Auto (``coop`` None) turns the round on when
    more than one host is known and stays quietly off otherwise; a forced
    ``coop=True`` with an unusable topology logs why it is off. Returns
    ``(index, n_hosts, addrs)`` or None; empty ``addrs`` are discovered
    over the process group's store (:func:`_coop_stage`)."""
    enabled = coop if coop is not None else cfg.coop_pull
    if enabled is False:
        return None
    n = coop_hosts if coop_hosts is not None else cfg.coop_hosts
    i = coop_index if coop_index is not None else cfg.coop_index
    addrs = dict(coop_addrs) if coop_addrs else dict(cfg.coop_addrs)
    if n is None and addrs:
        n = max(addrs) + 1
    if cfg.mesh.is_distributed:
        if n is None:
            n = cfg.mesh.num_processes
        if i is None:
            i = cfg.mesh.process_id
    if enabled is None:
        enabled = bool(n and n > 1)
    if not enabled:
        return None
    if not n or n <= 1 or i is None or not 0 <= i < n:
        log("cooperative pull disabled: need coop hosts > 1 and a host "
            f"index in range (hosts={n}, index={i})", file=sys.stderr)
        return None
    return i, n, addrs


def _coop_priorities(cfg, bridge, pending, recs):
    """The layer-priority map the cooperative round orders its units by,
    from the shards' headers (head frames only); None when streaming is
    off or a header cannot be read (the order is advisory)."""
    if not cfg.land_stream:
        return None
    shard_recs = [r for e, r in zip(pending, recs)
                  if e.path.endswith(".safetensors")]
    try:
        headers = _hdr_fan(lambda r: fetch_header_probe(bridge, r),
                           shard_recs)
    except (*FETCH_ERRORS, ValueError):
        return None
    return unit_layer_priorities(list(zip(shard_recs, headers)))


def _coop_stage(bridge, recs, cfg, coop_cfg, repo_id, commit_sha, device,
                server, clock, log, priorities=None, units=None) -> dict:
    """Run the cooperative round. Without peer addresses the hosts find
    each other over the ``torch.distributed`` store: this host's DCN
    listener binds first (peers learn the port it really bound; the
    bridge keeps it up until the pull ends), then every host announces
    and reads the others (:func:`coop.exchange_addrs_via_kv`). Neither
    addresses nor a store raises :class:`CoopUnavailable`.

    The pull's trace id is minted from ``repo@sha`` and the nonce host 0
    shares over the store. Host 0 writes the nonce before it announces
    its address and the others read it only after the address exchange,
    so every host that sees host 0 mints the same id. The id and the host
    index become the process trace context (one host is one process in a
    deployment), recorded in the tracer's metadata too, since
    ``pull_model`` restores the previous context at exit. ``units`` is a
    delta pull's changed set: only those are planned."""
    host_index, n_hosts, addrs = coop_cfg
    pull_key = f"{repo_id}@{commit_sha}"
    nonce = ""
    if not {h for h in addrs if h != host_index}:
        if server is None:
            server = DcnServer(cfg, bridge.cache)
            try:
                port = server.start()
            except OSError:
                server, port = None, cfg.dcn_port
            else:
                bridge.adopt_coop_server(server)
        else:
            port = server.port
        if host_index == 0:
            nonce = share_nonce_via_kv(pull_key, host_index)
        addrs = exchange_addrs_via_kv(pull_key, host_index, n_hosts, port)
        if not addrs:
            raise CoopUnavailable(
                "no coop peer addresses: pass coop_addrs, set "
                "ZEST_COOP_ADDRS, or run under torch.distributed for "
                "discovery over its store")
        if host_index != 0:
            nonce = share_nonce_via_kv(pull_key, host_index, timeout_s=5.0)
    trace_id = mint_trace_id(pull_key, nonce)
    if telemetry.enabled():
        telemetry.trace.set_context(host=host_index, trace_id=trace_id)
        tracer = telemetry.trace.active()
        if tracer is not None:
            tracer.add_metadata(
                context={"host": host_index, "trace_id": trace_id})
    return coop_round(bridge, recs, host_index, n_hosts, addrs,
                      device=device, server=server,
                      budget_bytes=cfg.coop_inflight_bytes,
                      trace_id=trace_id,
                      priorities=priorities, units=units, clock=clock,
                      log=log)


def _early_config(hub, repo_id, revision, files, snapshot_dir
                  ) -> dict | None:
    """config.json parsed before the file loop; None on any miss: the
    callers degrade to the family-agnostic path. Before the snapshot has
    it, this reads a private download, and the file loop writes the
    snapshot's copy (so its waterfall lane books the file on every
    pull)."""
    import json

    dest = snapshot_dir / "config.json"
    try:
        if dest.exists():
            text = dest.read_text()
        else:
            entry = next((e for e in files if e.path == "config.json"),
                         None)
            if entry is None:
                return None
            home = snapshot_dir.parent.parent
            home.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=home,
                                             prefix=".early-") as d:
                own = Path(d) / "config.json"
                hub.download_regular_file(repo_id, revision, entry.path,
                                          own)
                text = own.read_text()
        cfg = json.loads(text)
    except (HubError, OSError, ValueError):
        return None
    return cfg if isinstance(cfg, dict) else None


def _background_metadata(dev) -> bool:
    """Whether a landing on ``dev`` reads config.json and the shard
    headers in the background: on the card only, as the JAX package does
    on its accelerator. On the CPU those reads would compete with the
    landing's own thread for the interpreter outside any span."""
    return dev.type == "cuda"


def _prefetch_headers(bridge, files, ensure_auth) -> None:
    """Fetch every xet safetensors file's header through the waterfall
    (the head units land in the cache). Best effort: a miss leaves the
    header to whoever reads it next."""
    try:
        ensure_auth()
        _hdr_fan(lambda e: pod_mod.fetch_file_header(
                     bridge, bridge.get_reconstruction(e.xet_hash)),
                 [e for e in files
                  if e.is_xet and e.path.endswith(".safetensors")])
    except Exception:  # noqa: BLE001 - an advisory warm-up
        pass


def _landing_rules(early_cfg):
    """The family's shard rules (``models.registry``); None for an
    unknown family, which the loader's ``infer_spec`` fallback lands."""
    from zest_tpu_torch.models.registry import shard_rules_for_model_type

    return shard_rules_for_model_type((early_cfg() or {}).get("model_type"))


def _pod_stage(bridge, pending, recs, dev, log, early_cfg,
               mesh=None) -> dict | None:
    """The pod pre-pass over the slots of ``mesh`` (the landing mesh),
    else of ``dev`` (every CUDA device; the one CPU device otherwise, so
    the round skips), family-dispatched: an expert-sharded family takes
    the expert-routed round, every other the plain one.

    With several processes every one must have its reconstructions
    (``recs`` not None) and agree on the expert pre-pass before any
    gathers: they agree on both bits first. One without reconstructions
    takes the whole pod to the per-host waterfall, and one whose pre-pass
    failed takes it to the plain round, instead of stranding the others
    in a gather of another plan."""
    import torch.distributed as dist

    from zest_tpu_torch.models.registry import is_expert_sharded

    if mesh is not None:
        slots = mesh.local_devices()
    else:
        slots = pod_mesh(None if dev.type == "cuda" else [dev])
    ready = recs is not None
    prepped = None
    cfg_json = early_cfg() if ready and num_slots(slots) > 1 else None
    n_experts = int((cfg_json or {}).get("num_local_experts") or 0)
    if (cfg_json and is_expert_sharded(cfg_json.get("model_type"))
            and n_experts > 0):
        try:
            prepped = _expert_prep(bridge, pending, recs, n_experts, slots)
        except (*FETCH_ERRORS, ValueError) as exc:
            log(f"expert routing unavailable ({exc}); falling back to the "
                "plain pod round", file=sys.stderr)
    if world_size() > 1:
        flags = [None] * world_size()
        dist.all_gather_object(flags, (ready, prepped is not None))
        if ready and not all(f[0] for f in flags):
            log("pod round skipped: another host has no reconstructions",
                file=sys.stderr)
        ready = all(f[0] for f in flags)
        if prepped is not None and not all(f[1] for f in flags):
            log("expert routing disabled: another host's pre-pass failed; "
                "taking the plain pod round", file=sys.stderr)
            prepped = None
    if not ready:
        return None
    if prepped is not None:
        return _expert_stage(bridge, prepped, slots, log)
    return pod_round(bridge, recs, mesh=slots, log=log)


def _expert_prep(bridge, pending, recs, n_experts, slots):
    """The expert round's inputs, fetched before any gather: each
    safetensors file's header (through the waterfall) and tensor → expert
    map, and the placement. Returns (file_maps, other_recs, placement)."""
    from zest_tpu_torch.models import moe
    from zest_tpu_torch.parallel.expert import ExpertPlacement, classify_file

    placement = ExpertPlacement(n_experts, num_hosts=num_slots(slots))
    file_maps, other = [], []
    for entry, rec in zip(pending, recs):
        if entry.path.endswith(".safetensors"):
            header = fetch_file_header(bridge, rec)
            file_maps.append(classify_file(rec, header,
                                           moe.expert_of_tensor))
        else:
            other.append(rec)
    if not file_maps:
        raise ValueError("no safetensors files to expert-route")
    return file_maps, other, placement


def _expert_stage(bridge, prepped, slots, log) -> dict:
    """The expert-routed round for the safetensors files; any other xet
    files still ride the plain round, reported under ``"other"``."""
    file_maps, other, placement = prepped
    stats = expert_pod_round(bridge, file_maps, placement, mesh=slots,
                             log=log)
    stats["expert_routed"] = True
    stats["n_experts"] = placement.n_experts
    if other:
        stats["other"] = pod_round(bridge, other, mesh=slots, log=log)
    return stats


# pwritev bounds: iovecs per call (below every Linux IOV_MAX) and bytes
# per call (one call transfers at most ~2 GiB).
_IOV_BATCH = 512
_IOV_BATCH_BYTES = 1 << 30


def _preallocate(fd: int, size: int) -> None:
    """Best-effort ``posix_fallocate`` (ENOSPC surfaces before any byte
    moves)."""
    if size <= 0:
        return
    with contextlib.suppress(AttributeError, OSError):
        os.posix_fallocate(fd, 0, size)


def _pwritev_all(fd: int, buffers: list, offset: int) -> int:
    """Positional vectored write of ``buffers`` at ``offset``, resuming
    short writes. Returns the byte count."""
    views = [memoryview(b).cast("B") for b in buffers]
    total = sum(v.nbytes for v in views)
    pos = 0
    while views:
        n = os.pwritev(fd, views, offset + pos)
        if n <= 0:
            raise OSError(f"pwritev wrote {n} bytes")
        pos += n
        while views and n >= views[0].nbytes:
            n -= views[0].nbytes
            views.pop(0)
        if views and n:
            views[0] = views[0][n:]
    if pos != total:
        raise OSError(f"pwritev wrote {pos} of {total} bytes")
    return pos


def _raw_bytes(a) -> np.ndarray:
    """A host tensor's (or numpy array's) bytes as a flat uint8 array."""
    if isinstance(a, torch.Tensor):
        return tensor_bytes(a)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _write_file_from_tensors(bridge, rec, header, host,
                             dest: Path) -> str | None:
    """The ``tensors`` lane: a safetensors file assembled from the
    landing's decoded tensors (``host``: name → CPU tensor or raw bytes),
    with no second decode. Only when provably byte-exact: the tensor
    ranges must tile the data section. The header prefix decodes from the
    cache. Writes a preallocated temp file with batched ``pwritev`` and
    returns its path (fsync and rename are the caller's barrier's), or
    None to decline."""
    data_start = header.data_start
    size = rec.total_bytes
    spans = sorted((info.file_range(data_start) + (name,)
                    for name, info in header.tensors.items()),
                   key=lambda s: s[0])
    pos = data_start
    for lo, hi, name in spans:
        if lo != pos or name not in host:
            return None
        pos = hi
    if pos != size:
        return None

    dest.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dest.parent, prefix=f".tmp-{dest.name}.")
    try:
        _preallocate(fd, size)
        _write_head(bridge, rec, header, fd)
        offset = data_start
        batch: list = []
        batch_bytes = 0
        for _lo, _hi, name in spans:
            view = memoryview(_raw_bytes(host[name]))
            # Zero-size tensors add no iovec; >1 GiB tensors split.
            while view.nbytes:
                piece, view = view[:_IOV_BATCH_BYTES], view[_IOV_BATCH_BYTES:]
                batch.append(piece)
                batch_bytes += piece.nbytes
                if len(batch) >= _IOV_BATCH or batch_bytes >= _IOV_BATCH_BYTES:
                    offset += _pwritev_all(fd, batch, offset)
                    batch, batch_bytes = [], 0
        if batch:
            _pwritev_all(fd, batch, offset)
    except BaseException:
        os.close(fd)
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    os.close(fd)
    return tmp


def _write_head(bridge, rec, header, fd: int) -> None:
    """A safetensors file's header bytes, decoded from the cache, at the
    start of ``fd``; the whole file is booked like any file served from
    cached units."""
    if header.data_start:
        reader = CachedFileReader(bridge.cache, rec, bridge=bridge, workers=1)
        _pwritev_all(fd, [reader.read(0, header.data_start)], 0)
    for term in rec.terms:
        bridge.stats.record("cache", term.unpacked_length)


# After the first refusal of ``copy_file_range`` by the platform (ENOSYS
# on old kernels, EXDEV across filesystems), every run takes the
# pread/pwrite bounce: still no decode.
_CFR_DISABLED = not hasattr(os, "copy_file_range")


def _copy_run(src_fd: int, dst_fd: int, src_off: int, dst_off: int,
              length: int) -> None:
    """Move one contiguous payload run from a cache entry into the
    destination, in the kernel where the platform allows. Short
    transfers resume; a source that ends early (a truncated entry) raises
    ValueError so the caller declines to the waterfall."""
    global _CFR_DISABLED
    remaining = length
    while remaining:
        if not _CFR_DISABLED:
            try:
                n = os.copy_file_range(src_fd, dst_fd, remaining,
                                       src_off, dst_off)
            except OSError as exc:
                # Only a platform refusal downgrades; a real I/O error
                # (EIO, ENOSPC) propagates and declines this file.
                if exc.errno not in (errno.ENOSYS, errno.EXDEV,
                                     errno.EOPNOTSUPP, errno.EINVAL):
                    raise
                _CFR_DISABLED = True
                continue
            if n == 0:
                raise ValueError(
                    f"cache entry ended {remaining} bytes early")
        else:
            data = os.pread(src_fd, min(remaining, 8 << 20), src_off)
            if not data:
                raise ValueError(
                    f"cache entry ended {remaining} bytes early")
            n = os.pwrite(dst_fd, data, dst_off)
        src_off += n
        dst_off += n
        remaining -= n


def _execute_copy_plan(copies, dst_fd: int) -> int:
    """Run a :meth:`CachedFileReader.copy_plan` copy list into ``dst_fd``;
    returns the bytes moved. Each distinct entry file opens once."""
    fds: dict = {}
    moved = 0
    try:
        for path, src_offs, dst_offs, lens in copies:
            fd = fds.get(path)
            if fd is None:
                fd = fds[path] = os.open(path, os.O_RDONLY)
            for s, d, n in zip(src_offs.tolist(), dst_offs.tolist(),
                               lens.tolist()):
                _copy_run(fd, dst_fd, s, d, n)
                moved += n
    finally:
        for fd in fds.values():
            os.close(fd)
    return moved


def _drop_tracebacks(exc: BaseException) -> BaseException:
    """``exc`` with its own and its chained exceptions' tracebacks
    dropped: their frames (a read and its view of the lane's mmap) must
    not outlive the read."""
    seen = set()
    e = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        e.__traceback__ = None
        if e.__cause__ is not None:
            _drop_tracebacks(e.__cause__)
        e = e.__context__
    return exc


def _close_mmap(mm: mmap.mmap) -> None:
    """Close ``mm``. A slice of its view that only a reference cycle
    still holds is collected first."""
    try:
        mm.close()
    except BufferError:
        gc.collect()
        mm.close()


def _write_file_from_cache(bridge, xet_hash: str, dest: Path,
                           lane_note=None) -> str | None:
    """The copy-range cache lane: a file written from its cached units,
    with no fetch. Stored-chunk runs move from the entry files with
    ``copy_file_range`` (no decode, no user-space byte), and the rest
    (compressed chunks, footer-hashed entries, boundary terms) decodes in
    place into an mmap of the preallocated temp file. ``lane_note`` gets
    the bytes of the ``copy`` and ``decode`` lanes.

    Returns the temp file's path (its fsync and rename are the caller's
    barrier's), or None to decline to the waterfall, which fetches and
    heals: a unit missing from the cache or failing to decode, an entry
    that vanished or was truncated (``OSError``, ``ValueError``), or a
    reconstruction that cannot be resolved. Any other error raises."""
    try:
        rec = bridge.get_reconstruction(xet_hash)
    except FETCH_ERRORS:
        return None
    # Cache only (no bridge: a miss declines instead of fetching), and a
    # serial decode: a worker's traceback could pin a view of the mmap
    # past its close.
    reader = CachedFileReader(bridge.cache, rec, workers=1)
    size = reader.size
    dest.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dest.parent, prefix=f".tmp-{dest.name}.")
    copied = decoded = 0
    try:
        ok = True
        err: BaseException | None = None
        if size:
            _preallocate(fd, size)
            os.ftruncate(fd, size)
            try:
                copies, leftovers = reader.copy_plan(0, size)
            except DirectLandingError:
                copies, leftovers = [], [(0, size)]
            try:
                copied = _execute_copy_plan(copies, fd)
            except (OSError, ValueError):
                ok = False
            if ok and leftovers:
                mm = mmap.mmap(fd, size)
                try:
                    view = memoryview(mm)
                    try:
                        for d_lo, d_hi in leftovers:
                            decoded += reader.read_into(
                                d_lo, d_hi, view[d_lo:d_hi])
                    except (DirectLandingError, ValueError) as exc:
                        # Handled inside the view's lifetime, the
                        # tracebacks dropped: one that lived on would pin
                        # read_into's frame and its cast of the view.
                        _drop_tracebacks(exc)
                        ok = False
                    except BaseException as exc:
                        # Anything else survives as itself once the mmap
                        # is closed.
                        err = _drop_tracebacks(exc)
                    finally:
                        view.release()
                finally:
                    _close_mmap(mm)
        if err is not None:
            raise err
        if not ok:
            os.unlink(tmp)
            return None
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    finally:
        os.close(fd)
    if lane_note is not None:
        if copied:
            lane_note("copy", copied)
        if decoded:
            lane_note("decode", decoded)
    # One cache event per term, as the waterfall books it.
    for term in rec.terms:
        bridge.stats.record("cache", term.unpacked_length)
    return tmp
