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
  the reconstruction waterfall writes the rest.

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
``stats["peer_served_ratio"]`` its headline. Only a missing topology
(:class:`~zest_tpu_torch.transfer.coop.CoopUnavailable`) or a connection
failure degrades the pull to the per-host waterfall; any other error of
the round — a kernel that does not build or launch — fails the pull.

**Pod round** (``pod``; on by default for ``cuda``, forced with
``ZEST_TPU_POD=1/0``): after the cooperative round,
``transfer/pod.pod_round`` distributes the units over the slot mesh of
every CUDA device and fills the cache before the landing
(``stats["pod"]``; on one card ``{"slots": 1, ..., "skipped": true}``).
Expert routing is not ported: every family takes the plain round. With
several processes they agree first, over ``torch.distributed``, that
every one has its reconstructions. Pull sessions and mesh placement of
the landing are not ported.

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
from zest_tpu_torch.cas.hub import HubClient
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
    stage_cached_to_hbm,
    stage_snapshot_to_hbm,
)
from zest_tpu_torch.models.safetensors_io import tensor_bytes
from zest_tpu_torch.parallel.mesh import num_slots, pod_mesh, world_size
from zest_tpu_torch.parallel.plan import collect_units
from zest_tpu_torch.resilience import Deadline
from zest_tpu_torch.transfer import delta
from zest_tpu_torch.transfer.bridge import FETCH_ERRORS, XetBridge
from zest_tpu_torch.transfer.coop import (
    ByteBudget,
    CoopUnavailable,
    coop_round,
    mint_trace_id,
)
from zest_tpu_torch.transfer.federated import (
    _entries_by_hash,
    warm_units_parallel,
)
from zest_tpu_torch.transfer.pod import (
    fetch_file_header,
    fetch_header_probe,
    pod_round,
)


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
    bytes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._intervals: dict[str, list[tuple[float, float]]] = {}
        self._bytes: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.note_interval(stage, t0, time.monotonic())

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

    def note_bytes(self, stage: str, nbytes: int) -> None:
        with self._lock:
            self._bytes[stage] = self._bytes.get(stage, 0) + int(nbytes)

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
    re-raises from :meth:`join`."""

    def __init__(self, width: int, budget_bytes: int, clock: StageClock,
                 work, skip_check=None, materialize_workers: int = 1,
                 async_handoff: bool = True):
        self.width = max(1, int(width))
        self.budget = ByteBudget(budget_bytes)
        self.clock = clock
        self.work = work  # work(entry) -> "downloaded" | "skipped"
        self.skip_check = skip_check
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
        try:
            if self._cancel.is_set():
                return
            with self.clock("files"):
                status = prepared(entry)
                if status is None:
                    status = self.work(entry)
        finally:
            self.budget.release(entry.size)
        self._count(status)

    def _run(self, entry) -> None:
        if self._cancel.is_set():
            return
        if self.skip_check is not None and self.skip_check(entry):
            self._count("skipped")
            return
        self.budget.acquire(entry.size)  # queueing, outside the clock
        try:
            if self._cancel.is_set():
                return
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
        with self.clock("files"):
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
        # A held job waits for its shard's writes: the write pool last.
        for pool in (self._pool, self._prepared_pool, self._write_pool):
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
               pod: bool | None = None, log=print) -> PullResult:
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
    unless ``ZEST_TPU_POD`` says otherwise)."""
    if not land and base_params is not None:
        raise ValueError("base_params needs a landing (land=True)")
    if base_params is not None and not base_revision:
        raise ValueError(
            "base_params requires base_revision: tensor reuse is only "
            "sound against the manifest of the revision the resident "
            "tree actually holds")
    dev = resolve_device(device)  # fail before any network work
    land_dtype = resolve_dtype(cfg.land_dtype)
    t0 = time.monotonic()
    hub = HubClient(cfg)
    clock = StageClock()
    with clock("resolve"):
        commit_sha = hub.resolve_revision(repo_id, revision)
        files = hub.list_files(repo_id, revision)
    snapshot_dir = cfg.model_snapshot_dir(repo_id, commit_sha)
    own_swarm = None
    if swarm is None and not no_p2p:
        swarm = own_swarm = _default_swarm(cfg)
    bridge = XetBridge(cfg, swarm=swarm)
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
            if tmp is not None:
                file_pipeline.defer_commit(tmp, dest)
                clock.note_bytes("files", entry.size)
                return "downloaded"
            try:
                bridge.reconstruct_to_file(entry.xet_hash, dest)
            except Exception as exc:  # noqa: BLE001 - reference chain
                # Last rung of the reference's fallback chain: the plain
                # CDN download of the whole file.
                log(f"reconstruct of {entry.path} failed ({exc}); "
                    "falling back to plain download", file=sys.stderr)
                fallbacks.append(entry.path)
                hub.download_regular_file(repo_id, revision, entry.path,
                                          dest)
        else:
            hub.download_regular_file(repo_id, revision, entry.path, dest)
        file_pipeline.note_lane("waterfall", entry.size)
        clock.note_bytes("files", entry.size)
        return "downloaded"

    file_pipeline = _FilePipeline(
        1, cfg.pull_inflight_bytes, clock, file_work,
        skip_check=lambda e: _is_complete(snapshot_dir, e),
        materialize_workers=_resolve_files_workers(cfg.files_workers),
        async_handoff=cfg.files_async)
    hbm_params = hbm_stats = None
    time_to_hbm = hbm_done_at = time_to_first_layer = None
    delta_plan = delta_base = delta_net_before = None
    if pod is None:
        env = os.environ.get("ZEST_TPU_POD")
        pod = env == "1" if env in ("0", "1") else dev.type == "cuda"
    try:
        coop_stats = pod_stats = recs = None
        coop_cfg = _resolve_coop(cfg, coop, coop_hosts, coop_index,
                                 coop_addrs, log)
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
        if (coop_cfg or pod) and pending:
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
        if pod and pending:
            pod_stats = _pod_stage(bridge, recs, dev, log)
        # Files the landing does not write ride the pipeline under it.
        for entry in files:
            if not entry.path.endswith(".safetensors"):
                file_pipeline.submit(entry)
        if land:
            hbm_params, hbm_stats = _try_direct_stage(
                bridge, files, snapshot_dir, dev, land_dtype, log, clock,
                file_pipeline, ensure_auth,
                delta_state=((delta_base, base_params, delta_plan)
                             if delta_plan is not None else None))
        if hbm_stats is not None:
            hbm_done_at = time.monotonic()
            time_to_hbm = hbm_done_at - t0
            clock.note_bytes("hbm_commit", hbm_stats["bytes"])
            fl_at = hbm_stats.pop("first_layer_at", None)
            if fl_at is not None:
                time_to_first_layer = fl_at - t0
                clock.note_interval("first_layer", t0, fl_at)
        for entry in files:
            file_pipeline.submit(entry)
        clock.ensure("files")
        downloaded, skipped = file_pipeline.join()
    except BaseException:
        file_pipeline.abort()
        raise
    finally:
        bridge.close()
        if own_swarm is not None:
            own_swarm.close()

    storage.write_ref(cfg, repo_id, revision, commit_sha)
    if cfg.delta_pull:
        _save_manifest(cfg, bridge, repo_id, commit_sha, files, delta_base,
                       log)

    if land and hbm_stats is None:
        # Disk staging: a resumed pull (complete files) or a shard that
        # is not a xet file; the files are on disk now.
        with clock("hbm_commit"):
            hbm_params, hbm_stats = stage_snapshot_to_hbm(
                snapshot_dir, dev, land_dtype)
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
        stats["hbm"] = hbm_stats
    if time_to_first_layer is not None:
        stats["time_to_first_layer_s"] = round(time_to_first_layer, 3)
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
            if base_params:
                # Tensors the new revision dropped: the base dict is
                # empty when a swap returns.
                base_params.clear()
        stats["delta"] = dsum
    if coop_stats is not None:
        stats["coop"] = coop_stats
        stats["peer_served_ratio"] = coop_stats.get("peer_served_ratio")
    if pod_stats is not None:
        stats["pod"] = pod_stats
    if deadline is not None:
        stats["deadline"] = {
            "budget_s": deadline.total_s,
            "remaining_s": round(max(0.0, deadline.remaining()), 3),
        }
    if swarm is not None:
        stats["swarm"] = swarm.summary()
    return PullResult(snapshot_dir, stats, params=hbm_params)


def _default_swarm(cfg: Config):
    """A swarm with no candidates (the tracker and DHT sources are not
    ported): its stats block is the JAX package's; None when it cannot
    start."""
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


def _reused_tensors(cache, st, recs_with_headers, base_manifest,
                    base_params, dev, dtype) -> dict:
    """The tensors of the base tree that the landing reuses as they are:
    bytes proven unchanged (the reference's fingerprints, and the chunk
    alignment the cached xorbs' chunk tables show), and the shape, landed
    dtype and device this landing would give them. A base tree landed at
    another dtype or shape reuses nothing there, so the swapped tree
    equals a cold landing."""
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
            info = header.tensors[name]
            if (tuple(t.shape) != tuple(info.shape)
                    or t.dtype != _landed_dtype(info, dtype)
                    or t.device != dev):
                continue
            reused[name] = t
    return reused


def _try_direct_stage(bridge, files, snapshot_dir, dev, dtype, log,
                      clock: StageClock, file_pipeline: _FilePipeline,
                      ensure_auth, delta_state=None):
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
                                        d_params, dev, dtype)
            for name in preloaded:
                d_params.pop(name)  # moved into the new tree

    def delta_shard(i) -> bool:
        return bool(preloaded) and any(
            n in preloaded for n in recs_with_headers[i][1].tensors)

    pipeline = None
    try:
        if cfg.land_stream and cfg.land_decode_ahead:
            priorities = unit_layer_priorities(recs_with_headers)
            required = [tensor_unit_keys(rec, header)
                        for rec, header in recs_with_headers]
            pipeline = _PipelinedWarm(bridge, recs_only,
                                      evidence_recs=evidence_recs,
                                      unit_priorities=priorities,
                                      streaming=True, clock=clock,
                                      skip_keys=skip_keys)

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

            clock.ensure("fetch")  # the warm threads clock it
            pipeline.poke(0)
            with clock("hbm_commit"):
                params, hbm_stats = stage_cached_to_hbm(
                    bridge, recs_with_headers, dev, dtype=dtype,
                    prefetch_next=pipeline.poke, clock=clock, stream=True,
                    tensor_gate=tensor_gate,
                    on_first_layer=lambda: first_layer_at.append(
                        time.monotonic()),
                    stream_file_sink=stream_file_sink,
                    preloaded=preloaded or None, swap_from=swap_from)
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
            with clock("hbm_commit"):
                params, hbm_stats = stage_cached_to_hbm(
                    bridge, recs_with_headers, dev, dtype=dtype,
                    prefetch_next=pipeline.ensure,
                    on_host_ready=on_host_ready, clock=clock, stream=False,
                    preloaded=preloaded or None, swap_from=swap_from)
    except BaseException as exc:
        if swap_from is None:
            raise
        swap_from.update(preloaded)
        if not isinstance(exc, Exception):
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
        except (*FETCH_ERRORS, ValueError):
            # The landing's per-term waterfall serves what is missing.
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
    """The cooperative topology: explicit arguments, else ``ZEST_COOP*``.
    Auto (``coop`` None) turns the round on when more than one host is
    known and stays quietly off otherwise; a forced ``coop=True`` with an
    unusable topology logs why it is off. Returns ``(index, n_hosts,
    addrs)`` or None."""
    enabled = coop if coop is not None else cfg.coop_pull
    if enabled is False:
        return None
    n = coop_hosts if coop_hosts is not None else cfg.coop_hosts
    i = coop_index if coop_index is not None else cfg.coop_index
    addrs = dict(coop_addrs) if coop_addrs else dict(cfg.coop_addrs)
    if n is None and addrs:
        n = max(addrs) + 1
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
    """Run the cooperative round over explicit peer addresses (address
    discovery over a KV store is not ported). The pull's trace id is
    minted from ``repo@sha``, as every host of the pull mints it.
    ``units`` is a delta pull's changed set: only those are planned."""
    host_index, n_hosts, addrs = coop_cfg
    if not {h for h in addrs if h != host_index}:
        raise CoopUnavailable("no coop peer addresses: pass coop_addrs or "
                              "set ZEST_COOP_ADDRS")
    return coop_round(bridge, recs, host_index, n_hosts, addrs,
                      device=device, server=server,
                      budget_bytes=cfg.coop_inflight_bytes,
                      trace_id=mint_trace_id(f"{repo_id}@{commit_sha}"),
                      priorities=priorities, units=units, clock=clock,
                      log=log)


def _pod_stage(bridge, recs, dev, log) -> dict | None:
    """The pod pre-pass over the slot mesh of ``dev`` (every CUDA device;
    the one CPU device otherwise, so the round skips). With several
    processes every one must have its reconstructions (``recs`` not
    None) before any gathers: they agree on that bit first, and one
    without takes the whole pod to the per-host waterfall instead of
    stranding the others in the gather."""
    import torch.distributed as dist

    mesh = pod_mesh(None if dev.type == "cuda" else [dev])
    ready = recs is not None
    if world_size() > 1:
        flags = [None] * world_size()
        dist.all_gather_object(flags, ready)
        if ready and not all(flags):
            log("pod round skipped: another host has no reconstructions",
                file=sys.stderr)
        ready = all(flags)
    if not ready:
        return None
    if num_slots(mesh) > 1:
        log("pod round: expert routing is not ported; every family takes "
            "the plain round", file=sys.stderr)
    return pod_round(bridge, recs, mesh=mesh, log=log)


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
                    except (DirectLandingError, ValueError):
                        # Handled inside the view's lifetime: a
                        # propagating traceback would pin read_into's
                        # frame and its cast of the view, and mm.close()
                        # would raise BufferError.
                        ok = False
                    except BaseException as exc:
                        # Anything else survives as itself once the mmap
                        # is closed.
                        err = exc.with_traceback(None)
                    finally:
                        view.release()
                finally:
                    mm.close()
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
