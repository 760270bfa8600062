"""``pull``: download a model repo into the HF cache and land it on a device.

The counterpart of ``zest_tpu/transfer/pull.py`` for one host: resolve the
revision, list files, reconstruct every xet file through the bridge's
cache → CDN waterfall (regular files stream from ``resolve``), write the
ref and the revision manifest, then land the snapshot in device memory
the disk-staging way (:func:`~zest_tpu_torch.models.loader.
stage_snapshot_to_hbm`). Already-complete files are skipped.

``device`` is ``cuda`` unless the caller passes ``cpu``; there is no
silent fallback. The stats keep the JAX package's names and meaning:
``elapsed_s`` (whole pull), ``time_to_hbm_s`` (pull start → every tensor
resident on the device), ``stages`` (per-stage wall seconds) and ``hbm``
(the landing's block). ``fallback_files`` counts xet files whose
reconstruction failed and that came whole from ``resolve`` instead.

**Cooperative pull** (``coop=True`` with ``coop_hosts``, ``coop_index``
and the other hosts' DCN addresses, or ``ZEST_COOP*``): before the file
loop, ``transfer/coop.coop_round`` fetches this host's share of the
deduplicated xorb units and pulls the rest from their owners over the DCN
chunk RPC, verifying every received whole xorb on ``device``; the file
loop then reads the cache. ``stats["coop"]`` is the round's block and
``stats["peer_served_ratio"]`` its headline. Only a missing topology
(:class:`~zest_tpu_torch.transfer.coop.CoopUnavailable`) or a connection
failure degrades the pull to the per-host waterfall; any other error of
the round — a kernel that does not build or launch — fails the pull.
The pod, direct and streaming paths come with later slices.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from pathlib import Path

from zest_tpu_torch import storage
from zest_tpu_torch.cas.client import CasError
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.config import DEFAULT_DEVICE, Config, resolve_device
from zest_tpu_torch.transfer import delta
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.coop import (
    CoopUnavailable,
    coop_round,
    mint_trace_id,
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
    """Per-stage wall time: the union of each stage's (start, end)
    intervals, so concurrent entries count once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._intervals: dict[str, list[tuple[float, float]]] = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            with self._lock:
                self._intervals.setdefault(stage, []).append(
                    (t0, time.monotonic()))

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

    def summary(self) -> dict[str, float]:
        with self._lock:
            items = {k: list(v) for k, v in self._intervals.items()}
        return {k: round(self._coverage(v), 4) for k, v in items.items()}


def _is_complete(snapshot_dir: Path, entry) -> bool:
    dest = snapshot_dir / entry.path
    return dest.exists() and dest.stat().st_size == entry.size


def pull_model(cfg: Config, repo_id: str, revision: str = "main",
               device=DEFAULT_DEVICE, coop: bool | None = None,
               coop_hosts: int | None = None, coop_index: int | None = None,
               coop_addrs: dict[int, tuple[str, int]] | None = None,
               coop_server=None, log=print) -> PullResult:
    """Pull ``repo_id@revision`` and land it on ``device`` (see module
    docstring). ``coop_server`` is this host's running ``DcnServer`` over
    ``cfg``'s cache, which then answers the peers for as long as its
    caller keeps it up; without one the round starts its own listener,
    which closes when this pull returns."""
    dev = resolve_device(device)  # fail before any network work
    t0 = time.monotonic()
    hub = HubClient(cfg)
    clock = StageClock()
    with clock("resolve"):
        commit_sha = hub.resolve_revision(repo_id, revision)
        files = hub.list_files(repo_id, revision)
    snapshot_dir = cfg.model_snapshot_dir(repo_id, commit_sha)
    bridge = XetBridge(cfg)
    try:
        coop_stats = None
        coop_cfg = _resolve_coop(cfg, coop, coop_hosts, coop_index,
                                 coop_addrs, log)
        pending = [e for e in files
                   if e.is_xet and not _is_complete(snapshot_dir, e)]
        if coop_cfg and pending:
            try:
                with clock("cas_metadata"):
                    bridge.authenticate(repo_id, revision, hub=hub)
                    recs = [bridge.get_reconstruction(e.xet_hash)
                            for e in pending]
                with clock("coop"):
                    coop_stats = _coop_stage(bridge, recs, cfg, coop_cfg,
                                             repo_id, commit_sha, dev,
                                             coop_server, clock, log)
            except (CoopUnavailable, CasError, ConnectionError) as exc:
                log(f"cooperative pull unavailable ({exc}); continuing "
                    "with the per-host waterfall", file=sys.stderr)
        downloaded, skipped, fallbacks = _fetch_files(
            bridge, hub, repo_id, revision, files, snapshot_dir, clock, log)
    finally:
        bridge.close()

    storage.write_ref(cfg, repo_id, revision, commit_sha)
    # The revision manifest, complete or not at all (a fully skipped
    # resume pull resolved no reconstruction; its first pull wrote it).
    delta.save_manifest(cfg, repo_id, commit_sha, files,
                        lambda e: bridge.known_reconstruction(e.xet_hash))

    from zest_tpu_torch.models.loader import stage_snapshot_to_hbm

    with clock("hbm_commit"):
        params, hbm_stats = stage_snapshot_to_hbm(snapshot_dir, dev)
    elapsed = time.monotonic() - t0
    stats = {
        "repo": repo_id,
        "revision": commit_sha,
        "device": str(dev),
        "files_downloaded": downloaded,
        "files_skipped": skipped,
        "fallback_files": fallbacks,
        "elapsed_s": round(elapsed, 3),
        "time_to_hbm_s": round(elapsed, 3),
        "stages": clock.summary(),
        "fetch": bridge.stats.summary(
            bridge.cas.retry_count if bridge.cas else 0),
        "hbm": hbm_stats,
    }
    if coop_stats is not None:
        stats["coop"] = coop_stats
        stats["peer_served_ratio"] = coop_stats.get("peer_served_ratio")
    return PullResult(snapshot_dir, stats, params=params)


def _fetch_files(bridge, hub, repo_id, revision, files, snapshot_dir,
                 clock, log) -> tuple[int, int, int]:
    """The file loop: every incomplete file through the bridge (xet) or
    ``resolve`` (regular). Returns (downloaded, skipped, fallbacks)."""
    downloaded = skipped = fallbacks = 0
    with clock("files"):
        for entry in files:
            dest = snapshot_dir / entry.path
            if _is_complete(snapshot_dir, entry):
                skipped += 1
                continue
            if entry.is_xet:
                if bridge.cas is None:
                    bridge.authenticate(repo_id, revision, hub=hub)
                try:
                    bridge.reconstruct_to_file(entry.xet_hash, dest)
                except Exception as exc:  # noqa: BLE001 - reference chain
                    # Last rung of the reference's fallback chain: the
                    # plain CDN download of the whole file.
                    log(f"reconstruct of {entry.path} failed ({exc}); "
                        "falling back to plain download", file=sys.stderr)
                    fallbacks += 1
                    hub.download_regular_file(repo_id, revision, entry.path,
                                              dest)
            else:
                hub.download_regular_file(repo_id, revision, entry.path,
                                          dest)
            downloaded += 1
    return downloaded, skipped, fallbacks


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


def _coop_stage(bridge, recs, cfg, coop_cfg, repo_id, commit_sha, device,
                server, clock, log) -> dict:
    """Run the cooperative round over explicit peer addresses (address
    discovery over a KV store is not ported). The pull's trace id is
    minted from ``repo@sha``, as every host of the pull mints it."""
    host_index, n_hosts, addrs = coop_cfg
    if not {h for h in addrs if h != host_index}:
        raise CoopUnavailable("no coop peer addresses: pass coop_addrs or "
                              "set ZEST_COOP_ADDRS")
    return coop_round(bridge, recs, host_index, n_hosts, addrs,
                      device=device, server=server,
                      budget_bytes=cfg.coop_inflight_bytes,
                      trace_id=mint_trace_id(f"{repo_id}@{commit_sha}"),
                      clock=clock, log=log)
