"""Federated multi-pod rounds, and the unit-level cache helpers the
cooperative round and the landing share.

The counterpart of ``zest_tpu/transfer/federated.py``.
``parallel/hierarchy.py`` distributes across pods when every host joins
one mesh. This module serves the other deployment: pods that are separate
processes or jobs with no shared mesh (separate trainers, a warm pod
seeding a cold one, pods that start at different times). Between them no
collective exists, so bytes move over the DCN chunk RPC
(``transfer/dcn.py``), and each unit keeps the waterfall with the owner
pod slotted in before the CDN:

    local cache  →  owner pod over DCN  →  (peers)  →  CDN

Ownership is the hierarchical plan's pod draw (``owner_pod_host``), so
every pod computes the same owner map with no coordination, each unit
leaves the CDN once, through its owning pod, and crosses pods at most
``n_pods - 1`` times. A missing or failed owner degrades the unit to the
waterfall. After the round every unit is in the local cache and the
in-pod pod round (``transfer/pod.py``) spreads it over the pod's slots.

The helpers: the structural cover gate, the cache probe that never lets a
narrower blob be re-written over a wider entry, the full-vs-partial cache
write, and the parallel warm of a unit set through the waterfall (the
cooperative pull's fetch phase and the direct landing's warm fetch).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

from zest_tpu_torch import telemetry
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.reconstruction import FetchInfo, Reconstruction
from zest_tpu_torch.cas.xorb import XorbReader
from zest_tpu_torch.parallel.hierarchy import owner_pod_host
from zest_tpu_torch.parallel.plan import collect_units
from zest_tpu_torch.transfer.bridge import FETCH_ERRORS
from zest_tpu_torch.transfer.dcn import DcnPool, DcnResponse


def pod_owned_units(recs: list[Reconstruction], pod_index: int,
                    n_pods: int):
    """The deduplicated fetch units split into ``(mine, theirs by pod)``.
    Only the pod draw matters here (the in-pod spread is the pod round's),
    so the host draw is pinned to one host."""
    mine: list[tuple[str, FetchInfo]] = []
    theirs: dict[int, list[tuple[str, FetchInfo]]] = {}
    for (hash_hex, start), fi in collect_units(recs):
        pod, _host = owner_pod_host(hashing.hex_to_hash(hash_hex), start,
                                    n_pods, 1)
        if pod == pod_index:
            mine.append((hash_hex, fi))
        else:
            theirs.setdefault(pod, []).append((hash_hex, fi))
    return mine, theirs


def _blob_covers(data: bytes, n_chunks: int) -> bool:
    """Structural gate before caching a peer blob: it parses and holds at
    least ``n_chunks`` frames. Content verification is the receipt's."""
    try:
        return len(XorbReader(data)) >= n_chunks
    except ValueError:
        return False


def _already_cached(bridge, hash_hex: str, fi: FetchInfo) -> bool:
    """True when the local cache already serves ``[fi.range)`` — to skip
    the fetch and, above all, never to write: a blob that came back from a
    cache hit can be a narrower slice of the cached entry."""
    def covers(res) -> bool:
        return (res.chunk_offset <= fi.range.start
                and _blob_covers(res.data, fi.range.end - res.chunk_offset))

    return bridge.cache.get_with_range(hash_hex, fi.range.start,
                                       covers=covers) is not None


def _entries_by_hash(recs: list[Reconstruction]) -> dict[str, list[FetchInfo]]:
    out: dict[str, list[FetchInfo]] = {}
    for rec in recs:
        for hash_hex, entries in rec.fetch_info.items():
            out.setdefault(hash_hex, []).extend(entries)
    return out


def _cache_unit(bridge, entries_map, hash_hex: str, fi: FetchInfo,
                chunk_offset: int, data: bytes) -> None:
    """Cache a fetched unit: the full key only with whole-xorb evidence
    across every file (``entries_map``), through the bridge's guarded
    write."""
    bridge.cache_blob(hash_hex, chunk_offset, data,
                      whole=bridge.whole_xorb_provable(
                          entries_map.get(hash_hex, []), chunk_offset))


def warm_units_parallel(bridge, recs: list[Reconstruction],
                        entries_map: dict[str, list[FetchInfo]] | None = None,
                        units: list[tuple[str, FetchInfo]] | None = None,
                        on_unit=None) -> dict:
    """Fetch every uncached unit of ``recs`` (or of the ``units`` subset)
    into the local cache, ``cfg.max_concurrent_downloads`` waterfall
    fetches at once (fewer over loopback). Idempotent. ``entries_map``
    must span ALL files even when warming a subset: a xorb shared across
    files can look whole from one file's references alone. Units are
    submitted in ``units`` order (the landing passes layer order).
    ``on_unit(key)`` is called with a unit's ``(hash_hex, range_start)``
    the moment it is resolved: at once when already cached, when its
    fetch completes, or after its last failed attempt (the landing's
    per-term waterfall is the last resort, so resolved does not mean
    cached). Returns ``{"units", "bytes", "failed"}`` (plus ``"retried"``
    when the sequential retry pass rescued any). Runs in a
    ``warm.units`` span."""
    with telemetry.span("warm.units", shards=len(recs)):
        return _warm_units_parallel(bridge, recs, entries_map, units,
                                    on_unit)


def _warm_units_parallel(bridge, recs, entries_map, units, on_unit) -> dict:
    if entries_map is None:
        entries_map = _entries_by_hash(recs)
    if units is None:
        units = [(hh, fi) for (hh, _s), fi in collect_units(recs)]
    wanted = [(hh, fi) for hh, fi in units
              if not _already_cached(bridge, hh, fi)]
    if on_unit is not None:
        wanted_keys = {(hh, fi.range.start) for hh, fi in wanted}
        for hh, fi in units:
            if (hh, fi.range.start) not in wanted_keys:
                on_unit((hh, fi.range.start))
    max_concurrent = bridge.cfg.max_concurrent_downloads
    urls = {bridge._absolute_url(fi.url) for _h, fi in wanted[:8]}
    if urls and all("127.0.0.1" in u or "localhost" in u for u in urls):
        # Loopback bytes are bound by the local CPU, where threads far past
        # the cores only contend for the interpreter lock.
        max_concurrent = min(max_concurrent,
                             max(2, 4 * (os.cpu_count() or 1)))
    stats = {"units": len(wanted), "bytes": 0, "failed": 0}
    if not wanted:
        return stats

    def fetch(unit) -> int | None:
        hash_hex, fi = unit
        try:
            if bridge.swarm is None and bridge.cas is not None:
                # No peer tier, and the cache was checked above: stream
                # the CDN body straight into its cache file. A short
                # body or a full disk (CacheFullError) leaves no entry
                # and fails the unit.
                return bridge.stream_unit_from_cdn(
                    hash_hex, fi, bridge.whole_xorb_provable(
                        entries_map.get(hash_hex, []), fi.range.start))
            data = bridge.fetch_unit(hash_hex, fi)
        except FETCH_ERRORS:
            return None
        _cache_unit(bridge, entries_map, hash_hex, fi, fi.range.start, data)
        return len(data)

    failed = []
    with ThreadPoolExecutor(max_workers=max_concurrent,
                            thread_name_prefix="zest-warm") as pool:
        futures = {pool.submit(fetch, u): u for u in wanted}
        for fut in as_completed(futures):
            n = fut.result()
            if n is None:
                failed.append(futures[fut])
            else:
                stats["bytes"] += n
                if on_unit is not None:
                    on_unit((futures[fut][0], futures[fut][1].range.start))
    # One sequential retry: under load a concurrent fetch can fail where
    # the same transfer alone succeeds.
    for unit in failed:
        n = fetch(unit)
        if n is None:
            stats["failed"] += 1
        else:
            stats["retried"] = stats.get("retried", 0) + 1
            stats["bytes"] += n
        if on_unit is not None:
            on_unit((unit[0], unit[1].range.start))
    return stats


def federated_round(bridge, recs: list[Reconstruction], pod_index: int,
                    n_pods: int, pod_addrs: dict[int, tuple[str, int]],
                    dcn_pool: DcnPool | None = None,
                    pipeline_depth: int = 16, log=None) -> dict:
    """One cross-pod stage: this pod's units through the waterfall, every
    other pod's from their owner over DCN (``pipeline_depth`` requests in
    flight a channel), the waterfall for whatever the owner cannot serve.
    Afterwards every unit is in the local cache. ``pod_addrs`` maps a pod
    index to its ``(host, dcn_port)``; a pod with no address is
    unreachable and its units degrade. Returns ``stats["federated"]``
    with the JAX package's keys."""
    with telemetry.span("federated.round", pod=pod_index, pods=n_pods):
        return _federated_round(bridge, recs, pod_index, n_pods, pod_addrs,
                                dcn_pool, pipeline_depth, log)


def _federated_round(bridge, recs, pod_index, n_pods, pod_addrs, dcn_pool,
                     pipeline_depth, log) -> dict:
    t0 = time.monotonic()
    pool = dcn_pool or DcnPool()
    mine, theirs = pod_owned_units(recs, pod_index, n_pods)
    entries_map = _entries_by_hash(recs)
    stats = {
        "pod": pod_index,
        "pods": n_pods,
        "own_units": 0,
        "own_bytes": 0,
        "cached_units": 0,
        "dcn_units": 0,
        "dcn_bytes": 0,
        "fallback_units": 0,
        "fallback_bytes": 0,
        "failed_units": 0,
    }

    def waterfall(hash_hex, fi) -> int | None:
        """Fetch one unit through the waterfall and cache it; its bytes,
        or None (counted failed) when every tier failed."""
        try:
            data = bridge.fetch_unit(hash_hex, fi)
        except FETCH_ERRORS:
            stats["failed_units"] += 1
            return None
        _cache_unit(bridge, entries_map, hash_hex, fi, fi.range.start, data)
        return len(data)

    # Stage 1: this pod's units, cached so it can serve the others.
    for hash_hex, fi in mine:
        if _already_cached(bridge, hash_hex, fi):
            stats["own_units"] += 1
            continue
        n = waterfall(hash_hex, fi)
        if n is not None:
            stats["own_units"] += 1
            stats["own_bytes"] += n

    def fallback(units, owner_pod):
        for hash_hex, fi in units:
            if _already_cached(bridge, hash_hex, fi):
                stats["fallback_units"] += 1
                continue
            n = waterfall(hash_hex, fi)
            if n is None:
                continue
            stats["fallback_units"] += 1
            stats["fallback_bytes"] += n
            telemetry.record("cdn_fallback", unit=hash_hex[:16],
                             owner=owner_pod, tier="federated", bytes=n)

    # Stage 2: the other pods' units from their owners, pipelined.
    try:
        for pod, all_units in sorted(theirs.items()):
            units = []
            for hash_hex, fi in all_units:
                if _already_cached(bridge, hash_hex, fi):
                    stats["cached_units"] += 1
                else:
                    units.append((hash_hex, fi))
            if not units:
                continue
            addr = pod_addrs.get(pod)
            if addr is None:
                fallback(units, pod)
                continue
            for i in range(0, len(units), pipeline_depth):
                window = units[i:i + pipeline_depth]
                try:
                    # The pool reconnects and retries a window once on a
                    # stale channel, so a failure here is a hard one: the
                    # pod's remaining units degrade.
                    replies = pool.request_many(*addr, [
                        (hashing.hex_to_hash(hh), fi.range.start,
                         fi.range.end) for hh, fi in window])
                except (ConnectionError, TimeoutError, OSError):
                    fallback(units[i:], pod)
                    break
                missed = []
                for (hash_hex, fi), reply in zip(window, replies):
                    if (isinstance(reply, DcnResponse)
                            and reply.chunk_offset <= fi.range.start
                            and _blob_covers(
                                reply.data,
                                fi.range.end - reply.chunk_offset)):
                        _cache_unit(bridge, entries_map, hash_hex, fi,
                                    reply.chunk_offset, reply.data)
                        bridge.stats.record("peer", len(reply.data))
                        stats["dcn_units"] += 1
                        stats["dcn_bytes"] += len(reply.data)
                    else:
                        missed.append((hash_hex, fi))
                fallback(missed, pod)
    finally:
        if dcn_pool is None:
            pool.close()
    stats["units"] = len(mine) + sum(len(u) for u in theirs.values())
    stats["elapsed_s"] = round(time.monotonic() - t0, 3)
    if log is not None:
        log(f"federated round pod {pod_index}/{n_pods}: "
            f"{stats['own_units']} own, {stats['dcn_units']} over DCN "
            f"({stats['dcn_bytes']} bytes), {stats['fallback_units']} "
            f"CDN-fallback, {stats['failed_units']} failed")
    return stats
