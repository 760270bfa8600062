"""Unit-level cache helpers shared by the cooperative round.

The helpers of ``zest_tpu/transfer/federated.py`` that the cooperative
pull (``transfer/coop.py``) and the direct landing's warm fetch
(``transfer/pull.py``) run: the structural cover gate, the cache probe
that never lets a narrower blob be re-written over a wider entry, the
full-vs-partial cache write, and the parallel warm of a unit set through
the waterfall. The federated round itself is not ported.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor, as_completed

from zest_tpu_torch.cas.reconstruction import FetchInfo, Reconstruction
from zest_tpu_torch.cas.xorb import XorbReader
from zest_tpu_torch.parallel.plan import collect_units
from zest_tpu_torch.transfer.bridge import FETCH_ERRORS


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
    when the sequential retry pass rescued any)."""
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
