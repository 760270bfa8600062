"""Cooperative pull: shard the CDN fetch across hosts, then swap units.

The counterpart of ``zest_tpu/transfer/coop.py``. N hosts agree — with no
coordination — on a byte-balanced ownership plan over the deduplicated
fetch units; each host fetches only its ~1/N share through the waterfall,
then an **exchange** moves every other unit from its owner, so every host
ends fully cached and its per-file reconstruction runs from the cache.

The exchange is a ladder. The **collective** (``transfer/collective.py``:
plan-derived hypercube/ring phases, one pre-sized window a phase, ici/dcn
link classes) runs first (``Config.coop_collective``); what a dead or
lagging partner leaves undelivered goes to the **point-to-point**
exchange, which pulls each unit from its owner over the DCN chunk RPC
(``transfer/dcn.py``) and degrades per unit to the CDN.
``ZEST_COOP_COLLECTIVE=0`` runs the point-to-point exchange alone, with
its stats schema.

- **Compressed on the wire**: the exchange moves xorb frame streams, BG4
  and LZ4 payloads still compressed. A unit that provably is a whole xorb
  is verified on the receiving host's device before it is cached
  (``transfer/pod.make_unit_verifier``: the CUDA BG4 regroup + BLAKE3
  pair for BG4 chunks, the BLAKE3 kernel for the rest).
- **Bounded staging**: exchange windows acquire a :class:`ByteBudget`
  before any reply is in flight.
- **Degradation, never a stall**: a host quarantined up front is left out
  of the plan (its share re-shards, every unit exactly once); a host that
  dies mid-exchange degrades its units to the per-host CDN fallback, which
  ``fallbacks`` counts; a blob that fails verification is never cached and
  heals from the CDN (``verify_rejected``).

``stats["coop"]`` keeps the JAX package's keys and meaning:
``collective`` when the collective ran, ``clock_offsets`` (host index →
the peer's hello clock offset and round trip) when a channel measured
one. Not ported: the lossy tier, address discovery over a KV store and
the point-to-point exchange's use of swarm health. An error that is not a
transfer failure — a kernel that does not build or launch — leaves the
round as an exception, from either tier.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from zest_tpu_torch import faults, telemetry
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.reconstruction import FetchInfo, Reconstruction
from zest_tpu_torch.cas.xorb import XorbReader
from zest_tpu_torch.models.direct import unit_priority_sort_key
from zest_tpu_torch.parallel.plan import collect_units
from zest_tpu_torch.transfer.bridge import FETCH_ERRORS
from zest_tpu_torch.transfer.dcn import DcnPool, DcnResponse, DcnServer
from zest_tpu_torch.transfer.federated import (
    _already_cached,
    _blob_covers,
    _cache_unit,
    _entries_by_hash,
    warm_units_parallel,
)
from zest_tpu_torch.transfer.pod import make_unit_verifier

# How long a host keeps retrying NOT_FOUND units (the owner may still be
# fetching them: hosts run the round concurrently) before degrading them
# to the CDN, and the backoff between passes.
DEFAULT_EXCHANGE_DEADLINE_S = 60.0
_RETRY_SLEEP_S = 0.25
_RETRY_SLEEP_CAP_S = 2.0
# Exchange window: enough replies in flight to pipeline the channel
# without staging more than this (and never past the ByteBudget).
_WINDOW_TARGET_BYTES = 32 * 1024 * 1024
_WINDOW_MAX_UNITS = 64
# How long the round waits for the hello dials that measure the clock
# offsets of peers the exchange never dialed.
_CLK_HELLO_TIMEOUT_S = 2.0


class CoopUnavailable(RuntimeError):
    """Cooperative mode cannot run (no peer addresses, no alive hosts):
    the caller degrades to the ordinary full-fetch waterfall."""


class ByteBudget:
    """Counting byte-semaphore bounding in-flight exchange bytes.

    ``acquire(n)`` blocks while admitting ``n`` more bytes would push the
    in-flight total past the budget — except when nothing is in flight,
    where an item larger than the whole budget is admitted alone rather
    than deadlocking. ``peak_bytes`` is the high-water mark."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = max(1, int(budget_bytes))
        self._cv = threading.Condition(threading.Lock())
        self._inflight = 0
        self.peak_bytes = 0

    def acquire(self, nbytes: int) -> None:
        nbytes = max(0, int(nbytes))
        with self._cv:
            while (self._inflight > 0
                   and self._inflight + nbytes > self.budget_bytes):
                self._cv.wait()
            self._inflight += nbytes
            self.peak_bytes = max(self.peak_bytes, self._inflight)

    def try_acquire(self, nbytes: int) -> bool:
        """:meth:`acquire` without waiting: False when it would wait."""
        nbytes = max(0, int(nbytes))
        with self._cv:
            if (self._inflight > 0
                    and self._inflight + nbytes > self.budget_bytes):
                return False
            self._inflight += nbytes
            self.peak_bytes = max(self.peak_bytes, self._inflight)
            return True

    def release(self, nbytes: int) -> None:
        with self._cv:
            self._inflight -= max(0, int(nbytes))
            self._cv.notify_all()


@dataclass(frozen=True)
class CoopPlan:
    """Deterministic, byte-balanced unit → host ownership.

    Every host builds the plan from the same reconstructions and gets the
    same answer: units sorted by (wire bytes desc, key) go to the
    least-loaded alive host, ties to the lowest index (LPT keeps the
    per-host skew within mean + largest unit). ``quarantined`` hosts are
    left out; their share re-shards with every unit still owned once."""

    n_hosts: int
    alive: tuple[int, ...]
    units: tuple[tuple[tuple[str, int], FetchInfo], ...]
    owners: dict[tuple[str, int], int]

    @staticmethod
    def build(recs: list[Reconstruction], n_hosts: int,
              quarantined=frozenset(), units=None) -> "CoopPlan":
        """``units`` restricts the plan to an explicit ``[(hash_hex,
        FetchInfo)]`` subset: the delta pull's content-changed units,
        which depend only on content-addressed metadata, so hosts with
        differently warm caches build the same plan."""
        if n_hosts <= 0:
            raise ValueError("n_hosts must be positive")
        alive = tuple(h for h in range(n_hosts) if h not in set(quarantined))
        if not alive:
            raise CoopUnavailable("every host is quarantined")
        if units is not None:
            units = tuple(sorted(
                ((hh, fi.range.start), fi) for hh, fi in units))
        else:
            units = tuple(collect_units(recs))
        order = sorted(units, key=lambda u: (
            -(u[1].url_range_end - u[1].url_range_start), u[0]))
        load = {h: 0 for h in alive}
        owners: dict[tuple[str, int], int] = {}
        for key, fi in order:
            best = min(alive, key=lambda h: (load[h], h))
            owners[key] = best
            load[best] += fi.url_range_end - fi.url_range_start
        return CoopPlan(n_hosts, alive, units, owners)

    def for_host(self, host: int) -> list[tuple[str, FetchInfo]]:
        return [(key[0], fi) for key, fi in self.units
                if self.owners[key] == host]

    def bytes_per_host(self) -> dict[int, int]:
        out = {h: 0 for h in self.alive}
        for key, fi in self.units:
            out[self.owners[key]] += fi.url_range_end - fi.url_range_start
        return out

    @property
    def total_bytes(self) -> int:
        return sum(fi.url_range_end - fi.url_range_start
                   for _k, fi in self.units)

    def skew(self) -> float:
        """Max bytes/host over mean bytes/host (1.0 = perfect)."""
        per = self.bytes_per_host()
        if not per or self.total_bytes == 0:
            return 1.0
        return max(per.values()) / (self.total_bytes / len(per))

    def fingerprint(self) -> str:
        """Content hash of the whole assignment: the determinism proof."""
        return hashing.blake3_hash(b"|".join(
            f"{hh}:{start}:{self.owners[(hh, start)]}".encode()
            for (hh, start), _fi in self.units)).hex()

    def summary(self) -> dict:
        per = self.bytes_per_host()
        return {
            "units": len(self.units),
            "hosts": self.n_hosts,
            "alive": len(self.alive),
            "total_bytes": self.total_bytes,
            "bytes_per_host": [per.get(h, 0) for h in range(self.n_hosts)],
            "skew": round(self.skew(), 4),
            "fingerprint": self.fingerprint()[:16],
        }


def _unpacked_bytes(data: bytes) -> int:
    """Sum of the blob's chunk sizes: the bytes the wire would have carried
    expanded (``wire < unpacked`` is the compressed-on-the-wire evidence)."""
    try:
        return int(XorbReader(data).chunk_sizes.sum())
    except ValueError:
        return len(data)


def mint_trace_id(pull_key: str) -> str:
    """16-byte trace id (32 hex) of one cooperative pull, derived so that
    every host mints the same one: the JAX package's
    ``telemetry.fleet.mint_trace_id`` with no nonce (the port has no KV
    store to share one through)."""
    return hashlib.blake2b(f"zest-trace|{pull_key}|".encode(),
                           digest_size=16).hexdigest()


def _derive_trace_id(recs) -> str:
    """Trace id from the deduplicated unit-key set, identical on every
    host of one pull."""
    return mint_trace_id("|".join(
        f"{hh}:{start}" for (hh, start), _fi in collect_units(recs)))


class _ExchangeStats:
    """Thread-safe per-unit ledger of the exchange: every delivered unit
    is booked under exactly one tier — the exchange wire (with its link
    class) or the fallback tier that served it — and a unit delivered
    again replaces its earlier booking (``reattributed``), so
    ``wire_bytes + fallback_bytes`` always tiles what the round
    delivered."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        # key -> (kind, tier or link, bytes, unpacked)
        self._booked: dict[tuple[str, int], tuple] = {}
        self.reattributed = 0
        self.units = 0
        self.wire_bytes = 0
        self.unpacked_bytes = 0
        self.fallback_units = 0
        self.fallback_bytes = 0
        self.fallback_tiers: dict[str, int] = {}
        self.verify_rejected = 0
        self.retries = 0
        self.dead_hosts: set[int] = set()

    def book_exchange(self, key: tuple[str, int], wire: int,
                      unpacked: int, link: str = "dcn") -> None:
        with self.lock:
            self._unbook(key)
            self._booked[key] = ("x", link, wire, unpacked)
            self.units += 1
            self.wire_bytes += wire
            self.unpacked_bytes += unpacked

    def book_fallback(self, key: tuple[str, int], source: str,
                      nbytes: int) -> None:
        with self.lock:
            self._unbook(key)
            self._booked[key] = ("f", source, nbytes, 0)
            self.fallback_units += 1
            self.fallback_bytes += nbytes
            self.fallback_tiers[source] = (
                self.fallback_tiers.get(source, 0) + nbytes)

    def _unbook(self, key: tuple[str, int]) -> None:
        prev = self._booked.pop(key, None)
        if prev is None:
            return
        kind, tier, nbytes, unpacked = prev
        self.reattributed += 1
        if kind == "x":
            self.units -= 1
            self.wire_bytes -= nbytes
            self.unpacked_bytes -= unpacked
            return
        self.fallback_units -= 1
        self.fallback_bytes -= nbytes
        left = self.fallback_tiers.get(tier, 0) - nbytes
        if left > 0:
            self.fallback_tiers[tier] = left
        else:
            self.fallback_tiers.pop(tier, None)

    def summary(self) -> dict:
        out = {
            "units": self.units,
            "wire_bytes": self.wire_bytes,
            "unpacked_bytes": self.unpacked_bytes,
            "fallback_units": self.fallback_units,
            "fallback_bytes": self.fallback_bytes,
            "verify_rejected": self.verify_rejected,
            "retries": self.retries,
        }
        if self.fallback_tiers:
            out["fallback_tiers"] = dict(sorted(self.fallback_tiers.items()))
        if self.reattributed:
            out["reattributed"] = self.reattributed
        if self.dead_hosts:
            out["dead_hosts"] = sorted(self.dead_hosts)
        return out


def _tier_bytes(stats) -> dict[str, int]:
    return {"cache": stats.bytes_from_cache,
            "peer": stats.bytes_from_peer,
            "cdn": stats.bytes_from_cdn}


def _tier_delta(before: dict[str, int], after: dict[str, int]) -> dict:
    return {k: after[k] - before[k] for k in before
            if after[k] - before[k] > 0}


def coop_round(bridge, recs: list[Reconstruction], host_index: int,
               n_hosts: int,
               host_addrs: dict[int, tuple[str, int]] | None = None, *,
               device="cuda", budget_bytes: int | None = None,
               server: DcnServer | None = None, quarantined=None,
               trace_id: str | None = None, priorities: dict | None = None,
               units=None, clock=None, dcn_pool: DcnPool | None = None,
               log=None) -> dict:
    """One cooperative round: plan → fetch my ~1/N → exchange the rest.

    Afterwards every unit of ``recs`` is in the local verified cache.
    Returns the ``stats["coop"]`` block, ``peer_served_ratio`` its
    headline. ``host_addrs`` maps host index → ``(host, dcn_port)`` for
    the other hosts. ``server`` is this host's running DCN listener;
    without one, a listener starts on ``cfg.dcn_port`` and the bridge
    owns it until ``bridge.close()`` (peers behind us still read from it),
    or, when that port is taken, the process already serving this cache
    there answers the peers. Received whole xorbs are verified on
    ``device``. ``quarantined`` is a set of host indices to leave out of
    the plan. ``clock`` (the pull's ``StageClock``) times the fetch phase,
    the exchange phase and the receipt verification as ``coop_fetch``,
    ``coop_exchange`` and ``coop_verify``. ``priorities`` (unit key →
    layer priority, ``models.direct.unit_layer_priorities``) orders both
    phases so embedding and layer-0 units move first; the plan and its
    fingerprint do not depend on it. ``units`` restricts the round to a
    unit subset (a delta pull's changed units): unchanged bytes never
    cross the exchange. ``dcn_pool`` is a ``DcnPool`` of the caller's
    (kept open; tests read its wire-tag counters). Raises
    :class:`CoopUnavailable` when no peer is addressable.
    """
    t0 = time.monotonic()
    if trace_id is None:
        trace_id = _derive_trace_id(recs)
    if n_hosts <= 1:
        return {"host": host_index, "hosts": n_hosts, "skipped": True}
    peers = {h: a for h, a in (host_addrs or {}).items() if h != host_index}
    if not peers:
        raise CoopUnavailable(
            f"cooperative pull over {n_hosts} hosts has no peer addresses "
            "(host_addrs empty)")
    q = set(quarantined or ())
    q.discard(host_index)  # we are demonstrably alive
    plan = CoopPlan.build(recs, n_hosts, frozenset(q), units=units)
    entries_map = _entries_by_hash(recs)

    own_server = False
    if server is None:
        server = DcnServer(bridge.cfg, bridge.cache)
        try:
            server.start()
        except OSError:
            # A fixed ``dcn_port`` that is taken: read as the deployment's
            # own daemon serving this cache there, as the JAX package does.
            # Callers that run the listener themselves pass ``server``.
            server = None
        else:
            own_server = True
            bridge.adopt_coop_server(server)

    if budget_bytes is None:
        budget_bytes = bridge.cfg.coop_inflight_bytes
    # Retry headroom scales with the work: owners may legitimately still be
    # fetching their share.
    deadline_s = DEFAULT_EXCHANGE_DEADLINE_S + 8.0 * plan.total_bytes / 1e9

    stage = clock or (lambda _name: contextlib.nullcontext())

    # ── Phase 1: fetch my share through the waterfall ──
    mine = _layer_order(plan.for_host(host_index), priorities)
    before = _tier_bytes(bridge.stats)
    with stage("coop_fetch"):
        fetch_stats = warm_units_parallel(bridge, recs,
                                          entries_map=entries_map, units=mine)
    fetch_tiers = _tier_delta(before, _tier_bytes(bridge.stats))

    # ── Phase 2: the exchange, collective first ──
    budget = ByteBudget(budget_bytes)
    ex = _ExchangeStats()
    pool = dcn_pool or DcnPool()
    unit_verify = make_unit_verifier(device=device)

    def verify(hash_hex: str, data: bytes) -> bool:
        with stage("coop_verify"):
            return unit_verify(hash_hex, data)

    # Anchored here, not at round start: a slow fetch phase must not eat
    # the exchange's retry headroom.
    deadline = time.monotonic() + deadline_s
    foreign = {
        h: _layer_order([(hh, fi) for hh, fi in plan.for_host(h)
                         if not _already_cached(bridge, hh, fi)],
                        priorities)
        for h in plan.alive if h != host_index
    }
    clock_offsets: dict = {}
    collective_stats: dict | None = None
    try:
        with stage("coop_exchange"):
            if bridge.cfg.coop_collective and any(foreign.values()):
                collective_stats, foreign = _collective_tier(
                    bridge, plan, host_index, n_hosts, peers, pool, budget,
                    ex, verify, deadline, priorities, entries_map, device,
                    foreign)
            jobs = [(h, units) for h, units in foreign.items() if units]
            if jobs:
                with ThreadPoolExecutor(
                        len(jobs), thread_name_prefix="zest-coop-x") as tp:
                    futures = [tp.submit(_exchange_from, bridge,
                                         entries_map, pool, peers, h, units,
                                         budget, ex, verify, deadline)
                               for h, units in jobs]
                for fut in futures:
                    fut.result()  # a worker's error is the round's error
        _collect_clock_offsets(pool, peers, clock_offsets)
        telemetry.timeline.set_clock_offsets(clock_offsets)
    finally:
        if dcn_pool is None:
            pool.close()

    # Headline ratio over network bytes (cache hits excluded), fallback
    # bytes booked under the tier that actually served them.
    cdn_bytes = fetch_tiers.get("cdn", 0) + ex.fallback_tiers.get("cdn", 0)
    peer_bytes = (fetch_tiers.get("peer", 0) + ex.wire_bytes
                  + ex.fallback_tiers.get("peer", 0))
    served = peer_bytes + cdn_bytes
    ratio = 1.0 - (cdn_bytes / served) if served else 1.0
    stats = {
        "host": host_index,
        "hosts": n_hosts,
        "trace_id": trace_id,
        "plan": plan.summary(),
        "fetch": {**fetch_stats, "tiers": fetch_tiers},
        "exchange": {
            **ex.summary(),
            "budget_bytes": budget.budget_bytes,
            "inflight_peak_bytes": budget.peak_bytes,
        },
        "fallbacks": ex.fallback_units,
        "own_server": own_server,
        "peer_served_ratio": round(ratio, 4),
        "elapsed_s": round(time.monotonic() - t0, 3),
    }
    if collective_stats is not None:
        stats["collective"] = collective_stats
    if clock_offsets:
        stats["clock_offsets"] = clock_offsets
    if log is not None:
        log(f"coop round host {host_index}/{n_hosts}: {len(mine)} fetched, "
            f"{ex.units} over DCN ({ex.wire_bytes} wire bytes), "
            f"{ex.fallback_units} CDN-fallback, peer_served "
            f"{stats['peer_served_ratio']:.0%}")
    return stats


def _collective_tier(bridge, plan, host_index, n_hosts, peers, pool, budget,
                     ex, verify, deadline, priorities, entries_map, device,
                     foreign):
    """Run the collective exchange. Returns ``(stats or None, left)``: the
    units left for the point-to-point exchange by true owner, all of
    ``foreign`` when the collective cannot run (recorded, not raised: the
    point-to-point exchange needs no topology). A partner the
    remediation target condemned mid-round is not asked again: its units
    degrade through the waterfall at once."""
    from zest_tpu_torch.transfer.collective import (
        CollectiveUnavailable,
        pod_topology,
        run_collective,
        slice_topology,
    )

    health = bridge.swarm.health if bridge.swarm is not None else None
    try:
        stats, left = run_collective(
            bridge, plan, host_index, peers, pool, budget, ex, verify,
            deadline, slice_topology(n_hosts, cfg=bridge.cfg),
            priorities=priorities, entries_map=entries_map, health=health,
            pods=pod_topology(n_hosts, cfg=bridge.cfg), device=device)
    except (CollectiveUnavailable, ValueError) as exc:
        telemetry.record("collective_unavailable", error=str(exc))
        return None, foreign
    if stats.get("aborted") == "remediation" \
            and stats.get("dead_host") is not None:
        condemned = left.pop(stats["dead_host"], None)
        if condemned:
            telemetry.record("exchange_condemned", owner=stats["dead_host"],
                             units=len(condemned))
            _fallback(bridge, entries_map, condemned, ex,
                      owner=stats["dead_host"])
    return stats, left


def _collect_clock_offsets(pool, peers, out: dict,
                           timeout_s: float = _CLK_HELLO_TIMEOUT_S) -> None:
    """Per-peer hello clock offsets keyed by host index into ``out``.
    Peers the exchange never dialed (a collective talks to its log N
    partners only) get a hello dialed here, in named threads joined under
    one bounded deadline; a hello that hangs is left to its daemon
    thread, and its channel, should it complete, closes with the pool."""
    by_addr = pool.clock_offsets()
    missing = [(idx, addr) for idx, addr in sorted(peers.items())
               if addr not in by_addr]
    if missing:
        def dial(addr):
            try:
                pool.channel(*addr)  # the hello runs as the channel opens
            except (ConnectionError, TimeoutError, OSError):
                pass  # offsets are best effort

        workers = [threading.Thread(target=dial, args=(addr,),
                                    name=f"zest-coop-clk-{idx}", daemon=True)
                   for idx, addr in missing]
        for w in workers:
            w.start()
        join_deadline = time.monotonic() + timeout_s
        for w in workers:
            w.join(timeout=max(0.0, join_deadline - time.monotonic()))
        by_addr = pool.clock_offsets()
    addr_to_idx = {addr: idx for idx, addr in peers.items()}
    for addr, row in by_addr.items():
        idx = row.get("host", addr_to_idx.get(addr))
        if idx is not None:
            out[int(idx)] = {"offset_s": row["offset_s"],
                             "rtt_s": row["rtt_s"]}


def _layer_order(units, priorities):
    """``[(hash_hex, fi)]`` units in layer-priority order (unknown units
    last); unchanged without priorities."""
    if not priorities:
        return list(units)
    return sorted(units, key=unit_priority_sort_key(priorities))


def _exchange_from(bridge, entries_map, pool, peers, owner, units,
                   budget, ex: _ExchangeStats, verify, deadline) -> None:
    """Pull ``units`` from ``owner``: NOT_FOUND retries until the deadline
    (the owner may still be fetching), a dead channel or an expired
    deadline degrades the rest to the per-host CDN fallback."""
    addr = peers.get(owner)
    if addr is None:
        _fallback(bridge, entries_map, units, ex, owner=owner)
        return
    host, port = addr
    pending = list(units)
    sleep_s = _RETRY_SLEEP_S
    # A window never plans past the budget: the oversized-alone admission
    # is for single units larger than the whole budget.
    window_cap = min(_WINDOW_TARGET_BYTES, budget.budget_bytes)
    while pending:
        window, wire_est = [], 0
        while pending and len(window) < _WINDOW_MAX_UNITS:
            fi = pending[0][1]
            nbytes = fi.url_range_end - fi.url_range_start
            if window and wire_est + nbytes > window_cap:
                break
            window.append(pending.pop(0))
            wire_est += nbytes
        budget.acquire(wire_est)
        try:
            if faults.fire("peer_timeout", key=f"{host}:{port}"):
                raise TimeoutError(f"injected peer_timeout for {host}:{port}")
            replies = pool.request_many(
                host, port,
                [(hashing.hex_to_hash(hh), fi.range.start, fi.range.end)
                 for hh, fi in window],
                timeout=max(1.0, deadline - time.monotonic()),
                tag=pool.window_tag())
        except (ConnectionError, TimeoutError, OSError):
            budget.release(wire_est)
            with ex.lock:
                ex.dead_hosts.add(owner)
            _fallback(bridge, entries_map, window + pending, ex, owner=owner)
            return
        missing = []
        try:
            for (hh, fi), reply in zip(window, replies):
                admitted, wire, unpacked = _admit(bridge, entries_map, hh,
                                                  fi, reply, verify)
                if admitted:
                    bridge.stats.record("peer", wire)
                    ex.book_exchange((hh, fi.range.start), wire, unpacked)
                elif isinstance(reply, DcnResponse):
                    # Bad bytes from a live owner: the same bytes would
                    # come back, so do not retry; the CDN heals the key.
                    with ex.lock:
                        ex.verify_rejected += 1
                    telemetry.record("verify_rejected", unit=hh[:16],
                                     owner=owner)
                    _fallback(bridge, entries_map, [(hh, fi)], ex,
                              owner=owner)
                else:
                    missing.append((hh, fi))  # NOT_FOUND: owner behind
        finally:
            budget.release(wire_est)
        if missing:
            if time.monotonic() + sleep_s > deadline:
                _fallback(bridge, entries_map, missing + pending, ex,
                          owner=owner)
                return
            with ex.lock:
                ex.retries += 1
            time.sleep(sleep_s)
            sleep_s = min(sleep_s * 2, _RETRY_SLEEP_CAP_S)
            pending = missing + pending


def _admit(bridge, entries_map, hh, fi, reply, verify):
    """Gate one exchange reply into the cache: the right coordinate
    frame, a structural cover, and — when the evidence proves the blob is
    the whole xorb — a content verification on the device BEFORE the cache
    write. A partial-range blob keeps the extraction-time trust model, as
    on every other tier. Returns ``(admitted, wire_bytes,
    unpacked_bytes)``."""
    if not isinstance(reply, DcnResponse):
        return False, 0, 0
    if reply.chunk_offset > fi.range.start:
        return False, 0, 0
    if not _blob_covers(reply.data, fi.range.end - reply.chunk_offset):
        return False, 0, 0
    if bridge.whole_xorb_provable(entries_map.get(hh, []),
                                  reply.chunk_offset):
        if not verify(hh, reply.data):
            return False, 0, 0
    _cache_unit(bridge, entries_map, hh, fi, reply.chunk_offset, reply.data)
    return True, len(reply.data), _unpacked_bytes(reply.data)


def _fallback(bridge, entries_map, units, ex: _ExchangeStats,
              owner=None) -> None:
    """Per-host fallback for units the exchange could not deliver,
    through the whole waterfall; a unit whose fetch fails too is left to
    the landing's per-term waterfall."""
    for hh, fi in units:
        if _already_cached(bridge, hh, fi):
            continue
        try:
            data, source = bridge.fetch_unit_tiered(hh, fi)
        except FETCH_ERRORS:
            continue
        _cache_unit(bridge, entries_map, hh, fi, fi.range.start, data)
        ex.book_fallback((hh, fi.range.start), source, len(data))
        telemetry.record("cdn_fallback", unit=hh[:16], owner=owner,
                         tier=source, bytes=len(data))
