"""Per-peer health: latency EWMA, strike circuit breaker, quarantine.

The port's copy of ``zest_tpu/p2p/health.py``, with the same
process-registry counters (``zest_peer_strikes_total``,
``zest_peer_quarantines_total``) and flight-recorder events, and with
one deliberate difference: a transport success clears transport strikes
only. A corruption strike stands until it trips the breaker, because the
swarm records a delivery's success before the bridge verifies its bytes:
in the JAX package that success resets the count, so a peer whose every
response is corrupt never reaches ``strikes_to_quarantine``.

The reference's swarm walks candidates in a fixed order with no memory
of who failed last time (swarm.zig:398-437) — one dead direct peer
costs a full connect timeout on *every* xorb. This registry is the
memory: each peer accumulates a latency EWMA on success and strikes on
failure (connect failure, IO timeout, and corrupt-chunk attribution
from the bridge all count); ``strikes_to_quarantine`` strikes trip a
circuit breaker that removes the peer from candidate ordering for a
quarantine window. Windows double on consecutive quarantines (capped)
and decay again on good behavior — a flapping peer is re-admitted on
probation (one strike from re-quarantine), not with a clean slate.

Ordering: healthy peers sort by observed EWMA round-trip (fast first);
peers with no history slot at a neutral prior so known-fast peers beat
strangers and strangers beat known-slow ones. The sort is stable, so
ties preserve the caller's priority (direct peers before discovered).

The EWMAs also drive adaptive timeouts: connect/IO deadlines start at a
tight default and track a multiple of the observed latency, clamped to
a floor and the legacy ceiling — a peer that answers in 30 ms gets a
sub-second IO timeout instead of the reference's fixed 60 s stall.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from zest_tpu_torch import telemetry

Addr = tuple[str, int]

# Strikes and breaker trips outlive the swarm session that counted them:
# "which host keeps quarantining peers" is a fleet question.
_M_STRIKES = telemetry.counter(
    "zest_peer_strikes_total", "Peer health strikes, by failure kind",
    ("kind",))
_M_QUARANTINES = telemetry.counter(
    "zest_peer_quarantines_total", "Peer circuit-breaker trips")

DEFAULT_STRIKES_TO_QUARANTINE = 3
DEFAULT_QUARANTINE_BASE_S = 15.0
QUARANTINE_CAP_S = 240.0
EWMA_ALPHA = 0.3
# Neutral prior RTT for never-observed peers (seconds): sorts strangers
# between known-fast and known-slow.
PRIOR_RTT_S = 0.25
# Reciprocity memory (seconds): the e-folding time of the decayed
# served-bytes counter behind the seeding tier's unchoke ranking — "the
# K peers that served us the most bytes RECENTLY" means within the last
# minute or two, not all-time (an all-time sum would let one old bulk
# transfer pin an upload slot forever).
RECIPROCITY_TAU_S = 120.0


@dataclass
class PeerHealth:
    ewma_rtt_s: float | None = None
    ewma_connect_s: float | None = None
    strikes: int = 0
    quarantines: int = 0          # consecutive-quarantine depth (backoff)
    quarantined_until: float = 0.0
    in_quarantine: bool = False   # set on trip, cleared at probation
    successes: int = 0
    failures: int = 0
    corruptions: int = 0
    # Corruption strikes not yet discharged by a breaker trip: a
    # transport success resets ``strikes`` to this, not to 0.
    corrupt_strikes: int = 0
    # Per-kind strike breakdown: "error"/"corrupt" from the fetch side,
    # "seed_stall" for a peer that timed out while SERVING us after a
    # good lease (recorded by transfer.swarm), "stalled_reader" for a
    # leecher that stopped draining OUR upload (recorded by the
    # seeding server) — the two sides of a stall stay distinct.
    strike_kinds: dict = field(default_factory=dict)
    # Exponentially-decayed bytes this peer served US (reciprocity).
    recent_bytes: float = 0.0
    recent_bytes_t: float = 0.0


def _ewma(prev: float | None, sample: float) -> float:
    if prev is None:
        return sample
    return (1.0 - EWMA_ALPHA) * prev + EWMA_ALPHA * sample


class HealthRegistry:
    """Thread-safe per-address health book, shared by one swarm."""

    def __init__(
        self,
        strikes_to_quarantine: int | None = None,
        quarantine_base_s: float | None = None,
        time_fn=time.monotonic,
    ):
        if strikes_to_quarantine is None:
            strikes_to_quarantine = int(
                os.environ.get("ZEST_PEER_STRIKES",
                               DEFAULT_STRIKES_TO_QUARANTINE))
        if quarantine_base_s is None:
            quarantine_base_s = float(
                os.environ.get("ZEST_PEER_QUARANTINE_S",
                               DEFAULT_QUARANTINE_BASE_S))
        self.strikes_to_quarantine = max(1, strikes_to_quarantine)
        self.quarantine_base_s = quarantine_base_s
        self._time = time_fn
        self._peers: dict[Addr, PeerHealth] = {}
        self._lock = threading.Lock()
        self.quarantine_events = 0
        self.demotions = 0
        self._listeners: list = []

    def now(self) -> float:
        """This registry's clock (``time_fn``) — shared with the
        swarm's re-announce dedup window so simulated-time tests drive
        both from one fake clock."""
        return self._time()

    def _peer_locked(self, addr: Addr) -> PeerHealth:
        peer = self._peers.get(addr)
        if peer is None:
            peer = self._peers[addr] = PeerHealth()
        return peer

    # ── Transition listeners ──

    def subscribe(self, cb) -> None:
        """``cb(event, addr)`` fires on circuit-breaker transitions —
        ``"quarantined"`` when a strike trips the breaker and
        ``"probation"`` when a quarantine window is first OBSERVED
        expired (re-admit). The swarm's quarantine-aware announce rides
        this: both transitions change which peers this host effectively
        offers/uses, so the tracker's view should be refreshed.
        Callbacks run outside the registry lock; exceptions are the
        caller's problem and must not be raised (wrap if unsure)."""
        self._listeners.append(cb)

    def unsubscribe(self, cb) -> None:
        """Remove a listener registered with :meth:`subscribe`. A
        shared registry outlives the swarms that subscribe to it
        (cmd_serve's daemon registry, benches) — a closed swarm's
        callback must not keep firing zombie re-announces or pin the
        swarm in memory. Unknown callbacks are a no-op."""
        try:
            self._listeners.remove(cb)
        except ValueError:
            pass

    def _notify(self, events: list[tuple[str, Addr]]) -> None:
        for event, addr in events:
            for cb in self._listeners:
                try:
                    cb(event, addr)
                except Exception:  # noqa: BLE001 - observer must not break
                    pass           # the health hot path

    def _observe_expiry_locked(self, p: PeerHealth, now: float,
                               addr: Addr,
                               events: list[tuple[str, Addr]]) -> None:
        """First query to see an expired window flips the peer to
        probation and queues the transition event."""
        if p.in_quarantine and now >= p.quarantined_until:
            p.in_quarantine = False
            events.append(("probation", addr))

    # ── Recording ──

    def record_success(self, addr: Addr, rtt_s: float | None = None,
                       connect_s: float | None = None,
                       nbytes: int | None = None) -> None:
        with self._lock:
            p = self._peer_locked(addr)
            p.successes += 1
            p.strikes = p.corrupt_strikes
            # Good behavior decays the quarantine backoff depth, so a
            # recovered peer that trips again serves a short window, not
            # the doubled one its bad week earned.
            if p.quarantines:
                p.quarantines -= 1
            if rtt_s is not None:
                p.ewma_rtt_s = _ewma(p.ewma_rtt_s, rtt_s)
            if connect_s is not None:
                p.ewma_connect_s = _ewma(p.ewma_connect_s, connect_s)
            if nbytes:
                now = self._time()
                p.recent_bytes = self._decayed_locked(p, now) + nbytes
                p.recent_bytes_t = now

    @staticmethod
    def _decayed_locked(p: PeerHealth, now: float) -> float:
        if p.recent_bytes <= 0.0:
            return 0.0
        dt = max(0.0, now - p.recent_bytes_t)
        return p.recent_bytes * math.exp(-dt / RECIPROCITY_TAU_S)

    def record_failure(self, addr: Addr, kind: str = "error") -> bool:
        """One strike; True when this strike tripped the breaker."""
        peer = f"{addr[0]}:{addr[1]}"
        events: list[tuple[str, Addr]] = []
        with self._lock:
            p = self._peer_locked(addr)
            p.failures += 1
            if kind == "corrupt":
                p.corruptions += 1
                p.corrupt_strikes += 1
            p.strike_kinds[kind] = p.strike_kinds.get(kind, 0) + 1
            p.strikes += 1
            _M_STRIKES.inc(kind=kind)
            if p.strikes < self.strikes_to_quarantine:
                tripped, window = False, 0.0
            else:
                p.quarantines += 1
                window = min(
                    QUARANTINE_CAP_S,
                    self.quarantine_base_s * (2.0 ** (p.quarantines - 1)),
                )
                p.quarantined_until = self._time() + window
                p.in_quarantine = True
                # Probation: on re-admit one more strike re-quarantines
                # (with the doubled window); a success clears it.
                p.strikes = self.strikes_to_quarantine - 1
                p.corrupt_strikes = 0
                self.quarantine_events += 1
                _M_QUARANTINES.inc()
                tripped = True
                events.append(("quarantined", addr))
        # The breaker's decisions in event order, outside the lock.
        telemetry.record("peer_strike", peer=peer, strike=kind)
        if tripped:
            telemetry.record("peer_quarantined", peer=peer,
                             window_s=round(window, 2))
        self._notify(events)
        return tripped

    def demote(self, addr: Addr, window_s: float | None = None) -> float:
        """Proactive remediation demotion: pull the peer out
        of candidate ordering for one base quarantine window so the
        swarm re-announces and traffic shifts — WITHOUT a strike.

        The failure-semantics rule this encodes: a remediation may
        never *create* a strike against a healthy peer. Strikes (and
        the doubling-window backoff depth they feed) stay reserved for
        observed failures recorded by the subsystems that witnessed
        them; a demotion leaves ``strikes``/``strike_kinds``/
        ``quarantines`` untouched, so the peer re-enters through the
        existing probation path with exactly the record its real
        behavior earned. Returns the window applied."""
        window = (self.quarantine_base_s if window_s is None
                  else max(0.0, window_s))
        with self._lock:
            p = self._peer_locked(addr)
            p.quarantined_until = max(p.quarantined_until,
                                      self._time() + window)
            p.in_quarantine = True
            self.demotions += 1
        telemetry.record("peer_demoted", peer=f"{addr[0]}:{addr[1]}",
                         window_s=round(window, 2))
        # Same transition surface as the breaker: the swarm's
        # re-announce listener treats any membership-changing event
        # alike, and probation fires on expiry as usual.
        self._notify([("demoted", addr)])
        return window

    # ── Queries ──

    def is_quarantined(self, addr: Addr) -> bool:
        now = self._time()
        events: list[tuple[str, Addr]] = []
        with self._lock:
            p = self._peers.get(addr)
            if p is None:
                return False
            self._observe_expiry_locked(p, now, addr, events)
            quarantined = now < p.quarantined_until
        self._notify(events)
        return quarantined

    def served_bytes(self, addr: Addr) -> float:
        """Decayed bytes this peer served us recently — the seeding
        tier's reciprocity score (``transfer.server`` ranks unchoke
        candidates by it)."""
        now = self._time()
        with self._lock:
            p = self._peers.get(addr)
            return 0.0 if p is None else self._decayed_locked(p, now)

    def _score_locked(self, addr: Addr) -> float:
        p = self._peers.get(addr)
        if p is None:
            return PRIOR_RTT_S
        rtt = p.ewma_rtt_s if p.ewma_rtt_s is not None else PRIOR_RTT_S
        # Each outstanding strike pushes the peer behind clean ones of
        # equal speed without hiding it entirely.
        return rtt + 0.5 * p.strikes

    def partition(self, addrs: list[Addr]) -> tuple[list[Addr], list[Addr]]:
        """(healthy ordered best-first, currently-quarantined). Stable
        sort: equal scores keep the caller's priority order."""
        now = self._time()
        events: list[tuple[str, Addr]] = []
        with self._lock:
            healthy, shunned = [], []
            for addr in addrs:
                p = self._peers.get(addr)
                if p is not None:
                    self._observe_expiry_locked(p, now, addr, events)
                if p is not None and now < p.quarantined_until:
                    shunned.append(addr)
                else:
                    healthy.append(addr)
            healthy.sort(key=self._score_locked)
        self._notify(events)
        return healthy, shunned

    # ── Adaptive timeouts ──

    def connect_timeout(self, addr: Addr, default_s: float = 3.0,
                        floor_s: float = 0.75, ceiling_s: float = 5.0,
                        mult: float = 4.0) -> float:
        with self._lock:
            p = self._peers.get(addr)
            observed = p.ewma_connect_s if p is not None else None
        if observed is None:
            return min(default_s, ceiling_s)
        return min(max(mult * observed, floor_s), ceiling_s)

    def io_timeout(self, addr: Addr, default_s: float = 20.0,
                   floor_s: float = 2.0, ceiling_s: float = 60.0,
                   mult: float = 8.0) -> float:
        with self._lock:
            p = self._peers.get(addr)
            observed = p.ewma_rtt_s if p is not None else None
        if observed is None:
            return min(default_s, ceiling_s)
        return min(max(mult * observed, floor_s), ceiling_s)

    # ── Telemetry ──

    def summary(self) -> dict:
        now = self._time()
        with self._lock:
            return {
                "tracked": len(self._peers),
                "quarantined_now": sum(
                    1 for p in self._peers.values()
                    if now < p.quarantined_until
                ),
                "quarantine_events": self.quarantine_events,
                "demotions": self.demotions,
                "corrupt_strikes": sum(
                    p.corruptions for p in self._peers.values()
                ),
            }

    def detail(self) -> list[dict]:
        """Per-peer health rows for ``/v1/status`` / ``zest status`` —
        quarantine decisions used to be invisible outside the process;
        this is the operator's view of why a peer is being avoided.
        ``quarantined_for_s`` is the remaining window (0 = not
        quarantined), reported relative so the payload is meaningful to
        a reader without this process' monotonic clock."""
        now = self._time()
        with self._lock:
            rows = []
            for (host, port), p in sorted(self._peers.items()):
                rows.append({
                    "peer": f"{host}:{port}",
                    "ewma_rtt_ms": (None if p.ewma_rtt_s is None
                                    else round(p.ewma_rtt_s * 1e3, 2)),
                    "ewma_connect_ms": (
                        None if p.ewma_connect_s is None
                        else round(p.ewma_connect_s * 1e3, 2)),
                    "strikes": p.strikes,
                    # Per-kind attribution: "seed_stall" = timed out
                    # while serving OUR fetch; "stalled_reader" =
                    # stopped draining OUR upload — stalls stay
                    # attributed to the right side.
                    "strike_kinds": dict(sorted(p.strike_kinds.items())),
                    "successes": p.successes,
                    "failures": p.failures,
                    "corruptions": p.corruptions,
                    "quarantines": p.quarantines,
                    "quarantined_for_s": round(
                        max(0.0, p.quarantined_until - now), 2),
                    "served_bytes_recent": int(
                        self._decayed_locked(p, now)),
                })
            return rows


class ContentProvenance:
    """Bounded content → source-peer book for UNPROVEN cache entries.

    The bridge merkle-verifies every peer-served blob that is provably
    the whole xorb; blobs it can only check structurally (partial
    ranges, evidence-incomplete pulls) are cached under the documented
    extraction-time trust model. This book remembers WHICH peer those
    unproven bytes came from, so the seeding server can refuse to
    re-serve content whose source has since been quarantined for
    corruption — a loud NOT_AVAILABLE instead of laundering suspect
    bytes into the swarm. Entries clear when the key is later proven
    (full merkle verification) or overwritten by a CDN refetch.

    One key can carry SEVERAL sources: a xorb's ranges may be cached
    from different peers over time, and a later (even verified) blob
    cached under a partial key does not displace an earlier peer's
    bytes — so recording appends rather than overwrites, and the
    refusal check is "is ANY recorded source quarantined". LRU-bounded:
    provenance is a safety hint, not an audit log — the oldest
    suspicion ages out first."""

    # Sources kept per key: beyond this many distinct unproven
    # contributors the oldest attribution rotates out.
    PER_KEY_CAP = 8

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, capacity)
        self._book: OrderedDict[str, tuple[Addr, ...]] = OrderedDict()
        self._lock = threading.Lock()

    def record(self, hash_hex: str, addr: Addr | None) -> None:
        if addr is None:
            return
        with self._lock:
            prior = self._book.pop(hash_hex, ())
            if addr in prior:
                srcs = prior
            else:
                srcs = (prior + (addr,))[-self.PER_KEY_CAP:]
            self._book[hash_hex] = srcs
            while len(self._book) > self.capacity:
                self._book.popitem(last=False)

    def clear(self, hash_hex: str) -> None:
        with self._lock:
            self._book.pop(hash_hex, None)

    def sources(self, hash_hex: str) -> tuple[Addr, ...]:
        with self._lock:
            return self._book.get(hash_hex, ())

    def source(self, hash_hex: str) -> Addr | None:
        """The most recent recorded source (None = no suspicion)."""
        srcs = self.sources(hash_hex)
        return srcs[-1] if srcs else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._book)

    def reset(self) -> None:
        with self._lock:
            self._book.clear()


# Process-global book: the bridge records into it at cache-admission
# time and the seeding server (same process — "the package IS the
# seeder") consults it per chunk request.
PROVENANCE = ContentProvenance()
