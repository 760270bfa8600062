"""The multi-tenant pull service: shared, globally budgeted pools.

The counterpart of ``zest_tpu/transfer/tenancy.py``. Without it, two
concurrent pulls in one process are fully independent ``pull_model``
calls: the same xorb fetched twice, no shared byte or disk budget, no
eviction when the xorb cache fills, and no way to cancel a tenant
mid-pull. This module is what every pull session runs over:

- **Singleflight fetch dedupe** (:class:`Singleflight`): a process-wide
  in-flight table keyed by ``(xorb hash, chunk range)``. The first
  session to miss the cache leads the fetch; every other session waits
  and then reads the winner's cache entry. A failed flight hands the
  leader's typed error to every waiter (struck once, by the leader's own
  waterfall); a *cancelled* leader hands leadership to a live waiter.
- **Admission control** (:class:`AdmissionController`): one
  ``ZEST_TENANT_*`` budget set — concurrent pulls, aggregate in-flight
  file bytes (one :class:`ByteBudget` every session's file pipeline
  draws from), disk watermarks — admitting sessions through a fair
  per-tenant queue (deficit round-robin). Queued sessions show phase
  ``queued`` in ``/v1/pulls``; a full queue REJECTS with a typed
  retry-after (:class:`AdmissionRejected` → HTTP 429).
- **Xorb-cache eviction** (:class:`CacheEvictor`): LRU over cache entries
  with pins (:class:`PinBook`) — entries an admitted session resolved,
  or that a tree resident on the card will diff against in its next
  hot-swap, are never evicted. Run by the disk high watermark at
  admission and by ENOSPC (``storage.set_disk_full_hook``). An entry
  evicted mid-pull is a cache miss and a refetch, never a corrupt read.
- **Cancellation** (:class:`CancelToken`): an abort (client disconnect,
  ``DELETE /v1/pulls/<id>``) releases the session's slot and byte
  shares, unpins its entries, and leaves shared flights unharmed.

``ZEST_TENANCY=0`` turns all of it off: per-pull byte budgets, no
flights table, no queue, no eviction. Process state lives behind
:func:`state` (built from the first caller's Config); :func:`reset`
rebuilds it for tests.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from zest_tpu_torch import storage, telemetry

# The timeline gauges the process state registers (and reset() drops).
TIMELINE_PROBES = ("tenancy.queue_depth", "tenancy.active_pulls",
                   "tenancy.admitted_total", "tenancy.inflight_fetches")

_M_DEDUPE_HITS = telemetry.counter(
    "zest_inflight_dedupe_hits_total",
    "Fetches served from another session's in-flight fetch "
    "(the waiter read the winner's cache entry)")
_M_FLIGHTS = telemetry.counter(
    "zest_inflight_flights_total",
    "Singleflight fetches led (one per deduped network fetch)")
_M_REJECTS = telemetry.counter(
    "zest_admission_rejects_total",
    "Pull sessions rejected because the admission queue was full")
_M_EVICTIONS = telemetry.counter(
    "zest_cache_evictions_total",
    "Xorb-cache entries evicted under disk pressure, by trigger",
    ("reason",))
_M_QUEUE_DEPTH = telemetry.gauge(
    "zest_tenant_queue_depth",
    "Pull sessions currently parked in the admission queue")
_M_ADMITTED = telemetry.gauge(
    "zest_tenant_active_pulls",
    "Pull sessions currently holding an admission slot")
# How singleflight resolved each participant (leader fetched, waiter
# read the winner's entry, handoff = a waiter inherited a cancelled
# leader's fetch), and how long admission made sessions wait — the
# queue-health signal the queue-depth gauge alone can't give (depth 3
# for 10 ms and depth 3 for 10 min look identical on a gauge).
_M_SINGLEFLIGHT = telemetry.counter(
    "zest_singleflight_total",
    "Singleflight participations by outcome",
    ("outcome",))
_M_ADMISSION_WAIT = telemetry.histogram(
    "zest_admission_wait_seconds",
    "Wall seconds a pull session waited for an admission slot",
    buckets=(0.001, 0.01, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
             300.0))


class PullCancelled(RuntimeError):
    """A session abort: the pull stops at the next stage boundary and
    finishes with the ``cancelled`` terminal status (distinct from
    ``error`` — nothing went wrong, somebody asked it to stop)."""


class AdmissionRejected(RuntimeError):
    """Typed backpressure: the admission queue is full. Carries
    ``retry_after_s`` so the HTTP layer can answer 429 + Retry-After
    instead of parking the request unboundedly."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class CancelToken:
    """Cooperative cancellation for one pull session. ``cancel()`` is
    idempotent and safe from any thread (HTTP handler, SSE generator
    finalizer, chaos harness); the pull checks at stage boundaries via
    :meth:`check`, which raises :class:`PullCancelled`. A stage that
    blocks (the streaming landing) ties itself to the token once with
    :meth:`on_cancel`."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._callbacks: list = []
        self.reason: str | None = None

    def cancel(self, reason: str = "cancelled") -> None:
        with self._lock:
            if self._event.is_set():
                return
            self.reason = reason
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn()

    def on_cancel(self, fn):
        """Run ``fn()`` once, in the cancelling thread, when the token
        fires (at once if it has). Returns a function that takes ``fn``
        back."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return lambda: self._forget(fn)
        fn()
        return lambda: None

    def _forget(self, fn) -> None:
        with self._lock:
            if fn in self._callbacks:
                self._callbacks.remove(fn)

    @property
    def fired(self) -> bool:
        return self._event.is_set()

    def check(self) -> None:
        if self._event.is_set():
            raise PullCancelled(self.reason or "cancelled")


class ByteBudget:
    """Counting byte-semaphore bounding in-flight reassembly bytes.

    ``acquire(n)`` blocks while admitting ``n`` more bytes would push the
    in-flight total past the budget — except when nothing is in flight,
    where an oversized item (n > budget) is admitted alone rather than
    deadlocking (the classic bounded-buffer starvation case: a file
    larger than the whole budget must still be pullable, serially).
    ``peak_bytes`` records the high-watermark for the bench/tests to
    assert the bound held.

    One per pull's file pipeline (``transfer.pull._FilePipeline``) and
    per cooperative exchange; with tenancy on, ONE more instance is
    shared by every admitted session — the "aggregate in-flight bytes"
    budget — which is why it lives here (``coop`` and ``pull``
    re-export it)."""

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
        """Non-blocking :meth:`acquire` (same oversized-alone admission):
        the async materialization handoff runs in the landing's decode
        thread, where a blocked acquire would put file writes right back
        on the time-to-HBM critical path — a full budget means *decline*
        (the file falls to the post-commit cache lane), never wait."""
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


class StackedBudget:
    """A session-local :class:`ByteBudget` stacked under the shared
    aggregate one: every acquire must clear BOTH bounds — the per-pull
    ``ZEST_PULL_INFLIGHT`` contract keeps holding (tests pin its peak),
    and the process-wide ``ZEST_TENANT_INFLIGHT`` cap holds across
    every admitted session. Acquire order is local-then-shared,
    release is shared-then-local, everywhere — a session blocked on
    the shared budget holds only its own local bytes, so progress
    needs nothing from it. Reported bounds/peaks are the LOCAL ones
    (the shared peak lives in the tenancy summary)."""

    def __init__(self, local: ByteBudget, shared: ByteBudget):
        self.local = local
        self.shared = shared

    @property
    def budget_bytes(self) -> int:
        return self.local.budget_bytes

    @property
    def peak_bytes(self) -> int:
        return self.local.peak_bytes

    def _shared_take(self, nbytes: int) -> int:
        """Bytes charged to the shared tier. A single item LARGER than
        the whole aggregate budget bypasses it (charged 0): the
        shared oversized-alone rule would need process-wide inflight
        to hit zero, which concurrent tenants' steady acquires never
        let happen — the pull would hold its admission slot forever
        without progressing. Such an item stays bounded by its own
        per-pull budget (whose oversized-alone rule is per-session,
        so it CAN drain) and by the admission slot count. The
        predicate is a pure function of nbytes, so acquire and
        release always agree."""
        return 0 if nbytes > self.shared.budget_bytes else nbytes

    def acquire(self, nbytes: int) -> None:
        self.local.acquire(nbytes)
        shared = self._shared_take(nbytes)
        if shared:
            self.shared.acquire(shared)

    def try_acquire(self, nbytes: int) -> bool:
        if not self.local.try_acquire(nbytes):
            return False
        shared = self._shared_take(nbytes)
        if shared and not self.shared.try_acquire(shared):
            self.local.release(nbytes)
            return False
        return True

    def release(self, nbytes: int) -> None:
        shared = self._shared_take(nbytes)
        if shared:
            self.shared.release(shared)
        self.local.release(nbytes)


# ── Singleflight fetch dedupe ──


class _Flight:
    """One in-flight fetch: a leader, subscribed waiters, and a
    terminal state. Lives in the table only while running; resolve /
    fail / dissolve remove it, so a later miss starts a fresh flight."""

    __slots__ = ("key", "state", "error", "waiters", "promotions")

    def __init__(self, key):
        self.key = key
        self.state = "running"   # running | done | failed | gone
        self.error: BaseException | None = None
        self.waiters = 0
        self.promotions = 0      # pending leadership offers


class Singleflight:
    """Process-wide in-flight fetch table. Protocol (see
    ``XetBridge._deduped`` for the one real caller):

    - ``join(key)`` → ``("lead", flight)`` for the first caller (fetch,
      then ``resolve``/``fail``/``abdicate``), or ``("wait", flight)``.
    - waiters call ``wait(flight, cancel)`` → ``"done"`` (read the
      winner's cache entry), ``"lead"`` (the leader abdicated — this
      waiter now owns the fetch), ``"failed"`` (raise ``flight.error``,
      the leader's typed error, struck exactly once), or
      ``"cancelled"`` (this waiter's own session aborted — it detaches
      without touching the flight)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._flights: dict = {}
        self.led = 0
        self.hits = 0
        # Outcome book: leader / waiter / handoff counts, mirrored into
        # zest_singleflight_total{outcome}.
        self.outcomes = {"leader": 0, "waiter": 0, "handoff": 0}

    def _outcome(self, outcome: str) -> None:
        # Callers hold self._cv.
        self.outcomes[outcome] += 1
        _M_SINGLEFLIGHT.inc(outcome=outcome)

    def join(self, key) -> tuple[str, _Flight]:
        with self._cv:
            flight = self._flights.get(key)
            if flight is None:
                flight = self._flights[key] = _Flight(key)
                self.led += 1
                _M_FLIGHTS.inc()
                self._outcome("leader")
                return "lead", flight
            return "wait", flight

    def wait(self, flight: _Flight, cancel: CancelToken | None = None,
             poll_s: float = 0.05) -> str:
        with self._cv:
            flight.waiters += 1
            try:
                while True:
                    if flight.promotions > 0:
                        flight.promotions -= 1
                        self.led += 1
                        _M_FLIGHTS.inc()
                        self._outcome("handoff")
                        return "lead"
                    if flight.state == "done":
                        self._outcome("waiter")
                        return "done"
                    if flight.state == "failed":
                        self._outcome("waiter")
                        return "failed"
                    if flight.state == "gone":
                        # Leader abdicated with no waiter counted yet
                        # (we raced the dissolve): fetch ourselves.
                        self._outcome("handoff")
                        return "lead"
                    if cancel is not None and cancel.fired:
                        return "cancelled"
                    # Timed wait: a lost wakeup (or a cancel fired with
                    # no notify) must never park a waiter forever.
                    self._cv.wait(poll_s)
            finally:
                flight.waiters -= 1

    def note_hit(self) -> None:
        with self._cv:
            self.hits += 1
        _M_DEDUPE_HITS.inc()

    def resolve(self, flight: _Flight) -> None:
        with self._cv:
            flight.state = "done"
            self._flights.pop(flight.key, None)
            self._cv.notify_all()

    def fail(self, flight: _Flight, error: BaseException) -> None:
        with self._cv:
            flight.state = "failed"
            flight.error = error
            self._flights.pop(flight.key, None)
            self._cv.notify_all()

    def abdicate(self, flight: _Flight) -> None:
        """The leader's session was cancelled mid-flight: hand
        leadership to a live waiter (one pending promotion) instead of
        failing the flight; with no waiters the flight dissolves and
        the next miss starts fresh."""
        with self._cv:
            if flight.waiters > flight.promotions:
                flight.promotions += 1
            else:
                flight.state = "gone"
                self._flights.pop(flight.key, None)
            self._cv.notify_all()

    def in_flight(self) -> int:
        with self._cv:
            return len(self._flights)

    def summary(self) -> dict:
        with self._cv:
            return {"in_flight": len(self._flights),
                    "led": self.led, "dedupe_hits": self.hits,
                    "outcomes": dict(self.outcomes)}


# ── Pinning + eviction ──


class PinBook:
    """Refcounted pins on xorb hashes. Owners are opaque strings — a
    pull session pins the hashes of every reconstruction it resolves
    (owner ``sess:<id>``, released when the pull ends), and a landed
    HBM tree pins its manifest's hashes (owner ``tree:<repo>``,
    replaced when a newer revision of the same repo lands) so the
    delta/hot-swap evidence a live mesh depends on stays readable."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owners: dict[str, set[str]] = {}
        self._counts: dict[str, int] = {}

    def pin(self, owner: str, hashes) -> None:
        with self._lock:
            held = self._owners.setdefault(owner, set())
            for h in hashes:
                if h not in held:
                    held.add(h)
                    self._counts[h] = self._counts.get(h, 0) + 1

    def replace(self, owner: str, hashes) -> None:
        """Atomically swap an owner's pin set (the tree-pin pattern)."""
        with self._lock:
            self._release_locked(owner)
            held = self._owners.setdefault(owner, set())
            for h in hashes:
                if h not in held:
                    held.add(h)
                    self._counts[h] = self._counts.get(h, 0) + 1

    def release(self, owner: str) -> bool:
        """Returns whether the owner actually held pins — the pool's
        release_tree reports a no-op release honestly."""
        with self._lock:
            held = owner in self._owners
            self._release_locked(owner)
            return held

    def _release_locked(self, owner: str) -> None:
        for h in self._owners.pop(owner, ()):
            n = self._counts.get(h, 0) - 1
            if n <= 0:
                self._counts.pop(h, None)
            else:
                self._counts[h] = n

    def pinned(self, hash_hex: str) -> bool:
        with self._lock:
            return hash_hex in self._counts

    def summary(self) -> dict:
        with self._lock:
            return {"owners": len(self._owners),
                    "pinned_hashes": len(self._counts)}


class CacheEvictor:
    """LRU eviction over the on-disk xorb cache, honoring pins.

    Usage is judged by summing entry sizes under the cache dir (not fs
    free space — deterministic for tests and benches). Above the high
    watermark, unpinned entries evict oldest-mtime-first down to the
    low watermark; pinned entries are NEVER evicted, even when that
    leaves usage above the mark (the flight recorder says so). A pull
    whose entry vanishes mid-read degrades to a refetch: every reader
    treats a missing entry as a cache miss."""

    def __init__(self, cache_dir, high_bytes: int, low_bytes: int,
                 pins: PinBook):
        self.cache_dir = cache_dir
        self.high_bytes = max(0, int(high_bytes))
        low = int(low_bytes) if low_bytes else int(self.high_bytes * 0.8)
        self.low_bytes = max(0, low)
        self.pins = pins
        self._lock = threading.Lock()
        self.evictions = 0
        self.evicted_bytes = 0
        self.pinned_survivals = 0
        # Watermark-pass throttle: usage is computed by walking every
        # cache entry (O(entries) stat calls) — at a 200 GiB cache
        # that's ~1e5 syscalls, far too much to pay on EVERY pull
        # admission. Unforced passes run at most once per interval;
        # ENOSPC and explicit (force=True) passes always run.
        self.check_interval_s = 2.0
        self._last_check = float("-inf")

    def _entries(self) -> list[tuple[float, int, object, str]]:
        """(mtime, size, path, hash_hex) per cache entry; partial
        entries (``hash.start``) pin/evict under their xorb's hash."""
        out = []
        root = self.cache_dir
        if not root.is_dir():
            return out
        for sub in root.iterdir():
            if not sub.is_dir():
                continue
            for f in sub.iterdir():
                name = f.name
                if name.startswith(".tmp-"):
                    continue
                hash_hex = name.split(".", 1)[0]
                if len(hash_hex) != 64:
                    continue
                try:
                    st = f.stat()
                except OSError:
                    continue
                out.append((st.st_mtime, st.st_size, f, hash_hex))
        return out

    def usage_bytes(self) -> int:
        return sum(size for _m, size, _p, _h in self._entries())

    def maybe_evict(self, force: bool = False) -> int:
        """Watermark trigger: evict down to the low mark when usage
        exceeds the high mark. No-op when unarmed (high == 0);
        unforced calls are rate-limited (``check_interval_s``) so the
        per-admission trigger doesn't pay the O(entries) usage walk on
        every pull."""
        if not self.high_bytes:
            return 0
        if not force:
            now = time.monotonic()
            with self._lock:
                if now - self._last_check < self.check_interval_s:
                    return 0
                self._last_check = now
        return self._evict(self.low_bytes, reason="watermark",
                           only_if_above=self.high_bytes)

    def on_enospc(self) -> bool:
        """ENOSPC trigger (the :func:`storage.set_disk_full_hook`
        callable): the filesystem itself said we are out of space, so
        the watermark arithmetic is moot — free down to HALF the
        current usage (or the low mark, whichever is lower): bounded,
        guaranteed progress even when usage sits below the armed
        watermarks (something else filled the disk). True when
        anything was freed."""
        return self._evict(None, reason="enospc") > 0

    def _evict(self, target_bytes: int | None, reason: str,
               only_if_above: int | None = None) -> int:
        with self._lock:
            entries = self._entries()
            usage = sum(size for _m, size, _p, _h in entries)
            if only_if_above is not None and usage <= only_if_above:
                return 0
            if target_bytes is None:  # the ENOSPC half-usage rule
                target_bytes = min(self.low_bytes or usage // 2,
                                   usage // 2)
            freed = 0
            pinned_skips = 0
            pinned_skip_bytes = 0
            for mtime, size, path, hash_hex in sorted(entries):
                if usage - freed <= target_bytes:
                    break
                if self.pins.pinned(hash_hex):
                    self.pinned_survivals += 1
                    pinned_skips += 1
                    pinned_skip_bytes += size
                    continue
                try:
                    os.unlink(path)
                except OSError:
                    continue
                freed += size
                self.evictions += 1
                self.evicted_bytes += size
                _M_EVICTIONS.inc(reason=reason)
                telemetry.record("cache_evict", xorb=hash_hex,
                                 bytes=size, reason=reason)
            if pinned_skips:
                # One event per PASS, not per entry: a pressured cache
                # full of pinned trees would otherwise flood the ring
                # with thousands of identical skip events.
                telemetry.record("cache_evict_pinned_skip",
                                 reason=reason, entries=pinned_skips,
                                 bytes=pinned_skip_bytes)
            if freed and usage - freed > target_bytes:
                telemetry.record("cache_evict_short", reason=reason,
                                 remaining=usage - freed,
                                 target=target_bytes)
            return freed

    def summary(self) -> dict:
        return {"evictions": self.evictions,
                "evicted_bytes": self.evicted_bytes,
                "pinned_survivals": self.pinned_survivals,
                "high_bytes": self.high_bytes,
                "low_bytes": self.low_bytes}


# ── Admission control ──


class _Waiter:
    __slots__ = ("tenant", "weight", "admitted", "session", "shed")

    def __init__(self, tenant: str, weight: float, session=None):
        self.tenant = tenant
        self.weight = weight
        self.admitted = False
        self.session = session
        # Set to a retry-after estimate when a load-shed evicts this
        # waiter from the queue: its acquire() raises AdmissionRejected
        # instead of parking on.
        self.shed: float | None = None


class AdmissionController:
    """Global concurrent-pull admission with per-tenant fairness.

    ``max_pulls`` sessions hold slots at once; excess sessions park in
    per-tenant FIFO queues drained by deficit round-robin (each visit
    tops the tenant's deficit by ``quantum``; a session admits when
    the deficit covers its weight — with unit weights this is strict
    tenant round-robin, and a tenant queueing 50 sessions still yields
    to every other tenant's next session). ``max_queue`` bounds TOTAL
    queued sessions: beyond it, :meth:`acquire` raises
    :class:`AdmissionRejected` immediately — typed backpressure, not
    unbounded parking."""

    def __init__(self, max_pulls: int, max_queue: int,
                 quantum: float = 1.0):
        self.max_pulls = max(1, int(max_pulls))
        self.max_queue = max(0, int(max_queue))
        self.quantum = quantum
        self._cv = threading.Condition()
        self._active = 0
        self._queues: dict[str, deque] = {}
        self._order: list[str] = []
        self._deficit: dict[str, float] = {}
        self._rr = 0
        self._queued = 0
        self.admitted_total = 0
        self.rejected_total = 0
        self.shed_total = 0
        # Load-shed mode: while True, sessions that would queue are
        # rejected with 429 + Retry-After instead of parked — the
        # "shed" remediation target flips this on and back off.
        # Admitted sessions are never touched.
        self._shedding = False
        # Recent admission walls, for the 429 retry-after estimate.
        self._recent_walls: deque = deque(maxlen=16)

    # — internals (lock held) —

    def _dispatch_locked(self) -> None:
        while self._active < self.max_pulls and self._queued:
            admitted_one = False
            for _ in range(len(self._order)):
                tenant = self._order[self._rr % len(self._order)]
                self._rr += 1
                q = self._queues.get(tenant)
                if not q:
                    continue
                self._deficit[tenant] = (self._deficit.get(tenant, 0.0)
                                         + self.quantum)
                head = q[0]
                if self._deficit[tenant] + 1e-9 >= head.weight:
                    self._deficit[tenant] -= head.weight
                    q.popleft()
                    self._queued -= 1
                    if not q:
                        del self._queues[tenant]
                    head.admitted = True
                    self._active += 1
                    self.admitted_total += 1
                    admitted_one = True
                    break
            if not admitted_one:
                break
        # Tenants with no queue left fall out of the rotation (their
        # deficit resets — credit must not accumulate while idle).
        if len(self._order) != len(self._queues):
            self._order = [t for t in self._order if t in self._queues]
            self._deficit = {t: d for t, d in self._deficit.items()
                             if t in self._queues}
        _M_QUEUE_DEPTH.set(self._queued)
        _M_ADMITTED.set(self._active)
        self._cv.notify_all()

    def _remove_locked(self, waiter: _Waiter) -> None:
        q = self._queues.get(waiter.tenant)
        if q is not None:
            try:
                q.remove(waiter)
                self._queued -= 1
            except ValueError:
                pass
            if not q:
                del self._queues[waiter.tenant]
        _M_QUEUE_DEPTH.set(self._queued)

    # — load shedding —

    def shed(self) -> dict:
        """Enter shed mode and evict the lowest-deficit tenant's queued
        waiters (the tenant with the LEAST accumulated fairness credit
        — it queued most recently / least underserved, so shedding it
        costs the least accrued fairness debt). Evicted waiters raise
        :class:`AdmissionRejected` (→ 429 + Retry-After); admitted
        sessions are never touched. While shedding, new sessions that
        would queue are rejected immediately. Reversible via
        :meth:`recover`."""
        with self._cv:
            self._shedding = True
            victim = None
            if self._queues:
                victim = min(self._queues,
                             key=lambda t: self._deficit.get(t, 0.0))
            n = 0
            retry = self._retry_after_locked()
            if victim is not None:
                q = self._queues.pop(victim, None) or ()
                for waiter in q:
                    waiter.shed = retry
                    n += 1
                self._queued -= n
                self.shed_total += n
                self.rejected_total += n
                for _ in range(n):
                    _M_REJECTS.inc()
                _M_QUEUE_DEPTH.set(self._queued)
            self._cv.notify_all()
            return {"tenant": victim, "shed": n,
                    "retry_after_s": retry,
                    "queued_left": self._queued}

    def recover(self) -> dict:
        """Leave shed mode: new sessions queue normally again."""
        with self._cv:
            was = self._shedding
            self._shedding = False
            return {"was_shedding": was, "queued": self._queued}

    @property
    def shedding(self) -> bool:
        with self._cv:
            return self._shedding

    def retry_after_s(self) -> float:
        """Advice for a rejected client: roughly one mean recent pull
        wall per queued-sessions-per-slot, clamped to [1, 60]."""
        with self._cv:
            return self._retry_after_locked()

    def _retry_after_locked(self) -> float:
        walls = list(self._recent_walls)
        backlog = self._queued + self._active
        mean = (sum(walls) / len(walls)) if walls else 5.0
        est = mean * max(1.0, backlog / self.max_pulls)
        return round(min(60.0, max(1.0, est)), 1)

    # — the public protocol —

    def acquire(self, tenant: str, cancel: CancelToken | None = None,
                session=None, weight: float = 1.0) -> None:
        """Block until admitted. Raises :class:`AdmissionRejected` when
        the queue is full, :class:`PullCancelled` when the session's
        token fires while queued (the waiter leaves the queue — its
        spot frees immediately)."""
        waiter = _Waiter(tenant, weight, session)
        t_enter = time.monotonic()
        with self._cv:
            if self._active < self.max_pulls and not self._queued:
                self._active += 1
                self.admitted_total += 1
                _M_ADMITTED.set(self._active)
                _M_ADMISSION_WAIT.observe(0.0)
                return
            if self._shedding:
                self.rejected_total += 1
                _M_REJECTS.inc()
                raise AdmissionRejected(
                    "load shedding active (SLO burn); retry later",
                    self._retry_after_locked())
            if self._queued >= self.max_queue:
                self.rejected_total += 1
                _M_REJECTS.inc()
                raise AdmissionRejected(
                    f"admission queue full ({self.max_queue} queued); "
                    "retry later", self._retry_after_locked())
            self._queues.setdefault(tenant, deque()).append(waiter)
            if tenant not in self._order:
                self._order.append(tenant)
            self._queued += 1
            _M_QUEUE_DEPTH.set(self._queued)
            if session is not None:
                session.set_phase("queued")
            self._dispatch_locked()
            try:
                while not waiter.admitted:
                    if waiter.shed is not None:
                        # A load-shed evicted us from the queue; the
                        # shed pass already did the removal/accounting.
                        raise AdmissionRejected(
                            "shed while queued (SLO burn); retry later",
                            waiter.shed)
                    if cancel is not None and cancel.fired:
                        self._remove_locked(waiter)
                        raise PullCancelled(
                            cancel.reason or "cancelled while queued")
                    self._cv.wait(0.05)
            except BaseException:
                if not waiter.admitted:
                    self._remove_locked(waiter)
                else:
                    # Admitted between the failure and this cleanup:
                    # give the slot back or it leaks forever.
                    self._active -= 1
                    self._dispatch_locked()
                raise
        _M_ADMISSION_WAIT.observe(time.monotonic() - t_enter)
        if session is not None:
            session.set_phase("starting")

    def probe_reject(self) -> tuple[bool, float]:
        """Would a new session be REJECTED right now? The HTTP layer's
        pre-SSE 429 check — it lives HERE so the predicate (and its
        reject accounting) can never drift from what :meth:`acquire`
        actually does. A full answer IS the request's rejection (the
        caller returns 429 on it), so it counts toward the totals.
        Returns (rejected, retry_after_s)."""
        with self._cv:
            would_queue = self._active >= self.max_pulls or self._queued > 0
            if would_queue and (self._shedding
                                or self._queued >= self.max_queue):
                self.rejected_total += 1
                _M_REJECTS.inc()
                return True, self._retry_after_locked()
        return False, 0.0

    def release(self, wall_s: float | None = None) -> None:
        with self._cv:
            self._active = max(0, self._active - 1)
            if wall_s is not None:
                self._recent_walls.append(wall_s)
            self._dispatch_locked()

    def summary(self) -> dict:
        with self._cv:
            return {
                "max_pulls": self.max_pulls,
                "active": self._active,
                "queued": self._queued,
                "queue_cap": self.max_queue,
                "admitted_total": self.admitted_total,
                "rejected_total": self.rejected_total,
                "shed_total": self.shed_total,
                "shedding": self._shedding,
            }


# ── Process-global state ──


class TenancyState:
    """Everything one process' sessions share: the admission
    controller, the singleflight table, the pin book, the evictor, and
    the aggregate in-flight byte budget."""

    def __init__(self, cfg, pins: PinBook | None = None):
        self.knobs = _knob_tuple(cfg)
        self.controller = AdmissionController(
            cfg.tenant_max_pulls, cfg.tenant_queue)
        self.flights = Singleflight()
        # Pins survive a knob rebuild (state() passes the old book):
        # tree:<repo> pins are documented to outlive sessions — a
        # rebuild dropping them would let the next eviction pass evict
        # a live HBM tree's delta/hot-swap manifest xorbs.
        self.pins = pins if pins is not None else PinBook()
        self.evictor = CacheEvictor(
            cfg.xorb_cache_dir(), cfg.tenant_disk_high,
            cfg.tenant_disk_low, self.pins)
        self.byte_budget = ByteBudget(cfg.tenant_inflight_bytes)
        storage.set_disk_full_hook(self.evictor.on_enospc)
        # The timeline sampler's gauges: queue depth, admitted sessions
        # and in-flight fetches, the history the queue-growth rule
        # reads. Replace semantics: a knob rebuild re-registers them
        # over the old state's probes.
        c = self.controller
        telemetry.timeline.register_probe(
            "tenancy.queue_depth", lambda: c.summary()["queued"])
        telemetry.timeline.register_probe(
            "tenancy.active_pulls", lambda: c.summary()["active"])
        telemetry.timeline.register_probe(
            "tenancy.admitted_total",
            lambda: c.summary()["admitted_total"])
        telemetry.timeline.register_probe(
            "tenancy.inflight_fetches", self.flights.in_flight)
        # Remediation action target: "shed" evicts the lowest-deficit
        # tenant's queued sessions, "recover" leaves shed mode. Replace
        # semantics: a knob rebuild re-registers over the old state.
        telemetry.remediate.register_target("shed", self._shed_cmd)

    def _shed_cmd(self, cmd: str) -> dict:
        if cmd == "recover":
            return self.controller.recover()
        return self.controller.shed()

    def summary(self) -> dict:
        doc = self.controller.summary()
        doc["inflight"] = {
            "budget_bytes": self.byte_budget.budget_bytes,
            "peak_bytes": self.byte_budget.peak_bytes,
        }
        doc["dedupe"] = self.flights.summary()
        doc["eviction"] = self.evictor.summary()
        doc["pins"] = self.pins.summary()
        return doc


_lock = threading.Lock()
_state: TenancyState | None = None


def _knob_tuple(cfg) -> tuple:
    return (cfg.tenant_max_pulls, cfg.tenant_queue,
            cfg.tenant_inflight_bytes, cfg.tenant_disk_high,
            cfg.tenant_disk_low, str(cfg.xorb_cache_dir()))


def enabled(cfg) -> bool:
    return bool(getattr(cfg, "tenancy_enabled", False))


def state(cfg) -> TenancyState:
    """The process singleton, built from the first caller's Config.
    A later caller with DIFFERENT knob values rebuilds it — but only
    while idle (no active or queued sessions): mid-flight, the first
    admitted configuration wins, because swapping budgets under live
    holders would strand their releases."""
    global _state
    with _lock:
        if _state is None:
            _state = TenancyState(cfg)
        elif _state.knobs != _knob_tuple(cfg):
            c = _state.controller
            with c._cv:
                idle = c._active == 0 and c._queued == 0
            if idle:
                _state = TenancyState(cfg, pins=_state.pins)
        return _state


def summary(cfg=None) -> dict | None:
    """The ``tenancy{}`` status block, or None when the layer is
    knob-off for this caller (or never configured and no cfg given).
    With a cfg, the process state is (re)configured from it first —
    the daemon's ``/v1/status`` must report the daemon's own knobs,
    not whichever embedded pull happened to configure the state last
    (``state()`` only rebuilds while idle, so live sessions are never
    re-budgeted)."""
    if cfg is not None:
        if not enabled(cfg):
            return None
        st = state(cfg)
    else:
        with _lock:
            st = _state
        if st is None:
            return None
    doc = st.summary()
    doc["enabled"] = True
    return doc


def can_enqueue(cfg) -> tuple[bool, float]:
    """Cheap pre-SSE backpressure probe for the HTTP layer: would a
    new session be REJECTED right now? (Advisory — admission itself
    re-checks; the race just turns a 429 into an SSE-stream typed
    error.) Predicate + accounting live on the controller
    (:meth:`AdmissionController.probe_reject`) so they can never
    drift from the real admission decision. Returns
    (ok, retry_after_s)."""
    if not enabled(cfg):
        return True, 0.0
    rejected, retry_after = state(cfg).controller.probe_reject()
    return (not rejected), retry_after


class admit:
    """Context manager one pull session holds for its whole run:
    admission (queued phase, fairness, backpressure) on entry plus a
    watermark eviction pass; slot release, byte-share release (the
    shared budget is released by the file pipeline itself), and pin
    release on exit — however the pull ends."""

    def __init__(self, cfg, tenant: str | None,
                 cancel: CancelToken | None = None, session=None):
        self.cfg = cfg
        self.tenant = tenant or "default"
        self.cancel = cancel
        self.session = session
        self._st: TenancyState | None = None
        self._owner: str | None = None
        self._t0: float | None = None

    @property
    def pin_owner(self) -> str | None:
        return self._owner

    def __enter__(self) -> "admit":
        if not enabled(self.cfg):
            return self
        self._st = state(self.cfg)
        # The queue wait gets its own span, so a trace shows parked
        # time as a distinct "queued" stage instead of untraced idle.
        with telemetry.span("tenancy.queued", tenant=self.tenant):
            self._st.controller.acquire(self.tenant, cancel=self.cancel,
                                        session=self.session)
        self._t0 = time.monotonic()
        sid = getattr(self.session, "id", None) or f"{id(self):x}"
        self._owner = f"sess:{sid}"
        # Disk-pressure check at the one safe, amortized point: before
        # the session's plan pins anything (its own entries are then
        # still fair game if older pulls left the cache over the mark).
        try:
            self._st.evictor.maybe_evict()
        except Exception:  # noqa: BLE001 - eviction is advisory
            pass
        return self

    def pin(self, hashes) -> None:
        """Pin a resolved reconstruction's xorb hashes for the life of
        this admission (no-op when knob-off)."""
        if self._st is not None and self._owner is not None:
            self._st.pins.pin(self._owner, hashes)

    def pin_tree(self, repo: str, hashes) -> None:
        """Replace the live-HBM-tree pin for ``repo``: the manifest a
        delta/hot-swap will diff against stays unevictable after this
        session's own pins release."""
        if self._st is not None:
            self._st.pins.replace(f"tree:{repo}", hashes)

    def __exit__(self, *exc) -> None:
        if self._st is None:
            return
        if self._owner is not None:
            self._st.pins.release(self._owner)
        wall = (time.monotonic() - self._t0) if self._t0 else None
        self._st.controller.release(wall_s=wall)


def release_tree(cfg, repo: str) -> bool:
    """Drop the live-HBM-tree pin for ``repo`` (the inverse of
    ``admit.pin_tree``). The HBM pool calls this when a model's tree
    leaves the pool for good — its xorbs become ordinary eviction
    candidates again instead of staying pinned for a swap that will
    never come. No-op (False) when tenancy is off or nothing was
    pinned."""
    if not enabled(cfg):
        return False
    st = state(cfg)
    return bool(st.pins.release(f"tree:{repo}"))


def reset() -> None:
    """Tests: drop the process state (the next pull reconfigures)."""
    global _state
    with _lock:
        _state = None
    storage.set_disk_full_hook(None)
    for name in TIMELINE_PROBES:
        telemetry.timeline.unregister_probe(name)
    telemetry.remediate.unregister_target("shed")
