"""Live timelines: an in-process time-series store with streaming
anomaly detection.

The counterpart of ``zest_tpu/telemetry/timeline.py``. Gauges and
``/v1/status`` are a point in time and the registry counters an
aggregate over all time; this module keeps a metric's *history*, which
is what "was throughput collapsing before the error?" needs:

- **The store** (:class:`TimelineStore`): a bounded set of named series,
  each a fixed-capacity ring of ``(t, value)`` samples taken at
  ``ZEST_TIMELINE_HZ`` (default 1 Hz) by one process-wide sampler
  thread. Per-series capacity (``ZEST_TIMELINE_SAMPLES``) times a hard
  series cap bound the memory; the oldest-touched series goes first.
- **Rates from existing counters** (``RATE_SOURCES``): per-tier fetch
  B/s, per-lane file B/s, coop / collective / DCN wire B/s and seed
  upload B/s, each sample ``delta / dt`` over the tick interval, so
  :func:`integrate` of a rate series gives back the counter's delta.
- **Structural gauges**: subsystems register *probes*
  (:func:`register_probe`, called at tick time: tenancy queue depth,
  the landing ring's occupancy and stalls, the serving pool) or *post*
  cells (:func:`post`: the collective exchange's phase, partner and
  barrier seconds). Per-session byte progress is read off the session
  table.
- **The anomaly detector** (:class:`AnomalyDetector`): ``stall`` (no
  byte progress for ``ZEST_ANOMALY_WINDOW_S`` in a byte-moving stage),
  ``throughput_collapse`` (rate below 25% of the session's own EWMA for
  a window), ``queue_stuck`` (tenant queue held with no admission for a
  window) and ``collective_straggler`` (barrier wait within one phase
  past the window). Each firing records an ``anomaly`` flight event,
  bumps ``zest_anomalies_total{kind}``, annotates the session and calls
  the anomaly listeners (the remediation engine).

Surfaces: ``GET /v1/timeline?since=<cursor>`` (cursor-paged),
``?scope=pod`` (:func:`merge_timelines` onto the coordinator's clock),
the dashboard and ``zest top``.

``ZEST_TIMELINE=0`` (implied by ``ZEST_TELEMETRY=0``) is hard-off: no
sampler thread, an empty store, every ``register_probe``/``post`` one
flag check, and the pull is the pull without timelines.

No probe or listener launches a kernel or synchronizes the card: a probe
that reads device memory reads the allocator's counters.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import OrderedDict, deque

from zest_tpu_torch.telemetry import metrics, recorder, state
from zest_tpu_torch.telemetry import session as session_mod

ENV_TIMELINE = "ZEST_TIMELINE"
ENV_HZ = "ZEST_TIMELINE_HZ"
ENV_WINDOW = "ZEST_ANOMALY_WINDOW_S"
ENV_SAMPLES = "ZEST_TIMELINE_SAMPLES"

DEFAULT_HZ = 1.0
DEFAULT_WINDOW_S = 5.0
DEFAULT_SAMPLES = 512      # ring capacity per series
MAX_SERIES = 256           # hard cap on concurrent series
_ANOMALY_RING = 64         # recent-anomalies ring on the store
# Sample stamps: the monotonic clock plus a wall offset. A pass re-reads
# the offset between two monotonic reads; a read that took longer than
# _CLEAN_READ_S (a thread switch inside it) is dropped, and the kept
# offset moves only when the clean one differs by more than _WALL_STEP_S
# (the wall clock stepped or slewed that far).
_CLEAN_READ_S = 100e-6
_WALL_STEP_S = 1e-3

# The push fan-out's series, posted like any other cell: the publisher
# posts the first two on every ``/v1/push`` notification, each watch
# subscriber the third after its swap (trainer ``pushed_at`` to swap
# complete).
SERIES_PUSH_PREFIX = "push."

# Throughput collapse: the rate must fall below COLLAPSE_FRACTION of the
# session's own EWMA, and the EWMA be above a noise floor (an idle
# trickle would otherwise "collapse" all the time).
COLLAPSE_FRACTION = 0.25
_COLLAPSE_FLOOR_BPS = 64 * 1024
# EWMA time constant, in anomaly windows: one slow tick must not drag
# the baseline down to the collapsed rate.
_EWMA_WINDOWS = 3.0

_M_ANOMALIES = metrics.counter(
    "zest_anomalies_total",
    "Streaming anomalies detected on live timelines, by kind",
    ("kind",))
_M_SAMPLES = metrics.counter(
    "zest_timeline_samples_total",
    "Samples appended to the in-process timeline store")

# Counter → rate derivations: (series prefix, registry metric, label
# key). One series per label value (``<prefix>.<label>_bps``), or
# ``<prefix>.bps`` for a summed metric. All are byte counters.
RATE_SOURCES = (
    ("fetch", "zest_fetch_bytes_total", "source"),
    ("files", "zest_files_bytes_total", "lane"),
    ("coop", "zest_coop_bytes_total", "tier"),
    ("collective", "zest_coop_collective_bytes_total", "link"),
    ("dcn", "zest_dcn_bytes_served_total", None),
    ("seed", "zest_seed_bytes_total", None),
)

ANOMALY_COLLAPSE = "throughput_collapse"
ANOMALY_STALL = "stall"
ANOMALY_QUEUE = "queue_stuck"
ANOMALY_STRAGGLER = "collective_straggler"

_OFF_VALUES = frozenset({"0", "false", "off", "no"})

_flag_lock = threading.Lock()
_enabled: bool | None = None


def enabled() -> bool:
    """``ZEST_TELEMETRY`` off implies the timeline off; ``ZEST_TIMELINE=0``
    turns just this layer off."""
    if not state.enabled():
        return False
    global _enabled
    on = _enabled
    if on is not None:
        return on
    with _flag_lock:
        if _enabled is None:
            raw = os.environ.get(ENV_TIMELINE, "").strip().lower()
            _enabled = raw not in _OFF_VALUES
        return _enabled


def set_enabled(on: bool | None) -> None:
    """Test override; ``None`` returns to the environment."""
    global _enabled
    with _flag_lock:
        _enabled = on


def _env_float(name: str, default: float, floor: float) -> float:
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    if not math.isfinite(v) or v < floor:
        return default
    return v


def _env_int(name: str, default: int, floor: int) -> int:
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    return v if v >= floor else default


# ── Series and store ──


class Series:
    """One named timeline: a fixed-capacity ring of ``(seq, t, value)``.
    ``seq`` is the store-wide sample counter, the cursor ``GET
    /v1/timeline?since=`` resumes from."""

    __slots__ = ("name", "kind", "ring", "last_touch")

    def __init__(self, name: str, kind: str, capacity: int):
        self.name = name
        self.kind = kind            # "rate" | "gauge"
        self.ring: deque = deque(maxlen=capacity)
        self.last_touch = 0.0

    def samples_since(self, since: int) -> list[list[float]]:
        return [[t, v] for seq, t, v in self.ring if seq > since]


class AnomalyDetector:
    """Streaming rules over the sampler's per-tick views.

    State is per episode: a rule arms when its condition first holds,
    fires once it has held for ``window_s``, and re-arms only after the
    condition clears, so a wedged pull gives one ``stall``, not one per
    tick."""

    def __init__(self, store: "TimelineStore", window_s: float):
        self.store = store
        self.window_s = window_s
        # sid → {last_bytes, last_t, ewma, collapse_since, stall_since,
        #        fired: set[str]}
        self._sessions: dict[str, dict] = {}
        self._queue: dict = {}       # queue-growth episode
        self._collective: dict = {}  # per-phase barrier baseline

    def _fire(self, kind: str, session=None, **fields) -> None:
        sid = getattr(session, "id", None)
        _M_ANOMALIES.inc(kind=kind)
        ev = {"anomaly": kind, **fields}
        if sid is not None:
            ev["session"] = sid
        recorder.record("anomaly", **ev)
        if session is not None:
            note = getattr(session, "note_anomaly", None)
            if note is not None:
                try:
                    note(kind, fields)
                except Exception:  # noqa: BLE001 - annotation is advisory
                    pass
        self.store._note_anomaly(kind, sid, fields)
        # The anomaly stream: subscribers (the remediation engine) see
        # every firing with the live session attached.
        for cb in list(_anomaly_listeners):
            try:
                cb(kind, session, dict(fields))
            except Exception:  # noqa: BLE001 - a subscriber must never
                pass           # take the detector down

    # — per-session rules —

    def observe_session(self, sess, now: float) -> None:
        sid = sess.id
        row = self._sessions.get(sid)
        f = sess._fetch
        done = None
        if f is not None:
            done = (f.bytes_from_cache + f.bytes_from_peer
                    + f.bytes_from_cdn)
        if row is None:
            self._sessions[sid] = {
                "last_bytes": done, "last_t": now, "ewma": 0.0,
                "collapse_since": None, "stall_since": None,
                "fired": set(),
            }
            return
        dt = now - row["last_t"]
        if dt <= 0 or done is None:
            return
        last = row["last_bytes"]
        row["last_t"] = now
        row["last_bytes"] = done
        if last is None:
            return
        rate = max(0.0, (done - last) / dt)
        total = sess.total_bytes
        # Progress-bar semantics, like the session ETA: "bytes remain"
        # is approximate, which is fine for an anomaly gate.
        bytes_remain = total is not None and done < total
        # Byte-moving is judged on the open stages, not the display
        # phase: during a direct landing the phase reads hbm_commit
        # while fetch workers still pull bytes inside it.
        try:
            open_stages = tuple(sess._open)
        except RuntimeError:  # mutated under us: the next tick reads
            open_stages = ()
        moving_phase = ("fetch" in open_stages or "files" in open_stages
                        or sess.phase in ("fetch", "files"))

        # Zero-progress stall: no bytes for a whole window in a
        # byte-moving stage with work left.
        if rate == 0.0 and moving_phase and (bytes_remain or done == 0):
            if row["stall_since"] is None:
                row["stall_since"] = now
            elif (now - row["stall_since"] >= self.window_s
                    and ANOMALY_STALL not in row["fired"]):
                row["fired"].add(ANOMALY_STALL)
                self._fire(ANOMALY_STALL, session=sess,
                           phase=sess.phase, bytes_done=done,
                           stalled_s=round(now - row["stall_since"], 2))
        else:
            row["stall_since"] = None
            if rate > 0.0:
                row["fired"].discard(ANOMALY_STALL)

        # Collapse against the session's own history: a pull that was
        # always slow does not alarm, one that fell off its rate does.
        ewma = row["ewma"]
        collapsed = (ewma > _COLLAPSE_FLOOR_BPS
                     and rate < COLLAPSE_FRACTION * ewma
                     and bytes_remain)
        if collapsed:
            if row["collapse_since"] is None:
                row["collapse_since"] = now
            elif (now - row["collapse_since"] >= self.window_s
                    and ANOMALY_COLLAPSE not in row["fired"]):
                row["fired"].add(ANOMALY_COLLAPSE)
                self._fire(ANOMALY_COLLAPSE, session=sess,
                           rate_bps=int(rate), ewma_bps=int(ewma),
                           bytes_done=done)
        else:
            row["collapse_since"] = None
            if ewma > 0 and rate >= COLLAPSE_FRACTION * ewma:
                row["fired"].discard(ANOMALY_COLLAPSE)
        # The EWMA moves after the judgement, so collapsed ticks do not
        # pull the baseline down to meet them.
        tau = max(self.window_s * _EWMA_WINDOWS, 1e-6)
        alpha = 1.0 - math.exp(-dt / tau)
        row["ewma"] = ewma + alpha * (rate - ewma)

    def drop_session(self, sid: str) -> None:
        self._sessions.pop(sid, None)

    # — queue rule —

    def observe_queue(self, depth, admitted_total, now: float) -> None:
        """The tenant queue holds (or grows) for a whole window while
        ``admitted_total`` does not move: a wedged admission stage."""
        if depth is None or admitted_total is None:
            return
        q = self._queue
        stuck = (depth > 0 and bool(q)
                 and admitted_total == q.get("admitted")
                 and depth >= q.get("depth", 0))
        if not stuck:
            # Idle, drained below the episode's depth, or an admission:
            # a fresh episode.
            self._queue = {"since": now, "depth": depth,
                           "admitted": admitted_total, "fired": False}
            return
        q["depth"] = depth
        if now - q["since"] >= self.window_s and not q.get("fired"):
            q["fired"] = True
            self._fire(ANOMALY_QUEUE, depth=int(depth),
                       waited_s=round(now - q["since"], 2))

    # — collective rule —

    def observe_collective(self, cells: dict, now: float) -> None:
        """Barrier wait accumulated within one phase past the window
        blames that phase's partner: fired once per phase, with the
        phase index and the partner host."""
        phase = cells.get("collective.phase")
        barrier = cells.get("collective.barrier_s")
        if phase is None or barrier is None:
            self._collective = {}
            return
        c = self._collective
        if c.get("phase") != phase:
            self._collective = {"phase": phase, "barrier0": barrier,
                                "fired": False}
            return
        waited = barrier - c.get("barrier0", 0.0)
        if waited >= self.window_s and not c.get("fired"):
            c["fired"] = True
            fields = {"phase": int(phase),
                      "barrier_wait_s": round(waited, 2)}
            partner = cells.get("collective.partner")
            if partner is not None:
                fields["partner"] = int(partner)
            self._fire(ANOMALY_STRAGGLER, **fields)


class TimelineStore:
    """The process timeline: bounded series rings, the probe and cell
    registries, the counter-rate state and the anomaly ring."""

    def __init__(self, capacity: int | None = None,
                 max_series: int = MAX_SERIES,
                 window_s: float | None = None):
        if capacity is None:
            capacity = _env_int(ENV_SAMPLES, DEFAULT_SAMPLES, 2)
        if window_s is None:
            window_s = _env_float(ENV_WINDOW, DEFAULT_WINDOW_S, 0.05)
        self.capacity = capacity
        self.max_series = max(1, max_series)
        self.window_s = window_s
        self.hz = _env_float(ENV_HZ, DEFAULT_HZ, 0.01)
        self._lock = threading.Lock()
        self._series: OrderedDict[str, Series] = OrderedDict()
        self._seq = 0
        self._probes: dict[str, object] = {}
        self._cells: dict[str, float] = {}
        # (metric, label value) → (counter value, t) rate baselines.
        self._rate_state: dict[tuple[str, str], tuple[float, float]] = {}
        # The previous tick (monotonic): a labelset first seen mid-run
        # credits its whole value over this interval.
        self._last_tick_t: float | None = None
        self._anomalies: deque = deque(maxlen=_ANOMALY_RING)
        self._clock_offsets: dict = {}
        self.detector = AnomalyDetector(self, window_s)
        self.ticks = 0
        # A sampling pass stamps its samples with the monotonic clock it
        # rates by, moved onto the wall clock by this offset, so that
        # integrate() gives back a counter's delta up to the samples'
        # rounding while the wall clock holds still, and the stamps follow
        # a step of it within one pass (_follow_wall). (The JAX package
        # reads time.time() after time.monotonic(); a thread switch between
        # the two reads skews that sample's interval.)
        self._wall_offset = time.time() - time.monotonic()

    # — write side —

    def _append(self, name: str, value: float, kind: str,
                t: float) -> None:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                while len(self._series) >= self.max_series:
                    # Oldest-touched first: every append moves its
                    # series to the end.
                    self._series.popitem(last=False)
                s = self._series[name] = Series(name, kind,
                                                self.capacity)
            self._seq += 1
            # Microsecond stamps: rate samples integrate back to bytes
            # (× dt), and millisecond rounding would leak ~1% per tick.
            s.ring.append((self._seq, round(t, 6), value))
            s.last_touch = t
            self._series.move_to_end(name)
        _M_SAMPLES.inc()

    def _note_anomaly(self, kind: str, sid, fields: dict) -> None:
        ev = {"t": round(time.time(), 3), "kind": kind}
        if sid is not None:
            ev["session"] = sid
        ev.update({k: v for k, v in fields.items()
                   if isinstance(v, (str, int, float, bool))})
        with self._lock:
            self._anomalies.append(ev)

    def set_clock_offsets(self, offsets: dict) -> None:
        """The pod clock offsets the last coop round measured (host
        index → ``{offset_s, rtt_s}``), what ``?scope=pod`` hands
        :func:`merge_timelines`."""
        with self._lock:
            self._clock_offsets.update(
                {str(k): dict(v) for k, v in offsets.items()})

    # — the sampling pass —

    def _follow_wall(self) -> float:
        """The wall offset for this pass's stamps: the kept one, or a
        clean new reading where the wall clock moved past ``_WALL_STEP_S``
        against the monotonic one."""
        m0 = time.monotonic()
        w = time.time()
        m1 = time.monotonic()
        if m1 - m0 <= _CLEAN_READ_S:
            off = w - (m0 + m1) / 2
            if abs(off - self._wall_offset) > _WALL_STEP_S:
                self._wall_offset = off
        return self._wall_offset

    def tick(self, now: float | None = None, wall: float | None = None,
             registry=None) -> None:
        """One sampling pass. ``now`` is the monotonic rate clock,
        ``wall`` the sample stamp (tests inject both)."""
        if now is None:
            now = time.monotonic()
            if wall is None:
                wall = now + self._follow_wall()
        if wall is None:
            wall = time.time()
        if registry is None:
            registry = metrics.REGISTRY
        self.ticks += 1

        # 1. Rates from the registry counters.
        last_tick = self._last_tick_t
        self._last_tick_t = now
        by_name = {m.name: m for m in registry.metrics()}
        for prefix, metric_name, label_key in RATE_SOURCES:
            m = by_name.get(metric_name)
            if m is None:
                continue
            sums: dict[str, float] = {}
            for labels, value in m.samples():
                key = labels.get(label_key, "") if label_key else ""
                sums[key] = sums.get(key, 0.0) + value
            for label_value, total in sums.items():
                rk = (metric_name, label_value)
                prev = self._rate_state.get(rk)
                self._rate_state[rk] = (total, now)
                name = (f"{prefix}.{label_value}_bps" if label_value
                        else f"{prefix}.bps")
                if prev is None:
                    if last_tick is None or now <= last_tick:
                        # The store's first look: a zero anchors the
                        # series for integration.
                        self._append(name, 0.0, "rate", wall)
                        continue
                    # First seen mid-run: the whole value moved since
                    # the previous tick; a zero anchor there keeps
                    # integrate() exact.
                    dt = now - last_tick
                    self._append(name, 0.0, "rate", wall - dt)
                    self._append(name, round(total / dt, 1), "rate",
                                 wall)
                    continue
                pv, pt = prev
                dt = now - pt
                if dt <= 0:
                    continue
                self._append(name, round(max(0.0, total - pv) / dt, 1),
                             "rate", wall)

        # 2. Registered probes.
        with self._lock:
            probes = list(self._probes.items())
            cells = dict(self._cells)
        probe_vals: dict[str, float] = {}
        for name, fn in probes:
            try:
                v = fn()
            except Exception:  # noqa: BLE001 - a dying probe drops out
                continue
            if v is None:
                continue
            probe_vals[name] = float(v)
            self._append(name, float(v), "gauge", wall)

        # 3. Posted cells.
        for name, v in cells.items():
            self._append(name, float(v), "gauge", wall)

        # 4. Per-session byte progress and the session rules.
        active = session_mod.SESSIONS.active()
        live_ids = set()
        for sess in active:
            live_ids.add(sess.id)
            f = sess._fetch
            if f is not None:
                done = (f.bytes_from_cache + f.bytes_from_peer
                        + f.bytes_from_cdn)
                self._append(f"session.{sess.id}.bytes", float(done),
                             "gauge", wall)
            self.detector.observe_session(sess, now)
        for sid in list(self.detector._sessions):
            if sid not in live_ids:
                self.detector.drop_session(sid)

        # 5. Queue and collective rules.
        self.detector.observe_queue(
            probe_vals.get("tenancy.queue_depth"),
            probe_vals.get("tenancy.admitted_total"), now)
        self.detector.observe_collective(cells, now)

        # 6. Tick subscribers: the remediation engine's periodic rules
        # ride the sampler's cadence.
        for cb in list(_tick_listeners):
            try:
                cb(self, now)
            except Exception:  # noqa: BLE001 - sampling must never crash
                pass

    # — read side —

    def payload(self, since: int = 0, prefix: str | None = None) -> dict:
        """The ``GET /v1/timeline`` document: every series' samples past
        ``since`` (pass the returned ``cursor`` back to stream
        increments), the recent anomalies and the sampling config."""
        with self._lock:
            series = {
                name: {"kind": s.kind,
                       "samples": s.samples_since(since)}
                for name, s in self._series.items()
                if prefix is None or name.startswith(prefix)
            }
            doc = {
                "enabled": True,
                "hz": self.hz,
                "window_s": self.window_s,
                "cursor": self._seq,
                "series": {n: d for n, d in series.items()
                           if d["samples"]},
                "anomalies": list(self._anomalies),
            }
            if self._clock_offsets:
                doc["clock_offsets"] = dict(self._clock_offsets)
        return doc


# ── The sampler thread ──


class _Sampler:
    def __init__(self, store: TimelineStore):
        self.store = store
        self._stop = threading.Event()
        self.thread = threading.Thread(
            target=self._run, daemon=True, name="zest-timeline")

    def _run(self) -> None:
        interval = 1.0 / max(self.store.hz, 0.01)
        # A baseline tick at once: bytes that move before the first
        # interval ends are credited to it.
        try:
            self.store.tick()
        except Exception:  # noqa: BLE001 - sampling must never crash
            pass
        while not self._stop.wait(interval):
            try:
                self.store.tick()
            except Exception:  # noqa: BLE001 - sampling must never crash
                pass

    def stop(self) -> None:
        self._stop.set()


# ── The process-wide instance and hooks ──

STORE = TimelineStore()

_sampler_lock = threading.Lock()
_sampler: _Sampler | None = None

# Module-level, not per store: subscribers outlive a test's store swap.
_anomaly_listeners: list = []
_tick_listeners: list = []


def add_anomaly_listener(cb) -> None:
    """``cb(kind, session, fields)`` on every firing. Idempotent."""
    if cb not in _anomaly_listeners:
        _anomaly_listeners.append(cb)


def add_tick_listener(cb) -> None:
    """``cb(store, now)`` after every sampling pass. Idempotent."""
    if cb not in _tick_listeners:
        _tick_listeners.append(cb)


def remove_anomaly_listener(cb) -> None:
    try:
        _anomaly_listeners.remove(cb)
    except ValueError:
        pass


def remove_tick_listener(cb) -> None:
    try:
        _tick_listeners.remove(cb)
    except ValueError:
        pass


def _session_evicted(sid: str) -> None:
    """A session's terminal transition drops its detector row at once,
    not at the next tick: an armed-off row left behind would swallow the
    first firing of a later session."""
    try:
        STORE.detector.drop_session(sid)
    except Exception:  # noqa: BLE001 - teardown is advisory
        pass


session_mod.add_evict_listener(_session_evicted)


def ensure_started() -> bool:
    """Start the process sampler (idempotent). False, and nothing
    started, when the layer is off."""
    if not enabled():
        return False
    global _sampler
    with _sampler_lock:
        if _sampler is None:
            _sampler = _Sampler(STORE)
            _sampler.thread.start()
    return True


def register_probe(name: str, fn) -> None:
    """A live gauge sampled every tick (``fn() -> float | None``).
    Re-registering a name swaps the callable."""
    if not enabled():
        return
    with STORE._lock:
        STORE._probes[name] = fn


def unregister_probe(name: str, fn=None) -> None:
    """With ``fn``, only if that callable is still the registered one:
    an old owner's teardown must not drop its replacement's probe."""
    with STORE._lock:
        if fn is None or STORE._probes.get(name) is fn:
            STORE._probes.pop(name, None)


def post(name: str, value: float) -> None:
    """Set a transient cell the sampler records every tick (the
    collective's phase index, partner and barrier seconds)."""
    if not enabled():
        return
    with STORE._lock:
        STORE._cells[name] = float(value)


def clear(prefix: str) -> None:
    """Drop every posted cell under ``prefix`` (the exchange is over)."""
    with STORE._lock:
        for name in [n for n in STORE._cells if n.startswith(prefix)]:
            STORE._cells.pop(name, None)


def cells() -> dict[str, float]:
    """The posted cells as they stand."""
    with STORE._lock:
        return dict(STORE._cells)


def set_clock_offsets(offsets: dict) -> None:
    if not enabled() or not offsets:
        return
    STORE.set_clock_offsets(offsets)


def clock_offsets() -> dict[str, dict]:
    """The recorded pod clock offsets (host index → offset, rtt)."""
    with STORE._lock:
        return {k: dict(v) for k, v in STORE._clock_offsets.items()}


def payload(since: int = 0, prefix: str | None = None) -> dict:
    """The ``/v1/timeline`` document (an explicit ``enabled: false``
    stub when off, so pollers see the state instead of a 404)."""
    if not enabled():
        return {"enabled": False, "series": {}, "anomalies": [],
                "cursor": 0}
    return STORE.payload(since=since, prefix=prefix)


def status_block() -> dict:
    """The ``timeline`` block of ``/v1/status``."""
    if not enabled():
        return {"enabled": False}
    with STORE._lock:
        return {"enabled": True, "hz": STORE.hz,
                "series": len(STORE._series), "cursor": STORE._seq,
                "anomalies": len(STORE._anomalies),
                "ticks": STORE.ticks}


def reset() -> None:
    """Tests: stop the sampler, drop the store and the subscribers, back
    to the environment."""
    global _sampler
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None
    global STORE
    STORE = TimelineStore()
    del _anomaly_listeners[:]
    del _tick_listeners[:]
    set_enabled(None)


# ── Pure helpers ──


def integrate(samples: list[list[float]]) -> float:
    """∫ rate·dt over a rate series, left-Riemann over the sample
    intervals: exact for this store's series, each sample being
    delta / dt for the interval that ends at its stamp."""
    total = 0.0
    for (t0, _v0), (t1, v1) in zip(samples, samples[1:]):
        total += v1 * (t1 - t0)
    return total


def merge_timelines(host_docs: dict, reference=None) -> dict:
    """Merge per-host ``/v1/timeline`` docs into one pod-scope doc:
    series renamed ``h<host>.<name>``, stamps moved onto the reference
    host's clock by each doc's recorded clock offsets (a host without an
    estimate merges on its raw clock, recorded as ``applied_offset_s:
    null``), anomalies in one time-ordered list stamped with their
    host."""
    if not host_docs:
        raise ValueError("no timelines to merge")
    keys = sorted(host_docs, key=str)
    if reference is None:
        reference = keys[0]
    ref_offsets = (host_docs[reference].get("clock_offsets") or {})

    merged_series: dict = {}
    anomalies: list[dict] = []
    norm_meta: dict = {}
    for host in keys:
        doc = host_docs[host]
        offset = 0.0 if host == reference else None
        est = ref_offsets.get(str(host))
        if isinstance(est, dict) and "offset_s" in est:
            offset = float(est["offset_s"])
        else:
            own = (doc.get("clock_offsets") or {}).get(str(reference))
            if isinstance(own, dict) and "offset_s" in own:
                offset = -float(own["offset_s"])
        norm_meta[str(host)] = {
            "applied_offset_s": (None if offset is None
                                 else round(offset, 6))}
        shift = -(offset or 0.0)
        for name, s in (doc.get("series") or {}).items():
            merged_series[f"h{host}.{name}"] = {
                "kind": s.get("kind", "gauge"),
                "samples": [[round(t + shift, 6), v]
                            for t, v in s.get("samples", [])],
            }
        for ev in doc.get("anomalies") or []:
            out = dict(ev)
            out["host"] = host
            if "t" in out:
                out["t"] = round(out["t"] + shift, 6)
            anomalies.append(out)
    anomalies.sort(key=lambda e: e.get("t", 0))
    return {
        "scope": "pod",
        "reference": reference,
        "hosts": [str(k) for k in keys],
        "clock_normalization": norm_meta,
        "series": merged_series,
        "anomalies": anomalies,
    }
