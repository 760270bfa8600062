"""Anomaly → action: the self-healing control plane.

The counterpart of ``zest_tpu/telemetry/remediate.py``. A policy engine
subscribed to the timeline's anomaly stream
(:func:`timeline.add_anomaly_listener`) and to the sampler's tick
(:func:`timeline.add_tick_listener`) maps each firing to a bounded,
rate-limited, reversible action through recovery paths that exist:

========================  ========  ==================================
anomaly / evidence        action    recovery path it drives
========================  ========  ==================================
stall / collapse on a     hedge     ``XetBridge.arm_hedge``: the hedge
fetch-bound session                 pool races the next tier mid-flight
collective_straggler      strike    ``health.record_failure`` on the
                                    blamed partner; past
                                    ``ZEST_REMEDIATE_PATIENCE`` firings,
                                    an abort down the point-to-point
                                    ladder
collapsing seeder         demote    ``HealthRegistry.demote`` and a
(near-budget or bad-kind            re-announce, with no strike added
strikes, served collapse)
queue_stuck + SLO burn    shed      ``AdmissionController.shed``;
                                    ``recover`` at half the burn
ring-stall growth         tune      ``land_ring_bytes`` doubled within
                                    [base, min(8 × base, 4 GiB)], one
                                    direction per observe window
pool gate-stall growth    hedge     ``HbmPool`` rush (``pool_land``)
pool eviction growth      shed      ``HbmPool.shed_coldest``
                                    (``pool_shed``)
========================  ========  ==================================

Rails: per-action token buckets (``ZEST_REMEDIATE_BURST`` tokens, one
back every ``ZEST_REMEDIATE_RATE_S``), the enable mask
``ZEST_REMEDIATE_ACTIONS`` (a masked action is recorded ``disabled``),
dry run (``ZEST_REMEDIATE_DRY=1`` or ``zest heal --dry-run on``), and
oscillation damping (``ZEST_REMEDIATE_OBSERVE_S``). Every decision,
executed or not, is a ``remediation`` flight event with before/after
snapshots of its series, a ``zest_remediations_total{action,outcome}``
sample and a row of ``GET /v1/remediations`` / ``zest heal``.

``ZEST_REMEDIATE=0`` (default on; the timeline off implies it) is the
pure observer: no subscription, no targets kept, no events.

Targets are injected by their owners (:func:`register_target`): the
telemetry package imports nothing of the rest of the port. No target
launches a kernel or synchronizes the card, so the engine's "failed"
catch can never hide a device fault.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from zest_tpu_torch.telemetry import metrics, recorder
from zest_tpu_torch.telemetry import session as session_mod
from zest_tpu_torch.telemetry import timeline

ENV_REMEDIATE = "ZEST_REMEDIATE"
ENV_ACTIONS = "ZEST_REMEDIATE_ACTIONS"
ENV_DRY = "ZEST_REMEDIATE_DRY"
ENV_RATE_S = "ZEST_REMEDIATE_RATE_S"
ENV_BURST = "ZEST_REMEDIATE_BURST"
ENV_PATIENCE = "ZEST_REMEDIATE_PATIENCE"
ENV_BURN_MAX = "ZEST_REMEDIATE_BURN_MAX"
ENV_OBSERVE_S = "ZEST_REMEDIATE_OBSERVE_S"

ACTIONS = ("hedge", "strike", "demote", "shed", "tune")

DEFAULT_RATE_S = 10.0     # seconds per replenished token, per action
DEFAULT_BURST = 3         # token-bucket capacity, per action
DEFAULT_PATIENCE = 2      # straggler firings before a mid-round abort
DEFAULT_BURN_MAX = 0.1    # SLO burn ratio that projects a breach
DEFAULT_OBSERVE_S = 30.0  # damping / demote-cooldown window
_LOG_CAP = 256            # decision ring behind /v1/remediations
_SNAP_SAMPLES = 8         # samples per series in a before/after snapshot

# The ring tuner's rails: never below the configured base, never above
# base × 8 or the absolute cap, whichever is smaller.
RING_KNOB = "land_ring_bytes"
RING_GROWTH_CAP = 8
RING_ABS_CAP_BYTES = 4 * 1024 * 1024 * 1024

# Strike kinds that read as "this seeder is going bad" (all recorded by
# other subsystems on real failures; the engine never invents one).
_DEMOTE_EVIDENCE_KINDS = ("corrupt", "seed_stall", "stalled_reader",
                          "io_timeout", "error")
_DEMOTE_EVIDENCE_STRIKES = 2
# Served-bytes collapse: recent below this fraction of the peer's own
# peak, the peak above a noise floor.
_DEMOTE_COLLAPSE_FRACTION = 0.25
_DEMOTE_COLLAPSE_FLOOR = 1 * 1024 * 1024

_KIND_TO_ACTION = {
    timeline.ANOMALY_STALL: "hedge",
    timeline.ANOMALY_COLLAPSE: "hedge",
    timeline.ANOMALY_STRAGGLER: "strike",
    timeline.ANOMALY_QUEUE: "shed",
}

_OFF_VALUES = frozenset({"0", "false", "off", "no"})
_ON_VALUES = frozenset({"1", "true", "on", "yes"})

_M_REMEDIATIONS = metrics.counter(
    "zest_remediations_total",
    "Self-healing control-plane decisions, by action and outcome",
    ("action", "outcome"))

_flag_lock = threading.Lock()
_forced: bool | None = None


def enabled() -> bool:
    """Default on; ``ZEST_REMEDIATE=0`` is the pure observer. The
    timeline off implies it off: there is no anomaly stream."""
    if not timeline.enabled():
        return False
    forced = _forced
    if forced is not None:
        return forced
    raw = os.environ.get(ENV_REMEDIATE, "").strip().lower()
    return raw not in _OFF_VALUES


def set_enabled(on: bool | None) -> None:
    """Test override; ``None`` returns to the environment."""
    global _forced
    with _flag_lock:
        _forced = on


def parse_actions(raw: str | None) -> frozenset[str]:
    """The ``ZEST_REMEDIATE_ACTIONS`` mask: comma-separated names, empty
    or ``all`` for every action. Unknown names are dropped here (a typo
    must not crash a pull); ``Config.load`` is the strict front door."""
    raw = (raw or "").strip().lower()
    if not raw or raw == "all":
        return frozenset(ACTIONS)
    return frozenset(p.strip() for p in raw.split(",")
                     if p.strip() in ACTIONS)


def _enabled_actions() -> frozenset[str]:
    return parse_actions(os.environ.get(ENV_ACTIONS))


class _TokenBucket:
    """Per-action rate limit: ``capacity`` tokens, one back every
    ``refill_s``; a flapping detector drains it and the engine goes
    quiet."""

    __slots__ = ("capacity", "refill_s", "tokens", "last_t")

    def __init__(self, capacity: int, refill_s: float):
        self.capacity = max(1, capacity)
        self.refill_s = max(refill_s, 1e-9)
        self.tokens = float(self.capacity)
        self.last_t = time.monotonic()

    def take(self, now: float) -> bool:
        self.tokens = min(float(self.capacity),
                          self.tokens + (now - self.last_t) / self.refill_s)
        self.last_t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class RemediationEngine:
    """The anomaly and tick subscriber: injected targets, the decision
    log and the rails."""

    def __init__(self):
        self._lock = threading.RLock()
        self._log: deque = deque(maxlen=_LOG_CAP)
        self._targets: dict[str, object] = {}
        self._buckets: dict[str, _TokenBucket] = {}
        self.counts: dict[tuple[str, str], int] = {}
        # Straggler firings since the current collective target
        # registered (one exchange, one patience budget).
        self._straggler_fired = 0
        # Per-peer demote state: served-bytes peak, last demote time.
        self._peers: dict[str, dict] = {}
        self._shedding = False
        # Knobs: base, value, rails and the last nudge (t, dir).
        self._knobs: dict[str, dict] = {}
        self._ring_last: float | None = None
        # The serving pool's last-seen gate-stall seconds and evictions:
        # growth between ticks is the evidence.
        self._pool_stall_last: float | None = None
        self._pool_evict_last: float | None = None
        # Decisions whose "after" snapshot settles on the next tick.
        self._pending_after: list[tuple[dict, tuple[str, ...]]] = []

        self.rate_s = _env_float(ENV_RATE_S, DEFAULT_RATE_S, 0.01)
        self.burst = _env_int(ENV_BURST, DEFAULT_BURST, 1)
        self.patience = _env_int(ENV_PATIENCE, DEFAULT_PATIENCE, 1)
        self.burn_max = _env_float(ENV_BURN_MAX, DEFAULT_BURN_MAX, 1e-6)
        self.observe_s = _env_float(ENV_OBSERVE_S, DEFAULT_OBSERVE_S,
                                    0.01)
        raw = os.environ.get(ENV_DRY, "").strip().lower()
        self.dry_run = raw in _ON_VALUES

    # ── Injected targets ──

    def register_target(self, name: str, fn) -> None:
        """The latest owner of a name wins."""
        with self._lock:
            self._targets[name] = fn
            if name == "collective":
                # A fresh exchange gets a fresh patience budget.
                self._straggler_fired = 0

    def unregister_target(self, name: str, fn=None) -> None:
        """With ``fn``, only if that callable is still the registered
        one."""
        with self._lock:
            if fn is None or self._targets.get(name) is fn:
                self._targets.pop(name, None)

    def target(self, name: str):
        with self._lock:
            return self._targets.get(name)

    # ── Snapshots ──

    def _snapshot(self, names: tuple[str, ...]) -> dict:
        """The tail samples of the named series: the evidence a decision
        was taken on (``before``) or left behind (``after``)."""
        store = timeline.STORE
        out: dict = {}
        with store._lock:
            for name in names:
                s = store._series.get(name)
                if s is None:
                    continue
                tail = list(s.ring)[-_SNAP_SAMPLES:]
                out[name] = [[t, v] for _seq, t, v in tail]
        return out

    # ── The decision spine ──

    def _decide(self, action: str, *, kind: str | None = None,
                sid: str | None = None, reason: str = "",
                series: tuple[str, ...] = (), execute=None,
                detail: dict | None = None, gated: bool = True) -> dict:
        """One decision: mask → token bucket → dry run → execute, and
        the decision recorded whatever the outcome. ``gated=False``
        skips mask and bucket, for the reversal legs (shed recovery)
        the rate limit must never block."""
        now = time.monotonic()
        detail = dict(detail or {})
        before = self._snapshot(series)
        outcome = "success"
        with self._lock:
            if gated and action not in _enabled_actions():
                outcome = "disabled"
            elif gated and not self._bucket(action).take(now):
                outcome = "rate_limited"
            elif execute is None:
                outcome = "no_target"
            elif self.dry_run:
                outcome = "dry_run"
        if outcome == "success":
            try:
                result = execute()
                if isinstance(result, dict):
                    detail.update(result)
            except Exception as exc:  # noqa: BLE001 - the control plane
                outcome = "failed"    # must never take the pull down
                detail["error"] = str(exc)
        after = self._snapshot(series)
        entry = {
            "t": round(time.time(), 3),
            "action": action,
            "outcome": outcome,
            "anomaly": kind,
            "session": sid,
            "reason": reason,
            "dry_run": self.dry_run,
            "detail": detail,
            "before": before,
            "after": after,
        }
        with self._lock:
            self._log.append(entry)
            key = (action, outcome)
            self.counts[key] = self.counts.get(key, 0) + 1
            if series:
                self._pending_after.append((entry, series))
        _M_REMEDIATIONS.inc(action=action, outcome=outcome)
        recorder.record(
            "remediation", action=action, outcome=outcome,
            anomaly=kind, session=sid, reason=reason,
            detail=detail, before=before, after=after)
        return entry

    def _bucket(self, action: str) -> _TokenBucket:
        b = self._buckets.get(action)
        if b is None:
            b = self._buckets[action] = _TokenBucket(self.burst,
                                                     self.rate_s)
        return b

    # ── Anomaly-driven actions ──

    def on_anomaly(self, kind: str, session, fields: dict) -> None:
        action = _KIND_TO_ACTION.get(kind)
        if action == "hedge":
            self._act_hedge(kind, session, fields)
        elif action == "strike":
            self._act_straggler(kind, fields)
        elif action == "shed":
            self._act_shed(kind, fields)

    def _act_hedge(self, kind: str, session, fields: dict) -> None:
        """A stall or collapse on a fetch-bound session arms the
        bridge's mid-flight hedge."""
        sid = getattr(session, "id", None)
        if sid is None:
            return
        phase = (fields or {}).get("phase") or getattr(session, "phase",
                                                       "")
        fn = self.target(f"hedge:{sid}")
        if fn is None:
            # No bridge for this session: not fetch-bound. Nothing to
            # drive, and no no_target row per stall of another phase.
            return
        self._decide(
            "hedge", kind=kind, sid=sid,
            reason=f"{kind} in phase {phase or '?'}",
            series=(f"session.{sid}.bytes", "fetch.cdn_bps",
                    "fetch.peer_bps"),
            execute=lambda: fn(f"anomaly:{kind}"),
            detail={"phase": phase})

    def _act_straggler(self, kind: str, fields: dict) -> None:
        """A collective straggler strikes the blamed partner; past the
        patience budget, the exchange aborts down the ladder."""
        partner = (fields or {}).get("partner")
        with self._lock:
            fn = self._targets.get("collective")
            self._straggler_fired += 1
            fired = self._straggler_fired
        if fn is None or partner is None:
            return
        cmd = "abort" if fired >= self.patience else "strike"
        self._decide(
            "strike", kind=kind,
            reason=(f"barrier straggler partner={partner} "
                    f"(firing {fired}/{self.patience})"),
            series=("collective.barrier_s", "collective.phase"),
            execute=lambda: fn(cmd, int(partner)),
            detail={"cmd": cmd, "partner": int(partner),
                    "barrier_wait_s": (fields or {}).get(
                        "barrier_wait_s")})

    def _act_shed(self, kind: str, fields: dict) -> None:
        """A stuck queue with an SLO burn projecting a breach sheds the
        lowest-deficit queued tenants (429 with Retry-After)."""
        fn = self.target("shed")
        if fn is None:
            return
        burn = _worst_burn()
        if burn < self.burn_max:
            self._decide(
                "shed", kind=kind,
                reason=(f"queue stuck but burn {burn:.3f} < "
                        f"{self.burn_max:.3f} — no breach projected"),
                series=("tenancy.queue_depth",),
                execute=lambda: {"skipped": True},
                detail={"burn": round(burn, 4), "cmd": "none"})
            return

        def _shed():
            out = fn("shed")
            with self._lock:
                self._shedding = True
            return out

        self._decide(
            "shed", kind=kind,
            reason=(f"queue stuck with SLO burn {burn:.3f} ≥ "
                    f"{self.burn_max:.3f}"),
            series=("tenancy.queue_depth", "tenancy.active_pulls"),
            execute=_shed,
            detail={"burn": round(burn, 4), "cmd": "shed",
                    "depth": (fields or {}).get("depth")})

    # ── Tick-driven actions ──

    def on_tick(self, store, now: float) -> None:
        self._settle_after()
        self._scan_seeders(now)
        self._maybe_recover_shed()
        self._tune_ring(store, now)
        self._pool_rules(store, now)

    def _settle_after(self) -> None:
        """Each recent decision's after-snapshot, one tick later: the
        series once the action had an interval to act."""
        with self._lock:
            pending, self._pending_after = self._pending_after, []
        for entry, series in pending:
            entry["after"] = self._snapshot(series)

    def _scan_seeders(self, now: float) -> None:
        """A collapsing seeder is demoted before its strike budget runs
        out: on near-budget strikes, repeated bad-kind strikes, or a
        served-bytes collapse with a strike. The demotion adds no
        strike."""
        with self._lock:
            monitor = self._targets.get("peer_health")
            demote = self._targets.get("demote")
        if monitor is None or demote is None:
            return
        try:
            view = monitor() or {}
        except Exception:  # noqa: BLE001 - a dying monitor drops out
            return
        budget = int(view.get("strike_budget", 3))
        for row in view.get("rows", ()):
            addr = row.get("peer")
            if not addr or row.get("quarantined_for_s"):
                continue
            served = float(row.get("served_bytes_recent") or 0.0)
            st = self._peers.setdefault(addr, {"peak": 0.0,
                                               "demoted_t": None})
            st["peak"] = max(st["peak"], served)
            if (st["demoted_t"] is not None
                    and now - st["demoted_t"] < self.observe_s):
                continue
            strikes = int(row.get("strikes") or 0)
            kinds = row.get("strike_kinds") or {}
            bad = sum(int(kinds.get(k, 0))
                      for k in _DEMOTE_EVIDENCE_KINDS)
            collapsing = (st["peak"] > _DEMOTE_COLLAPSE_FLOOR
                          and served < (_DEMOTE_COLLAPSE_FRACTION
                                        * st["peak"]))
            if strikes >= max(1, budget - 1):
                reason = (f"strikes {strikes} one short of "
                          f"budget {budget}")
            elif bad >= _DEMOTE_EVIDENCE_STRIKES:
                reason = f"{bad} bad-kind strikes ({dict(kinds)})"
            elif collapsing and strikes >= 1:
                reason = (f"served-bytes collapse "
                          f"{int(served)} < 25% of peak "
                          f"{int(st['peak'])} with a strike")
            else:
                continue
            st["demoted_t"] = now
            host, _, port = addr.rpartition(":")
            self._decide(
                "demote", reason=reason,
                series=("seed.bps", "fetch.peer_bps"),
                execute=lambda h=host, p=port: demote((h, int(p))),
                detail={"peer": addr, "strikes": strikes,
                        "served_recent": int(served)})

    def _maybe_recover_shed(self) -> None:
        """The reversal of the shed: once the burn falls under half the
        trigger, parked tenants re-admit. Ungated."""
        with self._lock:
            if not self._shedding:
                return
            fn = self._targets.get("shed")
        if fn is None:
            with self._lock:
                self._shedding = False
            return
        burn = _worst_burn()
        if burn >= self.burn_max / 2.0:
            return

        def _recover():
            out = fn("recover")
            with self._lock:
                self._shedding = False
            return out

        self._decide(
            "shed",
            reason=(f"burn recovered to {burn:.3f} < "
                    f"{self.burn_max / 2.0:.3f} — re-admitting"),
            series=("tenancy.queue_depth",),
            execute=_recover,
            detail={"burn": round(burn, 4), "cmd": "recover"},
            gated=False)

    # ── The knob tuner ──

    def set_knob_base(self, knob: str, base: int) -> None:
        """Pin a knob's configured base and rails (the landing calls it
        with the value the config resolved): the tuner moves only
        within [base, min(base × 8, absolute cap)]."""
        if knob != RING_KNOB:
            return
        with self._lock:
            k = self._knobs.get(knob)
            if k is not None and k["base"] == base:
                return
            self._knobs[knob] = {
                "base": int(base),
                "value": int(base),
                "min": int(base),
                "max": max(int(base),
                           min(int(base) * RING_GROWTH_CAP,
                               RING_ABS_CAP_BYTES)),
                "last_t": None,
                "last_dir": 0,
            }

    def knob_override(self, knob: str) -> int | None:
        """The tuner's override (None: the configured base)."""
        with self._lock:
            k = self._knobs.get(knob)
            if k is None or k["value"] == k["base"]:
                return None
            return int(k["value"])

    def _tune_ring(self, store, now: float) -> None:
        """``ring.stalls`` growth while a ring is live doubles the ring
        within its rails; a quiet observe window halves it back toward
        the base. One direction per window."""
        with store._lock:
            s = store._series.get("ring.stalls")
            stalls = s.ring[-1][2] if s is not None and s.ring else None
        with self._lock:
            k = self._knobs.get(RING_KNOB)
            if k is None:
                self._ring_last = stalls
                return
            last = self._ring_last
            self._ring_last = stalls
            grew = (stalls is not None and last is not None
                    and stalls > last)
            in_window = (k["last_t"] is not None
                         and now - k["last_t"] < self.observe_s)
            cur = k["value"]
            if grew and cur < k["max"]:
                # Damping: no nudge within the window of the last one,
                # either way (each doubling gets its own observation).
                if in_window:
                    return
                new, direction = min(k["max"], cur * 2), 1
            elif (not grew and stalls is not None and cur > k["min"]
                    and not in_window and k["last_t"] is not None):
                new, direction = max(k["min"], cur // 2), -1
            else:
                return
            if new == cur:
                return
        self._decide(
            "tune",
            reason=("ring stalls growing" if direction > 0
                    else f"quiet for {self.observe_s:.0f}s — easing "
                         "back toward base"),
            series=("ring.stalls", "ring.in_use_bytes"),
            execute=lambda: self._apply_knob(RING_KNOB, new, direction,
                                            now),
            detail={"knob": RING_KNOB, "from": cur, "to": new,
                    "dir": "up" if direction > 0 else "down"})

    def _pool_rules(self, store, now: float) -> None:
        """The serving pool's rules, both tick-driven: gate-stall growth
        with a land in flight rushes the layer flushes (``pool_land``,
        a ``hedge``); eviction growth sheds the coldest unpinned tree
        (``pool_shed``, a ``shed``)."""

        def _last(name: str) -> float | None:
            with store._lock:
                s = store._series.get(name)
                return (s.ring[-1][2]
                        if s is not None and s.ring else None)

        stall = _last("hbm_pool.gate_stall_s")
        evictions = _last("hbm_pool.evictions")
        landing = _last("hbm_pool.landing")
        with self._lock:
            stall_last, self._pool_stall_last = \
                self._pool_stall_last, stall
            evict_last, self._pool_evict_last = \
                self._pool_evict_last, evictions
            land_fn = self._targets.get("pool_land")
            shed_fn = self._targets.get("pool_shed")
        stall_grew = (stall is not None and stall_last is not None
                      and stall > stall_last + 1e-9)
        if stall_grew and landing and land_fn is not None:
            self._decide(
                "hedge",
                reason=(f"pool gate stall grew to {stall:.2f}s with a "
                        "land in flight — rushing layer flushes"),
                series=("hbm_pool.gate_stall_s", "hbm_pool.landing",
                        "hbm_pool.resident_bytes"),
                execute=lambda: land_fn("rush"),
                detail={"cmd": "rush", "gate_stall_s": round(stall, 3)})
        evict_grew = (evictions is not None and evict_last is not None
                      and evictions > evict_last)
        if evict_grew and shed_fn is not None:
            self._decide(
                "shed",
                reason=(f"pool thrash: evictions grew to "
                        f"{int(evictions)} — shedding the coldest "
                        "model"),
                series=("hbm_pool.evictions", "hbm_pool.resident_bytes",
                        "hbm_pool.pinned_bytes"),
                execute=lambda: shed_fn("shed_coldest"),
                detail={"cmd": "shed_coldest",
                        "evictions": int(evictions)})

    def _apply_knob(self, knob: str, new: int, direction: int,
                    now: float) -> dict:
        with self._lock:
            k = self._knobs[knob]
            k["value"] = int(new)
            k["last_t"] = now
            k["last_dir"] = direction
        return {"applied": int(new)}

    # ── Read side ──

    def payload(self, limit: int = 50) -> dict:
        with self._lock:
            recent = [dict(e) for e in list(self._log)[-limit:]]
            counts: dict[str, dict[str, int]] = {}
            for (action, outcome), n in sorted(self.counts.items()):
                counts.setdefault(action, {})[outcome] = n
            knobs = {name: {kk: vv for kk, vv in k.items()
                            if kk != "last_t"}
                     for name, k in self._knobs.items()}
            return {
                "enabled": True,
                "dry_run": self.dry_run,
                "actions": sorted(_enabled_actions()),
                "rate_s": self.rate_s,
                "burst": self.burst,
                "patience": self.patience,
                "burn_max": self.burn_max,
                "observe_s": self.observe_s,
                "shedding": self._shedding,
                "knobs": knobs,
                "counts": counts,
                "targets": sorted(self._targets),
                "recent": recent,
            }

    def status_block(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "dry_run": self.dry_run,
                "decisions": sum(self.counts.values()),
                "shedding": self._shedding,
            }


def _worst_burn() -> float:
    """The worst SLO burn ratio over the armed SLOs (breaches over pulls,
    from the session table): the breach projection behind the shed."""
    try:
        burns = session_mod.SESSIONS.slo_burn()
    except Exception:  # noqa: BLE001 - advisory
        return 0.0
    worst = 0.0
    for row in burns.values():
        b = row.get("burn")
        if isinstance(b, (int, float)):
            worst = max(worst, float(b))
    return worst


def _env_float(name: str, default: float, floor: float) -> float:
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if v >= floor else default


def _env_int(name: str, default: int, floor: int) -> int:
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    return v if v >= floor else default


# ── The process-wide engine and hooks ──

ENGINE: RemediationEngine | None = None
_engine_lock = threading.Lock()
_subscribed = False


def ensure_started() -> bool:
    """Build the engine and subscribe it to the anomaly and tick streams
    (idempotent). False, and nothing built, when off."""
    if not enabled():
        return False
    global ENGINE, _subscribed
    with _engine_lock:
        if ENGINE is None:
            ENGINE = RemediationEngine()
        if not _subscribed:
            timeline.add_anomaly_listener(_on_anomaly)
            timeline.add_tick_listener(_on_tick)
            _subscribed = True
    return True


def _on_anomaly(kind: str, session, fields: dict) -> None:
    eng = ENGINE
    if eng is not None and enabled():
        eng.on_anomaly(kind, session, fields)


def _on_tick(store, now: float) -> None:
    eng = ENGINE
    if eng is not None and enabled():
        eng.on_tick(store, now)


def register_target(name: str, fn) -> bool:
    """Inject an action target (``hedge:<sid>``, ``collective``,
    ``shed``, ``demote``, ``peer_health``, ``pool_land``,
    ``pool_shed``). False, and nothing kept, when off."""
    if not ensure_started():
        return False
    ENGINE.register_target(name, fn)
    return True


def unregister_target(name: str, fn=None) -> None:
    eng = ENGINE
    if eng is not None:
        eng.unregister_target(name, fn)


def invoke(name: str, *args):
    """Call the target registered under ``name`` directly, as a decision
    would but outside the rails; None when there is none."""
    eng = ENGINE
    fn = None if eng is None else eng.target(name)
    return None if fn is None else fn(*args)


def set_knob_base(knob: str, base: int) -> None:
    if ensure_started():
        ENGINE.set_knob_base(knob, base)


def knob_override(knob: str) -> int | None:
    eng = ENGINE
    if eng is None or not enabled():
        return None
    return eng.knob_override(knob)


def set_dry_run(on: bool) -> bool:
    """The ``zest heal --dry-run`` toggle (``POST /v1/remediations``);
    returns the dry-run state now in effect."""
    if not ensure_started():
        return False
    ENGINE.dry_run = bool(on)
    return ENGINE.dry_run


def payload(limit: int = 50) -> dict:
    """The ``GET /v1/remediations`` document (an ``enabled: false`` stub
    when off)."""
    eng = ENGINE
    if not enabled() or eng is None:
        return {"enabled": enabled(), "counts": {}, "recent": []}
    return eng.payload(limit=limit)


def status_block() -> dict:
    """The ``remediation`` block of ``/v1/status``."""
    eng = ENGINE
    if not enabled() or eng is None:
        return {"enabled": enabled()}
    return eng.status_block()


def reset() -> None:
    """Tests: drop the engine, unsubscribe, back to the environment."""
    global ENGINE, _subscribed
    with _engine_lock:
        ENGINE = None
        _subscribed = False
    set_enabled(None)
