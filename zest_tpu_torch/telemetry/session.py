"""Pull sessions: every pull as a first-class observable.

The counterpart of ``zest_tpu/telemetry/session.py``. The process metrics
answer "what has this host done across every pull"; the session table is
the per-pull layer: a process-global, bounded registry of live and
recently finished pulls, each with its identity (id, ``repo@sha``,
tenant), live phase and byte progress, an ETA, and once terminal the
pull's stats dict.

A session holds *references* to the pull's own instrumentation (the
``transfer.pull.StageClock`` and the bridge's ``FetchStats``) and computes
every snapshot at read time. The only push-style hook is the StageClock's
per-stage-entry observer (a handful of calls per pull, never per chunk),
which drives the live ``phase`` field and wakes SSE streams.

Surfaces built on the table: ``GET /v1/pulls`` (active + recent ring),
``GET /v1/pulls/<id>``, the SSE progress stream ``GET
/v1/pulls/<id>/events``, ``DELETE /v1/pulls/<id>`` (through the session's
cancel token), ``zest ps``, and the flight recorder's session stamp
(:func:`current_id` is its resolver).

With ``ZEST_TELEMETRY=0`` :func:`begin` returns ``None`` and the table
stays empty: the pull is the pull without sessions.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from zest_tpu_torch.telemetry import recorder, state

ENV_RECENT = "ZEST_SESSIONS_RECENT"
DEFAULT_RECENT = 32

# Display rank of a concurrently-open stage set: the landing outranks
# the background file lane, payload movement outranks metadata. An
# unknown stage ranks lowest but still displays when it's all there is.
_PHASE_RANK = {
    "files": 1,
    "resolve": 2,
    "cas_metadata": 3,
    "fetch": 4,
    "decode": 5,
    "hbm_commit": 6,
}


class PullSession:
    """One pull's live identity + progress. Snapshots are computed at
    read time from the attached clock/stats objects; mutation is
    limited to the coarse lifecycle hooks (phase, revision, totals,
    terminal state), each of which bumps ``version`` and notifies the
    condition SSE streams wait on."""

    def __init__(self, sid: str, repo: str, revision: str,
                 tenant: str | None, device: str | None):
        self.id = sid
        self.repo = repo
        self.revision = revision  # ref at begin; resolved sha once known
        self.tenant = tenant
        self.device = device
        self.started_at = round(time.time(), 6)
        self._t0 = time.monotonic()
        # running | ok | error | cancelled | rejected (admission 429)
        self.status = "running"
        self.error: str | None = None
        self.phase = "starting"
        # The pull's cancellation token (transfer.tenancy.CancelToken),
        # attached by pull_model so DELETE /v1/pulls/<id> and the SSE
        # disconnect path can abort the session; None for sessions that
        # predate the token (or were registered outside pull_model).
        self.cancel_token = None
        self.total_bytes: int | None = None  # pending payload, when known
        self.stats: dict | None = None       # terminal stats dict ref
        self.slo: dict = {}                  # slo -> breach info
        self.anomalies: dict = {}            # anomaly kind -> info
        self.ended_at: float | None = None
        self._ended_t: float | None = None
        self._clock = None
        self._fetch = None
        self._open: dict[str, int] = {}
        self._cv = threading.Condition()
        self.version = 0

    # ── Hooks (called from the pull, coarse-grained) ──

    def attach(self, clock=None, fetch_stats=None) -> None:
        """Wire the pull's existing instrumentation in: the StageClock
        (its observer drives ``phase``) and the bridge's FetchStats
        (read lazily for byte progress). No code path changes shape —
        the session only *watches* objects the pull already updates."""
        if clock is not None:
            self._clock = clock
            clock.observer = self._on_stage
        if fetch_stats is not None:
            self._fetch = fetch_stats

    def set_revision(self, sha: str) -> None:
        with self._cv:
            self.revision = sha
            self.version += 1
            self._cv.notify_all()

    def set_total_bytes(self, n: int) -> None:
        with self._cv:
            self.total_bytes = max(0, int(n))
            self.version += 1
            self._cv.notify_all()

    def set_phase(self, phase: str) -> None:
        """Direct phase override for lifecycle states outside the
        StageClock's view — ``queued`` while parked in the admission
        queue, back to ``starting`` on admit. Stage-observer updates
        keep flowing through :meth:`_on_stage` unchanged."""
        with self._cv:
            if phase != self.phase:
                self.phase = phase
                self.version += 1
                self._cv.notify_all()

    def cancel(self, reason: str = "cancelled") -> bool:
        """Fire the session's cancel token (``DELETE /v1/pulls/<id>``).
        False when the session has no token or is already terminal."""
        token = self.cancel_token
        if token is None or self.status != "running":
            return False
        token.cancel(reason)
        return True

    def note_slo(self, slo: str, info: dict) -> None:
        with self._cv:
            self.slo[slo] = dict(info)
            self.version += 1
            self._cv.notify_all()

    def note_anomaly(self, kind: str, info: dict | None = None) -> None:
        """Anomaly annotation: a detector stamps the live session so
        ``/v1/pulls`` shows the anomaly next to the pull it belongs to.
        Keyed by kind — a re-fired episode updates in place (bounded by
        the handful of anomaly kinds, never per-tick growth)."""
        with self._cv:
            row = dict(info or {})
            row["t"] = round(time.time(), 3)
            self.anomalies[kind] = row
            self.version += 1
            self._cv.notify_all()

    def _on_stage(self, stage: str, entered: bool) -> None:
        """StageClock observer: maintain the open-stage multiset and
        derive the display phase (highest-ranked open stage; the last
        exited stage when nothing is open)."""
        with self._cv:
            n = self._open.get(stage, 0) + (1 if entered else -1)
            if n <= 0:
                self._open.pop(stage, None)
            else:
                self._open[stage] = n
            if self._open:
                phase = max(self._open, key=lambda s: _PHASE_RANK.get(s, 0))
            else:
                phase = stage
            if phase != self.phase:
                self.phase = phase
                self.version += 1
                self._cv.notify_all()

    def finish(self, status: str, error: str | None = None,
               stats: dict | None = None) -> None:
        with self._cv:
            self.status = status
            self.error = error
            self.stats = stats
            self._ended_t = time.monotonic()
            self.ended_at = round(time.time(), 6)
            if status == "ok":
                self.phase = "done"
            elif status in ("cancelled", "rejected"):
                self.phase = status
            self.version += 1
            self._cv.notify_all()

    # ── Read side ──

    def wait(self, version: int, timeout: float = 1.0) -> int:
        """Block until the session's version moves past ``version`` (or
        the timeout lapses — the SSE heartbeat); returns the current
        version either way."""
        with self._cv:
            if self.version == version and self.status == "running":
                self._cv.wait(timeout)
            return self.version

    def _bytes_block(self) -> dict | None:
        f = self._fetch
        if f is None:
            return None
        block = {
            "cache": f.bytes_from_cache,
            "peer": f.bytes_from_peer,
            "cdn": f.bytes_from_cdn,
        }
        if self.total_bytes is not None:
            block["total"] = self.total_bytes
        return block

    def snapshot(self, detail: bool = False) -> dict:
        """JSON-friendly view. The list view (``detail=False``) is the
        ``/v1/pulls`` row; ``detail=True`` adds the live stage walls
        and, once terminal, the pull's full stats dict."""
        with self._cv:
            status, error, phase = self.status, self.error, self.phase
            version, slo = self.version, dict(self.slo)
            anomalies = dict(self.anomalies)
            ended_t, ended_at = self._ended_t, self.ended_at
            stats = self.stats
        end = ended_t if ended_t is not None else time.monotonic()
        elapsed = max(0.0, end - self._t0)
        doc: dict = {
            "id": self.id,
            "repo": self.repo,
            "revision": self.revision,
            "status": status,
            "phase": phase,
            "started_at": self.started_at,
            "elapsed_s": round(elapsed, 3),
            "version": version,
        }
        if self.tenant:
            doc["tenant"] = self.tenant
        if self.device:
            doc["device"] = self.device
        b = self._bytes_block()
        if b is not None:
            doc["bytes"] = b
            done = b["cache"] + b["peer"] + b["cdn"]
            total = b.get("total")
            if status == "ok":
                doc["progress"] = 1.0
            elif total:
                # Approximate by design: the tiers count wire/cache blob
                # bytes (compressed) against the uncompressed payload
                # total — good enough for a progress bar, never for
                # accounting (stats are the accounting).
                doc["progress"] = round(min(done / total, 0.99), 4)
                # ETA only while RUNNING: an errored session's frozen
                # partial progress is honest, an ETA for a pull that
                # will never finish is not.
                if status == "running" and 0 < done < total \
                        and elapsed > 0.05:
                    rate = done / elapsed
                    doc["eta_s"] = round((total - done) / rate, 1)
        if ended_at is not None:
            doc["ended_at"] = ended_at
        if error:
            doc["error"] = error
        if slo:
            doc["slo"] = slo
        if anomalies:
            doc["anomalies"] = anomalies
        if stats is not None:
            for k in ("time_to_hbm_s", "time_to_first_layer_s",
                      "time_to_swap_s", "peer_served_ratio"):
                if stats.get(k) is not None:
                    doc[k] = stats[k]
        if detail:
            clock = self._clock
            if clock is not None:
                doc["stages"] = clock.summary()
            if stats is not None:
                doc["stats"] = stats
        return doc

    def landing_block(self) -> dict | None:
        """This session's landing values in the ``/v1/debug`` block's
        shape — the per-session replacement for the clobber-prone
        ``zest_last_pull_*`` process gauges. None until the session is
        terminal with a --device landing."""
        stats = self.stats
        if not stats or stats.get("time_to_hbm_s") is None:
            return None
        landing: dict = {"session": self.id,
                         "time_to_hbm_s": stats["time_to_hbm_s"]}
        fl = stats.get("time_to_first_layer_s")
        if fl is not None:
            landing["first_layer_s"] = fl
            landing["first_layer_ratio"] = round(
                fl / stats["time_to_hbm_s"], 4) \
                if stats["time_to_hbm_s"] else None
            stalls = ((stats.get("hbm") or {}).get("ring") or {}).get(
                "stalls", 0)
            if stalls:
                landing["ring_stalls"] = int(stalls)
        delta = stats.get("delta")
        if delta is not None:
            ratio = delta.get("fetched_ratio",
                              delta.get("delta_bytes_ratio"))
            if ratio is not None:
                landing["delta_ratio"] = ratio
        swap = stats.get("time_to_swap_s")
        if swap is not None:
            landing["swap_s"] = swap
        return landing


class SessionTable:
    """Process-global bounded registry: live sessions plus a ring of
    the most recent terminal ones (``ZEST_SESSIONS_RECENT``, default
    32) — bounded cardinality by construction, so every surface built
    on it (endpoints, recorder stamps, the debug landing block) is
    safe in a long-lived daemon."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(ENV_RECENT, DEFAULT_RECENT))
            except ValueError:
                capacity = DEFAULT_RECENT
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._active: dict[str, PullSession] = {}
        self._recent: deque[PullSession] = deque(maxlen=self.capacity)
        self._seq = 0
        # SLO burn accounting: slo -> [evaluated pulls, breaches].
        self._slo_counts: dict[str, list[int]] = {}

    def begin(self, repo: str, revision: str = "main",
              tenant: str | None = None,
              device: str | None = None) -> PullSession:
        # Tenant resolution lives with the caller (pull_model: explicit
        # argument, else Config.tenant from ZEST_TENANT): a second env
        # read here would override an embedder's explicit Config.
        with self._lock:
            self._seq += 1
            sid = f"p{self._seq:04d}-{os.urandom(3).hex()}"
            sess = PullSession(sid, repo, revision, tenant, device)
            self._active[sid] = sess
        return sess

    def finish(self, sess: PullSession, status: str,
               error: str | None = None,
               stats: dict | None = None) -> None:
        # Terminal transition AND the active→recent move under ONE
        # table-lock hold: marking terminal first would let a
        # concurrent payload() list a finished session under "active";
        # moving first would make it vanish from both lists. Lock
        # order is table → session everywhere (payload() snapshots the
        # same way); no session method reaches back into the table.
        with self._lock:
            sess.finish(status, error=error, stats=stats)
            self._active.pop(sess.id, None)
            self._recent.append(sess)
        # Eviction listeners run OUTSIDE the lock (they reach into
        # other modules — lock order is table → session only).
        for cb in list(_evict_listeners):
            try:
                cb(sess.id)
            except Exception:  # noqa: BLE001 - observers must not
                pass           # break the terminal transition

    def note_slo(self, slo: str, breached: bool) -> None:
        with self._lock:
            row = self._slo_counts.setdefault(slo, [0, 0])
            row[0] += 1
            if breached:
                row[1] += 1

    def get(self, sid: str) -> PullSession | None:
        with self._lock:
            sess = self._active.get(sid)
            if sess is not None:
                return sess
            for s in self._recent:
                if s.id == sid:
                    return s
        return None

    def active(self) -> list[PullSession]:
        with self._lock:
            return list(self._active.values())

    def active_ids(self) -> list[str]:
        with self._lock:
            return list(self._active)

    def recent(self) -> list[PullSession]:
        """Newest first."""
        with self._lock:
            return list(self._recent)[::-1]

    def slo_burn(self) -> dict:
        """Process-lifetime burn per armed SLO: evaluated pulls,
        breaches, and the burn ratio (the error-budget spend rate a
        fleet scrape divides against its budget window)."""
        with self._lock:
            counts = {k: list(v) for k, v in self._slo_counts.items()}
        return {
            slo: {"pulls": pulls, "breaches": breaches,
                  "burn": round(breaches / pulls, 4) if pulls else 0.0}
            for slo, (pulls, breaches) in sorted(counts.items())
        }

    def payload(self) -> dict:
        """The ``GET /v1/pulls`` document. Both lists are captured
        under ONE lock acquisition (a pull finishing between two
        separate reads would appear in `active` AND `recent` — a
        duplicated row in `zest ps`/the dashboard), and the active
        rows are re-filtered to still-running after snapshotting: a
        session that went terminal between the capture and its
        snapshot drops out for one tick (the next read shows it under
        `recent`) instead of rendering a finished pull as active."""
        with self._lock:
            active = list(self._active.values())
            recent = list(self._recent)[::-1]
        active_rows = [s.snapshot() for s in active]
        doc = {
            "active": [r for r in active_rows
                       if r["status"] == "running"],
            "recent": [s.snapshot() for s in recent],
            "capacity": self.capacity,
        }
        burn = self.slo_burn()
        if burn:
            doc["slo"] = burn
        return doc

    def last_landing(self) -> dict | None:
        """The most recent terminal session's landing block — what the
        ``/v1/debug`` landing panel renders. Session-scoped, so two
        concurrent pulls can never cross-contaminate it the way the
        process-global ``zest_last_pull_*`` gauges do."""
        for sess in self.recent():
            block = sess.landing_block()
            if block is not None:
                return block
        return None


# ── Process-wide instance + module-level hooks ──

SESSIONS = SessionTable()

_tls = threading.local()

# Module-wired like the recorder's session resolver below: survives
# SessionTable swaps AND reset(), so a listener registered once keeps
# hearing evictions from every future table.
_evict_listeners: list = []


def add_evict_listener(cb) -> None:
    """``cb(sid)`` after a session's terminal transition (the id left
    the active table). Idempotent."""
    if cb not in _evict_listeners:
        _evict_listeners.append(cb)


def begin(repo: str, revision: str = "main", tenant: str | None = None,
          device: str | None = None) -> PullSession | None:
    """Register a session, or ``None`` with ``ZEST_TELEMETRY=0`` (the
    knob-off contract: an empty table, zero bookkeeping)."""
    if not state.enabled():
        return None
    return SESSIONS.begin(repo, revision, tenant=tenant, device=device)


def finish(sess: PullSession | None, status: str,
           error: str | None = None, stats: dict | None = None) -> None:
    if sess is None:
        return
    SESSIONS.finish(sess, status, error=error, stats=stats)


def get(sid: str) -> PullSession | None:
    return SESSIONS.get(sid)


def payload() -> dict:
    return SESSIONS.payload()


def last_landing() -> dict | None:
    return SESSIONS.last_landing()


def use(sid: str | None) -> None:
    """Bind this thread to a session id (worker-thread inheritance —
    pools capture the id at construction and re-bind per task)."""
    _tls.sid = sid


class bind:
    """Context manager binding the calling thread to a session id for
    the block (``None`` is a no-op bind — the knob-off path)."""

    def __init__(self, sid: str | None):
        self._sid = sid
        self._prev: str | None = None

    def __enter__(self) -> "bind":
        self._prev = getattr(_tls, "sid", None)
        _tls.sid = self._sid
        return self

    def __exit__(self, *exc) -> None:
        _tls.sid = self._prev


def current_id() -> str | None:
    """The session this thread's work belongs to: the thread binding
    when set, else — the common daemon case — the sole active session.
    With several concurrent pulls an unbound thread resolves to None
    (no stamp) rather than guessing wrong."""
    sid = getattr(_tls, "sid", None)
    if sid:
        return sid
    active = SESSIONS.active_ids()
    if len(active) == 1:
        return active[0]
    return None


def reset() -> None:
    """Tests: fresh table at the env-configured capacity."""
    global SESSIONS
    SESSIONS = SessionTable()
    _tls.sid = None


# Flight-recorder attribution: every recorded event — and the
# crash-report envelope — carries the session id of the pull it belongs
# to, so a busy daemon's event tail reads per pull.
recorder.set_session_resolver(current_id)
