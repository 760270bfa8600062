"""Flight recorder: a bounded ring of the last N *notable* events.

The counterpart of ``zest_tpu/telemetry/recorder.py``. Every notable
event (a pool eviction, landing or swap, a degraded delta pull, an SLO
breach) lands in one process-wide ring with a wall-clock timestamp, the
thread's innermost open span and the trace context; the ring holds
``ZEST_RECORDER_EVENTS`` events (512 by default) and can be dumped as a
JSON crash report. With ``ZEST_TELEMETRY=0``, :func:`record` is one flag
check.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from zest_tpu_torch.telemetry import state, trace

ENV_EVENTS = "ZEST_RECORDER_EVENTS"
DEFAULT_EVENTS = 512

# Session attribution: an injected ``fn() -> session id or None`` that a
# pull-session table registers (the recorder must not import one: it
# would invert the package's dependency order). None until one does.
_session_resolver = None


def set_session_resolver(fn) -> None:
    global _session_resolver
    _session_resolver = fn


def _current_session() -> str | None:
    if _session_resolver is None:
        return None
    try:
        return _session_resolver()
    except Exception:  # noqa: BLE001 - attribution must never break recording
        return None


class FlightRecorder:
    """Thread-safe bounded event ring for one process."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(ENV_EVENTS, DEFAULT_EVENTS))
            except ValueError:
                capacity = DEFAULT_EVENTS
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self.recorded = 0  # lifetime count (ring length caps at capacity)

    def record(self, kind: str, /, **fields) -> None:
        ev: dict = {"t": round(time.time(), 6), "kind": kind}
        spans = trace.open_spans()
        if spans:
            ev["span"] = spans[-1]
        ctx = trace.current_context()
        if ctx:
            ev.update({k: v for k, v in ctx.items() if k not in ev})
        sid = _current_session()
        if sid is not None and "session" not in ev:
            ev["session"] = sid
        for k, v in fields.items():
            if v is None:
                continue
            if k in ("t", "kind"):  # field names the envelope owns
                k = f"{k}_"
            if isinstance(v, (str, int, float, bool)):
                ev[k] = v
            elif isinstance(v, (dict, list, tuple)):
                # Structured payloads (the remediation events' before/
                # after timeline snapshots) stay machine-
                # readable when JSON-clean; anything dirtier falls back
                # to the scalar coercion below.
                try:
                    json.dumps(v)
                except (TypeError, ValueError):
                    ev[k] = str(v)
                else:
                    ev[k] = list(v) if isinstance(v, tuple) else v
            else:
                ev[k] = str(v)
        with self._lock:
            self._ring.append(ev)
            self.recorded += 1

    def tail(self, n: int | None = None) -> list[dict]:
        with self._lock:
            events = list(self._ring)
        if n is None:
            return events
        return events[-n:] if n > 0 else []  # [-0:] would be ALL

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.recorded = 0

    # ── Crash report ──

    def report(self, reason: str = "") -> dict:
        ctx = trace.current_context()
        doc = {
            "tool": "zest-tpu",
            "kind": "flight-recorder",
            "reason": reason,
            "dumped_at": round(time.time(), 6),
            "pid": os.getpid(),
            "capacity": self.capacity,
            "recorded_total": self.recorded,
            "events": self.tail(),
        }
        if ctx:
            doc["context"] = ctx
        sid = _current_session()
        if sid is not None:
            doc["session"] = sid
        return doc

    def dump(self, path: str | os.PathLike, reason: str = "") -> str:
        """Write the crash-report JSON (atomic tmp+rename, same
        discipline as the trace export); returns the path written."""
        path = os.fspath(path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.report(reason), f, indent=1)
        os.replace(tmp, path)
        return path


# ── Process-wide instance + module-level hooks ──

RECORDER = FlightRecorder()


def record(kind: str, /, **fields) -> None:
    """The hot-path hook: one flag check when telemetry is off."""
    if not state.enabled():
        return
    RECORDER.record(kind, **fields)


def tail(n: int | None = None) -> list[dict]:
    return RECORDER.tail(n)


def dump_crash_report(cache_dir, reason: str) -> str | None:
    """Dump under ``{cache_dir}/crash/`` with a timestamped name; None
    when telemetry is off or the ring is empty (an empty report would
    only bury the real one). Best-effort: a failing dump must never
    mask the exception that triggered it."""
    if not state.enabled() or not RECORDER.tail(1):
        return None
    try:
        name = f"zest-crash-{int(time.time())}-{os.getpid()}.json"
        return RECORDER.dump(os.path.join(os.fspath(cache_dir),
                                          "crash", name), reason)
    except OSError:
        return None


def reset() -> None:
    """Tests: fresh ring at the env-configured capacity."""
    global RECORDER
    RECORDER = FlightRecorder()
