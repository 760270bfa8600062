"""Span tracer: nested wall-clock spans → Chrome/Perfetto trace JSON.

The counterpart of ``zest_tpu/telemetry/trace.py``, exporting the same
``trace_event`` schema: ``span("hbm_pool.land", repo=...)`` records one
complete (``ph: "X"``) event per exit with its wall interval, thread and
attributes (plus byte counts via :meth:`Span.add_bytes`).

``ZEST_TRACE=path`` arms a process-global tracer whose file is written at
interpreter exit; :func:`install`/:func:`reset` serve tests. With no
tracer armed, :func:`span` returns a shared no-op span. A tracer keeps at
most :data:`MAX_SPANS` spans and counts the ones it drops.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time

from zest_tpu_torch.telemetry import state

ENV_TRACE = "ZEST_TRACE"

# Hard cap on buffered spans per tracer (drops are counted, not silent).
MAX_SPANS = 500_000

# ── Trace context (fleet correlation) ──
#
# A pod-scale pull is N processes emitting N traces; what correlates
# them is a shared ``trace_id`` plus a per-process ``host`` index
# stamped on every span. Two scopes:
#
# - the *process* context (``set_context``): one host = one process in
#   production, so stamping happens once at export time — zero per-span
#   cost on the hot path;
# - a *thread* context (``context()`` manager / ``use_context``): the
#   in-process multi-host simulations (tests, the 8-device dryrun
#   smoke) run each "host" as a thread of one process; their spans are
#   stamped at record time so the merged trace can still split them
#   into per-host tracks. Threads spawned inside a round must inherit
#   explicitly (``current_context()`` → ``use_context``) — Python
#   thread-locals do not propagate.

_base_context: dict = {}
_tls = threading.local()


def set_context(**attrs) -> None:
    """Merge ``attrs`` into the process-global trace context (stamped on
    every exported event and recorded in the trace metadata). A value of
    ``None`` removes the key."""
    for k, v in attrs.items():
        if v is None:
            _base_context.pop(k, None)
        else:
            _base_context[k] = v


def clear_context() -> None:
    _base_context.clear()
    _tls.ctx = {}


def current_context() -> dict:
    """Effective context for this thread: process base < thread overlay.
    Pass the result to :func:`use_context` in worker threads a traced
    round spawns."""
    out = dict(_base_context)
    out.update(getattr(_tls, "ctx", None) or {})
    return out


def base_context() -> dict:
    """Snapshot of the process-global context (for save/restore around
    a scope that installs its own — pull_model restores the previous
    context at exit so a daemon's NEXT pull never exports under a
    stale trace_id)."""
    return dict(_base_context)


def replace_context(ctx: dict) -> None:
    """Replace the process-global context wholesale (the restore half
    of :func:`base_context`)."""
    _base_context.clear()
    _base_context.update(ctx or {})


def use_context(ctx: dict | None) -> None:
    """Replace this thread's context overlay (worker-thread inheritance)."""
    _tls.ctx = dict(ctx) if ctx else {}


class context:
    """Thread-local context overlay for a ``with`` block (simulated
    hosts; restores the previous overlay on exit)."""

    def __init__(self, **attrs):
        self._attrs = attrs
        self._prev: dict | None = None

    def __enter__(self) -> "context":
        self._prev = getattr(_tls, "ctx", None) or {}
        merged = dict(self._prev)
        merged.update(self._attrs)
        _tls.ctx = merged
        return self

    def __exit__(self, *exc) -> None:
        _tls.ctx = self._prev or {}


def open_spans() -> tuple[str, ...]:
    """Names of the spans currently open on THIS thread, outermost
    first — the flight recorder stamps events with this to anchor them
    in the trace without holding span references."""
    return tuple(s.name for s in getattr(_tls, "stack", ()) or ())


class Span:
    """One finished (or in-flight) span. Context-manager protocol; the
    ``with`` target supports ``set(key, value)`` / ``add_bytes(n)`` so
    call sites can attach results discovered mid-span (bytes served,
    source tier, error class)."""

    __slots__ = ("name", "attrs", "t0", "t1", "tid", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.t1 = 0.0
        self.tid = 0

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def add_bytes(self, n: int) -> None:
        self.attrs["bytes"] = self.attrs.get("bytes", 0) + int(n)

    def __enter__(self) -> "Span":
        self.t0 = time.monotonic()
        self.tid = threading.get_ident()
        # Context stamp at RECORD time (base < thread overlay; explicit
        # attrs win, so the overlay must stamp before the base): the
        # span keeps the identity that was true when it ran, and a
        # daemon clearing the context after one pull cannot
        # retroactively restamp (or unstamp) earlier spans at export.
        tctx = getattr(_tls, "ctx", None)
        if tctx:
            for k, v in tctx.items():
                self.attrs.setdefault(k, v)
        if _base_context:
            for k, v in _base_context.items():
                self.attrs.setdefault(k, v)
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        self.t1 = time.monotonic()
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        elif stack:  # defensive: out-of-order exit must not wedge the stack
            try:
                stack.remove(self)
            except ValueError:
                pass
        if exc_type is not None:
            # The error *class* only: messages can carry URLs/paths and
            # the trace file may be shared more widely than logs.
            self.attrs["error"] = exc_type.__name__
        self._tracer._record(self)


class _NullSpan:
    """Shared no-op span: tracing disabled costs one attribute load."""

    __slots__ = ()

    def set(self, key: str, value) -> None:
        pass

    def add_bytes(self, n: int) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span recorder for one process (normally one pull)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self.dropped = 0
        # Anchors mapping monotonic span times to an absolute epoch, so
        # traces from several hosts of one pod can be laid side by side.
        self.t_origin = time.monotonic()
        self.epoch_origin = time.time()
        # Free-form export metadata (clock-offset estimates, peer maps):
        # merged into the exported doc's ``otherData``.
        self.metadata: dict = {}

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def add_metadata(self, **kv) -> None:
        with self._lock:
            for k, v in kv.items():
                self.metadata[k] = v

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) >= MAX_SPANS:
                self.dropped += 1
            else:
                self._spans.append(span)
                return
        # Outside the lock: the overflow used to be invisible outside
        # the process — now it is a first-class metric a fleet scrape can
        # alert on.
        from zest_tpu_torch.telemetry import metrics as _metrics

        _metrics.counter(
            "zest_trace_spans_dropped_total",
            "Spans dropped at the tracer's MAX_SPANS ring bound",
        ).inc()

    # ── Introspection ──

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def coverage_s(self, prefix: str | None = None) -> float:
        """Union wall-clock coverage of recorded spans (optionally only
        those whose name starts with ``prefix``) — the acceptance
        denominator: a trace is useful when its spans cover ~all of the
        pull's wall time, not a sliver of it."""
        with self._lock:
            ivs = sorted(
                (s.t0, s.t1) for s in self._spans
                if prefix is None or s.name.startswith(prefix)
            )
        total, end = 0.0, float("-inf")
        for s, e in ivs:
            if s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    # ── Export (Chrome trace_event JSON) ──

    def to_chrome(self) -> dict:
        """``{"traceEvents": [...]}`` — the Trace Event Format's JSON
        object form. Spans become ``ph: "X"`` complete events with
        microsecond ``ts``/``dur``; viewers nest same-track events by
        containment, which matches how our spans actually nest (a span
        opened inside another on the same thread closes inside it)."""
        pid = os.getpid()
        base = dict(_base_context)
        pname = "zest-tpu"
        if "host" in base:
            pname = f"zest-tpu host {base['host']}"
        events: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": pname}},
        ]
        with self._lock:
            spans = list(self._spans)
            dropped = self.dropped
            metadata = dict(self.metadata)
        for s in spans:
            ev = {
                "name": s.name,
                "ph": "X",
                "ts": round((s.t0 - self.t_origin) * 1e6, 1),
                "dur": round((s.t1 - s.t0) * 1e6, 1),
                "pid": pid,
                "tid": s.tid,
                "cat": s.name.split(".", 1)[0],
            }
            # Context attrs (trace_id/host) were stamped at RECORD time
            # (Span.__enter__) — stamping here instead would let a
            # context installed later claim spans that ran before it.
            if s.attrs:
                ev["args"] = {k: _jsonable(v) for k, v in s.attrs.items()}
            events.append(ev)
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "tool": "zest-tpu",
                "epoch_origin_s": round(self.epoch_origin, 6),
                "spans": len(spans),
            },
        }
        if base:
            doc["otherData"]["context"] = {
                k: _jsonable(v) for k, v in base.items()}
        if metadata:
            for k, v in metadata.items():
                doc["otherData"][k] = _jsonable_deep(v)
        if dropped:
            doc["otherData"]["dropped_spans"] = dropped
        return doc

    def export(self, path: str | os.PathLike) -> int:
        """Write the Chrome trace JSON; returns the span count written.
        Atomic (tmp + rename): a reader racing the atexit hook must see
        either nothing or a complete valid trace, never a prefix."""
        doc = self.to_chrome()
        path = os.fspath(path)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return len(doc["traceEvents"]) - 1  # minus the metadata event


# ── Module-level switchboard (lazy env parse, test override) ──

_lock = threading.Lock()
_tracer: Tracer | None = None
_trace_path: str | None = None
_resolved = False
_atexit_armed = False


def _arm_atexit() -> None:
    global _atexit_armed
    if not _atexit_armed:
        _atexit_armed = True
        atexit.register(_export_at_exit)


def _export_at_exit() -> None:
    tracer, path = _tracer, _trace_path
    if tracer is not None and path:
        try:
            tracer.export(path)
        except OSError:
            pass  # interpreter teardown: nowhere sane to report


def install(path: str | None = None) -> Tracer:
    """Install a fresh process tracer (CLI/tests). ``path`` arms the
    atexit export; callers may also :func:`export` explicitly."""
    global _tracer, _trace_path, _resolved
    with _lock:
        _resolved = True
        _tracer = Tracer()
        _trace_path = path
        if path:
            _arm_atexit()
        return _tracer


def uninstall() -> None:
    """Disable tracing (no export). Tests."""
    global _tracer, _trace_path, _resolved
    with _lock:
        _resolved = True
        _tracer = None
        _trace_path = None


def reset() -> None:
    """Back to unresolved: the next ``span()`` re-reads ``ZEST_TRACE``."""
    global _tracer, _trace_path, _resolved
    with _lock:
        _tracer = None
        _trace_path = None
        _resolved = False


def active() -> Tracer | None:
    global _tracer, _resolved, _trace_path
    if _resolved:
        return _tracer
    with _lock:
        if not _resolved:
            path = os.environ.get(ENV_TRACE)
            if path and state.enabled():
                _tracer = Tracer()
                _trace_path = path
                _arm_atexit()
            _resolved = True
    return _tracer


def trace_path() -> str | None:
    active()  # resolve env first
    return _trace_path


def span(name: str, **attrs):
    """The hot-path hook: the shared no-op span unless a tracer is
    armed (``ZEST_TRACE``/:func:`install`) and telemetry is enabled."""
    tracer = _tracer
    if tracer is None:
        if _resolved:
            return NULL_SPAN
        tracer = active()
        if tracer is None:
            return NULL_SPAN
    if not state.enabled():
        return NULL_SPAN
    return tracer.span(name, **attrs)


def export(path: str | os.PathLike) -> int:
    """Export the active tracer's spans; 0 when tracing is off."""
    tracer = active()
    return tracer.export(path) if tracer is not None else 0


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def _jsonable_deep(v):
    """Metadata values can be small nested maps (per-peer clock
    offsets); stringify only the leaves."""
    if isinstance(v, dict):
        return {str(k): _jsonable_deep(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable_deep(x) for x in v]
    return _jsonable(v)
