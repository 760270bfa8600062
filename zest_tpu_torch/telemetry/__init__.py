"""zest_tpu_torch.telemetry — process-wide observability for the pull path.

The counterpart of ``zest_tpu/telemetry``. Its pieces, all thread-safe:

- **Spans** (:mod:`.trace`): ``with telemetry.span("swarm.fetch",
  xorb=h) as sp: ... sp.add_bytes(n)`` — nested wall-clock spans that
  serialize to Chrome/Perfetto ``trace_event`` JSON. Armed by
  ``ZEST_TRACE=path`` (written at exit) or ``zest trace``.
- **Metrics** (:mod:`.metrics`): counters, gauges and histograms with
  label sets in one process registry, rendered as Prometheus text on the
  daemon's ``GET /v1/metrics`` and summarized by ``zest stats``.
- **Fleet correlation** (:mod:`.fleet`): the cross-host trace identity
  (``mint_trace_id``), merged multi-track traces (``merge_traces``) with
  flow links and clock-offset normalization, and the pod-scope
  Prometheus aggregation behind ``GET /v1/metrics?scope=pod``.
- **The flight recorder** (:mod:`.recorder`): a bounded ring of the last
  notable events (strikes, quarantines, fallbacks, faults, verify
  rejections, budget declines), served at ``GET /v1/debug``.
- **Pull sessions** (:mod:`.session`): the bounded table of live and
  recent pulls behind ``GET /v1/pulls`` and ``zest ps``.
- **Critical-path attribution** (:mod:`.critpath`): the blame-attributed
  path through a trace's spans, per-stage and per-tier exclusive
  seconds, ``stats["critical_path"]`` and ``zest analyze``.
- **Live timelines** (:mod:`.timeline`): the sampler's bounded series
  (counter rates, probes, posted cells, session progress) and the
  streaming anomaly detector, behind ``GET /v1/timeline`` and ``zest
  top``.
- **Self-healing** (:mod:`.remediate`): the engine that maps anomalies
  and sampler ticks to hedge / strike / demote / shed / tune decisions
  through injected targets, behind ``GET /v1/remediations`` and ``zest
  heal``.
- **The switch** (:mod:`.state`): ``ZEST_TELEMETRY=0`` turns the whole
  layer into flag checks; tracing also needs ``ZEST_TRACE`` or an
  installed tracer.

This package imports nothing from the rest of ``zest_tpu_torch``, so
every module can use it without cycles.
"""

from zest_tpu_torch.telemetry.metrics import (  # noqa: F401
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricError,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    render_prometheus,
    sum_allowlisted,
)
from zest_tpu_torch.telemetry.state import enabled, set_enabled  # noqa: F401
from zest_tpu_torch.telemetry.trace import (  # noqa: F401
    NULL_SPAN,
    Span,
    Tracer,
    span,
)
from zest_tpu_torch.telemetry import state as _state
from zest_tpu_torch.telemetry import trace as trace  # noqa: PLC0414
from zest_tpu_torch.telemetry import recorder as recorder  # noqa: PLC0414
from zest_tpu_torch.telemetry import timeline as timeline  # noqa: PLC0414
from zest_tpu_torch.telemetry import remediate as remediate  # noqa: PLC0414
from zest_tpu_torch.telemetry.recorder import record  # noqa: F401
from zest_tpu_torch.telemetry import session as session  # noqa: PLC0414
from zest_tpu_torch.telemetry import critpath as critpath  # noqa: PLC0414
from zest_tpu_torch.telemetry import fleet as fleet  # noqa: PLC0414

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricError",
    "MetricsRegistry",
    "NULL_SPAN",
    "Span",
    "Tracer",
    "counter",
    "critpath",
    "enabled",
    "fleet",
    "gauge",
    "histogram",
    "record",
    "recorder",
    "remediate",
    "render_prometheus",
    "reset_all",
    "session",
    "set_enabled",
    "span",
    "status_snapshot",
    "sum_allowlisted",
    "timeline",
    "trace",
]


def status_snapshot() -> dict:
    """The ``telemetry`` block for ``/v1/status``: is the layer on, is a
    trace armed, and how much has been recorded."""
    tracer = trace.active()
    doc: dict = {
        "enabled": enabled(),
        "trace_active": tracer is not None,
        "metrics": len(REGISTRY.metrics()),
    }
    if tracer is not None:
        doc["trace_path"] = trace.trace_path()
        doc["spans"] = len(tracer)
    return doc


def reset_all() -> None:
    """Tests: unresolve the enable flag, drop the tracer and contexts,
    clear metrics, empty the flight recorder."""
    _state.reset()
    trace.reset()
    trace.clear_context()
    REGISTRY.reset()
    recorder.reset()
    session.reset()
    timeline.reset()
    remediate.reset()
