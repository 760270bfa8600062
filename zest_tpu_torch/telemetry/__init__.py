"""zest_tpu_torch.telemetry — process-wide observability.

The core of ``zest_tpu/telemetry``: the switch (:mod:`.state`,
``ZEST_TELEMETRY``), metrics (:mod:`.metrics`: counters, gauges and
histograms rendered as Prometheus text on the daemon's ``GET
/v1/metrics``), spans (:mod:`.trace`, Chrome trace JSON under
``ZEST_TRACE``), the flight recorder (:mod:`.recorder`), and of
timelines and remediation the parts the collective exchange reaches
(:mod:`.timeline`: posted cells and clock offsets; :mod:`.remediate`:
the action-target registry), and pull sessions (:mod:`.session`: the
bounded table of live and recent pulls behind ``GET /v1/pulls`` and
``zest ps``). Critical-path analysis, the timeline sampler and anomaly
detector, the remediation engine and fleet aggregation are not ported;
of the fleet layer, only the trace identity (:mod:`.fleet`,
``mint_trace_id``).

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
    "enabled",
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
