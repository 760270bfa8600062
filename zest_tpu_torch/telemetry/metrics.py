"""Process-wide metrics registry: counters, gauges, histograms.

The counterpart of ``zest_tpu/telemetry/metrics.py``, with the same
names, label handling and Prometheus text exposition (format 0.0.4), so
one sequence of operations renders the same text in both packages. A
daemon answers ``GET /v1/metrics`` from :func:`render_prometheus`.

Zero dependencies, thread-safe, label sets as ordered tuples. Writes are
gated on :func:`zest_tpu_torch.telemetry.state.enabled`.

Collectors: live state should not be mirrored event by event — register
a ``fn(registry)`` collector and it runs at scrape/snapshot time,
setting gauges from the live object it closed over.
"""

from __future__ import annotations

import math
import threading
import warnings

from zest_tpu_torch.telemetry import state

# Prometheus default buckets suit request latencies; pull stages span
# ms..minutes, so stretch the tail.
DEFAULT_BUCKETS = (0.005, 0.02, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, 120.0, 300.0)

_METRIC_KINDS = ("counter", "gauge", "histogram")


class MetricError(ValueError):
    """Registration conflict (same name, different kind/labels) — fail
    loud: two call sites silently sharing a mistyped metric would
    corrupt both series."""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str = "",
                 labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help_text = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}

    def _key(self, labels: dict) -> tuple[str, ...]:
        if labels and set(labels) - set(self.labelnames):
            extra = sorted(set(labels) - set(self.labelnames))
            raise MetricError(
                f"{self.name}: unknown label(s) {extra}; "
                f"declared {list(self.labelnames)}")
        return tuple(str(labels.get(n, "")) for n in self.labelnames)

    def samples(self) -> list[tuple[dict, float]]:
        with self._lock:
            items = list(self._values.items())
        return [
            (dict(zip(self.labelnames, key)), value)
            for key, value in items
        ]

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if not state.enabled():
            return
        if amount < 0:
            raise MetricError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not state.enabled():
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1, **labels) -> None:
        if not state.enabled():
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 labelnames: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help_text, labelnames)
        self.buckets = tuple(sorted(buckets))
        # key → [bucket_counts..., +Inf count, sum]
        self._hist: dict[tuple[str, ...], list[float]] = {}

    def observe(self, value: float, **labels) -> None:
        if not state.enabled():
            return
        key = self._key(labels)
        with self._lock:
            row = self._hist.get(key)
            if row is None:
                row = self._hist[key] = [0.0] * (len(self.buckets) + 2)
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    row[i] += 1
            row[-2] += 1          # +Inf / count
            row[-1] += value      # sum

    def samples(self) -> list[tuple[dict, float]]:
        """Count per labelset (the scalar view for /v1/status)."""
        with self._lock:
            items = list(self._hist.items())
        return [
            (dict(zip(self.labelnames, key)), row[-2])
            for key, row in items
        ]

    def rows(self) -> list[tuple[tuple[str, ...], list[float]]]:
        with self._lock:
            return [(k, list(v)) for k, v in self._hist.items()]

    def clear(self) -> None:
        with self._lock:
            self._values.clear()
            self._hist.clear()


class MetricsRegistry:
    """Name → metric, plus scrape-time collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list = []

    def _get_or_create(self, cls, name: str, help_text: str,
                       labelnames, **kwargs):
        labelnames = tuple(labelnames or ())
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (existing.kind != cls.kind
                        or existing.labelnames != labelnames):
                    raise MetricError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{list(existing.labelnames)}, "
                        f"requested {cls.kind}{list(labelnames)}")
                return existing
            metric = cls(name, help_text, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_text: str = "",
                labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str = "", labelnames=(),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labelnames,
                                   buckets=buckets)

    def add_collector(self, fn) -> None:
        """``fn(registry)`` runs before every render/snapshot — the hook
        live-state surfaces (cache occupancy, peer health) use to set
        gauges at scrape time instead of mirroring every mutation."""
        with self._lock:
            self._collectors.append(fn)

    def remove_collector(self, fn) -> None:
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 - scrape must not 500 on one
                pass

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # ── Exposition ──

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4): HELP/TYPE headers
        and one escaped sample line per labelset."""
        self._run_collectors()
        out: list[str] = []
        for metric in sorted(self.metrics(), key=lambda m: m.name):
            out.append(f"# HELP {metric.name} "
                       f"{_escape_help(metric.help_text)}")
            out.append(f"# TYPE {metric.name} {metric.kind}")
            if isinstance(metric, Histogram):
                for key, row in sorted(metric.rows()):
                    base = dict(zip(metric.labelnames, key))
                    for i, ub in enumerate(metric.buckets):
                        out.append(_sample(
                            f"{metric.name}_bucket",
                            {**base, "le": _fmt_float(ub)}, row[i]))
                    out.append(_sample(f"{metric.name}_bucket",
                                       {**base, "le": "+Inf"}, row[-2]))
                    out.append(_sample(f"{metric.name}_sum", base, row[-1]))
                    out.append(_sample(f"{metric.name}_count", base,
                                       row[-2]))
            else:
                for labels, value in sorted(
                        metric.samples(), key=lambda s: sorted(s[0].items())):
                    out.append(_sample(metric.name, labels, value))
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-friendly dump for ``/v1/status`` / ``zest stats``:
        ``{name: {kind, samples: [{labels, value}]}}``."""
        self._run_collectors()
        doc: dict = {}
        for metric in self.metrics():
            doc[metric.name] = {
                "kind": metric.kind,
                "samples": [
                    {"labels": labels, "value": value}
                    for labels, value in metric.samples()
                ],
            }
        return doc

    def reset(self) -> None:
        """Zero every metric's samples and drop collectors (tests).

        Metric OBJECTS survive: hot-path modules hold module-level
        handles created at import (``_M_XORBS = telemetry.counter(...)``)
        — dropping the registry entries would orphan those handles from
        the rendered output while they kept counting into the void."""
        with self._lock:
            metrics = list(self._metrics.values())
            self._collectors.clear()
        for m in metrics:
            m.clear()


def _fmt_float(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    out = repr(float(v))
    return out[:-2] if out.endswith(".0") else out


def _fmt_value(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _sample(name: str, labels: dict, value: float) -> str:
    if labels:
        inner = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
        )
        return f"{name}{{{inner}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


# ── The process registry + convenience constructors ──

REGISTRY = MetricsRegistry()


def counter(name: str, help_text: str = "", labelnames=()) -> Counter:
    return REGISTRY.counter(name, help_text, labelnames)


def gauge(name: str, help_text: str = "", labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help_text, labelnames)


def histogram(name: str, help_text: str = "", labelnames=(),
              buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help_text, labelnames, buckets)


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


# ── Allowlisted counter merging (the _PipelinedWarm.summary contract) ──

_warned_unsummed: set[tuple[str, str]] = set()
_warned_lock = threading.Lock()


def sum_allowlisted(dicts, allow: frozenset | set, skip=(),
                    context: str = "") -> tuple[dict, list[str]]:
    """Sum the allowlisted additive counters across ``dicts``; unknown
    numeric keys are returned (sorted) instead of summed — and each new
    one raises a **one-time** ``RuntimeWarning`` plus a registry counter
    bump, so a newly added counter that nobody allowlisted shows up in
    CI output and on ``/v1/metrics`` instead of silently vanishing from
    the merged stats (the old inline merge dropped them with no signal
    beyond an ``unsummed_keys`` list nothing asserted on)."""
    sums: dict = {}
    unknown: set[str] = set()
    for d in dicts:
        for k, v in d.items():
            if k in skip or isinstance(v, bool) \
                    or not isinstance(v, (int, float)):
                continue
            if k in allow:
                sums[k] = sums.get(k, 0) + v
            else:
                unknown.add(k)
    for k in unknown:
        mark = (context, k)
        with _warned_lock:
            if mark in _warned_unsummed:
                continue
            _warned_unsummed.add(mark)
        counter(
            "zest_unsummed_counter_keys_total",
            "Numeric counter keys dropped from an allowlisted merge",
            ("context", "key"),
        ).inc(context=context, key=k)
        warnings.warn(
            f"{context or 'counter merge'}: numeric key {k!r} is not in "
            f"the additive-counter allowlist {sorted(allow)}; it was NOT "
            "summed (listed under unsummed_keys). Allowlist it if it is "
            "additive.",
            RuntimeWarning,
            stacklevel=2,
        )
    return sums, sorted(unknown)
