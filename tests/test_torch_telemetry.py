"""The port's telemetry core against ``zest_tpu.telemetry``, on the CPU.

Mirrors the tracer, metrics and recorder cases of tests/test_telemetry.py
for the port, and holds the two packages to each other: the same
sequence of counter, gauge and histogram operations renders the same
Prometheus text, nested spans export the same Chrome trace schema, and
the flight recorder keeps the same bounded, ordered ring.
"""

from __future__ import annotations

import json
import threading
import warnings

import pytest

from zest_tpu import telemetry as j_telemetry
from zest_tpu.models import hbm_pool as j_pool
from zest_tpu.telemetry import trace as j_trace
from zest_tpu_torch import telemetry
from zest_tpu_torch.models import hbm_pool
from zest_tpu_torch.telemetry import metrics as metrics_mod
from zest_tpu_torch.telemetry import recorder as recorder_mod
from zest_tpu_torch.telemetry import trace as trace_mod


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("ZEST_TELEMETRY", "ZEST_TRACE", "ZEST_RECORDER_EVENTS"):
        monkeypatch.delenv(name, raising=False)
    for reset in (hbm_pool.reset, j_pool.reset, telemetry.reset_all,
                  j_telemetry.reset_all, trace_mod.uninstall,
                  j_trace.uninstall):
        reset()
    yield
    for reset in (hbm_pool.reset, j_pool.reset, telemetry.reset_all,
                  j_telemetry.reset_all):
        reset()


def _ops(pkg, registry):
    """One sequence of metric operations, applied through ``pkg``'s
    classes to a fresh ``registry``."""
    c = registry.counter("t_requests_total", "reqs by\nsource", ("source",))
    c.inc(3, source="cdn")
    c.inc(source='a"b\\c\nd')
    c.inc(0.25, source="peer")
    g = registry.gauge("t_occupancy_bytes", "occ")
    g.set(12.5)
    g.inc(2)
    registry.gauge("t_big", "big").set(2 ** 60)
    h = registry.histogram("t_latency_seconds", "lat", ("op",),
                           buckets=(1.0, 0.1, 5e-3))
    for v, op in ((0.05, "get"), (2.0, "get"), (0.001, "put"),
                  (0.1, "put")):
        h.observe(v, op=op)
    registry.add_collector(
        lambda reg: reg.gauge("t_live", "live", ("host",)).set(7, host="0"))
    return registry


def test_prometheus_text_equals_reference():
    ours = _ops(telemetry, metrics_mod.MetricsRegistry()).render_prometheus()
    theirs = _ops(j_telemetry, j_telemetry.MetricsRegistry()) \
        .render_prometheus()
    assert ours == theirs
    assert 't_latency_seconds_bucket{le="0.005",op="put"} 1' in ours
    assert 't_requests_total{source="a\\"b\\\\c\\nd"} 1' in ours
    assert "# HELP t_requests_total reqs by\\nsource" in ours


def test_process_registry_renders_as_reference():
    for pkg in (telemetry, j_telemetry):
        pkg.counter("t_proc_total", "p", ("k",)).inc(2, k="x")
        pkg.histogram("t_proc_seconds", "s", buckets=(0.5,)).observe(0.25)
    ours = [ln for ln in telemetry.render_prometheus().splitlines()
            if "t_proc" in ln]
    theirs = [ln for ln in j_telemetry.render_prometheus().splitlines()
              if "t_proc" in ln]
    assert ours == theirs and len(ours) == 9


def test_snapshot_equals_reference():
    ours = _ops(telemetry, metrics_mod.MetricsRegistry()).snapshot()
    theirs = _ops(j_telemetry, j_telemetry.MetricsRegistry()).snapshot()
    assert ours == theirs


@pytest.mark.parametrize("pkg", [telemetry, j_telemetry],
                         ids=["port", "reference"])
def test_registration_conflicts_fail_loud(pkg):
    pkg.counter("t_conflict_total")
    with pytest.raises(pkg.MetricError):
        pkg.gauge("t_conflict_total")
    with pytest.raises(pkg.MetricError):
        pkg.counter("t_conflict_total", labelnames=("x",))
    c = pkg.counter("t_lbl_total", "", ("a",))
    with pytest.raises(pkg.MetricError):
        c.inc(b=1)
    with pytest.raises(pkg.MetricError):
        c.inc(-1, a="x")


def test_disabled_ops_are_noops(monkeypatch):
    c = telemetry.counter("t_off_total")
    h = telemetry.histogram("t_off_seconds")
    telemetry.set_enabled(False)
    c.inc()
    h.observe(1.0)
    telemetry.record("ignored")
    assert telemetry.span("x") is telemetry.NULL_SPAN
    telemetry.set_enabled(None)
    assert c.value() == 0 and h.samples() == []
    assert recorder_mod.tail() == []
    monkeypatch.setenv("ZEST_TELEMETRY", "off")
    telemetry.set_enabled(None)
    assert telemetry.enabled() is False
    monkeypatch.setenv("ZEST_TELEMETRY", "1")
    telemetry.set_enabled(None)
    assert telemetry.enabled() is True


def test_reset_keeps_metric_objects():
    c = telemetry.counter("t_kept_total")
    c.inc(5)
    telemetry.REGISTRY.reset()
    assert c.value() == 0
    c.inc()
    assert "t_kept_total 1" in telemetry.render_prometheus()


def test_sum_allowlisted_warns_once_and_counts():
    dicts = [{"units": 1, "rate": 0.5, "ok": True},
             {"units": 2, "rate": 0.7, "name": "x"}]
    with pytest.warns(RuntimeWarning, match="'rate'"):
        sums, unsummed = telemetry.sum_allowlisted(
            dicts, allow={"units"}, context="port.ctx")
    with pytest.warns(RuntimeWarning, match="'rate'"):
        assert (sums, unsummed) == j_telemetry.sum_allowlisted(
            dicts, allow={"units"}, context="port.ctx.ref")
    assert sums == {"units": 3} and unsummed == ["rate"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        telemetry.sum_allowlisted(dicts, allow={"units"}, context="port.ctx")
    c = telemetry.REGISTRY.counter("zest_unsummed_counter_keys_total", "",
                                   ("context", "key"))
    assert c.value(context="port.ctx", key="rate") == 1


# ── Spans ──


def _nested(pkg, trace):
    tracer = trace.install(None)
    trace.set_context(trace_id="abc", host=1)
    with pkg.span("pull", repo="acme/model") as sp:
        sp.set("tier", "cdn")
        with pkg.span("stage.fetch") as inner:
            inner.add_bytes(100)
            inner.add_bytes(28)
        with pytest.raises(ValueError):
            with pkg.span("stage.hbm_commit"):
                raise ValueError("secret /etc/passwd")
    tracer.add_metadata(offsets={"0": 0.5})
    return tracer


def _schema(doc: dict) -> dict:
    """The trace doc without its times and ids."""
    events = []
    for ev in doc["traceEvents"]:
        events.append({k: v for k, v in ev.items()
                       if k not in ("ts", "dur", "pid", "tid")})
    other = {k: v for k, v in doc["otherData"].items()
             if k != "epoch_origin_s"}
    return {"keys": sorted(doc), "events": events, "other": other,
            "unit": doc["displayTimeUnit"]}


def test_trace_export_schema_equals_reference(tmp_path):
    ours = _nested(telemetry, trace_mod)
    theirs = _nested(j_telemetry, j_trace)
    try:
        assert _schema(ours.to_chrome()) == _schema(theirs.to_chrome())
        doc = ours.to_chrome()
        by_name = {e["name"]: e for e in doc["traceEvents"]
                   if e["ph"] == "X"}
        root, fetch = by_name["pull"], by_name["stage.fetch"]
        assert fetch["tid"] == root["tid"] == threading.get_ident()
        assert root["ts"] <= fetch["ts"]
        assert fetch["ts"] + fetch["dur"] <= root["ts"] + root["dur"] + 1e-6
        assert fetch["args"]["bytes"] == 128
        assert by_name["stage.hbm_commit"]["args"]["error"] == "ValueError"
        assert "passwd" not in json.dumps(doc)
        out = tmp_path / "trace.json"
        assert ours.export(out) == 3
        assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
        assert not list(tmp_path.glob("*.tmp.*"))
    finally:
        trace_mod.clear_context()
        j_trace.clear_context()


def test_coverage_and_span_cap(monkeypatch):
    tracer = trace_mod.install(None)
    for name, t0, t1 in (("a", 0.0, 1.0), ("b", 0.5, 2.0), ("a", 3.0, 3.5)):
        s = tracer.span(name)
        s.t0, s.t1 = t0, t1
        tracer._record(s)
    assert tracer.coverage_s() == pytest.approx(2.5)
    assert tracer.coverage_s(prefix="a") == pytest.approx(1.5)
    tracer = trace_mod.install(None)
    monkeypatch.setattr(trace_mod, "MAX_SPANS", 2)
    for _ in range(4):
        with telemetry.span("x"):
            pass
    assert len(tracer) == 2
    assert tracer.to_chrome()["otherData"]["dropped_spans"] == 2
    dropped = telemetry.REGISTRY.counter("zest_trace_spans_dropped_total")
    assert dropped.value() == 2


def test_env_arms_tracer_lazily(monkeypatch, tmp_path):
    out = tmp_path / "env-trace.json"
    monkeypatch.setenv("ZEST_TRACE", str(out))
    trace_mod.reset()
    with telemetry.span("via-env"):
        pass
    tracer = trace_mod.active()
    assert tracer is not None and len(tracer) == 1
    assert trace_mod.trace_path() == str(out)
    snap = telemetry.status_snapshot()
    assert snap == {"enabled": True, "trace_active": True,
                    "metrics": snap["metrics"], "trace_path": str(out),
                    "spans": 1}
    trace_mod.uninstall()
    assert telemetry.span("anything", k=1) is telemetry.NULL_SPAN
    assert set(telemetry.status_snapshot()) == set(
        j_telemetry.status_snapshot())


# ── The flight recorder ──


def _record_all(rec, trace):
    rec.record("first", n=1, note=None, obj=object.__name__)
    trace.set_context(trace_id="t1")
    try:
        with trace.install(None).span("hbm_pool.land"):
            rec.record("inside", t=5, kind="shadowed", rows=(1, 2),
                       meta={"a": [1]}, bad={"x": {1, 2}}.__class__)
    finally:
        trace.clear_context()
        trace.uninstall()
    for i in range(5):
        rec.record("tick", i=i)


@pytest.mark.parametrize("capacity", [3, 64])
def test_recorder_ring_equals_reference(capacity):
    ours = recorder_mod.FlightRecorder(capacity)
    theirs = j_telemetry.recorder.FlightRecorder(capacity)
    _record_all(ours, trace_mod)
    _record_all(theirs, j_trace)

    def strip(events):
        return [{k: v for k, v in e.items() if k != "t"} for e in events]

    assert strip(ours.tail()) == strip(theirs.tail())
    assert ours.recorded == theirs.recorded == 7
    assert len(ours.tail()) == min(capacity, 7)
    assert [e.get("i") for e in ours.tail()][-3:] == [2, 3, 4]
    times = [e["t"] for e in ours.tail()]
    assert times == sorted(times)
    assert ours.tail(0) == [] and strip(ours.tail(2)) == strip(
        theirs.tail(2))
    if capacity == 64:
        inside = ours.tail()[1]
        assert inside["span"] == "hbm_pool.land"
        assert inside["trace_id"] == "t1"
        assert inside["t_"] == 5 and inside["kind_"] == "shadowed"
        assert inside["rows"] == [1, 2] and inside["meta"] == {"a": [1]}


def test_recorder_report_and_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("ZEST_RECORDER_EVENTS", "4")
    recorder_mod.reset()
    assert recorder_mod.RECORDER.capacity == 4
    assert recorder_mod.dump_crash_report(tmp_path, "empty") is None
    for i in range(6):
        telemetry.record("pool_evict", repo="acme/a", reason="pressure",
                         i=i)
    doc = recorder_mod.RECORDER.report("test")
    ref = j_telemetry.recorder.FlightRecorder(4).report("test")
    assert set(doc) == set(ref)
    assert doc["recorded_total"] == 6 and len(doc["events"]) == 4
    path = recorder_mod.dump_crash_report(tmp_path, "boom")
    saved = json.loads(open(path).read())
    assert saved["reason"] == "boom" and saved["events"][-1]["i"] == 5
    telemetry.reset_all()
    assert recorder_mod.tail() == []
