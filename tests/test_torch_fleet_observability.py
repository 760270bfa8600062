"""Fleet observability in the port, held to the JAX package's.

Mirrors the cases of ``tests/test_fleet_observability.py`` that no other
port test covers:

- a two-host cooperative round traced in one process, split per host and
  merged into one doc with per-host tracks, one trace id and
  client→server flow links; ``merge_traces`` equal to the reference's on
  the same per-host docs; ``trace --merge`` offline;
- the DCN hello's trace block: each package's channel reads the other's
  server's trace id and host index; a traced window's tag and the
  client's host and trace id reach the server's ``dcn.serve`` spans (port
  and reference servers alike); an untraced window goes out untagged;
- pod metrics: ``parse_prometheus`` and ``aggregate_prometheus`` (text
  equal to the reference's on the same inputs), derived pod gauges,
  scrape errors;
- the daemon's ``/v1/trace``, ``/v1/debug`` and ``/v1/metrics?scope=pod``
  (a live and a dead peer; 64 peers through a 4-worker scrape pool),
  ``debug --out`` and one frame of ``stats --watch``;
- a ``ZEST_TELEMETRY=0`` cooperative pull writes the same files as a
  traced one, records no span and no event, and restores the trace
  context.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from tests.fixtures import FixtureHub, FixtureRepo
from zest_tpu import telemetry as j_telemetry
from zest_tpu.config import Config as JConfig
from zest_tpu.telemetry import fleet as j_fleet
from zest_tpu.transfer import dcn as j_dcn
from zest_tpu_torch import cli, faults, telemetry
from zest_tpu_torch.api.http_api import PublisherServer
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.config import Config
from zest_tpu_torch.storage import XorbCache
from zest_tpu_torch.telemetry import fleet
from zest_tpu_torch.telemetry import recorder as recorder_mod
from zest_tpu_torch.transfer import dcn
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.coop import CoopPlan, coop_round
from zest_tpu_torch.transfer.dcn import DcnPool, DcnServer
from zest_tpu_torch.transfer.federated import warm_units_parallel
from zest_tpu_torch.transfer.pull import pull_model

REPO_ID = "acme/fleet-model"
FILES = {
    "config.json": b'{"model_type": "fleet"}',
    "model.safetensors": np.random.default_rng(11).integers(
        0, 4, 1_200_000, dtype=np.uint8).tobytes(),
}


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO_ID, FILES, chunks_per_xorb=2)) as h:
        yield h


@pytest.fixture(autouse=True)
def clean_telemetry():
    for tel in (telemetry, j_telemetry):
        tel.reset_all()
    faults.reset()
    yield
    for tel in (telemetry, j_telemetry):
        tel.set_enabled(None)
        tel.reset_all()
    faults.reset()


def _quiet(*_a, **_k):
    pass


def _cfg(root, url="http://127.0.0.1:9", **kw):
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=url, dcn_port=0, **kw)


def _bridge(hub, root):
    b = XetBridge(_cfg(root, hub.url))
    b.authenticate(REPO_ID)
    return b


def _recs(bridge):
    return [bridge.get_reconstruction(e.xet_hash)
            for e in HubClient(bridge.cfg).list_files(REPO_ID) if e.is_xet]


def _run_coop_hosts(hub, tmp_path, n):
    """n concurrent in-process hosts, each with its own DCN server whose
    serve spans carry its host index."""
    bridges, servers, addrs = [], [], {}
    for i in range(n):
        b = _bridge(hub, tmp_path / f"h{i}")
        bridges.append(b)
        s = DcnServer(b.cfg, b.cache, span_attrs={"host": i})
        addrs[i] = ("127.0.0.1", s.start())
        servers.append(s)
    results: list = [None] * n
    errors: list = []

    def run(i):
        try:
            results[i] = coop_round(bridges[i], _recs(bridges[i]), i, n,
                                    addrs, server=servers[i], device="cpu")
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append((i, exc))

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for s in servers:
        s.shutdown()
    for b in bridges:
        b.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


# ── Trace merging over a real cooperative round ──


def test_mint_trace_id_equals_reference():
    for key, nonce in (("acme/m@sha1", ""), ("acme/m@sha1", "n1"),
                       ("x", "y")):
        assert fleet.mint_trace_id(key, nonce) == \
            j_fleet.mint_trace_id(key, nonce)


def test_merged_trace_round_trip_two_hosts(hub, tmp_path):
    tracer = telemetry.trace.install(None)
    results = _run_coop_hosts(hub, tmp_path, 2)

    assert results[0]["trace_id"] == results[1]["trace_id"]
    trace_id = results[0]["trace_id"]
    for i, r in enumerate(results):
        off = r["clock_offsets"][1 - i]
        assert abs(off["offset_s"]) < 2.0 and off["rtt_s"] >= 0.0
    doc = tracer.to_chrome()
    assert set(doc["otherData"]["clock_offsets"]) == {"0", "1"}

    per_host = fleet.split_hosts(doc, default_host=0)
    assert set(per_host) >= {0, 1}
    merged = fleet.merge_traces(per_host)
    assert merged == j_fleet.merge_traces(per_host)
    meta = merged["otherData"]
    assert set(meta["merged_hosts"]) >= {"0", "1"}
    assert meta["trace_ids"] == [trace_id]
    assert meta["flow_links"] > 0
    assert set(meta["clock_normalization"]) >= {"0", "1"}
    names = {e["args"]["name"] for e in merged["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert any("host 0" in n for n in names)
    assert any("host 1" in n for n in names)

    rounds = [e for e in merged["traceEvents"]
              if e.get("ph") == "X" and e["name"] == "coop.round"]
    assert len(rounds) == 2
    assert all(e["args"]["trace_id"] == trace_id for e in rounds)
    starts = [e for e in merged["traceEvents"] if e.get("ph") == "s"]
    finishes = [e for e in merged["traceEvents"] if e.get("ph") == "f"]
    assert starts and finishes
    assert {e["id"] for e in starts} >= {e["id"] for e in finishes}
    for host in (0, 1):
        cov, root = fleet.host_coverage_s(merged, host, "coop.round")
        assert root > 0 and cov >= 0.9 * root
        assert fleet.host_coverage_s(merged, host, "coop.round") == \
            j_fleet.host_coverage_s(merged, host, "coop.round")
    out = tmp_path / "merged.json"
    out.write_text(json.dumps(merged))
    assert json.loads(out.read_text())["otherData"]["flow_links"] > 0


def test_merge_and_split_equal_reference():
    """Two hand-built host docs with clock offsets each way, a missing
    offset, flows and a default host: the same merged doc."""
    def ev(name, ts, dur, **args):
        return {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": 1,
                "tid": 7, "args": args}

    docs = {
        0: {"traceEvents": [
                ev("coop.round", 0, 100, trace_id="ab" * 16),
                ev("dcn.request_many", 10, 20, flow_tag=3),
                {"ph": "M", "name": "process_name"}],
            "otherData": {"epoch_origin_s": 100.0,
                          "clock_offsets": {"1": {"offset_s": 0.25}}}},
        1: {"traceEvents": [
                ev("coop.round", 5, 90, trace_id="ab" * 16),
                ev("dcn.serve", 12, 4, client_host=0, tag=3),
                ev("dcn.serve", 18, 4, client_host=0, tag=3)],
            "otherData": {"epoch_origin_s": 100.5}},
        "2": {"traceEvents": [ev("pull", 0, 50)],
              "otherData": {"epoch_origin_s": 99.0,
                            "clock_offsets": {"0": {"offset_s": -0.1}}}},
    }
    for ref in (None, 1):
        assert fleet.merge_traces(docs, reference=ref) == \
            j_fleet.merge_traces(docs, reference=ref)
    assert fleet.merge_traces(docs)["otherData"]["flow_links"] == 2
    whole = {"traceEvents": docs[0]["traceEvents"] + docs[1]["traceEvents"],
             "otherData": {"spans": 5}}
    assert fleet.split_hosts(whole) == j_fleet.split_hosts(whole)
    with pytest.raises(ValueError):
        fleet.merge_traces({})


def test_cli_merge_offline(tmp_path, capsys):
    paths = []
    for host in (0, 1):
        telemetry.trace.clear_context()
        telemetry.trace.set_context(host=host, trace_id="cd" * 16)
        t = telemetry.trace.install(None)
        with telemetry.span("coop.round"):
            pass
        p = tmp_path / f"host{host}.json"
        p.write_text(json.dumps(t.to_chrome()))
        paths.append(str(p))
        telemetry.trace.uninstall()
    telemetry.trace.clear_context()
    out = tmp_path / "merged.json"
    assert cli.main(["trace", "--merge", *paths, "--out", str(out)]) == 0
    assert "2 host tracks" in capsys.readouterr().out
    merged = json.loads(out.read_text())
    assert merged["otherData"]["merged_hosts"] == ["0", "1"]
    assert merged["otherData"]["trace_ids"] == ["cd" * 16]


# ── The hello's trace block ──


@pytest.fixture
def dcn_servers(tmp_path):
    """A port and a reference DcnServer over empty caches."""
    cfg = _cfg(tmp_path / "p")
    jcfg = JConfig(hf_home=tmp_path / "j/hf", cache_dir=tmp_path / "j/z",
                   dcn_port=0)
    servers = {"port": DcnServer(cfg, XorbCache(cfg)),
               "ref": j_dcn.DcnServer(jcfg)}
    ports = {name: s.start() for name, s in servers.items()}
    yield ports
    for s in servers.values():
        s.shutdown()


@pytest.mark.parametrize("server", ["port", "ref"])
def test_request_tag_reaches_server_spans(dcn_servers, server):
    tracers = {"port": telemetry.trace.install(None),
               "ref": j_telemetry.trace.install(None)}
    pool = DcnPool(timeout=5.0)
    telemetry.trace.set_context(host=5, trace_id="aa" * 16)
    try:
        pool.request_many("127.0.0.1", dcn_servers[server],
                          [(b"\x04" * 32, 0, 1)])
        assert pool.channel("127.0.0.1", dcn_servers[server]) \
            .hello.subversion == 2
    finally:
        telemetry.trace.clear_context()
        pool.close()
    client = {s.name: s for s in tracers["port"].spans()}["dcn.request_many"]
    assert client.attrs["flow_tag"] >= 1
    deadline = time.monotonic() + 5
    while True:  # the server records its span after it replies
        spans = {s.name: s for s in tracers[server].spans()}
        if "dcn.serve" in spans or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    serve = spans["dcn.serve"]
    assert serve.attrs["tag"] == client.attrs["flow_tag"]
    assert serve.attrs["client_host"] == 5
    assert serve.attrs["trace_id"] == "aa" * 16
    assert serve.attrs["outcome"] == "not_found"


@pytest.mark.parametrize("server", ["port", "ref"])
def test_hello_trace_blocks_cross_packages(dcn_servers, server):
    """Each side's hello carries its process trace context: the port's
    channel reads the reference server's trace id and host index, and the
    reference's channel reads the port server's."""
    ctx = {"port": telemetry.trace, "ref": j_telemetry.trace}
    client_mod = j_dcn if server == "port" else dcn
    ctx[server].set_context(host=3, trace_id="ef" * 16)
    try:
        ch = client_mod.DcnChannel("127.0.0.1", dcn_servers[server])
    finally:
        ctx[server].clear_context()
    try:
        assert ch.hello.subversion == 2
        assert ch.hello.peer_trace_id == "ef" * 16
        assert ch.hello.peer_host == 3
        assert isinstance(ch.hello.clock_offset_s, float)
    finally:
        ch.close()
    # An empty context sends no id and no host.
    ch = client_mod.DcnChannel("127.0.0.1", dcn_servers[server])
    try:
        assert ch.hello.peer_trace_id is None and ch.hello.peer_host is None
    finally:
        ch.close()


def test_untraced_requests_stay_untagged(dcn_servers):
    pool = DcnPool(timeout=5.0)
    try:
        ch = pool.channel("127.0.0.1", dcn_servers["port"])
        sent = []
        orig = ch.request_many

        def spy(*a, **kw):
            sent.append(kw)
            return orig(*a, **kw)

        ch.request_many = spy
        pool.request_many("127.0.0.1", dcn_servers["port"],
                          [(b"\x05" * 32, 0, 1)])
        assert sent and sent[0].get("tag", 0) == 0
        assert pool.counters["untagged_windows"] == 1
    finally:
        pool.close()


# ── Pod metrics aggregation ──

_H0 = """\
# HELP zest_coop_bytes_total coop bytes
# TYPE zest_coop_bytes_total counter
zest_coop_bytes_total{tier="cdn"} 100
zest_coop_bytes_total{tier="dcn"} 700
# HELP zest_coop_exchange_wall_seconds wall
# TYPE zest_coop_exchange_wall_seconds gauge
zest_coop_exchange_wall_seconds 2.0
# HELP zest_coop_fetch_bytes fetch
# TYPE zest_coop_fetch_bytes gauge
zest_coop_fetch_bytes 400
# HELP zest_pull_seconds lat
# TYPE zest_pull_seconds histogram
zest_pull_seconds_bucket{le="1"} 1
zest_pull_seconds_bucket{le="+Inf"} 2
zest_pull_seconds_sum 3.5
zest_pull_seconds_count 2
"""

_H1 = """\
# HELP zest_coop_bytes_total coop bytes
# TYPE zest_coop_bytes_total counter
zest_coop_bytes_total{tier="cdn"} 100
zest_coop_bytes_total{tier="dcn"} 500
# HELP zest_coop_exchange_wall_seconds wall
# TYPE zest_coop_exchange_wall_seconds gauge
zest_coop_exchange_wall_seconds 8.0
# HELP zest_coop_fetch_bytes fetch
# TYPE zest_coop_fetch_bytes gauge
zest_coop_fetch_bytes 600
# HELP zest_pull_seconds lat
# TYPE zest_pull_seconds histogram
zest_pull_seconds_bucket{le="1"} 0
zest_pull_seconds_bucket{le="+Inf"} 1
zest_pull_seconds_sum 4.5
zest_pull_seconds_count 1
"""

_ODD = """\
# HELP zest_x_total a "quoted" \\\\ help
# TYPE zest_x_total counter
zest_x_total{path="a\\"b",k="v\\\\n"} 1.5e3
zest_up NaN
zest_low -Inf
"""


def test_aggregate_counters_summed_gauges_labeled():
    text = fleet.aggregate_prometheus({"0": _H0, "1": _H1})
    parsed = fleet.parse_prometheus(text)
    assert parsed["zest_coop_bytes_total"]["samples"][
        (("tier", "cdn"),)] == 200
    assert parsed["zest_coop_bytes_total"]["samples"][
        (("tier", "dcn"),)] == 1200
    walls = parsed["zest_coop_exchange_wall_seconds"]["samples"]
    assert walls[(("host", "0"),)] == 2.0
    assert walls[(("host", "1"),)] == 8.0
    assert parsed["zest_pull_seconds_count"]["samples"][()] == 3
    assert parsed["zest_pull_seconds_sum"]["samples"][()] == 8.0
    assert parsed["zest_pull_seconds_bucket"]["samples"][
        (("le", "+Inf"),)] == 3


def test_aggregate_derives_pod_gauges():
    parsed = fleet.parse_prometheus(
        fleet.aggregate_prometheus({"0": _H0, "1": _H1}))
    assert parsed["zest_coop_straggler_seconds"]["samples"][()] == \
        pytest.approx(3.0)
    assert parsed["zest_coop_fetch_share_skew"]["samples"][()] == \
        pytest.approx(1.2)
    assert parsed["zest_pod_peer_served_ratio"]["samples"][()] == \
        pytest.approx(1200 / 1400)
    assert parsed["zest_pod_hosts"]["samples"][()] == 2


def test_aggregate_reports_scrape_errors():
    parsed = fleet.parse_prometheus(
        fleet.aggregate_prometheus({"0": _H0}, errors={"1": "down"}))
    assert parsed["zest_pod_scrape_errors"]["samples"][
        (("host", "1"),)] == 1


def test_aggregate_demotes_unparseable_host_to_scrape_error():
    parsed = fleet.parse_prometheus(fleet.aggregate_prometheus(
        {"0": _H0, "1": "<html>502 Bad Gateway</html>"}))
    assert parsed["zest_pod_hosts"]["samples"][()] == 1
    assert parsed["zest_pod_scrape_errors"]["samples"][
        (("host", "1"),)] == 1
    assert parsed["zest_coop_bytes_total"]["samples"][
        (("tier", "cdn"),)] == 100


def test_parse_rejects_malformed():
    for bad in ("what even is this line\n", 'x{a="1",junk} 1\n'):
        with pytest.raises(ValueError):
            fleet.parse_prometheus(bad)
        with pytest.raises(ValueError):
            j_fleet.parse_prometheus(bad)


@pytest.mark.parametrize("texts,errors", [
    ({"0": _H0, "1": _H1}, None),
    ({"0": _H0}, {"1": "down", "2": "timeout"}),
    ({"0": _H0, "1": "<html>502</html>", "2": _ODD}, None),
    ({"a": _ODD}, {}),
    ({}, {"9": "down"}),
])
def test_aggregate_text_equals_reference(texts, errors):
    assert fleet.aggregate_prometheus(texts, errors) == \
        j_fleet.aggregate_prometheus(texts, errors)
    for text in texts.values():
        try:
            want = j_fleet.parse_prometheus(text)
        except ValueError:
            with pytest.raises(ValueError):
                fleet.parse_prometheus(text)
            continue
        assert _plain(fleet.parse_prometheus(text)) == _plain(want)


def _plain(parsed: dict) -> dict:
    """A parse with its values as reprs, so NaN compares equal."""
    return {name: (e["kind"], e["help"], sorted(
        (k, repr(v)) for k, v in e["samples"].items()))
        for name, e in parsed.items()}


def test_process_registry_aggregates_as_reference():
    """The pull-path metrics the port now registers render, and sum over
    two hosts, as the JAX package's registry does for the same calls."""
    def drive(tel):
        tel.counter("zest_pulls_total", "Pulls finished, by outcome",
                    ("outcome",)).inc(outcome="ok")
        tel.histogram("zest_stage_seconds", "Per-entry stage wall time",
                      ("stage",)).observe(0.25, stage="fetch")
        tel.gauge("zest_coop_exchange_wall_seconds",
                  "This host's last cooperative exchange-phase wall "
                  "time").set(1.5)
        return "".join(
            f"{ln}\n" for ln in tel.render_prometheus().splitlines()
            if "zest_pulls_total" in ln or "zest_stage_seconds" in ln
            or "zest_coop_exchange_wall_seconds" in ln)

    mine, ref = drive(telemetry), drive(j_telemetry)
    assert mine == ref and "zest_stage_seconds_bucket" in mine
    assert fleet.aggregate_prometheus({"0": mine, "1": mine}) == \
        j_fleet.aggregate_prometheus({"0": ref, "1": ref})


# ── The daemon's surfaces ──


@pytest.fixture
def daemon(tmp_path):
    server = PublisherServer(_cfg(tmp_path / "d"), device="cpu").start()
    try:
        yield server
    finally:
        server.close()


def _get(url: str, text: bool = False):
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read().decode()
    return body if text else json.loads(body)


def test_v1_trace_endpoint(daemon):
    doc = _get(f"{daemon.url}/v1/trace")
    assert doc["traceEvents"] == [] and "no tracer armed" in \
        doc["otherData"]["note"]
    tracer = telemetry.trace.install(None)
    with telemetry.span("pull", repo="x"):
        pass
    doc = _get(f"{daemon.url}/v1/trace")
    assert "pull" in {e["name"] for e in doc["traceEvents"]
                      if e["ph"] == "X"}
    assert doc["otherData"]["spans"] == len(tracer.spans())


def test_v1_debug_endpoint(daemon):
    telemetry.record("cdn_fallback", unit="abc", tier="cdn", bytes=5)
    coop_bytes = telemetry.counter("zest_coop_bytes_total", "", ("tier",))
    coop_bytes.inc(900, tier="dcn")
    coop_bytes.inc(100, tier="cdn")
    telemetry.gauge("zest_last_pull_hbm_seconds", "").set(2.5)
    telemetry.gauge("zest_last_pull_first_layer_seconds", "").set(0.5)
    telemetry.gauge("zest_last_pull_delta_ratio", "").set(-1.0)
    d = _get(f"{daemon.url}/v1/debug?tail=5")
    assert d["recorder"]["events"][-1]["kind"] == "cdn_fallback"
    assert d["coop"]["peer_served_ratio"] == pytest.approx(0.9)
    assert d["coop"]["tier_bytes"] == {"dcn": 900, "cdn": 100}
    # No session landed: the gauges stand in.
    assert d["landing"] == {"first_layer_s": 0.5, "time_to_hbm_s": 2.5,
                            "first_layer_ratio": 0.2}
    assert d["telemetry"]["enabled"] is True
    assert _get(f"{daemon.url}/v1/debug?tail=0")["recorder"]["events"] == []


def _peer_httpd(handler_body):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):  # noqa: N802
            body = handler_body()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def test_v1_metrics_pod_scope_scrapes_peers(tmp_path):
    peer = _peer_httpd(lambda: (
        b"# HELP zest_coop_bytes_total b\n"
        b"# TYPE zest_coop_bytes_total counter\n"
        b'zest_coop_bytes_total{tier="dcn"} 11\n'))
    telemetry.counter("zest_coop_bytes_total", "", ("tier",)) \
        .inc(9, tier="dcn")
    server = PublisherServer(
        _cfg(tmp_path / "d", coop_index=0), device="cpu",
        pod_peers={1: ("127.0.0.1", peer.server_address[1]),
                   2: ("127.0.0.1", 1)}).start()  # nothing listens on 1
    try:
        parsed = fleet.parse_prometheus(
            _get(f"{server.url}/v1/metrics?scope=pod", text=True))
        assert parsed["zest_coop_bytes_total"]["samples"][
            (("tier", "dcn"),)] == 20
        assert parsed["zest_pod_hosts"]["samples"][()] == 2
        assert parsed["zest_pod_scrape_errors"]["samples"][
            (("host", "2"),)] == 1
        local = fleet.parse_prometheus(
            _get(f"{server.url}/v1/metrics", text=True))
        assert local["zest_coop_bytes_total"]["samples"][
            (("tier", "dcn"),)] == 9
    finally:
        server.close()
        peer.shutdown()
        peer.server_close()


def test_v1_metrics_pod_scope_alone_is_this_host(daemon):
    telemetry.counter("zest_pulls_total", "", ("outcome",)).inc(outcome="ok")
    text = _get(f"{daemon.url}/v1/metrics?scope=pod", text=True)
    assert text == fleet.aggregate_prometheus(
        {"0": telemetry.render_prometheus()})
    assert fleet.parse_prometheus(text)["zest_pod_hosts"]["samples"][()] \
        == 1


def test_pod_scrape_fanout_bounded_at_64_peers(tmp_path, monkeypatch):
    lk = threading.Lock()
    in_flight, peak, served = [0], [0], [0]

    def body():
        # Counted before the reply goes out: a worker starts its next
        # scrape only after reading this one.
        with lk:
            in_flight[0] += 1
            peak[0] = max(peak[0], in_flight[0])
        time.sleep(0.02)
        with lk:
            in_flight[0] -= 1
            served[0] += 1
        return b"# TYPE zest_x_total counter\nzest_x_total 1\n"

    httpd = _peer_httpd(body)
    port = httpd.server_address[1]
    monkeypatch.setattr(fleet, "_SCRAPE_POOL", None)
    from zest_tpu_torch.api.http_api import HttpApi

    api = HttpApi(_cfg(tmp_path, coop_index=0, pod_scrape_workers=4),
                  device="cpu",
                  pod_peers={i: ("127.0.0.1", port) for i in range(1, 65)})
    try:
        text = api.pod_metrics_text()
    finally:
        api.close()
        httpd.shutdown()
        httpd.server_close()
        pool = fleet._SCRAPE_POOL
        monkeypatch.setattr(fleet, "_SCRAPE_POOL", None)
        if pool is not None:
            pool.shutdown(wait=False)
    assert served[0] == 64
    assert peak[0] <= 4, f"scrape fan-out burst to {peak[0]} threads"
    assert fleet.parse_prometheus(text)["zest_pod_hosts"]["samples"][()] \
        == 65


def test_pod_peers_config_knobs():
    cfg = Config.load({"ZEST_POD_PEERS": "1=hostB:9847,2=hostC:9848",
                       "ZEST_POD_SCRAPE_WORKERS": "3"})
    jcfg = JConfig.load({"ZEST_POD_PEERS": "1=hostB:9847,2=hostC:9848",
                         "ZEST_POD_SCRAPE_WORKERS": "3"})
    assert cfg.pod_peers == jcfg.pod_peers == {
        1: ("hostB", 9847), 2: ("hostC", 9848)}
    assert cfg.pod_scrape_workers == jcfg.pod_scrape_workers == 3
    assert Config.load({}).pod_scrape_workers == 8
    with pytest.raises(ValueError):
        Config.load({"ZEST_POD_SCRAPE_WORKERS": "0"})


def test_cmd_debug_writes_report(daemon, tmp_path, monkeypatch):
    monkeypatch.setenv("ZEST_HTTP_PORT", daemon.url.rsplit(":", 1)[1])
    monkeypatch.setenv("ZEST_CACHE_DIR", str(tmp_path / "c"))
    telemetry.record("fault_fired", fault="cdn_503")
    out = tmp_path / "report.json"
    assert cli.main(["debug", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert any(e["kind"] == "fault_fired"
               for e in doc["recorder"]["events"])


def test_cmd_stats_watch_renders_one_frame(daemon, monkeypatch, capsys,
                                           tmp_path):
    monkeypatch.setenv("ZEST_HTTP_PORT", daemon.url.rsplit(":", 1)[1])
    monkeypatch.setenv("ZEST_CACHE_DIR", str(tmp_path / "c"))
    telemetry.counter("zest_coop_bytes_total", "", ("tier",)) \
        .inc(42, tier="dcn")
    telemetry.record("peer_strike", peer="10.0.0.9:7001", strike="corrupt")
    assert cli.main(["stats", "--watch", "--count", "1",
                     "--interval", "0.1"]) == 0
    out = capsys.readouterr().out
    assert "coop: peer_served=" in out
    assert "peer_strike" in out
    assert cli.main(["stats"]) == 0
    assert "zest_coop_bytes_total" in capsys.readouterr().out


# ── Knob-off: the same files, no span, no event ──


def test_knob_off_coop_pull_byte_identical(hub, tmp_path):
    def coop_pull(root):
        peer = _bridge(hub, root / "peer")
        recs = _recs(peer)
        warm_units_parallel(peer, recs,
                            units=CoopPlan.build(recs, 2).for_host(1))
        server = DcnServer(peer.cfg, peer.cache)
        port = server.start()
        try:
            return pull_model(_cfg(root / "p0", hub.url), REPO_ID,
                              device="cpu", land=False, no_p2p=True,
                              coop=True, coop_hosts=2, coop_index=0,
                              coop_addrs={1: ("127.0.0.1", port)},
                              log=_quiet)
        finally:
            server.shutdown()
            peer.close()

    tracer_on = telemetry.trace.install(None)
    on = coop_pull(tmp_path / "on")
    assert len(tracer_on) > 0
    assert {"coop.round", "coop.exchange"} <= {
        s.name for s in tracer_on.spans()}
    telemetry.trace.uninstall()
    telemetry.reset_all()

    tracer_off = telemetry.trace.install(None)
    telemetry.set_enabled(False)
    try:
        off = coop_pull(tmp_path / "off")
    finally:
        telemetry.set_enabled(None)
    for name, data in FILES.items():
        assert (on.snapshot_dir / name).read_bytes() == data
        assert (off.snapshot_dir / name).read_bytes() == data
    assert len(tracer_off) == 0
    assert recorder_mod.RECORDER.recorded == 0
    assert on.stats["coop"]["exchange"]["units"] == \
        off.stats["coop"]["exchange"]["units"]
    assert sorted(on.stats["coop"]) == sorted(off.stats["coop"])
    assert "critical_path" not in off.stats
    assert telemetry.trace.base_context() == {}
