"""Live timelines in the port, held to the JAX package's.

Mirrors ``tests/test_timeline.py``: the same counter increments, probe
values, cells and sessions, with injected ``now``/``wall`` clocks, go
through both packages' stores, and the ``payload`` documents must be
equal float for float (a session's id, random in each package, is
renamed before the comparison; an anomaly's wall stamp ``t`` is left
out). ``integrate`` agrees to 1e-9 relative; anomaly kinds and fields,
``merge_timelines`` and ``zest top``'s ``_top_lines`` are equal; the
knob-off pull keeps the stats schema with an empty store and no thread;
a real ``seeder_stall`` pull fires ``stall`` on its session and the
engine executes a hedge; and the daemon answers ``/v1/timeline`` (cursor
paging, ``?scope=pod`` over two daemons) and the dashboard.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import pytest

from tests.fixtures import FixtureHub, FixtureRepo
from zest_tpu import cli as j_cli
from zest_tpu import telemetry as j_telemetry
from zest_tpu.config import Config as JConfig
from zest_tpu.telemetry import session as j_session
from zest_tpu.telemetry import timeline as j_timeline
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer import tenancy as j_tenancy
from zest_tpu_torch import cli, faults, telemetry
from zest_tpu_torch.api.http_api import PublisherServer
from zest_tpu_torch.config import Config
from zest_tpu_torch.telemetry import session as session_mod
from zest_tpu_torch.telemetry import timeline
from zest_tpu_torch.transfer import tenancy
from zest_tpu_torch.transfer.pull import pull_model

# name → (timeline module, telemetry package, session module)
PACKAGES = {
    "port": (timeline, telemetry, session_mod),
    "reference": (j_timeline, j_telemetry, j_session),
}


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("ZEST_TIMELINE", "ZEST_TELEMETRY", "ZEST_TIMELINE_HZ",
                 "ZEST_ANOMALY_WINDOW_S", "ZEST_TIMELINE_SAMPLES",
                 "ZEST_REMEDIATE"):
        monkeypatch.delenv(name, raising=False)
    for mod, tel in ((tenancy, telemetry), (j_tenancy, j_telemetry)):
        tel.reset_all()
        mod.reset()
    faults.reset()
    yield
    faults.reset()
    for mod, tel in ((tenancy, telemetry), (j_tenancy, j_telemetry)):
        tel.set_enabled(None)
        tel.reset_all()
        mod.reset()


def _quiet(*_a, **_k):
    pass


class _FakeFetch:
    """The three byte counters the detector reads."""

    def __init__(self):
        self.bytes_from_cache = 0
        self.bytes_from_peer = 0
        self.bytes_from_cdn = 0


def _both(script):
    """Run ``script(timeline, telemetry, session)`` against each package;
    returns ``{name: result}``."""
    return {name: script(*mods) for name, mods in PACKAGES.items()}


def _norm(doc, ids: dict):
    """A payload with session ids renamed (``S0``, ``S1``...) and the
    anomalies' wall stamps left out."""
    text = json.dumps(doc, sort_keys=True)
    for sid, label in ids.items():
        text = text.replace(sid, label)
    out = json.loads(text)
    for ev in out.get("doc", out).get("anomalies", []):
        ev.pop("t", None)
    return out


def _equal(results):
    assert results["port"] == results["reference"]
    return results["port"]


# ── Store: ring bound, series cap, cursor paging, prefix ──


def test_store_bounds_cursor_and_prefix_match_reference():
    def script(tl, _tel, _sess):
        ring = tl.TimelineStore(capacity=4)
        for i in range(10):
            ring._append("s", float(i), "gauge", float(i))
        lru = tl.TimelineStore(capacity=4, max_series=3)
        for i in range(5):
            lru._append(f"s{i}", 1.0, "gauge", float(i))
        lru._append("s2", 2.0, "gauge", 9.0)
        lru._append("brand.new", 1.0, "gauge", 10.0)
        page = tl.TimelineStore(capacity=16)
        page._append("a", 1.0, "gauge", 1.0)
        page._append("b", 2.0, "gauge", 1.0)
        first = page.payload()
        empty = page.payload(since=first["cursor"])
        page._append("a", 3.0, "gauge", 2.0)
        pref = tl.TimelineStore(capacity=4)
        pref._append("fetch.cdn_bps", 1.0, "rate", 1.0)
        pref._append("ring.stalls", 0.0, "gauge", 1.0)
        return [ring.payload(), lru.payload(), first, empty,
                page.payload(since=first["cursor"]),
                pref.payload(prefix="fetch.")]

    ring, lru, first, empty, page, pref = _equal(_both(script))
    assert [v for _t, v in ring["series"]["s"]["samples"]] \
        == [6.0, 7.0, 8.0, 9.0]
    assert set(lru["series"]) == {"s2", "s4", "brand.new"}
    assert empty["series"] == {}
    assert page["series"] == {"a": {"kind": "gauge",
                                    "samples": [[2.0, 3.0]]}}
    assert page["cursor"] == first["cursor"] + 1
    assert list(pref["series"]) == ["fetch.cdn_bps"]


# ── Rates from registry counters ──


def test_rates_and_integration_match_reference():
    steps = [(1.0, 5000, 0, 100), (0.5, 0, 600, 0), (2.0, 12345, 300, 250),
             (1.0, 777, 0, 0), (0.25, 1, 9, 1)]

    def script(tl, tel, _sess):
        store = tl.TimelineStore(capacity=64)
        fetch = tel.counter("zest_fetch_bytes_total", "", ("source",))
        files = tel.counter("zest_files_bytes_total", "", ("lane",))
        seed = tel.counter("zest_seed_bytes_total", "", ("peer_state",))
        fetch.inc(1000, source="cdn")
        files.inc(0, lane="copy")
        store.tick(now=100.0, wall=1000.0)
        t = 100.0
        for dt, cdn, peer, up in steps:
            t += dt
            fetch.inc(cdn, source="cdn")
            if peer:
                fetch.inc(peer, source="peer")  # first seen mid-run
            files.inc(cdn, lane="copy")
            seed.inc(up, peer_state="reciprocal")
            seed.inc(up // 2, peer_state="optimistic")
            store.tick(now=t, wall=900.0 + t)
        doc = store.payload()
        return doc, {n: tl.integrate(s["samples"])
                     for n, s in doc["series"].items()}

    res = _both(script)
    (doc, ints), (j_doc, j_ints) = res["port"], res["reference"]
    assert doc == j_doc
    assert set(ints) == set(j_ints) == {
        "fetch.cdn_bps", "fetch.peer_bps", "files.copy_bps", "seed.bps"}
    for name, v in ints.items():
        assert v == pytest.approx(j_ints[name], rel=1e-9)
    cdn_total = sum(s[1] for s in steps)
    assert ints["fetch.cdn_bps"] == pytest.approx(cdn_total, rel=1e-9)
    assert ints["fetch.peer_bps"] == pytest.approx(909, rel=1e-9)
    assert ints["files.copy_bps"] == pytest.approx(cdn_total, rel=1e-9)


# ── Probes and cells ──


def test_probes_and_cells_match_reference():
    def script(tl, _tel, _sess):
        store = tl.TimelineStore(capacity=8)
        store._probes["g"] = lambda: 7
        store._probes["idle"] = lambda: None

        def boom():
            raise RuntimeError("probe died")

        store._probes["bad"] = boom
        store._cells["collective.phase"] = 2.0
        store.tick(now=1.0, wall=1.0)
        store._probes["g"] = lambda: 9  # the replacement wins
        store._cells.pop("collective.phase")
        store.tick(now=2.0, wall=2.0)
        return store.payload()

    doc = _equal(_both(script))
    assert doc["series"]["g"]["samples"] == [[1.0, 7.0], [2.0, 9.0]]
    assert doc["series"]["collective.phase"]["samples"] == [[1.0, 2.0]]
    assert set(doc["series"]) == {"g", "collective.phase"}


class _Clock:
    """A stand-in for the ``time`` module: a monotonic clock that each
    read advances by ``read_s`` and a wall clock ``offset`` ahead of it."""

    def __init__(self, mono: float, offset: float):
        self.mono, self.offset, self.read_s = mono, offset, 0.0

    def monotonic(self) -> float:
        v = self.mono
        self.mono += self.read_s
        return v

    def time(self) -> float:
        return self.mono + self.offset


def test_sample_stamps_follow_a_wall_clock_step(monkeypatch):
    clock = _Clock(100.0, 1000.0)
    monkeypatch.setattr(timeline, "time", clock)
    store = timeline.TimelineStore(capacity=16)
    store._probes["g"] = lambda: 1

    def tick(dt, step=0.0, read_s=0.0):
        clock.mono += dt
        clock.offset += step
        clock.read_s = read_s
        store.tick()
        clock.read_s = 0.0
        return store.payload()["series"]["g"]["samples"][-1][0]

    stamps = [tick(0.0)]
    stamps.append(tick(0.05, step=0.0005))  # a slew under 1 ms: kept
    stamps.append(tick(0.05, step=10.0))     # a step: followed
    # A reading with a thread switch inside it (1 ms a read): dropped.
    stamps.append(tick(0.05, step=5.0, read_s=1e-3))
    stamps.append(tick(0.05))                # the next clean one follows
    want = [1100.0, 1100.05, 1100.1 + 10.0005, 1100.15 + 10.0005,
            1100.203 + 15.0005]
    assert stamps == pytest.approx(want, abs=2e-6)


def test_conditional_unregister_and_the_host_ring_probes():
    from zest_tpu.models.loader import HostRing as JHostRing
    from zest_tpu_torch.models.loader import HostRing

    old, new = (lambda: 1), (lambda: 2)
    timeline.register_probe("ring.test", old)
    timeline.register_probe("ring.test", new)
    timeline.unregister_probe("ring.test", old)  # a stale teardown
    assert timeline.STORE._probes["ring.test"] is new
    timeline.unregister_probe("ring.test", new)
    assert "ring.test" not in timeline.STORE._probes

    ring, j_ring = HostRing(1024, 4), JHostRing(1024, 4)
    assert set(timeline.STORE._probes) == set(j_timeline.STORE._probes) \
        == {"ring.in_use_bytes", "ring.stalls"}
    slot = ring.acquire(512)
    assert timeline.STORE._probes["ring.in_use_bytes"]() == 512
    slot.release()
    ring.close()
    assert timeline.STORE._probes == {}
    r1, r2 = HostRing(1024, 4), HostRing(2048, 4)
    r1.close()  # replaced before it closed: a no-op
    assert timeline.STORE._probes["ring.in_use_bytes"] is r2._probe_in_use
    r2.close()
    j_ring.close()
    assert timeline.STORE._probes == {}


# ── Anomaly detection ──


def _begin(sess_mod, total, phase):
    sess = sess_mod.begin("acme/anom", "main")
    f = _FakeFetch()
    sess._fetch = f
    sess.set_total_bytes(total)
    sess.phase = phase
    return sess, f


def _scenario_stall(tl, _tel, sess_mod):
    store = tl.TimelineStore(capacity=64, window_s=2.0)
    sess, f = _begin(sess_mod, 10_000, "fetch")
    t = 0.0
    f.bytes_from_cdn = 2000
    store.tick(now=t, wall=t)
    for delta in (1000, 1000):
        t += 1.0
        f.bytes_from_cdn += delta
        store.tick(now=t, wall=t)
    for _ in range(12):  # a dead stop, well past the window
        t += 1.0
        store.tick(now=t, wall=t)
    return store, [sess]


def _scenario_stall_gated(tl, _tel, sess_mod):
    store = tl.TimelineStore(capacity=64, window_s=1.0)
    sess, f = _begin(sess_mod, 10_000, "hbm_commit")
    f.bytes_from_cdn = 5000
    for i in range(6):
        store.tick(now=float(i), wall=float(i))
    return store, [sess]


def _scenario_stall_open_fetch(tl, _tel, sess_mod):
    store = tl.TimelineStore(capacity=64, window_s=1.0)
    sess, f = _begin(sess_mod, 10_000, "hbm_commit")
    sess._open = {"hbm_commit": 1, "fetch": 1}
    f.bytes_from_cdn = 5000
    for i in range(6):
        store.tick(now=float(i), wall=float(i))
    return store, [sess]


def _scenario_collapse(tl, _tel, sess_mod):
    store = tl.TimelineStore(capacity=128, window_s=2.0)
    sess, f = _begin(sess_mod, 100_000_000, "fetch")
    t = 0.0
    store.tick(now=t, wall=t)
    for _ in range(10):
        t += 1.0
        f.bytes_from_cdn += 2_000_000
        store.tick(now=t, wall=t)
    for _ in range(6):  # a trickle: not a stall, far below 25%
        t += 1.0
        f.bytes_from_cdn += 10_000
        store.tick(now=t, wall=t)
    return store, [sess]


def _scenario_queue(tl, _tel, _sess):
    store = tl.TimelineStore(capacity=32, window_s=2.0)
    det = store.detector
    for i in range(5):
        det.observe_queue(3, 10, float(i))
    det.observe_queue(3, 11, 6.0)  # an admission re-arms the episode
    for i in range(7, 12):
        det.observe_queue(3, 11, float(i))
    for i, depth in enumerate([5, 4, 3, 2, 1, 0]):  # draining: silent
        det.observe_queue(depth, 20 + i, 20.0 + i)
    return store, []


def _scenario_queue_probes(tl, _tel, _sess):
    """The queue rule read through the tenancy probes at tick time."""
    store = tl.TimelineStore(capacity=32, window_s=1.5)
    depth, admitted = [0], [4]
    store._probes["tenancy.queue_depth"] = lambda: depth[0]
    store._probes["tenancy.admitted_total"] = lambda: admitted[0]
    for i in range(8):
        depth[0] = min(i, 3)
        store.tick(now=float(i), wall=float(i))
    return store, []


def _scenario_straggler(tl, _tel, _sess):
    store = tl.TimelineStore(capacity=32, window_s=1.0)
    cells = store._cells
    cells.update({"collective.phase": 0.0, "collective.barrier_s": 0.0,
                  "collective.partner": 3.0})
    store.tick(now=0.0, wall=0.0)
    cells["collective.barrier_s"] = 1.5  # waited past the window
    store.tick(now=1.5, wall=1.5)
    cells["collective.barrier_s"] = 3.0  # same phase: fired once
    store.tick(now=3.0, wall=3.0)
    cells["collective.phase"] = 1.0      # a new phase: a fresh baseline
    store.tick(now=4.0, wall=4.0)
    cells["collective.barrier_s"] = 3.5
    store.tick(now=4.5, wall=4.5)
    return store, []


SCENARIOS = {
    "stall": (_scenario_stall, ["stall"]),
    "stall_gated_on_phase": (_scenario_stall_gated, []),
    "stall_with_open_fetch": (_scenario_stall_open_fetch, ["stall"]),
    "throughput_collapse": (_scenario_collapse, ["throughput_collapse"]),
    "queue_stuck": (_scenario_queue, ["queue_stuck", "queue_stuck"]),
    "queue_stuck_from_probes": (_scenario_queue_probes, ["queue_stuck"]),
    "collective_straggler": (_scenario_straggler,
                             ["collective_straggler"]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_anomalies_match_reference(name):
    scenario, kinds = SCENARIOS[name]

    def script(tl, tel, sess_mod):
        store, sessions = scenario(tl, tel, sess_mod)
        ids = {s.id: f"S{i}" for i, s in enumerate(sessions)}
        metric = {m.name: m for m in tel.REGISTRY.metrics()}[
            "zest_anomalies_total"]
        recs = [e for e in tel.recorder.tail() if e["kind"] == "anomaly"]
        notes = [sorted(s.snapshot().get("anomalies", {}))
                 for s in sessions]
        for s in sessions:
            sess_mod.finish(s, "ok")
        return _norm({"doc": store.payload(),
                      "metric": sorted(metric.samples(),
                                       key=lambda r: r[0]["kind"]),
                      "recorded": [{k: v for k, v in e.items()
                                    if k not in ("t", "seq")}
                                   for e in recs],
                      "notes": notes}, ids)

    out = _equal(_both(script))
    assert [e["kind"] for e in out["doc"]["anomalies"]] == kinds
    assert [e["anomaly"] for e in out["recorded"]] == kinds
    if name == "stall":
        (ev,) = out["doc"]["anomalies"]
        assert ev["session"] == "S0" and ev["stalled_s"] <= 4.0
        assert out["notes"] == [["stall"]]
    if name == "collective_straggler":
        (ev,) = out["doc"]["anomalies"]
        assert (ev["phase"], ev["partner"]) == (0, 3)


def test_finish_drops_the_detector_row():
    for tl, _tel, sess_mod in PACKAGES.values():
        tl.ensure_started()
        det = tl.STORE.detector
        sess = sess_mod.begin("acme/m", "main")
        det.observe_session(sess, now=1.0)
        assert sess.id in det._sessions
        sess_mod.finish(sess, "ok")
        assert sess.id not in det._sessions


# ── Knob off ──


def test_off_means_no_thread_no_samples_no_probes(monkeypatch):
    for tl, tel, _sess in PACKAGES.values():
        tl.set_enabled(False)
        assert tl.ensure_started() is False
        assert tl._sampler is None
        tl.register_probe("x", lambda: 1)
        tl.post("y", 2.0)
        assert tl.STORE._probes == {} and tl.STORE._cells == {}
    assert timeline.payload() == j_timeline.payload() == {
        "enabled": False, "series": {}, "anomalies": [], "cursor": 0}
    assert timeline.status_block() == j_timeline.status_block() \
        == {"enabled": False}
    for tl, tel, _sess in PACKAGES.values():
        tl.set_enabled(None)
        tel.set_enabled(False)  # telemetry off implies timeline off
        tl.set_enabled(True)
        assert tl.enabled() is False


def test_status_block_keys_match_reference():
    for tl, _tel, _sess in PACKAGES.values():
        tl.STORE._append("a", 1.0, "gauge", 1.0)
        tl.STORE.tick(now=1.0, wall=1.0)
    assert timeline.status_block() == j_timeline.status_block()


# Stats keys of a files-only pull that only the port reports.
PORT_ONLY = {"device", "fallback_files", "files_after_hbm_s"}

FILES = {
    "config.json": b'{"model_type": "test"}',
    "model.safetensors": bytes(range(256)) * 2048,  # 512 KiB
    "tokenizer.json": b'{"tok": 1}' * 20,
}


def test_knob_off_pull_keeps_the_schema_with_an_empty_store(
        tmp_path, monkeypatch):
    """``ZEST_TIMELINE=0``: no sampler thread, an empty store, no engine,
    the same bytes and the same stats keys, in both packages."""
    repo = FixtureRepo("acme/tl-model", FILES, chunks_per_xorb=3)
    with FixtureHub(repo) as hub:
        def cfg(cls, root):
            return cls(hf_home=root / "hf", cache_dir=root / "zest",
                       hf_token="hf_test", endpoint=hub.url)

        def pull(name):
            return pull_model(cfg(Config, tmp_path / name), "acme/tl-model",
                              device="cpu", land=False, no_p2p=True,
                              log=_quiet)

        def j_pull_(name):
            return j_pull.pull_model(cfg(JConfig, tmp_path / name),
                                     "acme/tl-model", no_p2p=True,
                                     log=_quiet)

        on, j_on = pull("on"), j_pull_("j_on")
        assert timeline._sampler is not None  # the pull started it
        for mod, tel in ((tenancy, telemetry), (j_tenancy, j_telemetry)):
            tel.reset_all()
            mod.reset()
        monkeypatch.setenv("ZEST_TIMELINE", "0")
        off, j_off = pull("off"), j_pull_("j_off")
    assert timeline._sampler is None and j_timeline._sampler is None
    deadline = time.monotonic() + 5  # the stopped sampler's last wait
    while [t for t in threading.enumerate()
           if t.name == "zest-timeline" and t.is_alive()]:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    assert timeline.STORE.payload()["series"] == {}
    assert timeline.STORE._probes == {}
    assert telemetry.remediate.ENGINE is None
    assert set(on.stats) == set(off.stats)
    assert set(j_on.stats) == set(j_off.stats)
    assert set(off.stats) - PORT_ONLY == set(j_off.stats)
    for name in FILES:
        assert (on.snapshot_dir / name).read_bytes() \
            == (off.snapshot_dir / name).read_bytes()


# ── Chaos: a stalled seeder fires the stall and the engine hedges ──


def test_seeder_stall_pull_fires_stall_and_executes_a_hedge(
        tmp_path, monkeypatch):
    from zest_tpu_torch.transfer.server import BtServer
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    import numpy as np

    # Several xorbs, fetched one at a time: the first fetch stalls past
    # the window, and every later one starts after the hedge is armed.
    files = {"config.json": b'{"model_type": "stall"}',
             "model.safetensors": np.random.default_rng(17).bytes(600_000)}
    repo = FixtureRepo("acme/stall-model", files, chunks_per_xorb=2)
    window_s = 0.4
    monkeypatch.setenv("ZEST_ANOMALY_WINDOW_S", str(window_s))
    monkeypatch.setenv("ZEST_TIMELINE_HZ", "20")
    timeline.reset()
    with FixtureHub(repo) as hub:
        def cfg(root):
            return Config(hf_home=root / "hf", cache_dir=root / "zest",
                          hf_token="hf_test", endpoint=hub.url,
                          listen_port=0, max_concurrent_downloads=1)

        seeder_cfg = cfg(tmp_path / "seeder")
        pull_model(seeder_cfg, "acme/stall-model", device="cpu",
                   no_p2p=True, land=False, log=_quiet)
        telemetry.reset_all()  # drop the warm pull's session
        server = BtServer(seeder_cfg)
        port = server.start()
        # Every peer response sleeps well past two windows: the pull's
        # fetch makes no byte progress meanwhile.
        faults.install("seeder_stall:1.0@2.0")
        try:
            leech = cfg(tmp_path / "leech")
            swarm = SwarmDownloader(leech)
            swarm.add_direct_peer("127.0.0.1", port)
            try:
                res = pull_model(leech, "acme/stall-model", device="cpu",
                                 swarm=swarm, land=False, log=_quiet)
            finally:
                swarm.close()
            assert faults.counters().get("seeder_stall", 0) >= 1
        finally:
            faults.install(None)
            server.shutdown()
    for name, want in files.items():
        assert (res.snapshot_dir / name).read_bytes() == want
    stalls = [e for e in timeline.STORE.payload()["anomalies"]
              if e["kind"] == timeline.ANOMALY_STALL]
    assert stalls, timeline.STORE.payload()["anomalies"]
    (recent,) = session_mod.payload()["recent"][:1]
    assert stalls[0]["session"] == recent["id"]
    assert stalls[0].get("stalled_s", 0) <= 2 * window_s + 0.5
    sess = session_mod.get(recent["id"])
    assert timeline.ANOMALY_STALL in sess.snapshot()["anomalies"]
    hedges = [e for e in telemetry.remediate.payload()["recent"]
              if e["action"] == "hedge" and e["session"] == recent["id"]]
    assert hedges and hedges[0]["outcome"] == "success"
    assert hedges[0]["detail"]["armed"] is True
    assert f"session.{recent['id']}.bytes" in hedges[0]["before"]
    # The armed hedge raced the stalled peer: the CDN served the fetches
    # that started after it.
    resil = res.stats["fetch"]["resilience"]
    assert resil["hedges"] >= 1 and resil["hedges_won"] >= 1, resil
    assert res.stats["fetch"]["bytes"]["cdn"] > 0


# ── The daemon's surfaces and the pod merge ──


@pytest.fixture
def daemon(tmp_path, monkeypatch):
    # One tick per 50 s: the route tests drive the store with injected
    # clocks, which a live tick would interleave with.
    monkeypatch.setenv("ZEST_TIMELINE_HZ", "0.02")
    timeline.reset()
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 http_port=0)
    with PublisherServer(cfg, device="cpu") as srv:
        yield srv


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read().decode())


def test_v1_timeline_cursor_paging_and_status(daemon):
    base = daemon.url
    c = telemetry.counter("zest_fetch_bytes_total", "", ("source",))
    c.inc(1000, source="cdn")
    timeline.STORE.tick(now=1.0, wall=1.0)
    c.inc(2000, source="cdn")
    timeline.STORE.tick(now=2.0, wall=2.0)
    doc = _get(f"{base}/v1/timeline")
    assert doc["enabled"] is True
    assert doc["series"]["fetch.cdn_bps"]["kind"] == "rate"
    assert len(doc["series"]["fetch.cdn_bps"]["samples"]) == 2
    cursor = doc["cursor"]
    assert _get(f"{base}/v1/timeline?since={cursor}")["series"] == {}
    c.inc(500, source="cdn")
    timeline.STORE.tick(now=3.0, wall=3.0)
    page = _get(f"{base}/v1/timeline?since={cursor}")
    assert page["series"] == {"fetch.cdn_bps": {
        "kind": "rate", "samples": [[3.0, 500.0]]}}
    assert _get(f"{base}/v1/timeline?series=ring.")["series"] == {}
    st = _get(f"{base}/v1/status")
    assert st["timeline"]["enabled"] is True
    assert st["timeline"]["cursor"] >= 3
    assert set(st["timeline"]) == {"enabled", "hz", "series", "cursor",
                                   "anomalies", "ticks"}


def test_dashboard_is_served(daemon):
    with urllib.request.urlopen(daemon.url + "/", timeout=10) as r:
        body = r.read().decode()
        assert r.headers["Content-Type"].startswith("text/html")
    assert "zest-tpu-torch" in body and "/v1/timeline?since=" in body


def test_dashboard_escapes_every_interpolated_value():
    """Repo ids, peer addresses and recorder fields reach the dashboard
    from outside the process: every ``${...}`` in its markup is escaped,
    a number, or a choice between literal strings (and escaped values)."""
    import re

    from zest_tpu_torch.api.http_api import DASHBOARD_HTML

    script = DASHBOARD_HTML.split("<script>", 1)[1]
    assert script.index("const esc=") < script.index("innerHTML")
    # Numbers the page computes itself (toFixed, Number, the sparkline).
    computed = {"pct", "eta", "W", "H", "pl", "spark(pts)"}

    def safe(expr: str) -> bool:
        e = " ".join(expr.split())
        if e.startswith(("esc(", "Number(")) or e in computed:
            return True
        _cond, sep, rest = e.partition("?")
        rest = re.sub(r"esc\([^()]*\)", "", rest)
        rest = re.sub(r"'[^']*'", "", rest)
        return bool(sep) and re.fullmatch(r"[\s:+]*", rest) is not None

    exprs = re.findall(r"\$\{([^{}]*)\}", script)
    assert len(exprs) > 20
    assert [e for e in exprs if not safe(e)] == []
    assert "${x.repo_id}" not in script and "${e.kind}" not in script


def test_pod_scope_merges_two_daemons(tmp_path, monkeypatch):
    monkeypatch.setenv("ZEST_TIMELINE_HZ", "0.02")
    timeline.reset()
    peer_cfg = Config(hf_home=tmp_path / "p/hf", cache_dir=tmp_path / "p/z",
                      http_port=0)
    with PublisherServer(peer_cfg, device="cpu") as peer:
        timeline.STORE._append("fetch.cdn_bps", 7.0, "rate", 102.0)
        port = int(peer.url.rsplit(":", 1)[1])
        cfg = Config(hf_home=tmp_path / "c/hf", cache_dir=tmp_path / "c/z",
                     http_port=0, coop_index=0,
                     pod_peers={1: ("127.0.0.1", port),
                                2: ("127.0.0.1", 1)})
        with PublisherServer(cfg, device="cpu") as coord:
            doc = _get(coord.url + "/v1/timeline?scope=pod")
    # One process: both daemons serve the same store, so the peer's
    # series is the coordinator's, renamed, on the raw clock.
    assert doc["scope"] == "pod" and doc["reference"] == "0"
    assert doc["hosts"] == ["0", "1"]
    assert doc["series"]["h0.fetch.cdn_bps"]["samples"] == [[102.0, 7.0]]
    assert doc["series"]["h1.fetch.cdn_bps"]["samples"] == [[102.0, 7.0]]
    assert doc["clock_normalization"] == {
        "0": {"applied_offset_s": 0.0}, "1": {"applied_offset_s": None}}
    assert set(doc["scrape_errors"]) == {"2"}


MERGE_DOCS = [
    {"0": {"series": {"fetch.cdn_bps": {"kind": "rate",
                                        "samples": [[100.0, 5.0]]}},
           "anomalies": [{"t": 100.5, "kind": "stall"}],
           "clock_offsets": {"1": {"offset_s": 2.0, "rtt_s": 0.01}}},
     "1": {"series": {"fetch.cdn_bps": {"kind": "rate",
                                        "samples": [[102.0, 7.0]]}},
           "anomalies": [{"t": 101.0, "kind": "queue_stuck"}]}},
    {"0": {"series": {}, "anomalies": []},
     "1": {"series": {"x": {"kind": "gauge", "samples": [[5.0, 1.0]]}},
           "anomalies": []}},
    {"a": {"series": {"s": {"samples": [[1.0000004, 2.0]]}},
           "anomalies": []},
     "b": {"series": {}, "anomalies": [{"t": 3.0, "kind": "stall"}],
           "clock_offsets": {"a": {"offset_s": -0.5}}}},
]


@pytest.mark.parametrize("i", range(len(MERGE_DOCS)))
def test_merge_timelines_matches_reference(i):
    docs = MERGE_DOCS[i]
    assert timeline.merge_timelines(docs) == \
        j_timeline.merge_timelines(docs)
    assert timeline.merge_timelines(docs, reference=sorted(docs)[-1]) == \
        j_timeline.merge_timelines(docs, reference=sorted(docs)[-1])
    with pytest.raises(ValueError):
        timeline.merge_timelines({})


# ── zest top ──


def _top_payloads():
    status = {"version": "1.0"}
    pulls = {
        "active": [{"id": "p0001-ab", "repo": "a/b", "phase": "fetch",
                    "status": "running", "progress": 0.5, "eta_s": 12.0,
                    "anomalies": {"stall": {"t": 1.0}}}],
        "recent": [],
        "tenancy": {"active": 1, "queued": 2, "max_pulls": 4,
                    "queue_cap": 16},
    }
    series = {
        "session.p0001-ab.bytes": [[1.0, 0.0], [2.0, 4_000_000.0]],
        "fetch.cdn_bps": [[2.0, 2_500_000.0]],
        "fetch.peer_bps": [[2.0, 1_500_000.0]],
        "dcn.bps": [[2.0, 900.0]],
        "collective.ici_bps": [[2.0, 3e9]],
        "ring.in_use_bytes": [[2.0, 1024.0]],
        "ring.stalls": [[2.0, 3.0]],
        "tenancy.queue_depth": [[2.0, 2.0]],
        "tenancy.active_pulls": [[2.0, 1.0]],
        "tenancy.inflight_fetches": [[2.0, 5.0]],
    }
    tl = {"enabled": True,
          "series": {n: {"kind": "gauge", "samples": s}
                     for n, s in series.items()},
          "anomalies": [{"t": 1.5, "kind": "stall", "session": "p0001-ab",
                         "phase": "fetch"},
                        {"t": 1.6, "kind": "collective_straggler",
                         "partner": 3}]}
    return status, pulls, tl


@pytest.mark.parametrize("case", ["frame", "idle_off"])
def test_top_lines_match_reference(case):
    args = (_top_payloads() if case == "frame"
            else ({"version": "1.0"}, {}, {"enabled": False}))
    lines = cli._top_lines(*args)
    assert lines == j_cli._top_lines(*args)
    frame = "\n".join(lines)
    if case == "frame":
        assert "[############------------]" in frame
        assert "cdn=2.5 MB/s" in frame and "!stall" in frame
        assert "queue: depth=2  active=1  inflight_fetches=5" in frame
    else:
        assert "(no active pulls)" in frame and "ZEST_TIMELINE=0" in frame


def test_cmd_top_against_the_daemon(daemon, monkeypatch, capsys):
    monkeypatch.setenv("ZEST_HTTP_PORT", daemon.url.rsplit(":", 1)[1])
    sess = session_mod.begin("a/b", tenant="t")
    try:
        assert cli.main(["top", "--count", "1"]) == 0
        out = capsys.readouterr().out
        assert "zest top" in out and sess.id in out
        assert cli.main(["top", "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["timeline"]["enabled"] is True
        assert set(doc) == {"status", "pulls", "timeline"}
    finally:
        session_mod.finish(sess, "ok")
    monkeypatch.setenv("ZEST_HTTP_PORT", "1")
    assert cli.main(["top", "--count", "1"]) == 1


def test_push_series_are_posted(daemon):
    from zest_tpu_torch.api.http_api import push_notify

    out = push_notify(daemon.hub, {"repo": "a/b", "revision": "c" * 40,
                                   "new_xorb_bytes": 1234,
                                   "dedup_ratio": 0.75})
    assert out["ok"]
    timeline.STORE.tick(now=1.0, wall=1.0)
    doc = timeline.payload(prefix=timeline.SERIES_PUSH_PREFIX)
    assert doc["series"]["push.new_xorb_bytes"]["samples"] == [[1.0, 1234.0]]
    assert doc["series"]["push.dedup_ratio"]["samples"] == [[1.0, 0.75]]


def test_push_preview_matches_reference_and_writes_nothing(tmp_path,
                                                           capsys):
    """``preview_push`` (``zest diff --push-preview``) reports what the
    JAX package's does for the same checkpoint over the same base, and
    writes, verifies and notifies nothing; the CLI prints it."""
    from tests.fixtures import gpt2_checkpoint_files
    from zest_tpu.transfer import push as j_push
    from zest_tpu_torch.transfer import push

    files = gpt2_checkpoint_files(n_embd=32, n_layer=2)
    base, new = tmp_path / "base", tmp_path / "new"
    for d, fs in ((base, files), (new, {**files, "extra.safetensors":
                                        files["model.safetensors"][::-1]})):
        d.mkdir()
        for name, data in fs.items():
            (d / name).write_bytes(data)
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 push_chunks_per_xorb=2)
    j_cfg = JConfig(hf_home=tmp_path / "jhf", cache_dir=tmp_path / "jzest",
                    push_chunks_per_xorb=2)
    sha = push.push_checkpoint(cfg, "acme/pv", base, device="cpu",
                               notify=False, log=_quiet).revision
    j_push.push_checkpoint(j_cfg, "acme/pv", base, notify=False,
                           log=_quiet)
    before = sorted(p for p in tmp_path.rglob("*") if p.is_file())
    ours = push.preview_push(cfg, "acme/pv", new, base_revision=sha)
    theirs = j_push.preview_push(j_cfg, "acme/pv", new, base_revision=sha)
    assert sorted(p for p in tmp_path.rglob("*") if p.is_file()) == before
    assert ours["preview"] is True and ours["new_xorbs"] > 0
    for key in ("revision", "parent", "preview", "files", "xet_files",
                "total_bytes", "xet_bytes", "reused_bytes", "new_xorbs",
                "new_xorb_bytes", "dedup_ratio", "manifest_written",
                "seeded_base_xorbs"):
        assert ours[key] == theirs[key], key
    env = {"HF_HOME": str(cfg.hf_home), "ZEST_CACHE_DIR": str(cfg.cache_dir)}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        assert cli.main(["diff", f"acme/pv@{sha}", "--push-preview",
                         str(new)]) == 0
        out = capsys.readouterr().out
        assert "push preview: acme/pv" in out
        assert f"dedup ratio   : {ours['dedup_ratio']:.4f}" in out
        assert cli.main(["diff", "acme/pv", "--push-preview",
                         str(tmp_path / "missing")]) == 2
