"""Pull sessions in the port, held to the JAX package's.

Mirrors ``tests/test_sessions.py`` (its critical-path cases are in
``tests/test_torch_critpath.py``): the session table's life cycle, bounds and
recorder stamps, a pull's terminal session, ``ZEST_TELEMETRY=0``, two
concurrent landings with their own sessions, the per-session SLO check,
the ``/v1/pulls`` payload with the JAX package's keys for the same pull,
the ``/v1/pulls/<id>/events`` SSE stream of a real fixture pull, ``POST
/v1/pull``'s stream, and ``ps`` with ``_ps_lines`` byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests.fixtures import FixtureHub, FixtureRepo, gpt2_checkpoint_files
from zest_tpu import cli as j_cli
from zest_tpu import telemetry as j_telemetry
from zest_tpu.config import Config as JConfig
from zest_tpu.telemetry import session as j_session
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer import tenancy as j_tenancy
from zest_tpu_torch import cli, telemetry
from zest_tpu_torch.api.http_api import PublisherServer
from zest_tpu_torch.config import Config
from zest_tpu_torch.telemetry import session as session_mod
from zest_tpu_torch.transfer import tenancy
from zest_tpu_torch.transfer.pull import pull_model


@pytest.fixture(autouse=True)
def clean_telemetry():
    for mod, tel in ((tenancy, telemetry), (j_tenancy, j_telemetry)):
        tel.reset_all()
        mod.reset()
    yield
    for mod, tel in ((tenancy, telemetry), (j_tenancy, j_telemetry)):
        tel.set_enabled(None)
        tel.reset_all()
        mod.reset()


FILES = {
    "config.json": b'{"model_type": "test"}',
    "model.safetensors": bytes(range(256)) * 2048,  # 512 KiB
    "tokenizer.json": b'{"tok": 1}' * 40,
}


def _quiet(*_a, **_k):
    pass


@pytest.fixture(scope="module")
def hub():
    repo = FixtureRepo("acme/session-model", FILES, chunks_per_xorb=3)
    ckpt = FixtureRepo("acme/session-ckpt",
                       gpt2_checkpoint_files(n_embd=32, n_layer=2),
                       chunks_per_xorb=3)
    with FixtureHub(repo, ckpt) as h:
        yield h


def _cfg(hub, root, **kw):
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read().decode())


def _status(url: str) -> int:
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as exc:
        return exc.code


def _sse(resp) -> list[dict]:
    events = []
    for line in resp:
        if line.startswith(b"data: "):
            events.append(json.loads(line[6:]))
            if events[-1]["event"] in ("done", "error", "cancelled"):
                break
    return events


# ── The session table ──


def test_lifecycle_active_then_recent():
    sess = session_mod.begin("a/b", "main", tenant="t1", device="cuda")
    assert session_mod.SESSIONS.active_ids() == [sess.id]
    snap = sess.snapshot()
    assert snap["status"] == "running"
    assert snap["tenant"] == "t1" and snap["device"] == "cuda"
    session_mod.finish(sess, "ok", stats={"elapsed_s": 1.0})
    assert session_mod.SESSIONS.active_ids() == []
    recent = session_mod.SESSIONS.recent()
    assert [s.id for s in recent] == [sess.id]
    snap = recent[0].snapshot(detail=True)
    assert snap["status"] == "ok" and snap["phase"] == "done"
    assert snap["stats"] == {"elapsed_s": 1.0}
    assert session_mod.get(sess.id) is sess


def test_recent_ring_is_bounded():
    table = session_mod.SessionTable(capacity=3)
    ids = []
    for i in range(5):
        s = table.begin(f"a/r{i}")
        table.finish(s, "ok")
        ids.append(s.id)
    assert [s.id for s in table.recent()] == ids[-1:-4:-1]
    assert table.get(ids[0]) is None


def test_capacity_env_knob(monkeypatch):
    monkeypatch.setenv(session_mod.ENV_RECENT, "2")
    assert session_mod.SessionTable().capacity == 2
    monkeypatch.setenv(session_mod.ENV_RECENT, "many")
    assert session_mod.SessionTable().capacity \
        == j_session.SessionTable().capacity == session_mod.DEFAULT_RECENT


def test_disabled_registers_nothing():
    telemetry.set_enabled(False)
    assert session_mod.begin("a/b") is None
    session_mod.finish(None, "ok")
    assert session_mod.payload()["active"] == []
    assert session_mod.payload()["recent"] == []


def test_error_terminal_state():
    sess = session_mod.begin("a/b")
    session_mod.finish(sess, "error", error="ValueError: boom")
    snap = session_mod.SESSIONS.recent()[0].snapshot()
    assert snap["status"] == "error" and snap["error"] == "ValueError: boom"


def test_errored_session_keeps_progress_but_never_an_eta():
    class Stats:
        bytes_from_cache = 0
        bytes_from_peer = 0
        bytes_from_cdn = 400

    sess = session_mod.begin("a/b")
    sess.attach(fetch_stats=Stats())
    sess.set_total_bytes(1000)
    time.sleep(0.06)  # past the ETA warm-up floor
    assert "eta_s" in sess.snapshot()
    session_mod.finish(sess, "error", error="boom")
    snap = sess.snapshot()
    assert snap["progress"] == 0.4 and "eta_s" not in snap


def test_current_id_binding_and_sole_active_fallback():
    sess = session_mod.begin("a/b")
    assert session_mod.current_id() == sess.id
    other = session_mod.begin("a/c")
    assert session_mod.current_id() is None  # two active: no guess
    with session_mod.bind(other.id):
        assert session_mod.current_id() == other.id
    assert session_mod.current_id() is None
    session_mod.finish(sess, "ok")
    session_mod.finish(other, "ok")


def test_recorder_events_carry_session_id():
    sess = session_mod.begin("a/b")
    with session_mod.bind(sess.id):
        telemetry.record("fault_fired", fault="cdn_503")
    (ev,) = telemetry.recorder.tail(1)
    assert ev["session"] == sess.id
    with session_mod.bind(sess.id):
        assert telemetry.recorder.RECORDER.report()["session"] == sess.id
    session_mod.finish(sess, "ok")


def test_stage_observer_drives_phase():
    """The StageClock's entry/exit observer: the highest-ranked open
    stage is the phase, as in the JAX package."""
    from zest_tpu_torch.transfer.pull import StageClock

    sess = session_mod.begin("a/b")
    clock = StageClock()
    sess.attach(clock=clock)
    seen = []
    with clock("files"):
        seen.append(sess.phase)
        with clock("fetch"):
            seen.append(sess.phase)
        seen.append(sess.phase)
    seen.append(sess.phase)
    assert seen == ["files", "fetch", "files", "files"]
    session_mod.finish(sess, "ok")


# ── Pulls ──


def test_pull_registers_terminal_session(hub, tmp_path):
    res = pull_model(_cfg(hub, tmp_path), "acme/session-model",
                     device="cpu", land=False, no_p2p=True,
                     tenant="team-a", log=_quiet)
    payload = session_mod.payload()
    assert payload["active"] == []
    (snap,) = payload["recent"]
    assert snap["repo"] == "acme/session-model"
    assert snap["revision"] == res.stats["revision"]
    assert snap["tenant"] == "team-a" and "device" not in snap
    assert snap["status"] == "ok" and snap["progress"] == 1.0
    assert snap["bytes"]["cdn"] > 0
    assert snap["bytes"]["total"] == sum(len(v) for v in FILES.values())
    detail = session_mod.get(snap["id"]).snapshot(detail=True)
    assert detail["stats"] is res.stats
    assert detail["stages"].keys() == res.stats["stages"].keys()


def test_v1_pulls_payload_keys_equal_reference(hub, tmp_path):
    """The same files-only pull through both packages: the ``/v1/pulls``
    documents and their rows have the same keys (the detail view's
    stats are each package's own)."""
    pull_model(_cfg(hub, tmp_path / "p"), "acme/session-model",
               device="cpu", land=False, no_p2p=True, tenant="t",
               log=_quiet)
    j_pull.pull_model(JConfig(hf_home=tmp_path / "j/hf",
                              cache_dir=tmp_path / "j/zest",
                              hf_token="hf_test", endpoint=hub.url),
                      "acme/session-model", no_p2p=True, tenant="t",
                      log=_quiet)
    port, ref = session_mod.payload(), j_session.payload()
    assert port.keys() == ref.keys()
    (p_row,), (j_row,) = port["recent"], ref["recent"]
    assert p_row.keys() == j_row.keys()
    assert p_row["bytes"].keys() == j_row["bytes"].keys()
    assert (p_row["bytes"], p_row["status"], p_row["phase"],
            p_row["revision"]) == (j_row["bytes"], j_row["status"],
                                   j_row["phase"], j_row["revision"])
    p_det = session_mod.get(p_row["id"]).snapshot(detail=True)
    j_det = j_session.get(j_row["id"]).snapshot(detail=True)
    assert p_det.keys() == j_det.keys()


def test_knob_off_pull_byte_identical_with_empty_table(hub, tmp_path):
    on = pull_model(_cfg(hub, tmp_path / "on"), "acme/session-model",
                    device="cpu", land=False, no_p2p=True, log=_quiet)
    assert len(session_mod.payload()["recent"]) == 1
    session_mod.reset()
    telemetry.set_enabled(False)
    try:
        off = pull_model(_cfg(hub, tmp_path / "off"), "acme/session-model",
                         device="cpu", land=False, no_p2p=True, log=_quiet)
    finally:
        telemetry.set_enabled(None)
    for name, data in FILES.items():
        assert (on.snapshot_dir / name).read_bytes() == data
        assert (off.snapshot_dir / name).read_bytes() == data
    assert sorted(on.stats) == sorted(off.stats)
    p = session_mod.payload()
    assert p["active"] == [] and p["recent"] == []


def test_two_concurrent_pulls_distinct_correct_sessions(tmp_path):
    repos = {
        "acme/cc-small": gpt2_checkpoint_files(n_embd=32, seed=1),
        "acme/cc-large": gpt2_checkpoint_files(n_embd=96, n_layer=3, seed=2),
    }
    results: dict = {}
    fixtures = [FixtureRepo(rid, f, chunks_per_xorb=3)
                for rid, f in repos.items()]
    with FixtureHub(*fixtures) as h:
        def pull(repo_id, root):
            results[repo_id] = pull_model(_cfg(h, root), repo_id,
                                          device="cpu", no_p2p=True,
                                          log=_quiet)

        threads = [threading.Thread(target=pull, args=(rid, tmp_path / str(i)))
                   for i, rid in enumerate(repos)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    recent = {s.repo: s for s in session_mod.SESSIONS.recent()}
    assert set(recent) == set(repos)
    assert len({s.id for s in recent.values()}) == 2
    for rid, res in results.items():
        sess = recent[rid]
        assert sess.stats is res.stats
        assert sess.snapshot()["time_to_hbm_s"] == res.stats["time_to_hbm_s"]
        block = sess.landing_block()
        assert block["time_to_hbm_s"] == res.stats["time_to_hbm_s"]
        assert block["session"] == sess.id
    assert session_mod.last_landing()["session"] in {
        s.id for s in recent.values()}


def test_slo_breach_detection(hub, tmp_path):
    cfg = _cfg(hub, tmp_path, slo_tthbm_s=1e-6)
    telemetry.trace.install(None)
    res = pull_model(cfg, "acme/session-ckpt", device="cpu", no_p2p=True,
                     log=_quiet)
    assert res.stats["time_to_hbm_s"] > 1e-6
    assert telemetry.REGISTRY.counter(
        "zest_slo_breaches_total", "", ("slo",)).value(slo="tthbm") == 1
    breaches = [e for e in telemetry.recorder.tail()
                if e["kind"] == "slo_breach"]
    assert len(breaches) == 1
    (snap,) = session_mod.payload()["recent"]
    assert breaches[0]["session"] == snap["id"]
    assert breaches[0]["actual_s"] == res.stats["time_to_hbm_s"]
    # The JAX package's rule: the largest stage of the critical path.
    stages = res.stats["critical_path"]["stages"]
    assert breaches[0]["blamed_stage"] == max(stages, key=stages.get)
    assert snap["slo"]["tthbm"]["breached"] is True
    assert session_mod.SESSIONS.slo_burn()["tthbm"] \
        == {"pulls": 1, "breaches": 1, "burn": 1.0}


def test_slo_within_budget_counts_pull_not_breach(hub, tmp_path):
    pull_model(_cfg(hub, tmp_path, slo_tthbm_s=3600.0), "acme/session-ckpt",
               device="cpu", no_p2p=True, log=_quiet)
    assert not [e for e in telemetry.recorder.tail()
                if e["kind"] == "slo_breach"]
    assert session_mod.SESSIONS.slo_burn()["tthbm"] \
        == {"pulls": 1, "breaches": 0, "burn": 0.0}


def test_slo_env_knob_parses_strictly():
    for config in (Config, JConfig):
        cfg = config.load({"ZEST_SLO_TTHBM_S": "12.5",
                           "ZEST_SLO_TTFL_S": ""})
        assert cfg.slo_tthbm_s == 12.5 and cfg.slo_ttfl_s is None
        for bad in ({"ZEST_SLO_TTHBM_S": "fast"},
                    {"ZEST_SLO_TTFL_S": "-30"},
                    {"ZEST_SLO_TTHBM_S": "nan"}):
            with pytest.raises(ValueError):
                config.load(bad)
        assert config.load({"ZEST_SLO_TTHBM_S": "0"}).slo_tthbm_s is None
        assert config.load({"ZEST_TENANT": "t9"}).tenant == "t9"


# ── HTTP and CLI surfaces ──


@pytest.fixture
def api(hub, tmp_path):
    cfg = _cfg(hub, tmp_path / "daemon")
    server = PublisherServer(cfg, device="cpu").start()
    yield server, server.url
    server.close()


def test_v1_pulls_endpoints(api):
    _server, base = api
    sess = session_mod.begin("a/b", tenant="t")
    doc = _get(f"{base}/v1/pulls")
    assert [s["id"] for s in doc["active"]] == [sess.id]
    assert doc["tenancy"]["active"] == 0
    assert _get(f"{base}/v1/pulls/{sess.id}")["repo"] == "a/b"
    assert _status(f"{base}/v1/pulls/nope") == 404
    assert _status(f"{base}/v1/pulls/nope/events") == 404
    session_mod.finish(sess, "ok", stats={"elapsed_s": 0.1})
    doc = _get(f"{base}/v1/pulls")
    assert doc["active"] == [] and len(doc["recent"]) == 1
    st = _get(f"{base}/v1/status")
    assert st["pulls"] == {"active": 0, "recent": 1}
    assert st["tenancy"]["max_pulls"] == 4 and st["tenancy"]["enabled"]


def test_sse_stream_against_real_pull(api, tmp_path):
    """``GET /v1/pulls/<id>/events`` while a real fixture pull runs:
    start → progress… → done, the terminal event carrying the stats."""
    _server, base = api
    files = {"config.json": b'{"model_type": "test"}',
             "model.safetensors": bytes(range(256)) * 8192}  # 2 MiB
    with FixtureHub(FixtureRepo("acme/sse-model", files, chunks_per_xorb=3),
                    throttle_bps=8_000_000) as h:
        done: dict = {}

        def work():
            done["res"] = pull_model(_cfg(h, tmp_path), "acme/sse-model",
                                     device="cpu", land=False, no_p2p=True,
                                     log=_quiet)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        sid = None
        while time.monotonic() < deadline and sid is None:
            active = _get(f"{base}/v1/pulls")["active"]
            if active:
                sid = active[0]["id"]
            else:
                time.sleep(0.01)
        assert sid is not None, "pull never registered a live session"
        with urllib.request.urlopen(f"{base}/v1/pulls/{sid}/events",
                                    timeout=30) as resp:
            events = _sse(resp)
        t.join(timeout=30)
    kinds = [e["event"] for e in events]
    assert kinds[0] == "start" and kinds[-1] == "done"
    assert events[-1]["status"] == "ok"
    assert events[-1]["stats"]["files_downloaded"] \
        == done["res"].stats["files_downloaded"]
    assert all(e["id"] == sid for e in events)


def test_post_pull_landing_stream(api):
    """``POST /v1/pull`` with ``device: "cpu"`` lands the tree: the
    ``done`` event carries the landing's time to HBM and bytes, and the
    session shows under ``/v1/pulls`` with its tenant."""
    _server, base = api
    req = urllib.request.Request(
        f"{base}/v1/pull", method="POST",
        data=json.dumps({"repo_id": "acme/session-ckpt", "device": "cpu",
                         "tenant": "t-http"}).encode())
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert "text/event-stream" in resp.headers["Content-Type"]
        events = _sse(resp)
    assert events[0]["event"] == "start" and events[-1]["event"] == "done"
    stats = events[-1]["stats"]
    assert stats["time_to_hbm_s"] > 0 and stats["hbm"]["bytes"] > 0
    assert stats["device"] == "cpu"
    (row,) = _get(f"{base}/v1/pulls")["recent"]
    assert (row["tenant"], row["status"], row["device"]) \
        == ("t-http", "ok", "cpu")
    bad = urllib.request.Request(
        f"{base}/v1/pull", method="POST",
        data=json.dumps({"repo_id": "acme/x", "device": "tpu"}).encode())
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(bad, timeout=10)
    assert ei.value.code == 400


def test_device_pull_over_http_releases_its_tree_pin_where_the_reference_keeps_it(
        hub, tmp_path):
    """ROADMAP Queue 3 fault 2, repaired in the port: ``pull_events``
    drops the tree a device pull landed and, in the port, its
    ``tree:<repo>`` pin with it, so an eviction pass under the disk
    watermark evicts the revision's xorbs. The reference keeps the pin
    for the daemon's life (only ``release_tree``, the pool's ``close``,
    frees it)."""
    from zest_tpu.api.http_api import HttpApi as JHttpApi
    from zest_tpu_torch.api.http_api import HttpApi

    repo = "acme/session-ckpt"
    j_cfg = JConfig(hf_home=tmp_path / "ref" / "hf",
                    cache_dir=tmp_path / "ref" / "zest", hf_token="hf_test",
                    endpoint=hub.url)
    # The reference lands for the device word "tpu" only: on JAX's CPU
    # platform that is the CPU.
    for make, mod, cfg, device, keeps in (
            (lambda c: HttpApi(c, device="cpu"), tenancy,
             _cfg(hub, tmp_path / "port"), "cpu", False),
            (JHttpApi, j_tenancy, j_cfg, "tpu", True)):
        api = make(cfg)
        try:
            events = list(api.pull_events(repo, "main", device))
        finally:
            api.close()
        assert events[-1]["event"] == "done"
        assert events[-1]["stats"]["hbm"]["bytes"] > 0
        st = mod.state(cfg)
        cached = {f.name.split(".", 1)[0]
                  for f in cfg.xorb_cache_dir().rglob("*") if f.is_file()}
        assert cached
        armed = dataclasses.replace(cfg, tenant_disk_high=1,
                                    tenant_disk_low=1)
        if keeps:
            assert all(st.pins.pinned(h) for h in cached)
            assert st.pins.summary()["owners"] == 1
            assert mod.state(armed).evictor.maybe_evict(force=True) == 0
            assert mod.release_tree(armed, repo)
        else:
            assert not any(st.pins.pinned(h) for h in cached)
            assert st.pins.summary()["owners"] == 0
            assert not mod.release_tree(armed, repo)
        assert mod.state(armed).evictor.maybe_evict(force=True) > 0
        left = {f.name.split(".", 1)[0]
                for f in cfg.xorb_cache_dir().rglob("*") if f.is_file()}
        assert left < cached


def test_post_pull_answers_429_before_the_stream(api):
    server, base = api
    cfg = server.api.cfg
    cfg.tenant_max_pulls, cfg.tenant_queue = 1, 0
    st = tenancy.state(cfg)
    st.controller.acquire("hog")
    try:
        req = urllib.request.Request(
            f"{base}/v1/pull", method="POST",
            data=json.dumps({"repo_id": "acme/session-model"}).encode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        body = json.loads(ei.value.read())
        assert body["error"] == "admission queue full"
    finally:
        st.controller.release()
    assert tenancy.summary(cfg)["rejected_total"] == 1


def test_landing_block_comes_from_the_session_table():
    sess = session_mod.begin("a/b", device="cuda")
    session_mod.finish(sess, "ok", stats={
        "time_to_hbm_s": 6.0, "time_to_first_layer_s": 1.2,
        "time_to_swap_s": 0.8, "hbm": {"ring": {"stalls": 2}},
        "delta": {"fetched_ratio": 0.021, "delta_bytes_ratio": 0.02}})
    want = {"session": sess.id, "time_to_hbm_s": 6.0,
            "first_layer_s": 1.2, "first_layer_ratio": 0.2,
            "ring_stalls": 2, "delta_ratio": 0.021, "swap_s": 0.8}
    assert session_mod.last_landing() == want
    session_mod.reset()
    assert session_mod.last_landing() is None


def test_cmd_ps(api, monkeypatch, capsys):
    _server, base = api
    monkeypatch.setenv("ZEST_HTTP_PORT", base.rsplit(":", 1)[1])
    sess = session_mod.begin("a/b", tenant="team-x")
    assert cli.main(["ps"]) == 0
    out = capsys.readouterr().out
    assert sess.id in out and "a/b@main" in out and "team-x" in out
    assert "tenancy: 0/4 active  0/16 queued" in out
    assert cli.main(["ps", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["active"][0]["id"] == sess.id
    session_mod.finish(sess, "ok")


@pytest.mark.parametrize("payload", [
    {"active": [{"id": "p1", "repo": "a/b", "revision": "deadbeef",
                 "status": "running", "phase": "fetch", "progress": 0.42,
                 "eta_s": 3.0, "elapsed_s": 2.1, "tenant": "t"}],
     "recent": [{"id": "p0", "repo": "a/b", "revision": "deadbeef",
                 "status": "ok", "phase": "done", "progress": 1.0,
                 "elapsed_s": 5.0, "slo": {"tthbm": {"breached": True}}}],
     "slo": {"tthbm": {"pulls": 4, "breaches": 1, "burn": 0.25}}},
    {"active": [], "recent": [], "capacity": 32},
    {"active": [{"id": "p2", "repo": "org/model", "revision": "main",
                 "status": "running", "phase": "queued",
                 "elapsed_s": 0.3, "tenant": "b"}],
     "recent": [{"id": "p1", "repo": "org/model", "revision": "0" * 40,
                 "status": "cancelled", "phase": "cancelled",
                 "elapsed_s": 1.25, "progress": 0.31}],
     "tenancy": {"active": 1, "queued": 1, "max_pulls": 1,
                 "queue_cap": 1, "rejected_total": 2}},
], ids=["slo", "idle", "queued"])
def test_ps_lines_equal_reference(payload):
    lines = cli._ps_lines(payload)
    assert lines == j_cli._ps_lines(payload)
    if payload.get("slo"):
        joined = "\n".join(lines)
        assert "42%" in joined and "eta 3.0s" in joined
        assert "ok!slo" in joined
        assert "slo burn: tthbm=1/4 (25.0%)" in joined
