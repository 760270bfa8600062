"""The port's critical-path analyzer and the traced pull, held to the JAX
package's.

- ``tests/test_sessions.py::TestCritpath``'s eight cases on the port's
  ``telemetry.critpath`` and a traced ``pull_model(device="cpu")``;
- identity: ``analyze_doc``, ``analyze_tracer``, ``categorize`` and
  ``render_text`` give the JAX package's output on the same hand-built
  docs, on a merged doc with ``host=``, and on a port pull's export;
- the span schema: a traced port pull and a traced reference pull of one
  fixture, plain and cooperative, record the same span names and the
  same ``categorize`` stages, but for the divergences listed here;
- two gates of ``scripts/critpath_smoke.py`` on a fixture landing: the
  path covers >= 90% of ``time_to_hbm_s`` and the stage split sums to
  the path.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from tests.fixtures import FixtureHub, FixtureRepo, gpt2_checkpoint_files
from zest_tpu import telemetry as j_telemetry
from zest_tpu.bench_scale import llama_checkpoint_files
from zest_tpu.config import Config as JConfig
from zest_tpu.telemetry import critpath as j_critpath
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer import tenancy as j_tenancy
from zest_tpu_torch import cli, telemetry
from zest_tpu_torch.config import Config
from zest_tpu_torch.telemetry import critpath
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
COOP_REPO = "acme/fleet-model"
COOP_FILES = {
    "config.json": b'{"model_type": "fleet"}',
    "model.safetensors": np.random.default_rng(11).integers(
        0, 4, 1_200_000, dtype=np.uint8).tobytes(),
}
SMOKE_FILES = llama_checkpoint_files(0.016, shard_bytes=4 * 1024 * 1024,
                                     scale=8)


def _quiet(*_a, **_k):
    pass


@pytest.fixture(scope="module")
def hub():
    repos = (FixtureRepo("acme/session-model", FILES, chunks_per_xorb=3),
             FixtureRepo("acme/session-ckpt",
                         gpt2_checkpoint_files(n_embd=32, n_layer=2),
                         chunks_per_xorb=3),
             FixtureRepo(COOP_REPO, COOP_FILES, chunks_per_xorb=2),
             FixtureRepo("smoke/critpath", SMOKE_FILES, chunks_per_xorb=16))
    with FixtureHub(*repos) as h:
        yield h


def _cfg(hub, root, **kw):
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _jcfg(hub, root, **kw):
    return JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                   hf_token="hf_test", endpoint=hub.url, **kw)


# ── test_sessions.py::TestCritpath on the port ──


def _iv(name, t0, t1, **attrs):
    return critpath._Iv(name, t0, t1, attrs)


def test_hand_built_dag_ground_truth():
    """pull 0..10 ─ resolve 0..1; fetch stage 1..4 with a cdn span
    1.5..3.5; landing 4..9 with decode 4..6 and commit 6..8.5; nothing
    9..10 (idle)."""
    spans = [
        _iv("pull", 0, 10, repo="a/b"),
        _iv("stage.resolve", 0, 1),
        _iv("stage.fetch", 1, 4),
        _iv("cdn.fetch", 1.5, 3.5),
        _iv("stage.hbm_commit", 4, 9),
        _iv("land.decode", 4, 6),
        _iv("hbm.commit", 6, 8.5),
    ]
    rep = critpath._analyze(spans)
    assert rep["root"]["wall_s"] == 10
    assert rep["path_s"] == 9.0 and rep["idle_s"] == 1.0
    assert rep["coverage"] == 0.9
    assert rep["stages"] == {"fetch": 3.0, "commit": 3.0,
                             "decode": 2.0, "metadata": 1.0}
    assert sum(rep["stages"].values()) == pytest.approx(rep["path_s"])
    assert rep["tiers"] == {"cdn": 2.0}
    assert rep["by_name"]["cdn.fetch"] == 2.0
    assert rep["by_name"]["stage.fetch"] == 1.0
    assert rep["top_spans"][0]["blamed_s"] == 2.5
    assert rep["top_spans"][0]["name"] == "hbm.commit"


def test_no_root_raises():
    with pytest.raises(critpath.AnalyzeError):
        critpath._analyze([_iv("stage.fetch", 0, 1)])


def test_newest_root_selects_last_pull():
    spans = [_iv("pull", 0, 10), _iv("stage.fetch", 0, 10),
             _iv("pull", 20, 22), _iv("stage.resolve", 20, 22)]
    rep = critpath._analyze(spans, newest_root=True)
    assert rep["root"]["wall_s"] == 2
    assert rep["stages"] == {"metadata": 2.0}


def test_explicit_root_pins_window_over_newest():
    spans = [_iv("pull", 0, 10), _iv("stage.fetch", 0, 10),
             _iv("pull", 20, 22), _iv("stage.resolve", 20, 22)]
    rep = critpath._analyze(spans, newest_root=True,
                            root=_iv("pull", 0, 10))
    assert rep["root"]["wall_s"] == 10
    assert rep["stages"] == {"fetch": 10.0}


def test_doc_round_trip_matches_live(hub, tmp_path):
    tracer = telemetry.trace.install(None)
    res = pull_model(_cfg(hub, tmp_path), "acme/session-ckpt",
                     device="cpu", no_p2p=True, log=_quiet)
    cp = res.stats["critical_path"]
    assert cp["path_s"] >= 0.9 * res.stats["time_to_hbm_s"]
    assert sum(cp["stages"].values()) == pytest.approx(cp["path_s"],
                                                       abs=0.01)
    out = tmp_path / "t.json"
    tracer.export(out)
    doc = json.loads(out.read_text())
    offline = critpath.analyze_doc(doc)
    for stage, sec in cp["stages"].items():
        assert offline["stages"].get(stage, 0.0) == \
            pytest.approx(sec, abs=0.02 + 0.02 * sec)
    # The JAX package's analyzer reads the port's export alike.
    assert j_critpath.analyze_doc(doc) == offline


SPAWN_DELAY_S = 0.05


def test_landing_starts_no_thread_outside_a_span(hub, tmp_path, monkeypatch):
    """Every thread the pull's own thread starts during a CPU landing is
    started under a span (or, for the process's sampler, before ``t0``):
    with each such start slowed by ``SPAWN_DELAY_S``, the uncovered wall
    stays under one delay and the 0.9 gate holds. A start outside every
    span (a header prefetch on a CPU landing, the file workers' first
    submit, the warm fetch's first poke) would add a whole delay to
    ``idle_s``. This is what a loaded machine does to a thread's start,
    made large enough to see on one pull."""
    import threading
    import time

    pulling = threading.current_thread()
    start = threading.Thread.start

    def slow_start(self):
        if threading.current_thread() is pulling:
            time.sleep(SPAWN_DELAY_S)
        return start(self)

    tracer = telemetry.trace.install(None)
    monkeypatch.setattr(threading.Thread, "start", slow_start)
    res = pull_model(_cfg(hub, tmp_path), "acme/session-ckpt",
                     device="cpu", no_p2p=True, log=_quiet)
    monkeypatch.undo()
    cp = res.stats["critical_path"]
    assert cp["idle_s"] < SPAWN_DELAY_S, cp
    assert cp["path_s"] >= 0.9 * res.stats["time_to_hbm_s"], cp
    assert {s.name for s in tracer.spans()} >= {"stage.files",
                                                "stage.fetch"}


TAIL_DELAY_S = 0.05


def test_files_only_tail_runs_inside_a_span(hub, tmp_path, monkeypatch):
    """A files-only pull's bookkeeping after the files join (the bridge's
    close, the ref, the delta manifest) runs inside ``stage.files``: with
    each slowed by ``TAIL_DELAY_S``, the wall of ``pull`` outside every
    span stays under 10 ms. Outside the stage each delay would land
    whole in ``idle_s``; this is what a loaded machine does to the
    ~0.5 ms each takes, made large enough to see on one pull. The file
    workers' thread starts from the pull's thread are slowed too: they
    run under the stage as well."""
    import threading
    import time

    from zest_tpu_torch import storage
    from zest_tpu_torch.transfer import bridge as bridge_mod
    from zest_tpu_torch.transfer import pull as pull_mod

    def slowed(fn):
        def run(*a, **k):
            time.sleep(TAIL_DELAY_S)
            return fn(*a, **k)
        return run

    monkeypatch.setattr(bridge_mod.XetBridge, "close",
                        slowed(bridge_mod.XetBridge.close))
    monkeypatch.setattr(storage, "write_ref", slowed(storage.write_ref))
    monkeypatch.setattr(pull_mod, "_save_manifest",
                        slowed(pull_mod._save_manifest))
    # The file workers' starts from the pull's own thread, slowed alike.
    pulling = threading.current_thread()
    start = threading.Thread.start

    def slow_start(self):
        if threading.current_thread() is pulling:
            time.sleep(TAIL_DELAY_S)
        return start(self)

    monkeypatch.setattr(threading.Thread, "start", slow_start)
    tracer = telemetry.trace.install(None)
    cfg = _cfg(hub, tmp_path)
    assert cfg.delta_pull  # the manifest is written
    res = pull_model(cfg, "acme/session-model", device="cpu", land=False,
                     no_p2p=True, log=_quiet)
    monkeypatch.undo()
    cp = res.stats["critical_path"]
    assert cp["idle_s"] < 0.01, cp
    assert cp["root"]["wall_s"] >= 3 * TAIL_DELAY_S, cp
    assert "stage.files" in {s.name for s in tracer.spans()}


def test_untraced_pull_has_no_critical_path(hub, tmp_path):
    res = pull_model(_cfg(hub, tmp_path), "acme/session-model",
                     device="cpu", land=False, no_p2p=True, log=_quiet)
    assert "critical_path" not in res.stats


def _ev(name, ts, dur, host, **args):
    return {"name": name, "ph": "X", "ts": ts * 1e6, "dur": dur * 1e6,
            "pid": 1, "tid": host, "args": {"host": host, **args}}


def test_merged_doc_host_filter():
    doc = {"traceEvents": [
        _ev("pull", 0, 10, 0), _ev("stage.fetch", 0, 10, 0),
        _ev("pull", 0, 4, 1), _ev("stage.files", 0, 4, 1),
    ]}
    rep = critpath.analyze_doc(doc)  # dominant root → host 0
    assert rep["root"]["host"] == 0
    assert rep["stages"] == {"fetch": 10.0}
    rep1 = critpath.analyze_doc(doc, host=1)
    assert rep1["stages"] == {"files": 4.0}


def test_analyze_cli(hub, tmp_path, capsys):
    tracer = telemetry.trace.install(None)
    pull_model(_cfg(hub, tmp_path), "acme/session-model", device="cpu",
               land=False, no_p2p=True, log=_quiet)
    out = tmp_path / "t.json"
    tracer.export(out)
    assert cli.main(["analyze", str(out), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["root"]["name"] == "pull"
    # A ~50 ms fixture pull's fixed setup is a visible idle share; the
    # 90% gate runs on a landing below.
    assert doc["coverage"] >= 0.8
    assert cli.main(["analyze", str(out)]) == 0
    text = capsys.readouterr().out
    assert "critical path" in text and "stage split" in text
    assert cli.main(["analyze", str(tmp_path / "missing.json")]) == 1


# ── Identity with the JAX package's analyzer ──

NAMES = ["pull", "stage.resolve", "stage.cas_metadata", "cas.reconstruction",
         "stage.fetch", "fetch.term", "fetch.unit", "cdn.get", "cdn.fetch",
         "cdn.stream", "swarm.fetch", "peer.connect", "peer.request",
         "dcn.serve", "dcn.request_many", "coop.round", "coop.fetch",
         "coop.exchange", "coop.collective.phase0", "coop.collective.barrier",
         "collective.lane", "collective.loopback", "push", "push.encode",
         "federated.round", "pod.round", "pod.expert_round", "warm.units",
         "land.decode", "land.slice", "stage.decode", "hbm.commit",
         "stage.hbm_commit", "delta.swap", "delta.plan", "stage.files",
         "files.commit", "tenancy.queued", "stage.first_layer",
         "stage.coop_verify", "stage.coop_fetch", "stage.coop",
         "hbm_pool.land", "something.else", ""]


def test_categorize_equals_reference():
    assert [critpath.categorize(n) for n in NAMES] == \
        [j_critpath.categorize(n) for n in NAMES]
    assert critpath.categorize("tenancy.queued") == "queued"
    assert critpath.categorize("coop.collective.barrier") == "barrier"


def _docs():
    """Hand-built docs: nested and cross-thread spans, tiers by attr and
    by name, a skipped stat interval, clipping at the root's edges, two
    roots, a bare-array doc and malformed events."""
    ev = _ev
    plain = {"traceEvents": [
        ev("pull", 0, 10, 0, repo="a/b", revision="0123456789abcdef"),
        ev("stage.first_layer", 0, 6, 0),
        ev("stage.resolve", 0, 0.5, 0),
        ev("cas.reconstruction", 0.5, 0.7, 0),
        ev("stage.fetch", 1, 5, 0),
        ev("fetch.term", 1.1, 2, 0, source="peer"),
        ev("swarm.fetch", 1.2, 1.9, 0),
        ev("cdn.get", 2, 4, 0),
        ev("dcn.request_many", 3, 3.5, 0),
        ev("coop.collective.phase1", 3.2, 3.4, 0, link="ici"),
        ev("coop.collective.barrier", 3.4, 3.5, 0),
        ev("stage.coop_verify", 4.5, 4.8, 0),
        ev("stage.hbm_commit", 5, 9.5, 0),
        ev("land.slice", 5, 6, 0),
        ev("hbm.commit", 6, 7.5, 0),
        ev("delta.swap", 7.5, 8, 0),
        ev("stage.files", 8, 12, 0),
        ev("files.commit", 9, 9.2, 0),
        ev("push", -1, 0.3, 0),
        ev("tenancy.queued", 0.1, 0.2, 0),
        {"name": "bad", "ph": "X", "ts": "x", "dur": 1},
        {"name": "meta", "ph": "M"},
    ]}
    two_roots = {"traceEvents": [
        ev("pull", 0, 3, 0), ev("stage.fetch", 0, 3, 0),
        ev("pull", 5, 9, 0), ev("stage.files", 5, 8, 0),
    ]}
    bare = [ev("pull", 0, 2, 0), ev("collective.lane", 0.5, 1.5, 0),
            ev("warm.units", 0, 1, 0)]
    merged = {"traceEvents": [
        ev("pull", 0, 10, 0), ev("coop.round", 0, 9, 0),
        ev("coop.exchange", 2, 8, 0), ev("dcn.serve", 2.5, 3, 1),
        ev("pull", 0, 12, 1), ev("coop.round", 0, 11, 1),
        ev("coop.fetch", 0, 6, 1), ev("fetch.unit", 1, 5, 1),
        ev("stage.decode", 0, 1, 2),
    ]}
    return {"plain": plain, "two_roots": two_roots, "bare": bare,
            "merged": merged}


@pytest.mark.parametrize("name", sorted(_docs()))
@pytest.mark.parametrize("host", [None, 0, 1, "1"])
@pytest.mark.parametrize("top_k", [0, 3, 8])
def test_analyze_doc_equals_reference(name, host, top_k):
    def run(mod):
        try:
            return mod.analyze_doc(_docs()[name], host=host, top_k=top_k)
        except mod.AnalyzeError as exc:  # a host with no root span
            return str(exc)

    mine = run(critpath)
    assert mine == run(j_critpath)
    if isinstance(mine, dict):
        assert critpath.render_text(mine) == j_critpath.render_text(mine)


def test_analyze_doc_errors_equal_reference():
    for doc in ({"traceEvents": [_ev("stage.fetch", 0, 1, 0)]},
                {"traceEvents": [_ev("pull", 1, 0, 0)]}, "not a doc"):
        with pytest.raises(critpath.AnalyzeError) as mine:
            critpath.analyze_doc(doc)
        with pytest.raises(j_critpath.AnalyzeError) as ref:
            j_critpath.analyze_doc(doc)
        assert str(mine.value) == str(ref.value)


class _Span:
    def __init__(self, name, t0, t1, **attrs):
        self.name, self.t0, self.t1, self.attrs = name, t0, t1, attrs


class _Tracer:
    def __init__(self, spans):
        self._spans = spans

    def spans(self):
        return list(self._spans)


def test_analyze_tracer_equals_reference():
    def tracer():
        return _Tracer([
            _Span("pull", 0.0, 4.0, repo="x"),
            _Span("stage.fetch", 0.5, 3.0),
            _Span("cdn.fetch", 1.0, 2.0),
            _Span("pull", 5.0, 6.0),
            _Span("stage.files", 5.0, 5.5),
        ])

    for root in (None, _Span("pull", 0.0, 4.0, repo="x"),
                 _Span("pull", 0.0, 0.0)):
        assert critpath.analyze_tracer(tracer(), root_span=root) == \
            j_critpath.analyze_tracer(tracer(), root_span=root)
    assert critpath.analyze_tracer(_Tracer([])) is None
    assert critpath.analyze_tracer(_Tracer([]), top_k=2) == \
        j_critpath.analyze_tracer(_Tracer([]), top_k=2)


# ── The span schema of a traced pull ──

# Names only the port's traced coop pull records, each with the divergence
# it records. Categories: stage.coop and the coop phase stages → other;
# stage.coop_verify → verify. A plain pull records the reference's names,
# cdn.stream (fetch) included: with no peer tier both warm fetches stream
# each CDN unit into the cache.
PORT_ONLY = {
    # The port's StageClock also times the cooperative round and its
    # phases and receipt verification, as stats["stages"] keys.
    "stage.coop", "stage.coop_fetch", "stage.coop_exchange",
    "stage.coop_verify",
}
# A files-only coop pull: the port's copy-range cache lane writes the
# file to a temp name committed at the exit barrier; the reference's
# files-only lane writes it in place.
PORT_ONLY_FILES = {"files.commit"}


def _coop_pull(pkg: str, hub, root):
    """A traced cooperative pull over two hosts, host 1 a DCN server
    holding its share of the plan."""
    if pkg == "port":
        from zest_tpu_torch.cas.hub import HubClient
        from zest_tpu_torch.transfer.bridge import XetBridge
        from zest_tpu_torch.transfer.coop import CoopPlan
        from zest_tpu_torch.transfer.dcn import DcnServer
        from zest_tpu_torch.transfer.federated import warm_units_parallel
        tel, cfg_cls, pull = telemetry, Config, pull_model
        kw = {"device": "cpu", "land": False}
    else:
        from zest_tpu.cas.hub import HubClient
        from zest_tpu.transfer.bridge import XetBridge
        from zest_tpu.transfer.coop import CoopPlan
        from zest_tpu.transfer.dcn import DcnServer
        from zest_tpu.transfer.federated import warm_units_parallel
        tel, cfg_cls, pull = j_telemetry, JConfig, j_pull.pull_model
        kw = {}
    peer_cfg = cfg_cls(hf_home=root / "peer/hf", cache_dir=root / "peer/z",
                       hf_token="hf_test", endpoint=hub.url, dcn_port=0)
    bridge = XetBridge(peer_cfg)
    bridge.authenticate(COOP_REPO)
    recs = [bridge.get_reconstruction(e.xet_hash)
            for e in HubClient(peer_cfg).list_files(COOP_REPO) if e.is_xet]
    warm_units_parallel(bridge, recs,
                        units=CoopPlan.build(recs, 2).for_host(1))
    server = DcnServer(peer_cfg, bridge.cache)
    port = server.start()
    tracer = tel.trace.install(None)
    cfg = cfg_cls(hf_home=root / "h0/hf", cache_dir=root / "h0/z",
                  hf_token="hf_test", endpoint=hub.url, dcn_port=0)
    try:
        pull(cfg, COOP_REPO, no_p2p=True, coop=True, coop_hosts=2,
             coop_index=0, coop_addrs={1: ("127.0.0.1", port)}, log=_quiet,
             **kw)
    finally:
        server.shutdown()
        bridge.close()
    return {s.name for s in tracer.spans()}


def _plain_pull(pkg: str, hub, root):
    if pkg == "port":
        tracer = telemetry.trace.install(None)
        pull_model(_cfg(hub, root), "acme/session-ckpt", device="cpu",
                   no_p2p=True, log=_quiet)
    else:
        tracer = j_telemetry.trace.install(None)
        j_pull.pull_model(_jcfg(hub, root), "acme/session-ckpt",
                          device="tpu", pod=False, no_p2p=True, log=_quiet)
    return {s.name for s in tracer.spans()}


@pytest.mark.parametrize("kind", ["plain", "coop"])
def test_span_schema_equals_reference(hub, tmp_path, kind):
    run = _plain_pull if kind == "plain" else _coop_pull
    port = run("port", hub, tmp_path / "port")
    ref = run("ref", hub, tmp_path / "ref")
    port_only = PORT_ONLY | PORT_ONLY_FILES if kind == "coop" else set()
    assert port - port_only == ref, (sorted(port - ref), sorted(ref - port))
    assert {critpath.categorize(n) for n in port - port_only} == \
        {j_critpath.categorize(n) for n in ref}
    # Every listed divergence is one that this pull shows.
    assert port & port_only if kind == "coop" else not port_only
    if kind == "coop":
        assert {"coop.round", "coop.fetch", "coop.exchange",
                "dcn.request_many", "dcn.serve"} <= port
    else:
        assert {"stage.hbm_commit", "hbm.commit", "land.slice",
                "cas.reconstruction", "cdn.get", "cdn.stream"} <= port
        assert "fetch.unit" not in port


# ── scripts/critpath_smoke.py's first two gates on a fixture landing ──


def test_critpath_smoke_gates(hub, tmp_path):
    telemetry.set_enabled(True)
    telemetry.trace.install(None)
    res = pull_model(_cfg(hub, tmp_path), "smoke/critpath", device="cpu",
                     no_p2p=True, log=_quiet)
    cp = res.stats["critical_path"]
    tth = res.stats["time_to_hbm_s"]
    # Gate 1: the path covers >= 90% of the landing wall.
    assert cp["path_s"] >= 0.9 * tth, cp
    # Gate 2: the stage split sums to the path (rounding only).
    split = sum(cp["stages"].values())
    assert abs(split - cp["path_s"]) <= 0.01 + 1e-4 * len(cp["stages"]), cp
