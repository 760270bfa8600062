"""The self-healing control plane of the port, held to the JAX package's.

Mirrors ``tests/test_remediate.py``. The same anomaly and tick sequences
go through both packages' engines, with the same targets, and the
decision logs must be equal row for row (action, outcome, anomaly,
reason, detail; the wall stamps and the before/after snapshots, which
carry monotonic stamps, left out unless a case pins them): the token
buckets, the action mask, dry run, the straggler's patience, shed and
its recovery, the seeder scan's demote evidence and cooldown, the ring
tuner's rails and damping, and the serving pool's rules. The payload and
``zest heal``'s ``_heal_lines`` match, the ``Config`` fields and their
errors match, ``ZEST_REMEDIATE=0`` keeps the pull's stats schema, and
the owners' targets (the swarm's ``peer_health``/``demote``, the
pool's ``pool_land``/``pool_shed``, the pull's ``hedge:<sid>``) carry
the reference's names. A real collective over loopback, whose partner
holds only part of its units, is aborted by the engine with
``"remediation"`` and the ladder caches every unit.
"""

from __future__ import annotations

import json
import random
import time
from types import SimpleNamespace

import pytest

from tests.fixtures import FixtureHub, FixtureRepo
from zest_tpu import cli as j_cli
from zest_tpu import telemetry as j_telemetry
from zest_tpu.config import Config as JConfig
from zest_tpu.telemetry import remediate as j_remediate
from zest_tpu.telemetry import session as j_session
from zest_tpu.telemetry import timeline as j_timeline
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer import tenancy as j_tenancy
from zest_tpu_torch import cli, faults, telemetry
from zest_tpu_torch.api.http_api import PublisherServer
from zest_tpu_torch.config import Config
from zest_tpu_torch.telemetry import remediate
from zest_tpu_torch.telemetry import session as session_mod
from zest_tpu_torch.telemetry import timeline
from zest_tpu_torch.transfer import tenancy
from zest_tpu_torch.transfer.pull import pull_model

PACKAGES = {
    "port": SimpleNamespace(tl=timeline, rm=remediate, sess=session_mod,
                            tel=telemetry),
    "reference": SimpleNamespace(tl=j_timeline, rm=j_remediate,
                                 sess=j_session, tel=j_telemetry),
}

ENV = ("ZEST_REMEDIATE", "ZEST_REMEDIATE_ACTIONS", "ZEST_REMEDIATE_DRY",
       "ZEST_REMEDIATE_RATE_S", "ZEST_REMEDIATE_BURST",
       "ZEST_REMEDIATE_PATIENCE", "ZEST_REMEDIATE_BURN_MAX",
       "ZEST_REMEDIATE_OBSERVE_S", "ZEST_TIMELINE", "ZEST_TELEMETRY",
       "ZEST_TIMELINE_HZ", "ZEST_ANOMALY_WINDOW_S")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for mod, tel in ((tenancy, telemetry), (j_tenancy, j_telemetry)):
        tel.reset_all()
        mod.reset()
    faults.reset()
    yield
    faults.reset()
    for mod, tel in ((tenancy, telemetry), (j_tenancy, j_telemetry)):
        tel.reset_all()
        mod.reset()


def _quiet(*_a, **_k):
    pass


def _rows(rm, ids=(), snapshots=False):
    """The decision log without wall stamps (and without snapshots unless
    asked), session ids renamed ``S0``, ``S1``..."""
    keep = ("action", "outcome", "anomaly", "session", "reason",
            "dry_run", "detail") + (("before", "after") if snapshots
                                    else ())
    text = json.dumps([{k: e[k] for k in keep}
                       for e in rm.payload(limit=256)["recent"]],
                      sort_keys=True)
    for i, sid in enumerate(ids):
        text = text.replace(sid, f"S{i}")
    return json.loads(text)


def _run(script, **kw):
    """``script(pkg, calls)`` on each package's fresh engine; returns
    ``{name: (rows, calls, payload-minus-recent)}``."""
    out = {}
    for name, pkg in PACKAGES.items():
        assert pkg.rm.ensure_started()
        calls: list = []
        ids = script(pkg, calls) or ()
        doc = pkg.rm.payload(limit=256)
        doc.pop("recent")
        text = json.dumps(doc, sort_keys=True)
        for i, sid in enumerate(ids):
            text = text.replace(sid, f"S{i}")
        out[name] = (_rows(pkg.rm, ids, **kw), calls, json.loads(text))
    return out


def _same(out):
    assert out["port"] == out["reference"]
    return out["port"]


def _counts(rows, action):
    c: dict = {}
    for r in rows:
        if r["action"] == action:
            c[r["outcome"]] = c.get(r["outcome"], 0) + 1
    return c


# ── The enable gate ──


def test_enable_gate_matches_reference(monkeypatch):
    for pkg in PACKAGES.values():
        assert pkg.rm.enabled() is True
    assert remediate.ACTIONS == j_remediate.ACTIONS
    monkeypatch.setenv("ZEST_REMEDIATE", "0")
    for pkg in PACKAGES.values():
        assert pkg.rm.enabled() is False
        assert pkg.rm.ensure_started() is False
        assert pkg.rm.register_target("hedge:x", lambda r: None) is False
        assert pkg.rm.ENGINE is None
    assert remediate.payload() == j_remediate.payload() == {
        "enabled": False, "counts": {}, "recent": []}
    assert remediate.status_block() == j_remediate.status_block()
    monkeypatch.delenv("ZEST_REMEDIATE")
    monkeypatch.setenv("ZEST_TIMELINE", "0")
    for pkg in PACKAGES.values():
        pkg.tl.reset()
        assert pkg.rm.enabled() is False


@pytest.mark.parametrize("raw", [None, "", "all", "hedge, demote",
                                 "hedge,typo", "TUNE,shed", ",,"])
def test_parse_actions_matches_reference(raw):
    assert remediate.parse_actions(raw) == j_remediate.parse_actions(raw)


# ── The decision spine: mask → bucket → dry run → execute ──


def _hedge_script(kind, n=1, fire_through_detector=False, target=True,
                  fn=None):
    def script(pkg, calls):
        sess = pkg.sess.begin("acme/m", "main")
        if target:
            pkg.rm.register_target(
                f"hedge:{sess.id}",
                fn or (lambda reason: calls.append(reason)
                       or {"armed": True}))
        for _ in range(n):
            if fire_through_detector:
                pkg.tl.STORE.detector._fire(kind, session=sess,
                                            phase="fetch", bytes_done=7)
            else:
                pkg.rm.ENGINE.on_anomaly(kind, sess, {})
        pkg.sess.finish(sess, "ok")
        return [sess.id]
    return script


def _boom(reason):
    raise RuntimeError("target exploded")


SPINE = {
    "stall_through_listener": ({}, _hedge_script(
        "stall", fire_through_detector=True), {"success": 1}),
    "collapse_maps_to_hedge": ({}, _hedge_script("throughput_collapse"),
                               {"success": 1}),
    "hedge_without_target_is_silent": ({}, _hedge_script(
        "stall", target=False), {}),
    "token_bucket": ({}, _hedge_script("stall", n=5),
                     {"success": 3, "rate_limited": 2}),
    "burst_env": ({"ZEST_REMEDIATE_BURST": "1"},
                  _hedge_script("stall", n=3),
                  {"success": 1, "rate_limited": 2}),
    "mask_disables": ({"ZEST_REMEDIATE_ACTIONS": "strike,shed"},
                      _hedge_script("stall"), {"disabled": 1}),
    "dry_run": ({"ZEST_REMEDIATE_DRY": "1"}, _hedge_script("stall"),
                {"dry_run": 1}),
    "failing_target": ({}, _hedge_script("stall", fn=_boom),
                       {"failed": 1}),
}


@pytest.mark.parametrize("case", sorted(SPINE))
def test_decision_spine_matches_reference(case, monkeypatch):
    env, script, want = SPINE[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rows, calls, doc = _same(_run(script))
    assert _counts(rows, "hedge") == want
    if want.get("success"):
        assert calls == [f"anomaly:{rows[0]['anomaly']}"] * want["success"]
    else:
        assert calls == []
    if case == "failing_target":
        assert rows[0]["detail"]["error"] == "target exploded"
    if case == "dry_run":
        assert doc["dry_run"] is True and rows[0]["dry_run"] is True


def test_decision_carries_before_after_snapshots():
    def script(pkg, calls):
        pkg.tl.STORE._append("fetch.cdn_bps", 5.0, "rate", 1.0)
        ids = _hedge_script("stall", fire_through_detector=True)(pkg, calls)
        pkg.tl.STORE._append("fetch.cdn_bps", 0.0, "rate", 2.0)
        pkg.rm.ENGINE._settle_after()
        return ids

    rows, _calls, _doc = _same(_run(script, snapshots=True))
    (row,) = rows
    assert row["before"] == {"fetch.cdn_bps": [[1.0, 5.0]]}
    assert row["after"] == {"fetch.cdn_bps": [[1.0, 5.0], [2.0, 0.0]]}
    for pkg in PACKAGES.values():
        (ev,) = [e for e in pkg.tel.recorder.tail()
                 if e["kind"] == "remediation"]
        assert ev["before"] == {"fetch.cdn_bps": [[1.0, 5.0]]}
        json.dumps(ev)


def test_unregister_target_is_identity_checked():
    for pkg in PACKAGES.values():
        assert pkg.rm.ensure_started()
        eng = pkg.rm.ENGINE
        a, b = (lambda r: "a"), (lambda r: "b")
        pkg.rm.register_target("hedge:x", a)
        pkg.rm.register_target("hedge:x", b)
        pkg.rm.unregister_target("hedge:x", a)
        assert eng._targets.get("hedge:x") is b
        pkg.rm.unregister_target("hedge:x", b)
        assert "hedge:x" not in eng._targets
    assert remediate.invoke("hedge:x") is None


# ── The straggler: strike, then abort past the patience ──


def _straggler(firings, partner=3, reregister_after=None):
    def script(pkg, calls):
        def target(cmd, p):
            calls.append((cmd, p))
            return {"cmd": cmd}
        pkg.rm.register_target("collective", target)
        for i in range(firings):
            if reregister_after is not None and i == reregister_after:
                pkg.rm.register_target("collective", target)
            fields = {"barrier_wait_s": 2.0}
            if partner is not None:
                fields["partner"] = partner
            pkg.rm.ENGINE.on_anomaly("collective_straggler", None, fields)
    return script


STRAGGLER = {
    "default_patience": ({}, _straggler(3),
                         [("strike", 3), ("abort", 3), ("abort", 3)]),
    "patience_1": ({"ZEST_REMEDIATE_PATIENCE": "1"}, _straggler(2),
                   [("abort", 3), ("abort", 3)]),
    "registration_resets": ({}, _straggler(3, partner=1,
                                           reregister_after=2),
                            [("strike", 1), ("abort", 1), ("strike", 1)]),
    "no_partner_is_silent": ({}, _straggler(2, partner=None), []),
}


@pytest.mark.parametrize("case", sorted(STRAGGLER))
def test_straggler_matches_reference(case, monkeypatch):
    env, script, want = STRAGGLER[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rows, calls, _doc = _same(_run(script))
    assert calls == want
    assert [r["detail"]["cmd"] for r in rows] == [c for c, _p in want]


# ── Shed on queue_stuck + SLO burn, and its recovery ──


def _shed(burns, recover_at=None, drain_bucket=False):
    def script(pkg, calls):
        burn = iter(burns)
        state = {"b": next(burn)}
        pkg.rm._worst_burn_saved = pkg.rm._worst_burn
        pkg.rm._worst_burn = lambda: state["b"]
        try:
            pkg.rm.register_target("shed",
                                   lambda cmd: calls.append(cmd) or {})
            pkg.rm.ENGINE.on_anomaly("queue_stuck", None, {"depth": 9})
            if drain_bucket:
                b = pkg.rm.ENGINE._bucket("shed")
                while b.take(time.monotonic()):
                    pass
            for b in burn:
                state["b"] = b
                pkg.rm.ENGINE._maybe_recover_shed()
        finally:
            pkg.rm._worst_burn = pkg.rm._worst_burn_saved
            del pkg.rm._worst_burn_saved
    return script


SHED = {
    "skipped_without_burn": (_shed([0.0]), [], False),
    "fires_with_burn": (_shed([0.5]), ["shed"], True),
    "recovery_is_ungated": (_shed([0.5, 0.0], drain_bucket=True),
                            ["shed", "recover"], False),
    "recovery_waits_for_half_burn": (_shed([0.5, 0.075, 0.06]),
                                     ["shed"], True),
}


@pytest.mark.parametrize("case", sorted(SHED))
def test_shed_matches_reference(case):
    script, want, shedding = SHED[case]
    rows, calls, doc = _same(_run(script))
    assert calls == want and doc["shedding"] is shedding
    if case == "skipped_without_burn":
        assert rows[0]["detail"]["cmd"] == "none"


def test_worst_burn_reads_the_session_table():
    for pkg in PACKAGES.values():
        for breached in (True, False, False, False):
            pkg.sess.SESSIONS.note_slo("tthbm", breached)
    assert remediate._worst_burn() == j_remediate._worst_burn() == 0.25


# ── Demote: the proactive seeder scan ──


def _peer_row(addr="10.0.0.1:7000", strikes=0, kinds=None, served=0.0,
              quarantined_for=0.0):
    return {"peer": addr, "strikes": strikes, "strike_kinds": kinds or {},
            "successes": 0, "failures": strikes, "corruptions": 0,
            "quarantines": 0, "quarantined_for_s": quarantined_for,
            "served_bytes_recent": served}


def _demote(scans, budget=3):
    """``scans``: [(now, [rows])]; the monitor answers each scan's rows."""
    def script(pkg, calls):
        view = {"rows": [], "strike_budget": budget}
        pkg.rm.register_target("peer_health", lambda: dict(view))
        pkg.rm.register_target(
            "demote", lambda addr: calls.append(addr) or {"window_s": 15.0})
        for now, rows in scans:
            view["rows"] = rows
            pkg.rm.ENGINE._scan_seeders(now=now)
    return script


DEMOTE = {
    "near_budget": (_demote([(100.0, [_peer_row(strikes=2)])]),
                    [("10.0.0.1", 7000)]),
    "bad_kinds": (_demote([(100.0, [_peer_row(
        strikes=2, kinds={"corrupt": 1, "io_timeout": 1})])], budget=9),
        [("10.0.0.1", 7000)]),
    "served_collapse_with_a_strike": (_demote(
        [(100.0, [_peer_row(strikes=1, served=8 << 20)]),
         (200.0, [_peer_row(strikes=1, served=100.0)])], budget=9),
        [("10.0.0.1", 7000)]),
    "collapse_without_a_strike": (_demote(
        [(100.0, [_peer_row(served=8 << 20)]),
         (200.0, [_peer_row(served=100.0)])], budget=9), []),
    "healthy_never": (_demote([(100.0, [_peer_row(served=8 << 20)])]), []),
    "quarantined_skipped": (_demote([(100.0, [_peer_row(
        strikes=2, quarantined_for=9.0)])]), []),
    "cooldown": (_demote([(100.0, [_peer_row(strikes=2)]),
                          (115.0, [_peer_row(strikes=2)]),
                          (131.0, [_peer_row(strikes=2)])]),
                 [("10.0.0.1", 7000)] * 2),
}


@pytest.mark.parametrize("case", sorted(DEMOTE))
def test_demote_matches_reference(case):
    script, want = DEMOTE[case]
    rows, calls, _doc = _same(_run(script))
    assert calls == want
    assert _counts(rows, "demote") == ({"success": len(want)} if want
                                       else {})


def test_swarm_demote_target_adds_no_strike(tmp_path):
    """The swarm's targets carry the reference's names; an engine demote
    quarantines with no strike, bumps ``peers_demoted`` and is taken back
    at close."""
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    assert remediate.ensure_started()
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "z")
    swarm = SwarmDownloader(cfg)
    eng = remediate.ENGINE
    assert {"peer_health", "demote"} <= set(eng._targets)
    addr = ("10.0.0.9", 7000)
    for _ in range(2):
        swarm.health.record_failure(addr, kind="seed_stall")
    eng._scan_seeders(now=100.0)
    (row,) = [r for r in remediate.payload()["recent"]
              if r["action"] == "demote"]
    assert row["outcome"] == "success" and row["detail"]["window_s"] > 0
    assert swarm.stats.peers_demoted == 1
    (detail,) = swarm.health.detail()
    assert detail["strikes"] == 2 and detail["quarantines"] == 0
    assert swarm.health.is_quarantined(addr)
    swarm.close()
    assert not {"peer_health", "demote"} & set(eng._targets)


# ── The ring tuner ──


def _tune(stalls, base=64 << 20, knob=True):
    """``stalls``: [(now, ring.stalls value)]."""
    def script(pkg, calls):
        eng = pkg.rm.ENGINE
        if knob:
            pkg.rm.set_knob_base("land_ring_bytes", base)
        for now, v in stalls:
            pkg.tl.STORE._append("ring.stalls", float(v), "gauge", now)
            eng._tune_ring(pkg.tl.STORE, now=now)
            calls.append(pkg.rm.knob_override("land_ring_bytes"))
    return script


B = 64 << 20
TUNE = {
    "up_on_growth": (_tune([(10.0, 1), (20.0, 3)]), [None, 2 * B]),
    "rails_cap_at_8x": (_tune([(31.0 * i, i) for i in range(1, 8)],
                              base=1 << 20),
                        [None, 2 << 20, 4 << 20, 8 << 20, 8 << 20,
                         8 << 20, 8 << 20]),
    "damping_one_direction_per_window": (
        _tune([(10.0, 1), (11.0, 5), (11.5, 5), (40.5, 5)]),
        [None, 2 * B, 2 * B, 2 * B]),
    "down_after_a_quiet_window": (_tune([(10.0, 1), (11.0, 5), (42.0, 5)]),
                                  [None, 2 * B, None]),
    "up_respects_its_window": (_tune([(10.0, 1), (11.0, 2), (12.0, 3)]),
                               [None, 2 * B, 2 * B]),
    "never_without_a_base": (_tune([(10.0, 1), (20.0, 9)], knob=False),
                             [None, None]),
}


@pytest.mark.parametrize("case", sorted(TUNE))
def test_tuner_matches_reference(case):
    script, want = TUNE[case]
    rows, calls, doc = _same(_run(script))
    assert calls == want
    if case == "never_without_a_base":
        assert doc["knobs"] == {} and rows == []
    if case == "rails_cap_at_8x":
        assert doc["knobs"]["land_ring_bytes"]["max"] == 8 << 20


def test_ring_override_reaches_the_landing(tmp_path, monkeypatch):
    """The landing reads ``land_ring_bytes`` through the tuner: an
    override doubles the next ring's budget; the rails stop at 8 × base;
    and the ring, closed when the landing ends, takes its probes back (a
    divergence: the JAX package's stay until the next ring)."""
    from zest_tpu_torch.models import loader

    budgets = []
    real = loader.HostRing

    class _Ring(real):
        def __init__(self, budget, *a, **k):
            budgets.append(budget)
            super().__init__(budget, *a, **k)

    monkeypatch.setattr(loader, "HostRing", _Ring)
    assert remediate.ensure_started()
    remediate.set_knob_base("land_ring_bytes", 1 << 20)
    eng = remediate.ENGINE
    eng._apply_knob("land_ring_bytes", 2 << 20, 1, 0.0)
    assert remediate.knob_override("land_ring_bytes") == 2 << 20
    from tests.fixtures import gpt2_checkpoint_files

    files = gpt2_checkpoint_files(n_embd=32, n_layer=2)
    repo = FixtureRepo("acme/ring", files, chunks_per_xorb=2)
    with FixtureHub(repo) as hub:
        cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "z",
                     hf_token="hf_test", endpoint=hub.url,
                     land_ring_bytes=1 << 20)
        pull_model(cfg, "acme/ring", device="cpu", no_p2p=True, log=_quiet)
    assert budgets == [2 << 20]
    assert eng._knobs["land_ring_bytes"]["max"] == 8 << 20
    # The landing closed its ring, and the ring's probes went with it.
    assert not {"ring.in_use_bytes", "ring.stalls"} \
        & set(timeline.STORE._probes)


# ── The serving pool's rules ──


def _pool(series):
    """``series``: [{name: value}] per tick, fed to the pool rules."""
    def script(pkg, calls):
        pkg.rm.register_target("pool_land",
                               lambda cmd: calls.append(cmd) or True)
        pkg.rm.register_target("pool_shed",
                               lambda cmd: calls.append(cmd) or True)
        for i, vals in enumerate(series):
            for name, v in vals.items():
                pkg.tl.STORE._append(name, float(v), "gauge", float(i))
            pkg.rm.ENGINE._pool_rules(pkg.tl.STORE, now=float(i))
    return script


POOL = {
    "gate_stall_growth_rushes": (_pool([
        {"hbm_pool.gate_stall_s": 0.0, "hbm_pool.landing": 1},
        {"hbm_pool.gate_stall_s": 0.4, "hbm_pool.landing": 1}]), ["rush"]),
    "gate_stall_without_a_land": (_pool([
        {"hbm_pool.gate_stall_s": 0.0, "hbm_pool.landing": 0},
        {"hbm_pool.gate_stall_s": 0.4, "hbm_pool.landing": 0}]), []),
    "eviction_growth_sheds": (_pool([
        {"hbm_pool.evictions": 0}, {"hbm_pool.evictions": 2},
        {"hbm_pool.evictions": 2}]), ["shed_coldest"]),
}


@pytest.mark.parametrize("case", sorted(POOL))
def test_pool_rules_match_reference(case):
    script, want = POOL[case]
    rows, calls, _doc = _same(_run(script))
    assert calls == want
    assert [r["detail"]["cmd"] for r in rows] == want


def test_pool_registers_the_reference_probes_and_targets(tmp_path):
    from zest_tpu.models import hbm_pool as j_pool
    from zest_tpu_torch.models import hbm_pool

    for pkg in PACKAGES.values():
        assert pkg.rm.ensure_started()
    pool = hbm_pool.HbmPool(Config(hf_home=tmp_path / "hf",
                                   cache_dir=tmp_path / "z"), "cpu")
    j = j_pool.HbmPool(JConfig(hf_home=tmp_path / "jhf",
                               cache_dir=tmp_path / "jz"))
    try:
        assert set(timeline.STORE._probes) == set(j_timeline.STORE._probes)
        assert len(timeline.STORE._probes) == 6
        assert {k: float(fn()) for k, fn in timeline.STORE._probes.items()} \
            == {k: float(fn()) for k, fn in j_timeline.STORE._probes.items()}
        assert set(remediate.ENGINE._targets) \
            == set(j_remediate.ENGINE._targets) == {"pool_land", "pool_shed"}
        assert remediate.invoke("pool_land", "rush") is True
        assert pool._rush.is_set()
        assert remediate.invoke("pool_land", "other") is False
        assert remediate.invoke("pool_shed", "shed_coldest") is False
    finally:
        pool.close()
        j.close()
    assert timeline.STORE._probes == {}
    assert remediate.ENGINE._targets == {}


# ── The payload and zest heal ──


def test_payload_and_status_match_reference(monkeypatch):
    monkeypatch.setenv("ZEST_REMEDIATE_ACTIONS", "hedge,tune")
    out = _same(_run(_hedge_script("stall", n=2)))
    _rows_, _calls, doc = out
    assert doc["actions"] == ["hedge", "tune"]
    assert doc["counts"] == {"hedge": {"success": 2}}
    assert remediate.status_block() == j_remediate.status_block()


HEAL_DOCS = [
    {"enabled": True, "dry_run": False, "actions": ["demote", "hedge"],
     "rate_s": 10.0, "burst": 3, "shedding": True,
     "knobs": {"land_ring_bytes": {"base": 64, "value": 128, "min": 64,
                                   "max": 512},
               "other": {"base": 1, "value": 1}},
     "counts": {"hedge": {"success": 2, "rate_limited": 1},
                "tune": {"dry_run": 1}},
     "recent": [{"t": 1700000000.0, "action": "hedge",
                 "outcome": "success", "reason": "stall in phase fetch",
                 "session": "p0001-aa"},
                {"t": 1700000001.5, "action": "tune",
                 "outcome": "dry_run", "reason": "ring stalls growing"}]},
    {"enabled": True, "dry_run": True, "actions": [], "counts": {},
     "recent": []},
    {"enabled": False},
]


@pytest.mark.parametrize("i", range(len(HEAL_DOCS)))
def test_heal_lines_match_reference(i):
    doc = HEAL_DOCS[i]
    lines = cli._heal_lines(doc)
    assert lines == j_cli._heal_lines(doc)
    frame = "\n".join(lines)
    if i == 0:
        assert "LOAD SHEDDING ACTIVE" in frame
        assert "knob land_ring_bytes: 128 (base 64" in frame
        assert "session=p0001-aa" in frame
    if i == 2:
        assert "pure observer" in frame


@pytest.fixture
def daemon(tmp_path, monkeypatch):
    monkeypatch.setenv("ZEST_TIMELINE_HZ", "0.02")
    timeline.reset()
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 http_port=0)
    with PublisherServer(cfg, device="cpu") as srv:
        yield srv


def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read().decode())


def _post(url, body: bytes):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def test_http_remediations_and_dry_run_toggle(daemon):
    base = daemon.url
    assert remediate.ensure_started()
    sess = session_mod.begin("acme/m", "main")
    remediate.register_target(f"hedge:{sess.id}", lambda r: {})
    remediate.ENGINE.on_anomaly("stall", sess, {})
    doc = _get(f"{base}/v1/remediations?limit=5")
    assert doc["enabled"] is True
    assert doc["counts"]["hedge"]["success"] == 1
    assert doc["recent"][-1]["action"] == "hedge"
    assert f"hedge:{sess.id}" in doc["targets"]
    assert set(doc) == set(j_remediate.RemediationEngine().payload())
    session_mod.finish(sess, "ok")
    assert _post(f"{base}/v1/remediations", b'{"dry_run": true}') \
        == (200, {"dry_run": True})
    assert remediate.ENGINE.dry_run is True
    assert _post(f"{base}/v1/remediations", b'{"dry_run": false}') \
        == (200, {"dry_run": False})
    assert _post(f"{base}/v1/remediations", b"not json")[0] == 400
    assert _post(f"{base}/v1/remediations", b"{}")[0] == 400
    st = _get(f"{base}/v1/status")
    assert st["remediation"] == {"enabled": True, "dry_run": False,
                                 "decisions": 1, "shedding": False}


def test_cmd_heal_against_the_daemon(daemon, monkeypatch, capsys):
    monkeypatch.setenv("ZEST_HTTP_PORT", daemon.url.rsplit(":", 1)[1])
    assert remediate.ensure_started()
    assert cli.main(["heal"]) == 0
    assert "self-healing: live" in capsys.readouterr().out
    assert cli.main(["heal", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["enabled"] is True
    assert cli.main(["heal", "--dry-run", "on"]) == 0
    assert remediate.ENGINE.dry_run is True
    assert cli.main(["heal", "--dry-run", "off"]) == 0
    assert remediate.ENGINE.dry_run is False
    monkeypatch.setenv("ZEST_HTTP_PORT", "1")
    assert cli.main(["heal"]) == 1
    assert cli.main(["heal", "--dry-run", "on"]) == 1


# ── Config ──


def _load(cls, **env):
    base = {"HF_HOME": "/tmp/hf", "ZEST_CACHE_DIR": "/tmp/zc"}
    base.update(env)
    return cls.load(base)


FIELDS = ("timeline_enabled", "timeline_hz", "anomaly_window_s",
          "remediate_enabled", "remediate_actions", "remediate_dry_run",
          "remediate_rate_s", "remediate_burst")

CONFIG_ENVS = [
    {},
    {"ZEST_REMEDIATE": "0", "ZEST_REMEDIATE_ACTIONS": "hedge,demote",
     "ZEST_REMEDIATE_DRY": "1", "ZEST_REMEDIATE_RATE_S": "2.5",
     "ZEST_REMEDIATE_BURST": "7"},
    {"ZEST_REMEDIATE_ACTIONS": "all", "ZEST_TIMELINE": "off",
     "ZEST_TIMELINE_HZ": "4", "ZEST_ANOMALY_WINDOW_S": "1"},
    {"ZEST_REMEDIATE_ACTIONS": " Tune , SHED ", "ZEST_REMEDIATE_DRY": "yes"},
]


@pytest.mark.parametrize("i", range(len(CONFIG_ENVS)))
def test_config_fields_match_reference(i):
    env = CONFIG_ENVS[i]
    ours, theirs = _load(Config, **env), _load(JConfig, **env)
    assert {f: getattr(ours, f) for f in FIELDS} \
        == {f: getattr(theirs, f) for f in FIELDS}


@pytest.mark.parametrize("env", [
    {"ZEST_REMEDIATE_ACTIONS": "hedge,typo"},
    {"ZEST_TIMELINE_HZ": "0.001"},
    {"ZEST_TIMELINE_HZ": "fast"},
    {"ZEST_ANOMALY_WINDOW_S": "0.01"},
    {"ZEST_REMEDIATE_RATE_S": "nan"},
    {"ZEST_REMEDIATE_BURST": "0"},
])
def test_config_errors_match_reference(env):
    with pytest.raises(ValueError) as ours:
        _load(Config, **env)
    with pytest.raises(ValueError) as theirs:
        _load(JConfig, **env)
    assert str(ours.value) == str(theirs.value)


# ── Knob off: ZEST_REMEDIATE=0 is a pure observer ──


FILES = {"config.json": b'{"model_type": "heal"}',
         "model.safetensors": bytes(range(256)) * 400}


def test_knob_off_pull_stats_schema_identical(tmp_path, monkeypatch):
    repo = FixtureRepo("acme/heal-model", FILES, chunks_per_xorb=3)
    with FixtureHub(repo) as hub:
        def cfg(cls, root):
            return cls(hf_home=root / "hf", cache_dir=root / "zest",
                       hf_token="hf_test", endpoint=hub.url)

        on = pull_model(cfg(Config, tmp_path / "on"), "acme/heal-model",
                        device="cpu", land=False, no_p2p=True, log=_quiet)
        assert remediate.ENGINE is not None  # the pull started it
        assert not [t for t in remediate.ENGINE._targets
                    if t.startswith("hedge:")]  # taken back at the end
        j_on = j_pull.pull_model(cfg(JConfig, tmp_path / "jon"),
                                 "acme/heal-model", no_p2p=True, log=_quiet)
        for mod, tel in ((tenancy, telemetry), (j_tenancy, j_telemetry)):
            tel.reset_all()
            mod.reset()
        monkeypatch.setenv("ZEST_REMEDIATE", "0")
        off = pull_model(cfg(Config, tmp_path / "off"), "acme/heal-model",
                         device="cpu", land=False, no_p2p=True, log=_quiet)
        j_off = j_pull.pull_model(cfg(JConfig, tmp_path / "joff"),
                                  "acme/heal-model", no_p2p=True,
                                  log=_quiet)
    assert remediate.ENGINE is None and j_remediate.ENGINE is None
    assert set(on.stats) == set(off.stats)
    assert set(j_on.stats) == set(j_off.stats)
    for name in FILES:
        assert (on.snapshot_dir / name).read_bytes() \
            == (off.snapshot_dir / name).read_bytes()


def test_reset_tears_everything_down():
    for pkg in PACKAGES.values():
        assert pkg.rm.ensure_started()
        pkg.rm.register_target("hedge:x", lambda r: {})
        pkg.tel.reset_all()
        assert pkg.rm.ENGINE is None
        assert pkg.tl._anomaly_listeners == [] == pkg.tl._tick_listeners


# ── A real collective straggler over loopback, aborted by the engine ──


REPO_ID = "acme/straggle"
PAYLOAD = random.Random(17).randbytes(600_000)


def test_collective_straggler_is_aborted_by_the_engine(tmp_path,
                                                       monkeypatch):
    """Host 0 holds only some of the units it owns and answers the rest
    NOT_FOUND for ever; with a 0.3 s window and a patience of 1 the
    detector blames it, the engine's first strike decision aborts the
    exchange, and the ladder fetches what it never sent."""
    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.transfer import coop
    from zest_tpu_torch.transfer.bridge import XetBridge
    from zest_tpu_torch.transfer.dcn import DcnServer

    monkeypatch.setenv("ZEST_ANOMALY_WINDOW_S", "0.3")
    monkeypatch.setenv("ZEST_TIMELINE_HZ", "20")
    monkeypatch.setenv("ZEST_REMEDIATE_PATIENCE", "1")
    timeline.reset()
    assert timeline.ensure_started() and remediate.ensure_started()
    files = {"model.safetensors": PAYLOAD}
    with FixtureHub(FixtureRepo(REPO_ID, files, chunks_per_xorb=2)) as hub:
        def bridge(root):
            cfg = Config(hf_home=root / "hf", cache_dir=root / "zest",
                         hf_token="hf_test", endpoint=hub.url, dcn_port=0)
            b = XetBridge(cfg)
            b.authenticate(REPO_ID)
            return b

        def recs(b):
            return [b.get_reconstruction(e.xet_hash)
                    for e in HubClient(b.cfg).list_files(REPO_ID)
                    if e.is_xet]

        partner = bridge(tmp_path / "partner")
        owned = coop.CoopPlan.build(recs(partner), 2).for_host(0)
        assert len(owned) >= 2
        # The partner holds the first half of its units only.
        for hh, fi in owned[:len(owned) // 2]:
            partner.cache_blob(hh, fi.range.start,
                               partner.fetch_unit(hh, fi), whole=False)
        server = DcnServer(partner.cfg, partner.cache)
        port = server.start()
        puller = bridge(tmp_path / "puller")
        try:
            out = coop.coop_round(puller, recs(puller), 1, 2,
                                  {0: ("127.0.0.1", port)}, device="cpu")
        finally:
            server.shutdown()
        cx = out["collective"]
        assert cx["aborted"] == "remediation" and cx["dead_host"] == 0
        assert out["exchange"]["units"] >= 1  # the held half arrived
        assert out["fallbacks"] >= 1          # the rest came down the ladder
        before = puller.stats.bytes_from_cdn
        target = tmp_path / "check.bin"
        for e in HubClient(puller.cfg).list_files(REPO_ID):
            puller.reconstruct_to_file(e.xet_hash, target)
            assert target.read_bytes() == files[e.path]
        assert puller.stats.bytes_from_cdn == before  # all cached
    anomalies = [e for e in timeline.STORE.payload()["anomalies"]
                 if e["kind"] == "collective_straggler"]
    assert anomalies and anomalies[0]["partner"] == 0
    (strike,) = [r for r in remediate.payload()["recent"]
                 if r["action"] == "strike"]
    assert strike["outcome"] == "success"
    assert strike["detail"]["cmd"] == "abort"
    assert strike["detail"]["partner"] == 0
    assert "collective" not in remediate.ENGINE._targets
