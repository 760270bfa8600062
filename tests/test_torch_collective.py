"""The port's collective exchange against the JAX package's, on the CPU.

Mirrors tests/test_collective.py without the federated end-to-end round,
on a seeded fixture (a 600 KB low-entropy payload, two chunks per
xorb, so half the chunks take BG4 and the receipt runs the plain fused
verifier as well as the plain BLAKE3), with ``device="cpu"``:

- schedules (kind, rank order, every phase's partner, owners and link
  class) equal to the reference's for n in {2, 3, 4, 5, 8}, two-slice
  topologies, a quarantined host and pod maps (the federated builder);
  transfer matrices and their skew equal; every foreign unit requested
  once;
- topology resolution and the collective knobs parsed as the reference
  parses them, the lossy values included; a bad value raises;
- the round end to end over loopback DCN sockets (ring at 3 hosts,
  hypercube at 4 and 8): ``stats["coop"]`` and its ``collective`` block
  with the reference's keys and counts (times excepted), every window
  tagged, the caches complete;
- degradation: a dead host, a corrupt frame, ``dcn_reset`` mid-phase, a
  remediation abort; the knob off gives the point-to-point schema; the
  exchange ledger; clock offsets of peers never dialed; a verifier that
  fails to launch raises out of the collective.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from tests.fixtures import FixtureHub, FixtureRepo
from zest_tpu import faults as j_faults
from zest_tpu.cas.hub import HubClient as JHubClient
from zest_tpu.config import Config as JConfig
from zest_tpu.config import parse_topology as j_parse_topology
from zest_tpu.transfer import coop as j_coop
from zest_tpu.transfer import collective as j_coll
from zest_tpu.transfer import dcn as j_dcn
from zest_tpu.transfer.bridge import XetBridge as JXetBridge
from zest_tpu_torch import faults, telemetry
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.config import Config, parse_topology
from zest_tpu_torch.ops import bg4
from zest_tpu_torch.shaping import TokenBucket
from zest_tpu_torch.transfer import collective as coll
from zest_tpu_torch.transfer import coop
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.dcn import DcnPool, DcnServer
from zest_tpu_torch.transfer.federated import warm_units_parallel

REPO_ID = "acme/collective-model"
_PAYLOAD = np.random.default_rng(7).integers(
    0, 4, 600_000, dtype=np.uint8).tobytes()
FILES = {
    "config.json": b'{"model_type": "collective"}',
    "model.safetensors": _PAYLOAD,
}
TOP_KEYS = {"host", "hosts", "trace_id", "plan", "fetch", "exchange",
            "fallbacks", "own_server", "peer_served_ratio", "elapsed_s",
            "clock_offsets"}
EX_KEYS = {"units", "wire_bytes", "unpacked_bytes", "fallback_units",
           "fallback_bytes", "verify_rejected", "retries", "budget_bytes",
           "inflight_peak_bytes"}


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO_ID, FILES, chunks_per_xorb=2)) as h:
        yield h


@pytest.fixture(scope="module")
def small_hub():
    """Two units: eight hosts in one interpreter verify every receipt with
    the plain BLAKE3, whose Python-level loop holds the interpreter lock."""
    files = {"model.safetensors": _PAYLOAD[:200_000]}
    with FixtureHub(FixtureRepo(REPO_ID, files, chunks_per_xorb=2)) as h:
        yield h, files


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    j_faults.reset()
    telemetry.remediate.reset()
    telemetry.timeline.reset()
    yield
    faults.reset()
    j_faults.reset()
    telemetry.remediate.reset()
    telemetry.timeline.reset()


@pytest.fixture(scope="module")
def plans(hub, tmp_path_factory):
    """``n -> (port CoopPlan, reference CoopPlan)`` over the fixture."""
    root = tmp_path_factory.mktemp("plans")
    recs, jrecs = _recs(_bridge(hub, root / "p")), _jrecs(
        _jbridge(hub, root / "j"))

    def build(n, quarantined=()):
        return (coop.CoopPlan.build(recs, n, frozenset(quarantined)),
                j_coop.CoopPlan.build(jrecs, n, frozenset(quarantined)))
    return build


def _bridge(hub, root, **cfg_kw):
    cfg = Config(hf_home=root / "hf", cache_dir=root / "zest",
                 hf_token="hf_test", endpoint=hub.url, dcn_port=0, **cfg_kw)
    b = XetBridge(cfg)
    b.authenticate(REPO_ID)
    return b


def _jbridge(hub, root, **cfg_kw):
    cfg = JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, dcn_port=0,
                  **cfg_kw)
    b = JXetBridge(cfg)
    b.authenticate(REPO_ID)
    return b


def _recs(bridge):
    return [bridge.get_reconstruction(e.xet_hash)
            for e in HubClient(bridge.cfg).list_files(REPO_ID) if e.is_xet]


def _jrecs(bridge):
    return [bridge.get_reconstruction(e.xet_hash)
            for e in JHubClient(bridge.cfg).list_files(REPO_ID) if e.is_xet]


def _sched(s) -> tuple:
    return (s.kind, s.host, s.alive,
            [(p.index, p.partner, p.owners, p.link) for p in s.phases])


# ── schedules and matrices ──


SCHEDULE_CASES = [
    (2, (0, 0), None, ()), (3, (0, 0, 0), None, ()),
    (4, (0,) * 4, None, ()), (5, (0,) * 5, None, ()),
    (8, (0,) * 8, None, ()), (4, (0, 0, 1, 1), None, ()),
    (8, (0, 0, 0, 0, 1, 1, 1, 1), None, ()),
    (8, (0, 1, 0, 1, 0, 1, 0, 1), None, ()),
    (5, (0, 0, 0, 1, 1), None, ()), (4, (0,) * 4, None, (2,)),
    (8, (0,) * 8, (0, 0, 0, 0, 1, 1, 1, 1), ()),
    (8, (0,) * 8, (0, 0, 1, 1, 2, 2, 3, 3), ()),
    (12, (0,) * 12, (0,) * 4 + (1,) * 4 + (2,) * 4, (4,)),
    (4, (0, 1, 2, 3), (0, 0, 1, 1), ()),
]


@pytest.mark.parametrize("n,topo,pods,quarantined", SCHEDULE_CASES)
def test_schedules_and_matrices_match_reference(plans, n, topo, pods,
                                                quarantined):
    plan, ref = plans(n, quarantined)
    for host in plan.alive:
        assert _sched(coll.CollectiveSchedule.build(plan, host, topo, pods)) \
            == _sched(j_coll.CollectiveSchedule.build(ref, host, topo, pods))
        # every foreign unit requested exactly once across the schedule
        blocks = coll.units_by_owner(plan)
        keys = [(hh, fi.range.start)
                for ph in coll.CollectiveSchedule.build(
                    plan, host, topo, pods).phases
                for o in ph.owners for hh, fi in blocks[o]]
        assert sorted(keys) == sorted(k for k, _fi in plan.units
                                      if plan.owners[k] != host)
    m = coll.transfer_matrix(plan, topo, pods)
    assert m == j_coll.transfer_matrix(ref, topo, pods)
    assert coll.matrix_skew(m) == j_coll.matrix_skew(m)
    for q in quarantined:
        assert all(v == 0 for v in m[q]) and all(row[q] == 0 for row in m)
    if pods is not None:
        assert coll.elect_gateways(plan, pods) == \
            j_coll.elect_gateways(ref, pods)


def test_schedule_unavailable_cases(plans):
    plan, _ = plans(4, (1, 2, 3))
    with pytest.raises(coll.CollectiveUnavailable):
        coll.CollectiveSchedule.build(plan, 0, (0,) * 4)
    with pytest.raises(coll.CollectiveUnavailable):
        coll.CollectiveSchedule.build(plans(4)[0], 9, (0,) * 4)
    with pytest.raises(ValueError):
        coll.CollectiveSchedule.build(plans(4)[0], 0, (0, 0))


# ── topology and knobs ──


def test_topology_resolution_matches_reference():
    for mod_topo, mod_pods in ((coll.slice_topology, coll.pod_topology),
                               (j_coll.slice_topology, j_coll.pod_topology)):
        assert mod_topo(4, env={"ZEST_COOP_TOPOLOGY": "0,0,1,1"}) \
            == (0, 0, 1, 1)
        assert mod_topo(3, env={}) == (0, 0, 0)
        assert mod_pods(3, env={}) is None
        assert mod_pods(4, env={"ZEST_COOP_PODS": "0,1,0,1"}) == (0, 1, 0, 1)
        for bad in ({"ZEST_COOP_TOPOLOGY": "0,0,nope,1"},
                    {"ZEST_COOP_TOPOLOGY": "0,0,1"}):
            with pytest.raises(ValueError):
                mod_topo(4, env=bad)
        with pytest.raises(ValueError):
            mod_pods(4, env={"ZEST_COOP_PODS": "0,1"})
    cfg = Config(hf_home="/tmp/x", cache_dir="/tmp/y", coop_topology=(0, 1),
                 coop_pods=(1, 0))
    assert coll.slice_topology(2, cfg=cfg, env={}) == (0, 1)
    assert coll.pod_topology(2, cfg=cfg, env={}) == (1, 0)
    for spec in ("0, 0, 1, 1", "3", "0,-1", "", "a,b"):
        try:
            want = j_parse_topology(spec)
        except ValueError:
            with pytest.raises(ValueError):
                parse_topology(spec)
        else:
            assert parse_topology(spec) == want


KNOB_ENVS = [
    {}, {"ZEST_COOP_COLLECTIVE": "0"}, {"ZEST_COOP_COLLECTIVE": "1"},
    {"ZEST_COOP_TOPOLOGY": "0, 0, 1, 1"}, {"ZEST_COOP_PODS": "0,0,1,1"},
    {"ZEST_COLLECTIVE_BACKEND": "dcn"}, {"ZEST_COLLECTIVE_BACKEND": "jax"},
    {"ZEST_COLLECTIVE_BACKEND": "loopback"}, {"ZEST_COLLECTIVE_LOSSY": "0"},
    {"ZEST_TPU_HBM_STAGING": "268435456"},
]
BAD_ENVS = [
    {"ZEST_COOP_COLLECTIVE": bad} for bad in ("false", "yes", "2", " ")
] + [{"ZEST_COOP_TOPOLOGY": "a,b"},
     {"ZEST_COLLECTIVE_BACKEND": "jxa"}, {"ZEST_COLLECTIVE_BACKEND": "DCN"},
     {"ZEST_COLLECTIVE_LOSSY": "yes"}, {"ZEST_COLLECTIVE_LOSSY": "dcn,wan"}]


@pytest.mark.parametrize("env", KNOB_ENVS)
def test_collective_knobs_parse_as_reference(env):
    base = {"HF_HOME": "/tmp/x", "ZEST_CACHE_DIR": "/tmp/y"}
    cfg, ref = Config.load({**base, **env}), JConfig.load({**base, **env})
    for field in ("coop_collective", "coop_topology", "coop_pods",
                  "collective_backend", "collective_lossy",
                  "hbm_staging_bytes"):
        assert getattr(cfg, field) == getattr(ref, field), field


@pytest.mark.parametrize("env", BAD_ENVS)
def test_collective_knob_typos_raise(env):
    base = {"HF_HOME": "/tmp/x", "ZEST_CACHE_DIR": "/tmp/y"}
    with pytest.raises(ValueError):
        JConfig.load({**base, **env})
    with pytest.raises(ValueError):
        Config.load({**base, **env})


@pytest.mark.parametrize("value", ["dcn", "wan"])
def test_lossy_values_raise_naming_the_missing_port(value):
    """The lossy tier is ported: both values parse as the reference parses
    them, from the environment and as arguments; what raises now is a
    value neither package accepts, naming the accepted modes."""
    base = {"HF_HOME": "/tmp/x", "ZEST_CACHE_DIR": "/tmp/y"}
    assert JConfig.load({**base, "ZEST_COLLECTIVE_LOSSY": value}) \
        .collective_lossy == value
    assert Config.load({**base, "ZEST_COLLECTIVE_LOSSY": value}) \
        .collective_lossy == value
    assert Config(hf_home="/tmp/x", cache_dir="/tmp/y",
                  collective_lossy=value).collective_lossy == value
    for bad in (value + "x", value.upper()):
        with pytest.raises(ValueError):
            JConfig.load({**base, "ZEST_COLLECTIVE_LOSSY": bad})
        with pytest.raises(ValueError, match="0|dcn|wan"):
            Config.load({**base, "ZEST_COLLECTIVE_LOSSY": bad})
        with pytest.raises(ValueError, match="0|dcn|wan"):
            Config(hf_home="/tmp/x", cache_dir="/tmp/y", collective_lossy=bad)
    with pytest.raises(ValueError):
        Config(hf_home="/tmp/x", cache_dir="/tmp/y",
               collective_backend="carrier-pigeon")


# ── the round, end to end ──


def _run_hosts(hub, tmp_path, n, ref=False, skip=(), pools=None,
               round_kwargs=None, server_kwargs=None, **cfg_kw):
    """n concurrent in-process hosts, each with its own cache and DCN
    server, over loopback; hosts in ``skip`` sit in the address map on a
    dead port. ``ref`` runs the JAX package's round. ``pools`` maps host
    index → a ``DcnPool`` whose counters the test reads;
    ``server_kwargs(i)`` gives host i's server its knobs."""
    make, recs_of, server_cls, round_fn = (
        (_jbridge, _jrecs, j_dcn.DcnServer, j_coop.coop_round) if ref else
        (_bridge, _recs, DcnServer, coop.coop_round))
    bridges, servers, addrs = [], [], {}
    for i in range(n):
        b = make(hub, tmp_path / f"{'ref' if ref else 'h'}{i}", **cfg_kw)
        bridges.append(b)
        if i in skip:
            addrs[i] = ("127.0.0.1", 1)  # nothing listens
            servers.append(None)
        else:
            s = server_cls(b.cfg, b.cache,
                           **(server_kwargs(i) if server_kwargs else {}))
            addrs[i] = ("127.0.0.1", s.start())
            servers.append(s)
    results: list = [None] * n
    errors: list = []

    def run(i):
        kw = dict(round_kwargs or {})
        if not ref:
            kw["device"] = "cpu"
        if pools and i in pools:
            kw["dcn_pool"] = pools[i]
        try:
            results[i] = round_fn(bridges[i], recs_of(bridges[i]), i, n,
                                  addrs, server=servers[i], **kw)
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append((i, exc))

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n) if i not in skip]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a host round hung"
    for s in servers:
        if s is not None:
            s.shutdown()
    assert not errors, errors
    return bridges, results


def _assert_fully_cached(bridge, root, files=FILES):
    before = bridge.stats.bytes_from_cdn
    for e in HubClient(bridge.cfg).list_files(REPO_ID):
        if e.is_xet:
            bridge.reconstruct_to_file(e.xet_hash, root / "check.bin")
            assert (root / "check.bin").read_bytes() == files[e.path]
    assert bridge.stats.bytes_from_cdn == before


def _counts(cx: dict) -> dict:
    """A collective block's counts: its times, and the barrier retries
    they decide, left out."""
    return {"schedule": cx["schedule"], "phases": cx["phases"],
            "walls": len(cx["phase_wall_s"]),
            "matrix_skew": cx["matrix_skew"], "link_bytes": cx["link_bytes"],
            "first_pass_windows": cx["windows"] - cx["retry_windows"],
            "unit_round_trips": cx["unit_round_trips"],
            "keys": sorted(cx)}


@pytest.mark.parametrize("n,kind", [(3, "ring"), (4, "hypercube")])
def test_collective_round_matches_reference(hub, tmp_path, n, kind):
    pools = {i: DcnPool() for i in range(n)}
    try:
        bridges, results = _run_hosts(hub, tmp_path, n, pools=pools)
    finally:
        for pool in pools.values():
            pool.close()
    _jb, ref = _run_hosts(hub, tmp_path, n, ref=True)
    for i, (b, r) in enumerate(zip(bridges, results)):
        cx, rx = r["collective"], ref[i]["collective"]
        assert set(r) == set(ref[i]) == TOP_KEYS | {"collective"}
        assert set(r["exchange"]) == set(ref[i]["exchange"]) == EX_KEYS
        assert _counts(cx) == _counts(rx)
        assert cx["schedule"] == kind and cx["phases"] == 2
        assert "aborted" not in cx and cx["unit_round_trips"] == 0
        for key in ("plan", "trace_id", "fetch", "fallbacks",
                    "peer_served_ratio", "own_server"):
            assert r[key] == ref[i][key], key
        for key in ("units", "wire_bytes", "unpacked_bytes",
                    "fallback_units", "verify_rejected", "retries",
                    "budget_bytes"):
            assert r["exchange"][key] == ref[i]["exchange"][key], key
        assert sorted(r["clock_offsets"]) == sorted(ref[i]["clock_offsets"])
        assert r["fallbacks"] == 0 and r["exchange"]["units"] > 0
        assert 0 < r["exchange"]["wire_bytes"] < \
            r["exchange"]["unpacked_bytes"]
        assert sum(cx["link_bytes"].values()) == r["exchange"]["wire_bytes"]
        assert r["peer_served_ratio"] >= 0.6
        c = pools[i].counters
        assert c["untagged_windows"] == 0 and c["windows"] == cx["windows"]
        assert 0 < cx["windows"] <= cx["phases"] + cx["retry_windows"]
        _assert_fully_cached(b, tmp_path / f"h{i}")
    assert sum(b.stats.bytes_from_cdn for b in bridges) <= \
        results[0]["plan"]["total_bytes"] * 1.05
    # A finished exchange posts no phase; the rounds' clock offsets stay.
    assert not [c for c in telemetry.timeline.cells()
                if c.startswith("collective.")]
    assert set(telemetry.timeline.clock_offsets()) == \
        {str(h) for r in results for h in r["clock_offsets"]}


def test_collective_eight_host_hypercube(small_hub, tmp_path):
    hub, files = small_hub
    bridges, results = _run_hosts(hub, tmp_path, 8)
    for i, (b, r) in enumerate(zip(bridges, results)):
        cx = r["collective"]
        assert (cx["schedule"], cx["phases"]) == ("hypercube", 3)
        assert "aborted" not in cx and r["fallbacks"] == 0, r
        _assert_fully_cached(b, tmp_path / f"h{i}", files)


# The round over pods through WAN-shaped servers: four hosts, each its
# own slice, two pods of two. Every host has a DCN partner; the pods'
# gateways (hosts 0 and 2) also exchange over WAN.
WAN_SLICES = (0, 1, 2, 3)
WAN_PODS = (0, 0, 1, 1)
WAN_SHAPING = dict(rate_bps=1_000_000, window_rtt_s=0.005,
                   wan_bps=200_000, wan_rtt_s=0.02)


def _wan_link(a, b):
    """The link class between hosts ``a`` and ``b`` under the maps."""
    if WAN_PODS[a] != WAN_PODS[b]:
        return "wan"
    return "ici" if WAN_SLICES[a] == WAN_SLICES[b] else "dcn"


def _wan_servers(i):
    return dict(WAN_SHAPING, shape_slices=WAN_SLICES, shape_pods=WAN_PODS,
                shape_host=i)


@pytest.fixture(scope="module")
def wan_hub():
    """Incompressible bytes, so a gateway's WAN share outgrows the
    serving bucket's burst and its pace shows."""
    files = {"model.safetensors": np.random.default_rng(9).integers(
        0, 256, 512_000, dtype=np.uint8).tobytes()}
    with FixtureHub(FixtureRepo(REPO_ID, files, chunks_per_xorb=1)) as h:
        yield h, files


def test_wan_shaped_round_over_pods_matches_reference(wan_hub, tmp_path):
    """The federated round over WAN-shaped servers, port and reference:
    equal counts and link bytes, WAN bytes on the gateways, every cache
    complete, and each host's WAN phases at least its WAN bytes over
    ``wan_bps`` less the serving bucket's burst."""
    hub, files = wan_hub
    kw = dict(coop_topology=WAN_SLICES, coop_pods=WAN_PODS)
    bridges, results = _run_hosts(hub, tmp_path, 4,
                                  server_kwargs=_wan_servers, **kw)
    burst = TokenBucket(WAN_SHAPING["wan_bps"]).capacity  # each server's
    _jb, ref = _run_hosts(hub, tmp_path, 4, ref=True,
                          server_kwargs=_wan_servers, **kw)
    plan = coop.CoopPlan.build(_recs(bridges[0]), 4)
    matrix = coll.transfer_matrix(plan, WAN_SLICES, WAN_PODS)
    for i, (b, r) in enumerate(zip(bridges, results)):
        cx = r["collective"]
        assert _counts(cx) == _counts(ref[i]["collective"])
        # The wire bytes are the plan's: shaping moves none elsewhere.
        want = {"ici": 0, "dcn": 0, "wan": 0}
        for src, row in enumerate(matrix):
            want[_wan_link(i, src)] += row[i]
        assert cx["link_bytes"] == want
        assert cx["schedule"] == "federated" and "aborted" not in cx
        assert r["fallbacks"] == 0
        _assert_fully_cached(b, tmp_path / f"h{i}", files)
        sched = coll.CollectiveSchedule.build(plan, i, WAN_SLICES, WAN_PODS)
        wan_walls = [w for ph, w in zip(sched.phases, cx["phase_wall_s"])
                     if ph.link == "wan"]
        wan = cx["link_bytes"]["wan"]
        assert cx["link_bytes"]["dcn"] > 0
        assert (wan > 0) == (i in (0, 2)) == bool(wan_walls)
        if wan:
            assert sum(wan_walls) >= (wan - burst) / WAN_SHAPING["wan_bps"]
            assert wan > burst  # the pacing is visible


def test_dead_host_degrades_to_p2p_ladder(hub, tmp_path):
    bridges, results = _run_hosts(hub, tmp_path, 4, skip={3})
    live = [r for r in results if r]
    assert any(r["collective"].get("aborted") for r in live)
    assert any(3 in r["exchange"].get("dead_hosts", []) for r in live)
    assert sum(r["fallbacks"] for r in live) > 0
    for i in range(3):
        _assert_fully_cached(bridges[i], tmp_path / f"h{i}")


def _poisoned_owner(hub, root):
    """Host 0 of two warms its share, then one whole unit's cache entry is
    byte-flipped mid-frames."""
    b0 = _bridge(hub, root)
    recs0 = _recs(b0)
    owned = coop.CoopPlan.build(recs0, 2).for_host(0)
    warm_units_parallel(b0, recs0, units=owned)
    hh, fi = owned[0]
    bad = bytearray(b0.cache.get_with_range(hh, fi.range.start).data)
    bad[len(bad) // 2] ^= 0xFF
    b0.cache.put(hh, bytes(bad))
    return b0


def test_corrupt_frame_rejected_and_healed(hub, tmp_path):
    b0 = _poisoned_owner(hub, tmp_path / "owner")
    server = DcnServer(b0.cfg, b0.cache)
    port = server.start()
    try:
        b1 = _bridge(hub, tmp_path / "puller")
        r = coop.coop_round(b1, _recs(b1), 1, 2, {0: ("127.0.0.1", port)},
                            device="cpu")
    finally:
        server.shutdown()
    assert r["collective"] and "aborted" not in r["collective"]
    assert r["exchange"]["verify_rejected"] >= 1 and r["fallbacks"] >= 1
    _assert_fully_cached(b1, tmp_path / "puller")


def test_dcn_reset_mid_phase_survived(hub, tmp_path):
    faults.install("dcn_reset:1.0", seed=1337)
    bridges, results = _run_hosts(hub, tmp_path, 2)
    assert faults.counters().get("dcn_reset", 0) > 0
    for i, (b, r) in enumerate(zip(bridges, results)):
        assert r["collective"].get("aborted"), r
        assert r["fallbacks"] > 0 and r["exchange"]["units"] == 0, r
        _assert_fully_cached(b, tmp_path / f"h{i}")


def test_knob_off_gives_the_point_to_point_schema(hub, tmp_path):
    _b, results = _run_hosts(hub, tmp_path, 2, coop_collective=False)
    _jb, ref = _run_hosts(hub, tmp_path, 2, ref=True,
                          coop_collective=False)
    for r, rr in zip(results, ref):
        assert set(r) == set(rr) == TOP_KEYS
        assert set(r["exchange"]) == set(rr["exchange"]) == EX_KEYS


def test_remediation_abort_condemns_the_partner(hub, tmp_path):
    """A partner that never holds its units (an empty cache: NOT_FOUND
    forever) is aborted by the remediation target; its units go down the
    waterfall at once, not back to it over the point-to-point exchange."""
    empty = _bridge(hub, tmp_path / "empty")
    server = DcnServer(empty.cfg, empty.cache)
    port = server.start()
    out: dict = {}
    b1 = _bridge(hub, tmp_path / "puller")

    def run():
        out["r"] = coop.coop_round(b1, _recs(b1), 1, 2,
                                   {0: ("127.0.0.1", port)}, device="cpu")

    t = threading.Thread(target=run, daemon=True)
    t0 = time.monotonic()
    t.start()
    try:
        while telemetry.remediate.invoke("collective", "abort", 0) is None:
            assert time.monotonic() - t0 < 30, "the target never registered"
            time.sleep(0.01)
        t.join(timeout=60)
    finally:
        server.shutdown()
    r = out["r"]
    assert r["collective"]["aborted"] == "remediation"
    assert r["collective"]["dead_host"] == 0
    assert r["fallbacks"] == len(coop.CoopPlan.build(_recs(b1), 2)
                                 .for_host(0))
    assert r["exchange"]["retries"] == 0  # never asked over point-to-point
    assert time.monotonic() - t0 < 30
    _assert_fully_cached(b1, tmp_path / "puller")


def test_exchange_ledger_matches_reference():
    ours, theirs = coop._ExchangeStats(), j_coop._ExchangeStats()
    for ex in (ours, theirs):
        ex.book_exchange(("aa", 0), 100, 400)
        ex.book_exchange(("bb", 0), 50, 200, link="ici")
        ex.book_fallback(("aa", 0), "cdn", 110)  # a re-delivery
    assert ours.summary() == theirs.summary()
    assert ours.summary()["reattributed"] == 1
    for ex in (ours, theirs):
        ex.book_exchange(("aa", 0), 100, 400)
    assert ours.summary() == theirs.summary()
    assert ours.fallback_tiers == {} and ours.wire_bytes == 150
    assert "reattributed" not in coop._ExchangeStats().summary()


def test_clock_offsets_of_peers_never_dialed(tmp_path):
    cfgs = [Config(hf_home=tmp_path / f"{i}/hf", cache_dir=tmp_path / f"{i}/z",
                   dcn_port=0) for i in range(3)]
    servers = [DcnServer(c) for c in cfgs]
    peers = {i: ("127.0.0.1", s.start()) for i, s in enumerate(servers)}
    peers[3] = ("127.0.0.1", 1)  # nothing listens: no offset, no hang
    pool = DcnPool()
    try:
        pool.channel(*peers[0])  # the exchange dialed only host 0
        out: dict = {}
        t0 = time.monotonic()
        coop._collect_clock_offsets(pool, peers, out, timeout_s=5.0)
        assert time.monotonic() - t0 < 5.0
    finally:
        pool.close()
        for s in servers:
            s.shutdown()
    assert sorted(out) == [0, 1, 2]
    for row in out.values():
        assert set(row) == {"offset_s", "rtt_s"}
        assert abs(row["offset_s"]) < 1.0 and row["rtt_s"] >= 0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("zest-coop-clk") and t.is_alive()
                and t.name != "zest-coop-clk-3"]


def test_verifier_launch_error_raises_out_of_the_collective(hub, tmp_path,
                                                            monkeypatch):
    def broken(self, words, lengths):
        raise RuntimeError("BG4 regroup kernel launch failed: cudaError 98")

    monkeypatch.setattr(bg4.FusedBg4Verifier, "hash_planar_device", broken)
    owner = _bridge(hub, tmp_path / "owner")
    warm_units_parallel(owner, _recs(owner))
    server = DcnServer(owner.cfg, owner.cache)
    port = server.start()
    try:
        b1 = _bridge(hub, tmp_path / "puller")
        with pytest.raises(RuntimeError, match="cudaError 98"):
            coop.coop_round(b1, _recs(b1), 1, 2, {0: ("127.0.0.1", port)},
                            device="cpu")
    finally:
        server.shutdown()
    assert b1.stats.bytes_from_cdn == sum(
        fi.url_range_end - fi.url_range_start
        for _hh, fi in coop.CoopPlan.build(_recs(b1), 2).for_host(1))
