"""The port's cooperative pull against the JAX package's, on the CPU.

Mirrors tests/test_coop.py on the same ``FixtureHub`` fixture (1.5 MB
low-entropy payload, two chunks per xorb: half the chunks take BG4, so
receipt verification runs through the plain fused verifier as well as
the plain BLAKE3), with ``device="cpu"``; both packages run with the
collective tier off (``coop_collective=False``: the point-to-point
exchange; tests/test_torch_collective.py holds the collective):

- plan parity: the same fingerprint, ownership sets and summary as the
  reference's ``CoopPlan``, the skew bound, the exactly-once re-shard;
- the round end to end over loopback DCN sockets with 4 hosts, with
  ``stats["coop"]`` keys equal to the reference round's;
- degradation: a dead host, a quarantined host, injected ``dcn_reset`` /
  ``peer_timeout``, a corrupt owner blob rejected and healed;
- the ``ByteBudget`` bound and ``pull_model(coop=True)``, whose landed
  ``params_digest`` equals the reference pull's;
- a verifier whose launch raises: the error leaves ``coop_round`` and
  ``pull_model`` and is never counted as a rejection.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

from tests.fixtures import FixtureHub, FixtureRepo, gpt2_checkpoint_files
from zest_tpu.cas.hub import HubClient as JHubClient
from zest_tpu.config import Config as JConfig
from zest_tpu.models import loader as j_loader
from zest_tpu.transfer import bridge as j_bridge
from zest_tpu.transfer import coop as j_coop
from zest_tpu.transfer import dcn as j_dcn
from zest_tpu.transfer import pull as j_pull
from zest_tpu_torch import faults
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import loader
from zest_tpu_torch.ops import bg4, nvcc
from zest_tpu_torch.transfer import coop
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.dcn import DcnServer
from zest_tpu_torch.transfer.federated import warm_units_parallel
from zest_tpu_torch.transfer.pull import pull_model

REPO_ID = "acme/coop-model"
_PAYLOAD = np.random.default_rng(5).integers(
    0, 4, 1_500_000, dtype=np.uint8).tobytes()
FILES = {
    "config.json": b'{"model_type": "coop"}',
    "model.safetensors": _PAYLOAD,
}


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO_ID, FILES, chunks_per_xorb=2)) as h:
        yield h


@pytest.fixture(autouse=True)
def _no_faults():
    faults.reset()
    yield
    faults.reset()


def _bridge(hub, root):
    cfg = Config(hf_home=root / "hf", cache_dir=root / "zest",
                 hf_token="hf_test", endpoint=hub.url, dcn_port=0,
                 coop_collective=False)
    b = XetBridge(cfg)
    b.authenticate(REPO_ID)
    return b


def _recs(bridge):
    return [bridge.get_reconstruction(e.xet_hash)
            for e in HubClient(bridge.cfg).list_files(REPO_ID) if e.is_xet]


def _jbridge(hub, root):
    cfg = JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, dcn_port=0)
    cfg.coop_collective = False
    b = j_bridge.XetBridge(cfg)
    b.authenticate(REPO_ID)
    return b


def _jrecs(bridge):
    return [bridge.get_reconstruction(e.xet_hash)
            for e in JHubClient(bridge.cfg).list_files(REPO_ID) if e.is_xet]


def _run_hosts(hub, tmp_path, n, round_kwargs=None, skip=(), ref=False):
    """n concurrent in-process hosts, each with its own cache and DCN
    server, over loopback; hosts in ``skip`` sit in the address map on a
    dead port and run no round. ``ref`` runs the JAX package's round."""
    make, recs_of, server_cls, round_fn = (
        (_jbridge, _jrecs, j_dcn.DcnServer, j_coop.coop_round) if ref else
        (_bridge, _recs, DcnServer, coop.coop_round))
    kwargs = dict(round_kwargs or {})
    if not ref:
        kwargs.setdefault("device", "cpu")
    bridges, servers, addrs = [], [], {}
    for i in range(n):
        b = make(hub, tmp_path / f"{'ref' if ref else 'h'}{i}")
        bridges.append(b)
        if i in skip:
            addrs[i] = ("127.0.0.1", 1)  # nothing listens
            servers.append(None)
        else:
            s = server_cls(b.cfg, b.cache)
            addrs[i] = ("127.0.0.1", s.start())
            servers.append(s)
    results: list = [None] * n
    errors: list = []

    def run(i):
        try:
            results[i] = round_fn(bridges[i], recs_of(bridges[i]), i, n,
                                  addrs, server=servers[i], **kwargs)
        except Exception as exc:  # noqa: BLE001 - asserted below
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
    return bridges, results, errors


def _assert_fully_cached(bridge, root):
    """Every xet file reconstructs byte-exactly with zero CDN traffic."""
    before = bridge.stats.bytes_from_cdn
    for e in HubClient(bridge.cfg).list_files(REPO_ID):
        if e.is_xet:
            out = root / "check.bin"
            bridge.reconstruct_to_file(e.xet_hash, out)
            assert out.read_bytes() == FILES[e.path]
    assert bridge.stats.bytes_from_cdn == before


def _keys(d: dict, nested=("plan", "fetch", "exchange")) -> dict:
    return {"top": sorted(d), **{k: sorted(d[k]) for k in nested}}


# ── Ownership plan ──


@pytest.mark.parametrize("n,quarantined", [(2, ()), (3, ()), (4, ()),
                                           (8, ()), (4, {2}), (3, {0})])
def test_plan_matches_reference(hub, tmp_path, n, quarantined):
    recs = _recs(_bridge(hub, tmp_path / "p"))
    jrecs = _jrecs(_jbridge(hub, tmp_path / "j"))
    plan = coop.CoopPlan.build(recs, n, quarantined=quarantined)
    ref = j_coop.CoopPlan.build(jrecs, n, quarantined=quarantined)
    assert plan.fingerprint() == ref.fingerprint()
    assert plan.summary() == ref.summary()
    for h in range(n):
        assert [(hh, fi.range.start) for hh, fi in plan.for_host(h)] == \
            [(hh, fi.range.start) for hh, fi in ref.for_host(h)]
    again = coop.CoopPlan.build(list(reversed(recs)), n,
                                quarantined=quarantined)
    assert again.fingerprint() == plan.fingerprint()


def test_plan_skew_bound_and_exactly_once_reshard(hub, tmp_path):
    recs = _recs(_bridge(hub, tmp_path))
    for n in (2, 3, 4, 8):
        plan = coop.CoopPlan.build(recs, n)
        if len(plan.units) >= 2 * n:
            assert plan.skew() <= 1.15, (n, plan.summary())
        largest = max(fi.url_range_end - fi.url_range_start
                      for _k, fi in plan.units)
        mean = plan.total_bytes / len(plan.alive)
        assert max(plan.bytes_per_host().values()) <= mean + largest + 1
    full = coop.CoopPlan.build(recs, 4)
    reshard = coop.CoopPlan.build(recs, 4, quarantined={2})
    assert reshard.for_host(2) == []
    seen = [(hh, fi.range.start) for h in range(4)
            for hh, fi in reshard.for_host(h)]
    assert sorted(seen) == sorted(k for k, _fi in full.units)
    assert len(seen) == len(set(seen))
    with pytest.raises(coop.CoopUnavailable):
        coop.CoopPlan.build(recs, 2, quarantined={0, 1})


# ── The round, end to end ──


def test_coop_round_end_to_end_matches_reference(hub, tmp_path):
    n = 4
    bridges, results, errors = _run_hosts(hub, tmp_path, n)
    assert not errors, errors
    _jb, ref, ref_errors = _run_hosts(hub, tmp_path, n, ref=True)
    assert not ref_errors, ref_errors
    for i, (b, r) in enumerate(zip(bridges, results)):
        assert r["fallbacks"] == 0, r
        assert r["exchange"]["verify_rejected"] == 0, r
        assert r["exchange"]["units"] > 0
        assert 0 < r["exchange"]["wire_bytes"] < \
            r["exchange"]["unpacked_bytes"]
        assert r["peer_served_ratio"] >= 0.6, r
        assert r["plan"] == ref[i]["plan"]
        assert r["trace_id"] == ref[i]["trace_id"]
        assert _keys(r) == _keys(ref[i])
        assert sorted(r["clock_offsets"]) == sorted(ref[i]["clock_offsets"])
        for key in ("units", "wire_bytes", "unpacked_bytes"):
            assert r["exchange"][key] == ref[i]["exchange"][key]
        _assert_fully_cached(b, tmp_path / f"h{i}")
    assert sum(b.stats.bytes_from_cdn for b in bridges) <= \
        results[0]["plan"]["total_bytes"] * 1.05


def test_coop_round_no_peers_raises_and_single_host_skips(hub, tmp_path):
    b = _bridge(hub, tmp_path)
    with pytest.raises(coop.CoopUnavailable):
        coop.coop_round(b, _recs(b), 0, 4, host_addrs={}, device="cpu")
    assert coop.coop_round(b, _recs(b), 0, 1, device="cpu")["skipped"]


def test_coop_dead_host_degrades_to_cdn(hub, tmp_path):
    bridges, results, errors = _run_hosts(hub, tmp_path, 3, skip={2})
    assert not errors, errors
    for i in (0, 1):
        r = results[i]
        assert r["fallbacks"] > 0, r
        assert 2 in r["exchange"].get("dead_hosts", []), r
        _assert_fully_cached(bridges[i], tmp_path / f"h{i}")


def test_coop_quarantined_host_resharded_upfront(hub, tmp_path):
    bridges, results, errors = _run_hosts(
        hub, tmp_path, 3, skip={2}, round_kwargs={"quarantined": {2}})
    assert not errors, errors
    for i in (0, 1):
        r = results[i]
        assert r["fallbacks"] == 0, r
        assert r["exchange"].get("dead_hosts") is None, r
        assert r["plan"]["alive"] == 2
        _assert_fully_cached(bridges[i], tmp_path / f"h{i}")


def test_coop_budget_bounds_exchange_staging(hub, tmp_path):
    budget = 256 * 1024
    bridges, results, errors = _run_hosts(
        hub, tmp_path, 2, round_kwargs={"budget_bytes": budget})
    assert not errors, errors
    largest = max(fi.url_range_end - fi.url_range_start for _k, fi in
                  coop.CoopPlan.build(_recs(bridges[0]), 2).units)
    for r in results:
        assert r["exchange"]["budget_bytes"] == budget
        assert 0 < r["exchange"]["inflight_peak_bytes"] <= \
            max(budget, largest), r


def _poisoned_owner(hub, root):
    """Host 0 of two warms its share honestly, then the cache entry of a
    unit holding a BG4 chunk is byte-flipped in the middle of its frames
    (a whole-xorb unit, so the receiver verifies it)."""
    from zest_tpu_torch.cas.compression import Scheme
    from zest_tpu_torch.cas.xorb import XorbReader

    b0 = _bridge(hub, root)
    recs0 = _recs(b0)
    owned = coop.CoopPlan.build(recs0, 2).for_host(0)
    warm_units_parallel(b0, recs0, units=owned)
    for hh, fi in owned:
        entry = b0.cache.get_with_range(hh, fi.range.start)
        if int(Scheme.BG4_LZ4) in XorbReader(entry.data).chunk_schemes:
            bad = bytearray(entry.data)
            bad[len(bad) // 2] ^= 0xFF
            b0.cache.put(hh, bytes(bad))
            return b0
    raise AssertionError("host 0 owns no BG4 unit")


def test_coop_corrupt_owner_blob_rejected_and_healed(hub, tmp_path):
    b0 = _poisoned_owner(hub, tmp_path / "owner")
    server = DcnServer(b0.cfg, b0.cache)
    port = server.start()
    try:
        b1 = _bridge(hub, tmp_path / "puller")
        r = coop.coop_round(b1, _recs(b1), 1, 2, {0: ("127.0.0.1", port)},
                            device="cpu")
        assert r["exchange"]["verify_rejected"] >= 1, r
        assert r["fallbacks"] >= 1, r
        _assert_fully_cached(b1, tmp_path / "puller")
    finally:
        server.shutdown()


@pytest.mark.parametrize("fault", ["dcn_reset:1.0", "peer_timeout:1.0"])
def test_coop_exchange_faults_degrade_to_cdn(hub, tmp_path, fault):
    faults.install(fault)
    bridges, results, errors = _run_hosts(hub, tmp_path, 2)
    assert not errors, errors
    assert faults.counters().get(fault.split(":")[0], 0) > 0
    for i, (b, r) in enumerate(zip(bridges, results)):
        assert r["fallbacks"] > 0, r
        assert r["exchange"]["units"] == 0, r
        _assert_fully_cached(b, tmp_path / f"h{i}")


def test_verifier_launch_error_surfaces(hub, tmp_path, monkeypatch):
    """A kernel launch that fails inside an exchange worker leaves the
    round — and the pull — as that error, never as a rejection healed
    from the CDN."""
    def broken(self, words, lengths):
        raise RuntimeError("BG4 regroup kernel launch failed: cudaError 98")

    monkeypatch.setattr(bg4.FusedBg4Verifier, "hash_planar_device", broken)
    owner = _bridge(hub, tmp_path / "owner")
    recs = _recs(owner)
    warm_units_parallel(owner, recs)  # owner holds everything
    server = DcnServer(owner.cfg, owner.cache)
    port = server.start()
    try:
        b1 = _bridge(hub, tmp_path / "puller")
        with pytest.raises(RuntimeError, match="cudaError 98"):
            coop.coop_round(b1, _recs(b1), 1, 2, {0: ("127.0.0.1", port)},
                            device="cpu")
        cfg = Config(hf_home=tmp_path / "p2/hf", cache_dir=tmp_path / "p2/z",
                     hf_token="hf_test", endpoint=hub.url, dcn_port=0)
        with pytest.raises(RuntimeError, match="cudaError 98"):
            pull_model(cfg, REPO_ID, device="cpu", coop=True, coop_hosts=2,
                       coop_index=1, coop_addrs={0: ("127.0.0.1", port)},
                       log=_quiet)
    finally:
        server.shutdown()


# ── pull_model ──


GPT2_REPO = "acme/coop-gpt2"


@pytest.fixture(scope="module")
def gpt2_hub():
    files = gpt2_checkpoint_files(n_embd=64, n_layer=2, seed=9)
    with FixtureHub(FixtureRepo(GPT2_REPO, files, chunks_per_xorb=2)) as h:
        yield h, files


def test_pull_model_coop_matches_reference_landing(gpt2_hub, tmp_path):
    """``pull_model(coop=True)`` on a small GPT-2: the peer host serves
    its share over a DCN server, the files are byte-exact and the landed
    ``params_digest`` equals the reference pull's."""
    h, files = gpt2_hub
    peer_cfg = Config(hf_home=tmp_path / "peer/hf",
                      cache_dir=tmp_path / "peer/zest", hf_token="hf_test",
                      endpoint=h.url, dcn_port=0)
    peer = XetBridge(peer_cfg)
    peer.authenticate(GPT2_REPO)
    recs = [peer.get_reconstruction(e.xet_hash)
            for e in HubClient(peer_cfg).list_files(GPT2_REPO) if e.is_xet]
    warm_units_parallel(peer, recs,
                        units=coop.CoopPlan.build(recs, 2).for_host(1))
    server = DcnServer(peer_cfg, peer.cache)
    port = server.start()
    try:
        cfg = Config(hf_home=tmp_path / "p0/hf",
                     cache_dir=tmp_path / "p0/zest", hf_token="hf_test",
                     endpoint=h.url, dcn_port=0)
        res = pull_model(cfg, GPT2_REPO, device="cpu", coop=True,
                         coop_hosts=2, coop_index=0,
                         coop_addrs={1: ("127.0.0.1", port)}, log=_quiet)
    finally:
        server.shutdown()
    ref = j_pull.pull_model(
        JConfig(hf_home=tmp_path / "ref/hf", cache_dir=tmp_path / "ref/zest",
                hf_token="hf_test", endpoint=h.url),
        GPT2_REPO, no_p2p=True, log=_quiet)
    c = res.stats["coop"]
    assert not c.get("skipped") and c["fallbacks"] == 0, c
    assert c["exchange"]["units"] > 0
    assert res.stats["peer_served_ratio"] == c["peer_served_ratio"] >= 0.4
    assert res.stats["fetch"]["bytes"]["peer"] == c["exchange"]["wire_bytes"]
    assert res.stats["fallback_files"] == 0
    for name, data in files.items():
        assert (res.snapshot_dir / name).read_bytes() == data
    j_params, _ = j_loader.stage_snapshot_to_hbm(ref.snapshot_dir)
    assert loader.params_digest(res.params) == j_loader.params_digest(
        j_params)


def test_pull_model_coop_auto_off_without_topology(gpt2_hub, tmp_path):
    """No coop arguments and no ZEST_COOP*: no round runs or reports; a
    forced ``coop=True`` without a host index is off and says why."""
    from zest_tpu_torch.transfer import pull as port_pull

    h, _files = gpt2_hub
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 hf_token="hf_test", endpoint=h.url)
    res = pull_model(cfg, GPT2_REPO, device="cpu", log=_quiet)
    assert "coop" not in res.stats and "peer_served_ratio" not in res.stats
    logged = []
    assert port_pull._resolve_coop(
        cfg, True, 4, None, None, lambda m, **k: logged.append(m)) is None
    assert logged and "disabled" in logged[0]


def test_config_coop_env_parsing():
    cfg = Config.load({
        "HF_HOME": "/tmp/x", "ZEST_CACHE_DIR": "/tmp/y", "ZEST_COOP": "1",
        "ZEST_COOP_HOSTS": "4", "ZEST_COOP_INDEX": "2",
        "ZEST_COOP_ADDRS": "0=h0:6991, 1=h1:6991,3=h3:7001",
        "ZEST_COOP_INFLIGHT": "123456", "ZEST_DCN_PORT": "7100",
    })
    ref = JConfig.load({
        "HF_HOME": "/tmp/x", "ZEST_CACHE_DIR": "/tmp/y", "ZEST_COOP": "1",
        "ZEST_COOP_HOSTS": "4", "ZEST_COOP_INDEX": "2",
        "ZEST_COOP_ADDRS": "0=h0:6991, 1=h1:6991,3=h3:7001",
        "ZEST_COOP_INFLIGHT": "123456", "ZEST_DCN_PORT": "7100",
    })
    for field in ("coop_pull", "coop_hosts", "coop_index", "coop_addrs",
                  "coop_inflight_bytes", "dcn_port"):
        assert getattr(cfg, field) == getattr(ref, field), field
    with pytest.raises(ValueError):
        Config.load({"HF_HOME": "/tmp/x", "ZEST_COOP_ADDRS": "nonsense"})
    default = Config.load({"HF_HOME": "/tmp/x"})
    jdefault = JConfig.load({"HF_HOME": "/tmp/x"})
    assert (default.coop_pull, default.dcn_port,
            default.coop_inflight_bytes) == (
        jdefault.coop_pull, jdefault.dcn_port, jdefault.coop_inflight_bytes)
    assert Config.load({"HF_HOME": "/tmp/x",
                        "ZEST_COOP": "0"}).coop_pull is False


def test_launch_counter_under_threads():
    """Host threads launch at once: no count is lost."""
    counter = nvcc.LaunchCounter()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counter.add(3) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert (counter.launches, counter.rows) == (32000, 96000)
