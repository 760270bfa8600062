"""The port's federated multi-pod pull against the JAX package's, on the
CPU, and the cooperative round's discovery and swarm health.

Mirrors the federated cases of tests/test_dcn.py and
tests/test_collective.py on seeded fixtures (a 1.5 MB low-entropy
payload, two chunks per xorb; a small GPT-2), with ``device="cpu"``:

- ``pod_owned_units`` equal to the reference's for 2 and 3 pods;
- ``federated_round`` in process over a real DCN socket, pod 0 first,
  then pod 1; degrading to the CDN when the owner is unreachable; never
  narrowing a cached entry; every stats block equal to the reference's
  (``elapsed_s`` excepted);
- ``pull_model(pods=, pod_index=, pod_addrs=)`` over a two-slot CPU mesh
  with the pod pre-pass, held to the reference's pull, and the CLI flags
  (``pull --pods --pod-index --pod-addr``) with the reference's checks;
- the 2 pods × 2 hosts collective round end to end (the federated
  schedule, the wan link ledger);
- a host the swarm's health registry quarantines is left out of the coop
  plan, as the reference leaves it out;
- discovery over a ``torch.distributed`` store (``TCPStore``,
  ``HashStore``): every host's DCN address, and one trace id from host 0's
  nonce however late host 0 starts; a coop ``pull_model`` with no
  addresses finds its peer over the store.
"""

from __future__ import annotations

import re
import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

from tests.fixtures import FixtureHub, FixtureRepo, gpt2_checkpoint_files
from zest_tpu.cas.hub import HubClient as JHubClient
from zest_tpu.config import Config as JConfig
from zest_tpu.p2p.health import HealthRegistry as JHealthRegistry
from zest_tpu.telemetry import fleet as j_fleet
from zest_tpu.transfer import coop as j_coop
from zest_tpu.transfer import dcn as j_dcn
from zest_tpu.transfer import federated as j_fed
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer.bridge import XetBridge as JXetBridge
from zest_tpu.transfer.swarm import SwarmDownloader as JSwarmDownloader
from zest_tpu_torch import cli
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.cas.reconstruction import (
    ChunkRange,
    FetchInfo,
    Reconstruction,
    Term,
)
from zest_tpu_torch.cas.xorb import XorbBuilder, XorbReader
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import loader
from zest_tpu_torch.p2p.health import HealthRegistry
from zest_tpu_torch.parallel.mesh import model_mesh
from zest_tpu_torch.telemetry import fleet
from zest_tpu_torch.transfer import coop, federated
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.dcn import DcnServer
from zest_tpu_torch.transfer.pull import pull_model
from zest_tpu_torch.transfer.swarm import SwarmDownloader

REPO_ID = "acme/federated-model"
_PAYLOAD = np.random.default_rng(13).integers(
    0, 4, 1_500_000, dtype=np.uint8).tobytes()
FILES = {
    "config.json": b'{"model_type": "federated"}',
    "model.safetensors": _PAYLOAD,
}
SMALL = {"model.safetensors": _PAYLOAD[:300_000]}


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO_ID, FILES, chunks_per_xorb=2)) as h:
        yield h


@pytest.fixture(scope="module")
def small_hub():
    with FixtureHub(FixtureRepo(REPO_ID, SMALL, chunks_per_xorb=2)) as h:
        yield h


def _bridge(hub, root, swarm=None, **kw):
    cfg = Config(hf_home=root / "hf", cache_dir=root / "zest",
                 hf_token="hf_test", endpoint=hub.url, dcn_port=0, **kw)
    b = XetBridge(cfg, swarm=swarm)
    b.authenticate(REPO_ID)
    return b


def _jbridge(hub, root, swarm=None, **kw):
    cfg = JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, dcn_port=0, **kw)
    b = JXetBridge(cfg, swarm=swarm)
    b.authenticate(REPO_ID)
    return b


def _recs(bridge, hub_cls=HubClient):
    return [bridge.get_reconstruction(e.xet_hash)
            for e in hub_cls(bridge.cfg).list_files(REPO_ID) if e.is_xet]


def _jrecs(bridge):
    return _recs(bridge, JHubClient)


def _keys(units):
    return [(hh, fi.range.start, fi.range.end) for hh, fi in units]


def _no_time(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "elapsed_s"}


# ── Ownership ──


@pytest.mark.parametrize("n_pods", [2, 3])
def test_pod_owned_units_match_reference(hub, tmp_path, n_pods):
    recs = _recs(_bridge(hub, tmp_path / "p"))
    jrecs = _jrecs(_jbridge(hub, tmp_path / "j"))
    mine_all = []
    for pod in range(n_pods):
        mine, theirs = federated.pod_owned_units(recs, pod, n_pods)
        jmine, jtheirs = j_fed.pod_owned_units(jrecs, pod, n_pods)
        assert _keys(mine) == _keys(jmine)
        assert {p: _keys(u) for p, u in theirs.items()} == \
            {p: _keys(u) for p, u in jtheirs.items()}
        mine_all.append({k[:2] for k in _keys(mine)})
    assert all(mine_all)  # the fixture gives every pod units
    for a in range(n_pods):
        for b in range(a + 1, n_pods):
            assert mine_all[a].isdisjoint(mine_all[b])


# ── The round in process ──


def _two_pods(hub, tmp_path, ref: bool):
    """Pod 0's round (no address for pod 1), a DCN server on its cache,
    then pod 1's round with pod 0's address. Returns both stats and pod
    1's bridge."""
    make, recs_of, server_cls, round_fn = (
        (_jbridge, _jrecs, j_dcn.DcnServer, j_fed.federated_round) if ref
        else (_bridge, _recs, DcnServer, federated.federated_round))
    tag = "j" if ref else "p"
    b0 = make(hub, tmp_path / f"{tag}0")
    s0 = round_fn(b0, recs_of(b0), 0, 2, pod_addrs={})
    server = server_cls(b0.cfg, b0.cache)
    port = server.start()
    try:
        b1 = make(hub, tmp_path / f"{tag}1")
        s1 = round_fn(b1, recs_of(b1), 1, 2,
                      pod_addrs={0: ("127.0.0.1", port)})
    finally:
        server.shutdown()
        b0.close()
    return s0, s1, b1


def test_federated_round_in_process_matches_reference(hub, tmp_path):
    s0, s1, b1 = _two_pods(hub, tmp_path, ref=False)
    j0, j1, jb1 = _two_pods(hub, tmp_path, ref=True)
    jb1.close()
    assert _no_time(s0) == _no_time(j0)
    assert _no_time(s1) == _no_time(j1)
    assert s0["own_units"] > 0 and s0["dcn_units"] == 0
    assert s1["dcn_units"] == s0["own_units"] and s1["dcn_bytes"] > 0
    assert s1["fallback_units"] == s1["failed_units"] == 0
    mine0, _ = federated.pod_owned_units(_recs(b1), 0, 2)
    assert s1["dcn_bytes"] == s0["own_bytes"] == sum(
        fi.url_range_end - fi.url_range_start for _, fi in mine0)
    try:
        cdn_before = b1.stats.bytes_from_cdn
        for e in HubClient(b1.cfg).list_files(REPO_ID):
            if e.is_xet:
                out = tmp_path / "out.bin"
                b1.reconstruct_to_file(e.xet_hash, out)
                assert out.read_bytes() == FILES[e.path]
        assert b1.stats.bytes_from_cdn == cdn_before
        assert b1.stats.bytes_from_peer == s1["dcn_bytes"]
    finally:
        b1.close()


def test_federated_round_degrades_to_cdn(hub, tmp_path):
    b1 = _bridge(hub, tmp_path / "p")
    jb1 = _jbridge(hub, tmp_path / "j")
    try:
        _mine, theirs = federated.pod_owned_units(_recs(b1), 1, 2)
        s = federated.federated_round(b1, _recs(b1), 1, 2,
                                      pod_addrs={0: ("127.0.0.1", 1)})
        js = j_fed.federated_round(jb1, _jrecs(jb1), 1, 2,
                                   pod_addrs={0: ("127.0.0.1", 1)})
        assert _no_time(s) == _no_time(js)
        assert s["dcn_units"] == 0 and s["failed_units"] == 0
        assert s["fallback_units"] == sum(len(u) for u in theirs.values())
    finally:
        b1.close()
        jb1.close()


def test_federated_round_never_narrows_cached_entries(hub, tmp_path):
    """A unit answered by a cache hit is never re-put: a whole cached
    xorb answering a narrow [0, 3) unit would be overwritten by its own
    slice."""
    b = _bridge(hub, tmp_path)
    try:
        rng = np.random.default_rng(77)
        builder = XorbBuilder()
        chunks = [rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
                  for _ in range(6)]
        for c in chunks:
            builder.add_chunk(c)
        xh = builder.xorb_hash()
        xh_hex = hashing.hash_to_hex(xh)
        b.cache.put(xh_hex, builder.serialize_full())
        full_before = b.cache.get(xh_hex)
        offs = builder.frame_offsets()
        rec = Reconstruction(
            file_hash=bytes(32),
            terms=[Term(xh, ChunkRange(0, 3),
                        sum(len(c) for c in chunks[:3]))],
            fetch_info={xh_hex: [FetchInfo("/nowhere", 0, offs[3],
                                           ChunkRange(0, 3))]})
        for pod_index in (0, 1):  # whoever owns it, the entry survives
            s = federated.federated_round(b, [rec], pod_index, 2,
                                          pod_addrs={})
            assert s["failed_units"] == 0
        assert b.cache.get(xh_hex) == full_before
        assert len(XorbReader(b.cache.get(xh_hex))) == 6
    finally:
        b.close()


# ── pull_model and the CLI ──

GPT2_REPO = "acme/federated-gpt2"


@pytest.fixture(scope="module")
def gpt2_hub():
    files = gpt2_checkpoint_files(n_embd=64, n_layer=2, seed=23)
    with FixtureHub(FixtureRepo(GPT2_REPO, files, chunks_per_xorb=2)) as h:
        yield h, files


def test_pull_model_two_pods_over_a_mesh_matches_reference(gpt2_hub,
                                                          tmp_path):
    """The slice's path on the CPU: pod 0 pulls, then serves its cache
    over DCN; pod 1 pulls with pod 0's address over a two-slot mesh with
    the pod pre-pass. The federated blocks equal the reference pulls',
    every landed tree is the exact one, and pod 1's pre-pass verifies and
    fills every unit."""
    h, files = gpt2_hub
    mesh = model_mesh({"model": 2}, ["cpu"] * 2)

    def cfg(name):
        return Config(hf_home=tmp_path / name / "hf",
                      cache_dir=tmp_path / name / "zest",
                      hf_token="hf_test", endpoint=h.url, dcn_port=0)

    def jcfg(name):
        return JConfig(hf_home=tmp_path / name / "hf",
                       cache_dir=tmp_path / name / "zest",
                       hf_token="hf_test", endpoint=h.url, dcn_port=0)

    exact = loader.load_checkpoint(_write(tmp_path / "exact", files), "cpu")
    res0 = pull_model(cfg("p0"), GPT2_REPO, device="cpu", pods=2,
                      pod_index=0, mesh=mesh, pod=True, log=_quiet)
    server = DcnServer(cfg("p0"))
    port = server.start()
    try:
        res1 = pull_model(cfg("p1"), GPT2_REPO, device="cpu", pods=2,
                          pod_index=1, pod_addrs={0: ("127.0.0.1", port)},
                          mesh=mesh, pod=True, log=_quiet)
    finally:
        server.shutdown()
    jres0 = j_pull.pull_model(jcfg("j0"), GPT2_REPO, pods=2, pod_index=0,
                              no_p2p=True, log=_quiet)
    jserver = j_dcn.DcnServer(jcfg("j0"))
    jport = jserver.start()
    try:
        jres1 = j_pull.pull_model(jcfg("j1"), GPT2_REPO, pods=2, pod_index=1,
                                  pod_addrs={0: ("127.0.0.1", jport)},
                                  no_p2p=True, log=_quiet)
    finally:
        jserver.shutdown()
    f0, f1 = res0.stats["federated"], res1.stats["federated"]
    assert _no_time(f0) == _no_time(jres0.stats["federated"])
    assert _no_time(f1) == _no_time(jres1.stats["federated"])
    mine0, _ = federated.pod_owned_units(_gpt2_recs(cfg("p1"), h), 0, 2)
    assert f1["dcn_units"] == len(mine0) > 0
    assert f1["fallback_units"] == f1["failed_units"] == 0
    for res in (res0, res1):
        pod = res.stats["pod"]
        assert pod["filled"] == pod["units"] and not pod["verify_rejected"]
        assert res.stats["hbm"]["sharded"]
        assert loader.params_digest(res.params) == \
            loader.params_digest(exact)
        for name, data in files.items():
            assert (res.snapshot_dir / name).read_bytes() == data
    cdn = [r.stats["fetch"]["bytes"]["cdn"] for r in (res0, res1)]
    assert cdn == [jres0.stats["fetch"]["bytes"]["cdn"],
                   jres1.stats["fetch"]["bytes"]["cdn"]]


def _gpt2_recs(cfg, h):
    b = XetBridge(cfg)
    b.authenticate(GPT2_REPO)
    try:
        return [b.get_reconstruction(e.xet_hash)
                for e in HubClient(cfg).list_files(GPT2_REPO) if e.is_xet]
    finally:
        b.close()


def _write(root, files):
    root.mkdir(parents=True)
    for name, data in files.items():
        (root / name).write_bytes(data)
    return root


def test_federated_pull_cli_flags(gpt2_hub, tmp_path, capsys,
                                  monkeypatch):
    """``pull --pods/--pod-index/--pod-addr`` runs the cross-pod stage and
    prints the reference's ``Federated:`` line; a half-given topology or
    an address without its index is a usage error."""
    def set_pod_env(i):
        monkeypatch.setenv("HF_HOME", str(tmp_path / f"pod{i}/hf"))
        monkeypatch.setenv("ZEST_CACHE_DIR", str(tmp_path / f"pod{i}/zest"))
        monkeypatch.setenv("HF_TOKEN", "hf_test")
        monkeypatch.setenv("HF_ENDPOINT", gpt2_hub[0].url)

    base = ["pull", GPT2_REPO, "--device", "cpu", "--no-p2p", "--no-pod"]
    set_pod_env(0)
    assert cli.main(base + ["--pods", "2", "--pod-index", "0"]) == 0
    assert "Federated:  pod 0/2" in capsys.readouterr().out
    cfg0 = Config(hf_home=tmp_path / "pod0/hf",
                  cache_dir=tmp_path / "pod0/zest", dcn_port=0)
    server = DcnServer(cfg0)
    port = server.start()
    try:
        for bad in (["--pods", "2"], ["--pod-index", "0"],
                    ["--pods", "2", "--pod-index", "2"],
                    ["--pods", "2", "--pod-index", "1",
                     "--pod-addr", "127.0.0.1:9"]):
            assert cli.main(base + bad) == 2
        set_pod_env(1)
        assert cli.main(base + ["--pods", "2", "--pod-index", "1",
                                "--pod-addr", f"0=127.0.0.1:{port}"]) == 0
        out1 = capsys.readouterr().out
        assert "Federated:  pod 1/2" in out1
        assert "0 CDN-fallback" in out1
        m = re.search(r"(\d+) over DCN \((\d+) bytes\)", out1)
        assert m and int(m.group(1)) > 0 and int(m.group(2)) > 0
    finally:
        server.shutdown()


# ── 2 pods × 2 hosts: the collective round ──


def _collective_hosts(hub, tmp_path, n, ref, swarms=None, skip=(),
                      quarantine=(), **cfg_kw):
    """``n`` hosts' coop rounds in threads over loopback DCN; hosts in
    ``skip`` sit on a dead port and run no round; the addresses of the
    hosts in ``quarantine`` are quarantined in every swarm's health before
    the rounds start."""
    make, recs_of, server_cls, round_fn = (
        (_jbridge, _jrecs, j_dcn.DcnServer, j_coop.coop_round) if ref
        else (_bridge, _recs, DcnServer, coop.coop_round))
    kwargs = {} if ref else {"device": "cpu"}
    bridges, servers, addrs = [], [], {}
    for i in range(n):
        b = make(hub, tmp_path / f"{'j' if ref else 'p'}{i}",
                 swarm=(swarms or {}).get(i), **cfg_kw)
        bridges.append(b)
        if i in skip:
            addrs[i] = ("127.0.0.1", 1)  # nothing listens
            servers.append(None)
            continue
        s = server_cls(b.cfg, b.cache)
        addrs[i] = ("127.0.0.1", s.start())
        servers.append(s)
    for sw in (swarms or {}).values():
        for q in quarantine:
            _quarantine(sw.health, addrs[q])
    results, errors = [None] * n, []

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
    for s in servers:
        if s is not None:
            s.shutdown()
    for b in bridges:
        b.close()
    assert not errors, errors
    return results, addrs


def test_federated_collective_round_2_pods_by_2_hosts(small_hub, tmp_path):
    """Four hosts, two pods of two over loopback DCN: the federated
    schedule, no fallback, the wan key in every link ledger and wan bytes
    only on the pods' gateways (hosts 0 and 2), as in the reference's
    round; the schedules and the link bytes equal the reference's."""
    pods = (0, 0, 1, 1)
    kw = dict(coop_pods=pods, coop_topology=pods)
    results, _ = _collective_hosts(small_hub, tmp_path, 4, False, **kw)
    jresults, _ = _collective_hosts(small_hub, tmp_path, 4, True, **kw)
    for r, jr in zip(results, jresults):
        cx, jcx = r["collective"], jr["collective"]
        assert cx["schedule"] == jcx["schedule"] == "federated"
        assert not cx.get("aborted") and r["fallbacks"] == 0
        assert cx["link_bytes"] == jcx["link_bytes"]
        assert "wan" in cx["link_bytes"]
        assert r["plan"] == jr["plan"]
    assert any(r["collective"]["link_bytes"]["wan"] > 0 for r in results)
    for i in (1, 3):
        assert results[i]["collective"]["link_bytes"]["wan"] == 0


# ── Swarm health in the coop plan ──


def _quarantine(health, addr):
    while not health.is_quarantined(addr):
        health.record_failure(addr, kind="io_timeout")


def test_quarantined_host_left_out_of_the_plan(small_hub, tmp_path):
    """Host 2 of 3 sits quarantined in both live hosts' swarm health:
    neither plans it a share (its units re-shard up front), the round
    completes without it, and the plans equal the reference's."""
    addrs = {0: ("127.0.0.1", 7001), 1: ("127.0.0.1", 7002),
             2: ("127.0.0.1", 7003)}
    h = HealthRegistry()
    jh = JHealthRegistry()
    _quarantine(h, addrs[2])
    _quarantine(jh, addrs[2])
    assert coop.quarantined_hosts(h, addrs) == \
        j_coop.quarantined_hosts(jh, addrs) == frozenset({2})
    assert coop.quarantined_hosts(None, addrs) == frozenset()

    def run(ref):
        sw = {i: (JSwarmDownloader if ref else SwarmDownloader)(
            (JConfig if ref else Config)(hf_home=tmp_path / "s" / "hf",
                                         cache_dir=tmp_path / "s" / "z"))
              for i in (0, 1)}
        try:
            return _collective_hosts(small_hub, tmp_path / str(ref), 3, ref,
                                     swarms=sw, skip=(2,), quarantine=(2,),
                                     coop_collective=False)[0]
        finally:
            for x in sw.values():
                x.close()

    results, jresults = run(False), run(True)
    for r, jr in zip(results[:2], jresults[:2]):
        assert r["plan"]["alive"] == 2 and r["plan"]["bytes_per_host"][2] == 0
        assert r["plan"] == jr["plan"]
        assert r["fallbacks"] == 0 and not r["exchange"].get("dead_hosts")


# ── Discovery over the torch.distributed store ──


def _store(kind):
    if kind == "hash":
        return dist.HashStore(), None
    port = _free_port()
    server = dist.TCPStore("127.0.0.1", port, is_master=True,
                           wait_for_workers=False)
    return dist.TCPStore("127.0.0.1", port, is_master=False), server


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("kind", ["tcp", "hash"])
@pytest.mark.parametrize("host0_delay", [0.0, 0.5])
def test_kv_discovery_addresses_and_one_trace_id(kind, host0_delay):
    """Three hosts announce and read each other's DCN endpoints over one
    store; host 0 writes its nonce before its address and the others read
    it after the exchange, so all mint one trace id even when host 0
    starts late."""
    store, _server = _store(kind)
    n, key = 3, "acme/m@sha1"
    got, ids = {}, {}

    def host(i):
        if i == 0:
            time.sleep(host0_delay)
            nonce = coop.share_nonce_via_kv(key, 0, store=store)
        addrs = coop.exchange_addrs_via_kv(key, i, n, 7000 + i,
                                           advertise_host=f"10.0.0.{i}",
                                           timeout_s=10.0, store=store)
        if i != 0:
            nonce = coop.share_nonce_via_kv(key, i, timeout_s=5.0,
                                            store=store)
        got[i] = addrs
        ids[i] = fleet.mint_trace_id(key, nonce)

    threads = [threading.Thread(target=host, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    want = {i: (f"10.0.0.{i}", 7000 + i) for i in range(n)}
    assert got == {i: want for i in range(n)}
    assert len(set(ids.values())) == 1
    assert ids[0] != fleet.mint_trace_id(key)  # the nonce took part


def test_kv_discovery_without_a_store():
    assert not dist.is_initialized()
    assert coop.exchange_addrs_via_kv("k", 0, 2, 7000) is None
    assert coop.share_nonce_via_kv("k", 1, timeout_s=0.1) == ""
    assert coop.exchange_addrs_via_kv(
        "k", 0, 2, 7000, advertise_host="h", timeout_s=0.3,
        store=dist.HashStore()) is None  # nobody else ever announced
    for key, nonce in (("acme/m@sha1", ""), ("acme/m@sha1", "n1")):
        assert fleet.mint_trace_id(key, nonce) == \
            j_fleet.mint_trace_id(key, nonce)


def test_coop_pull_discovers_peers_over_the_store(gpt2_hub, tmp_path,
                                                  monkeypatch):
    """Two hosts pull cooperatively with no addresses: each binds its DCN
    listener, announces it over the store and finds the other; the round
    runs with one trace id and both land the exact tree."""
    h, files = gpt2_hub
    store = dist.HashStore()
    monkeypatch.setattr(coop, "kv_store", lambda: store)
    monkeypatch.setenv("ZEST_COOP_ADVERTISE", "127.0.0.1")
    exact = loader.load_checkpoint(_write(tmp_path / "exact", files), "cpu")
    results, errors = [None, None], []

    def host(i):
        try:
            cfg = Config(hf_home=tmp_path / f"h{i}/hf",
                         cache_dir=tmp_path / f"h{i}/zest",
                         hf_token="hf_test", endpoint=h.url, dcn_port=0,
                         coop_collective=False)
            results[i] = pull_model(cfg, GPT2_REPO, device="cpu", coop=True,
                                    coop_hosts=2, coop_index=i, log=_quiet)
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    threads = [threading.Thread(target=host, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    c0, c1 = (r.stats["coop"] for r in results)
    assert c0["trace_id"] == c1["trace_id"] != fleet.mint_trace_id(
        f"{GPT2_REPO}@{results[0].stats['revision']}")
    for r in results:
        c = r.stats["coop"]
        assert c["exchange"]["units"] > 0 and c["fallbacks"] == 0
        assert loader.params_digest(r.params) == loader.params_digest(exact)
