"""Peer discovery and the parallel file rung, against the JAX package.

A files-only pull (``land=False``; the JAX package's ``device=None``) of
the GPT-2 fixture whose only peer source is a tracker that a seeder
registered with, and one whose only source is a DHT node bootstrapped
from a loopback router: the port's files, ``fetch`` block, file lanes and
fallbacks are the JAX package's through the same seeder and the same
tracker or router, and every xet file is written by the
``ParallelDownloader`` rung (each rung's writes counted by
``chip_smoke.RungLog``). Then ``XorbRegistry.scan`` against the JAX
package's on one cache, ``seed`` announcing every cached xorb,
``POST /v1/push`` registering and announcing its xorbs, ``serve`` with a
coop identity answering gossip on its DCN port, ``pull --tracker
--no-dht`` through the CLI, and the parallel rung's first error
cancelling the rest and falling to the sequential rung. Every listener
binds port 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

import chip_smoke
from tests.fixtures import FixtureHub, FixtureRepo, gpt2_checkpoint_files
from zest_tpu import cli as j_cli
from zest_tpu import storage as j_storage
from zest_tpu.config import Config as JConfig
from zest_tpu.p2p import dht as j_dht
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer.swarm import SwarmDownloader as JSwarmDownloader
from zest_tpu_torch import cli, faults, storage
from zest_tpu_torch.api.http_api import PublisherServer
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.config import Config
from zest_tpu_torch.p2p.dht import Dht
from zest_tpu_torch.p2p.health import PROVENANCE
from zest_tpu_torch.p2p.peer_id import compute_info_hash
from zest_tpu_torch.p2p.tracker import TrackerClient
from zest_tpu_torch.transfer import bridge as bridge_mod
from zest_tpu_torch.transfer.gossip import KIND_MANIFEST, KIND_XORB, GossipNode
from zest_tpu_torch.transfer.parallel import ParallelDownloader
from zest_tpu_torch.transfer.pull import pull_model
from zest_tpu_torch.transfer.server import BtServer
from zest_tpu_torch.transfer.swarm import SwarmDownloader

REPO = "openai-community/gpt2"
FILES = gpt2_checkpoint_files(n_embd=128, n_layer=2, vocab_size=512,
                              seed=14)
ROOT = Path(__file__).resolve().parent.parent


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    # Several xorbs, so the reconstruction has several terms to fetch in
    # parallel.
    with FixtureHub(FixtureRepo(REPO, FILES, chunks_per_xorb=2)) as h:
        yield h


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.reset()
    PROVENANCE.reset()
    yield
    faults.reset()
    PROVENANCE.reset()


def _cfg(hub, root, **kw):
    kw.setdefault("listen_port", 0)
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _jcfg(hub, root, **kw):
    kw.setdefault("listen_port", 0)
    return JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                   hf_token="hf_test", endpoint=hub.url, **kw)


@pytest.fixture(scope="module")
def seeder(hub, tmp_path_factory):
    """A warm port node seeding its cache over the BT wire: ``(cfg,
    port)``; ``cfg.listen_port`` is the bound port."""
    cfg = _cfg(hub, tmp_path_factory.mktemp("seeder"))
    pull_model(cfg, REPO, device="cpu", no_p2p=True, log=_quiet)
    server = BtServer(cfg)
    cfg.listen_port = server.start()
    yield cfg, cfg.listen_port
    server.shutdown()


@pytest.fixture(scope="module")
def tracker(seeder):
    """The loopback tracker, with every cached xorb of the seeder
    registered at its port."""
    cfg, port = seeder
    t = chip_smoke.LoopbackTracker()
    sw = SwarmDownloader(cfg, peer_sources=[TrackerClient(t.url, b"s" * 20,
                                                          listen_port=port)])
    sw.announce_xorbs(storage.list_cached_xorbs(cfg))
    sw.close()
    yield t
    t.close()


def _port_pull(cfg, swarm, logs):
    with chip_smoke.RungLog() as rungs:
        try:
            res = pull_model(cfg, REPO, device="cpu", land=False, swarm=swarm,
                             log=lambda *a, **k: logs.append(" ".join(
                                 map(str, a))))
        finally:
            swarm.close()
    return res, rungs


def _ref_pull(jcfg, swarm, logs):
    try:
        return j_pull.pull_model(jcfg, REPO, device=None, swarm=swarm,
                                 log=lambda *a, **k: logs.append(" ".join(
                                     map(str, a))))
    finally:
        swarm.close()


def _assert_parity(mine, theirs, rungs, my_logs, their_logs, seeder_port):
    for name, want in FILES.items():
        assert (mine.snapshot_dir / name).read_bytes() == want
        assert (theirs.snapshot_dir / name).read_bytes() == want
    a, b = mine.stats["fetch"], theirs.stats["fetch"]
    assert a["bytes"]["peer"] > 0 and a["bytes"]["cdn"] == 0
    for tier in ("peer", "cdn"):
        assert a["bytes"][tier] == b["bytes"][tier]
        assert a["xorbs"][tier] == b["xorbs"][tier]
    assert a["p2p_ratio"] == b["p2p_ratio"] == 1.0
    assert mine.stats["files_pipeline"]["lane_bytes"] == \
        theirs.stats["files_pipeline"]["lane_bytes"] == {
            "waterfall": sum(len(v) for v in FILES.values())}
    assert mine.stats["fallback_files"] == 0
    falls = [ln for ln in my_logs + their_logs if "failed" in ln]
    assert falls == []
    assert sorted(rungs.rows) == [("parallel", "model.safetensors"),
                                  ("plain", "config.json")]
    for res in (mine, theirs):
        sw = res.stats["swarm"]
        assert sw["peers_discovered"] > 0 and sw["peer_failures"] == 0
    assert set(mine.stats["swarm"]) == set(theirs.stats["swarm"])


def test_files_only_pull_through_a_tracker_equals_reference(hub, seeder,
                                                           tracker, tmp_path):
    _, port = seeder
    my_logs, their_logs = [], []
    cfg = _cfg(hub, tmp_path / "mine")
    swarm = cli._build_swarm(cfg, tracker=tracker.url, dht=False)
    leecher_id = swarm.peer_sources[0].peer_id
    mine, rungs = _port_pull(cfg, swarm, my_logs)
    jcfg = _jcfg(hub, tmp_path / "theirs")
    theirs = _ref_pull(jcfg, j_cli._build_swarm(jcfg, tracker=tracker.url,
                                                dht=False), their_logs)
    _assert_parity(mine, theirs, rungs, my_logs, their_logs, port)
    assert any(a["peer_id"] == leecher_id and a["port"] == 0
               for a in tracker.announces)


def _dht_leecher_pull(cfg_s, port, leecher_cls, pull):
    """A router node and the seeder's node, which announces the seeder's
    xorbs through a swarm; a ``leecher_cls`` node bootstrapped from the
    router is handed to ``pull``. A router of its own for each leecher: a
    leecher announces what it fetched at its listen port (0 here), which
    a second leecher asking the same router would try."""
    router = Dht(bind=("127.0.0.1", 0))
    seeder_node = Dht(bind=("127.0.0.1", 0))
    leecher = None
    try:
        seeder_node.bootstrap([("127.0.0.1", router.port)])
        announcer = SwarmDownloader(cfg_s, peer_sources=[seeder_node])
        keys = storage.list_cached_xorbs(cfg_s)
        assert announcer.announce_xorbs(keys) == len(keys)
        announcer.close()
        for key in keys:
            ih = compute_info_hash(hashing.hex_to_hash(key))
            assert ("127.0.0.1", port) in router.peer_store[ih]
        leecher = leecher_cls(bind=("127.0.0.1", 0))
        leecher.bootstrap([("127.0.0.1", router.port)])
        return pull(leecher)
    finally:
        router.close()
        seeder_node.close()
        if leecher is not None:
            leecher.close()


def test_files_only_pull_through_a_dht_equals_reference(hub, seeder,
                                                        tmp_path):
    """Each package's pull has one DHT node, bootstrapped from a router
    that the seeder's node announced to, as its only source."""
    cfg_s, port = seeder
    my_logs, their_logs = [], []
    cfg = _cfg(hub, tmp_path / "mine")

    def port_pull(node):
        out = _port_pull(cfg, SwarmDownloader(
            cfg, peer_sources=[node], own_sources=True), my_logs)
        assert node.sock.fileno() == -1  # the swarm closed it
        return out

    mine, rungs = _dht_leecher_pull(cfg_s, port, Dht, port_pull)
    jcfg = _jcfg(hub, tmp_path / "theirs")
    theirs = _dht_leecher_pull(cfg_s, port, j_dht.Dht, lambda node: _ref_pull(
        jcfg, JSwarmDownloader(jcfg, peer_sources=[node]), their_logs))
    _assert_parity(mine, theirs, rungs, my_logs, their_logs, port)


def test_a_leecher_on_port_0_registers_no_address_where_the_reference_does(
        hub, seeder, tracker, tmp_path):
    """ROADMAP Queue 3 fault 3, repaired in the port: a node whose
    ``listen_port`` is 0 serves nothing, so its swarm announces to no
    tracker or DHT. Leechers pull through one DHT router that the
    seeder's node announced to: the reference's leecher leaves
    ``(ip, 0)`` in the router's store, the port's leaves nothing there,
    and a second port leecher through the same router counts no peer
    failure. Through the tracker the port's leecher sends no ``started``
    announce."""
    cfg_s, port = seeder
    keys = storage.list_cached_xorbs(cfg_s)
    ihs = [compute_info_hash(hashing.hex_to_hash(k)) for k in keys]
    for pkg in ("ref", "port"):
        router = Dht(bind=("127.0.0.1", 0))
        seeder_node = Dht(bind=("127.0.0.1", 0))
        try:
            seeder_node.bootstrap([("127.0.0.1", router.port)])
            announcer = SwarmDownloader(cfg_s, peer_sources=[seeder_node])
            announcer.announce_xorbs(keys)
            announcer.close()
            for i in range(1 if pkg == "ref" else 2):
                root = tmp_path / f"{pkg}{i}"
                if pkg == "ref":
                    node = j_dht.Dht(bind=("127.0.0.1", 0))
                    node.bootstrap([("127.0.0.1", router.port)])
                    jcfg = _jcfg(hub, root)
                    try:
                        res = _ref_pull(jcfg, JSwarmDownloader(
                            jcfg, peer_sources=[node]), [])
                    finally:
                        node.close()
                else:
                    node = Dht(bind=("127.0.0.1", 0))
                    node.bootstrap([("127.0.0.1", router.port)])
                    cfg = _cfg(hub, root)
                    res, _ = _port_pull(cfg, SwarmDownloader(
                        cfg, peer_sources=[node], own_sources=True), [])
                sw = res.stats["swarm"]
                assert sw["peers_discovered"] > 0
                assert sw["peer_failures"] == 0
                assert res.stats["fetch"]["bytes"]["peer"] > 0
                stored = {a for ih in ihs
                          for a in router.peer_store.get(ih, ())}
                assert ("127.0.0.1", port) in stored
                assert (("127.0.0.1", 0) in stored) == (pkg == "ref")
        finally:
            router.close()
            seeder_node.close()
    cfg = _cfg(hub, tmp_path / "tracked")
    swarm = cli._build_swarm(cfg, tracker=tracker.url, dht=False)
    leecher_id = swarm.peer_sources[0].peer_id
    res, _ = _port_pull(cfg, swarm, [])
    assert res.stats["fetch"]["bytes"]["peer"] > 0
    mine = [a for a in tracker.announces if a["peer_id"] == leecher_id]
    assert mine and all(a["event"] != "started" for a in mine)


def test_registry_scan_equals_reference(seeder, tmp_path):
    import shutil

    shutil.copytree(seeder[0].cache_dir, tmp_path / "zest")
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    keys = storage.list_cached_xorbs(cfg)
    # A partial entry beside a full one, a partial-only key, and a temp
    # file that is not an entry.
    cache = storage.XorbCache(cfg)
    cache.put_partial(keys[0], 3, b"p" * 10)
    cache.put_partial("ab" * 32, 5, b"q" * 7)
    cache.put_partial("ab" * 32, 1, b"r" * 9)
    (cfg.xorb_cache_path(keys[0]).parent / (".tmp-" + keys[0])).write_bytes(
        b"x")
    mine, theirs = storage.XorbRegistry(), j_storage.XorbRegistry()
    jcfg = JConfig(hf_home=cfg.hf_home, cache_dir=cfg.cache_dir)
    assert mine.scan(cfg) == theirs.scan(jcfg) == len(keys) + 1
    assert mine.all_hashes() == theirs.all_hashes()
    for h in mine.all_hashes():
        a, b = mine.get(h), theirs.get(h)
        assert (a.hash_hex, a.size, a.partial_starts) == \
            (b.hash_hex, b.size, b.partial_starts)
    assert mine.get("ab" * 32).partial_starts == (1, 5)
    mine.add(keys[1], 1, (7,))
    theirs.add(keys[1], 1, (7,))
    assert mine.get(keys[1]).partial_starts == theirs.get(
        keys[1]).partial_starts == (7,)
    assert mine.has(keys[1]) and not mine.has("cd" * 32)
    assert len(mine) == len(theirs)
    assert storage.XorbRegistry().scan(Config(
        hf_home=tmp_path / "hf", cache_dir=tmp_path / "none")) == 0


def test_seed_announces_every_cached_xorb(seeder, tmp_path, monkeypatch,
                                          capsys):
    cfg, port = seeder
    t = chip_smoke.LoopbackTracker()
    try:
        for k, v in {"HF_HOME": cfg.hf_home, "ZEST_CACHE_DIR": cfg.cache_dir,
                     "ZEST_LISTEN_PORT": port}.items():
            monkeypatch.setenv(k, str(v))
        assert cli.main(["seed", "--tracker", t.url]) == 0
        keys = storage.list_cached_xorbs(cfg)
        assert f"announced {len(keys)}/{len(keys)} xorbs to the swarm" in \
            capsys.readouterr().out
        assert sorted(t.peers) == sorted(
            compute_info_hash(hashing.hex_to_hash(k)) for k in keys)
        assert all(list(p) == [("127.0.0.1", port)] for p in t.peers.values())
        assert {a["event"] for a in t.announces} == {"started"}
        monkeypatch.setenv("ZEST_CACHE_DIR", str(tmp_path / "empty"))
        assert cli.main(["seed", "--tracker", t.url]) == 0
        assert "nothing cached to seed" in capsys.readouterr().out
    finally:
        t.close()


def test_push_notify_registers_and_announces(tmp_path):
    """``POST /v1/push`` with xorbs: the registry takes them, the swarm
    announces them (the tracker sees each once, at the node's port, the
    gossip node first), the gossip plane carries ``repo@revision``; a
    malformed ``xorbs`` is a 400 and registers nothing."""
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 listen_port=6999)
    t = chip_smoke.LoopbackTracker()
    node = GossipNode(0, 2, {})
    swarm = SwarmDownloader(cfg, peer_sources=[TrackerClient(
        t.url, b"n" * 20, listen_port=6999)])
    swarm.attach_gossip(node)
    registry = storage.XorbRegistry()
    xorbs = [["%064x" % i, 1000 + i] for i in range(3)]
    try:
        with PublisherServer(cfg, device="cpu", swarm=swarm,
                             registry=registry, gossip_node=node) as srv:
            def post(body):
                req = urllib.request.Request(
                    f"{srv.url}/v1/push", data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=10) as r:
                        return r.status, json.loads(r.read())
                except urllib.error.HTTPError as exc:
                    return exc.code, json.loads(exc.read())

            code, doc = post({"repo": "acme/m", "revision": "r1",
                              "xorbs": [["zz", "nope"]]})
            assert code == 400 and "xorbs" in doc["error"]
            assert len(registry) == 0 and t.announces == []
            code, doc = post({"repo": "acme/m", "revision": "r1",
                              "parent": "r0", "xorbs": xorbs})
            assert code == 200 and doc["ok"]
            code, _ = post({"repo": "acme/m", "revision": "r2",
                            "xorbs": xorbs})
            assert code == 200
            status = json.loads(urllib.request.urlopen(
                f"{srv.url}/v1/status", timeout=10).read())
    finally:
        swarm.close()
        t.close()
    assert [registry.get(h).size for h, _ in xorbs] == [1000, 1001, 1002]
    assert status["xorbs_cached"] == 3
    hashes = [compute_info_hash(hashing.hex_to_hash(h)) for h, _ in xorbs]
    # The tracker saw the first announce per xorb only; gossip has all.
    assert sorted(a["info_hash"] for a in t.announces) == sorted(hashes)
    assert {a["port"] for a in t.announces} == {6999}
    for ih in hashes:
        assert node.digest.holders(KIND_XORB, ih.hex()) == {
            0: {"port": 6999}}
    assert node.digest.holders(KIND_MANIFEST, "acme/m@r1")[0] == {
        "repo": "acme/m", "revision": "r1", "parent": "r0",
        "pushed_at": None}
    assert node.announces == 6


def test_serve_with_a_coop_identity_gossips_on_its_dcn_port(seeder,
                                                            tmp_path):
    """``serve`` indexes its cache, attaches a gossip node to its swarm
    and its DCN listener, and a ``POST /v1/push`` puts the pushed xorbs in
    the digest that a host-1 node reads over the DCN wire."""
    from zest_tpu_torch.transfer.dcn import DcnPool
    from zest_tpu_torch.transfer.gossip import DcnGossipTransport

    cfg, _ = seeder
    dcn_port, other = chip_smoke.free_port(), chip_smoke.free_port()
    env = {k: v for k, v in os.environ.items() if k != "ZEST_FAULTS"}
    env.update(HF_HOME=str(cfg.hf_home), ZEST_CACHE_DIR=str(cfg.cache_dir),
               ZEST_COOP_INDEX="0", ZEST_COOP_HOSTS="2",
               ZEST_GOSSIP_INTERVAL_S="0.2",
               ZEST_COOP_ADDRS=f"0=127.0.0.1:{dcn_port},1=127.0.0.1:{other}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "zest_tpu_torch", "serve", "--listen-port",
         "0", "--dcn-port", str(dcn_port), "--port", "0", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines = []
    try:
        while not any(ln.startswith("publisher endpoint") for ln in lines):
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
            lines.append(line.strip())
        keys = storage.list_cached_xorbs(cfg)
        assert f"indexed {len(keys)} cached xorbs" in lines
        assert "gossip: fanout 1 over 2 peers, every 0.2s" in lines
        bt_port = int(next(ln for ln in lines if "(BT wire" in ln)
                      .split(":")[1].split()[0])
        url = lines[-1].rsplit(" ", 1)[-1]
        body = json.dumps({"repo": REPO, "revision": "r1", "xorbs": [
            [k, 1] for k in keys]}).encode()
        urllib.request.urlopen(urllib.request.Request(
            f"{url}/v1/push", data=body), timeout=10).read()
        status = json.loads(urllib.request.urlopen(f"{url}/v1/status",
                                                   timeout=10).read())
        assert status["swarm"]["gossip"]["announces"] == len(keys)
        assert status["xorbs_cached"] == len(keys)
        node = GossipNode(1, 2, {0: ("127.0.0.1", dcn_port)})
        pool = DcnPool()
        try:
            node.tick(DcnGossipTransport(pool, {0: ("127.0.0.1", dcn_port)}))
        finally:
            pool.close()
        for k in keys:
            ih = compute_info_hash(hashing.hex_to_hash(k))
            assert node.find_peers(ih) == [("127.0.0.1", bt_port)]
        time.sleep(0.5)  # the daemon's own ticks fail on a dead peer
        assert proc.poll() is None
    finally:
        proc.terminate()
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    assert "seeder stats: " in out


def test_cli_pull_through_a_tracker(hub, seeder, tracker, tmp_path,
                                    monkeypatch, capsys):
    leech = _cfg(hub, tmp_path / "leech")
    for k, v in {"HF_HOME": leech.hf_home, "ZEST_CACHE_DIR": leech.cache_dir,
                 "HF_ENDPOINT": hub.url, "HF_TOKEN": "hf_test",
                 "ZEST_LISTEN_PORT": "0"}.items():
        monkeypatch.setenv(k, str(v))
    capsys.readouterr()
    assert cli.main(["pull", REPO, "--device", "cpu", "--tracker",
                     tracker.url, "--no-dht"]) == 0
    out = capsys.readouterr().out
    assert "From CDN:   0 bytes" in out and "P2P ratio:  100.0%" in out
    snap = leech.model_snapshot_dir(REPO, hub.repos[REPO].commit_sha)
    for name, want in FILES.items():
        assert (snap / name).read_bytes() == want


# ── The parallel rung ──


class _Bridge:
    """``fetch_term`` for a plan of ``n`` terms: term ``bad`` raises at
    once, the others wait for ``release`` (so the error lands first)."""

    def __init__(self, n, bad):
        from zest_tpu_torch.cas import reconstruction as recon

        self.cfg = Config(hf_home=Path("."), cache_dir=Path("."),
                          max_concurrent_downloads=2)
        self.terms = [recon.Term(bytes([i]) * 32, recon.ChunkRange(0, 1), 4)
                      for i in range(n)]
        self.rec = recon.Reconstruction(bytes(32), self.terms)
        self.bad = bad
        self.release = threading.Event()
        self.calls = 0
        self.lock = threading.Lock()

    def fetch_term(self, term, rec):
        with self.lock:
            self.calls += 1
        i = self.terms.index(term)
        if i == self.bad:
            raise ConnectionError(f"term {i} refused")
        self.release.wait(5)
        return bytes([i]) * 4


def test_parallel_first_error_cancels_the_rest(tmp_path):
    bridge = _Bridge(40, bad=1)
    par = ParallelDownloader(bridge)  # 2 workers
    threading.Timer(0.5, bridge.release.set).start()
    with pytest.raises(ConnectionError, match="term 1 refused"):
        par.write_plan_to_temp(bridge.rec, tmp_path / "f.bin")
    assert bridge.calls < 40  # queued terms were cancelled
    assert list(tmp_path.iterdir()) == []  # no temp file left
    ok = _Bridge(5, bad=-1)
    ok.release.set()
    assert ParallelDownloader(ok).reconstruct_plan_to_file(
        ok.rec, tmp_path / "g.bin") == 20
    assert (tmp_path / "g.bin").read_bytes() == b"".join(
        bytes([i]) * 4 for i in range(5))
    assert [p.name for p in tmp_path.iterdir()] == ["g.bin"]


def test_parallel_rung_error_falls_to_the_sequential_rung(hub, tmp_path,
                                                          monkeypatch):
    """One term fails in the parallel rung only (``fetch_term``; the
    sequential rung decodes through ``_term_into``): the pull logs the
    reference's line, writes the file through the sequential rung, takes
    no plain-download fallback, and the files are exact."""
    real = bridge_mod.XetBridge.fetch_term
    failed = []

    def flaky(self, term, rec):
        if not failed:
            failed.append(term)
            raise ConnectionError("injected term failure")
        return real(self, term, rec)

    monkeypatch.setattr(bridge_mod.XetBridge, "fetch_term", flaky)
    logs = []
    cfg = _cfg(hub, tmp_path / "n")
    with chip_smoke.RungLog() as rungs:
        res = pull_model(cfg, REPO, device="cpu", land=False, no_p2p=True,
                         log=lambda *a, **k: logs.append(" ".join(a)))
    assert failed and len(logs) == 1
    assert logs[0].startswith("parallel fetch of model.safetensors failed "
                              "(injected term failure); retrying "
                              "sequentially")
    assert sorted(rungs.rows) == [("plain", "config.json"),
                                  ("sequential", "model.safetensors")]
    assert res.stats["fallback_files"] == 0
    for name, want in FILES.items():
        assert (res.snapshot_dir / name).read_bytes() == want
    leftovers = [p.name for p in res.snapshot_dir.iterdir()
                 if p.name.startswith(".tmp-")]
    assert leftovers == []


def test_parallel_rung_commits_at_the_pipeline_barrier(hub, tmp_path,
                                                       monkeypatch):
    """The port's divergence from the JAX package's rung, which renames
    its own temp file: the file the ``ParallelDownloader`` wrote is not
    under its name until the pipeline's commit barrier renames it, with
    every other deferred file."""
    from zest_tpu_torch.transfer import pull as pull_mod

    real = pull_mod._FilePipeline._commit_barrier
    seen = []

    def barrier(self):
        with self._lock:
            pending = [(Path(tmp).name, dest) for tmp, dest in
                       self._pending_commits]
        seen.append([(t, d.name, d.exists()) for t, d in pending])
        return real(self)

    monkeypatch.setattr(pull_mod._FilePipeline, "_commit_barrier", barrier)
    cfg = _cfg(hub, tmp_path / "n")
    res = pull_model(cfg, REPO, device="cpu", land=False, no_p2p=True,
                     log=_quiet)
    [pending] = seen
    assert [(d, exists) for t, d, exists in pending] == [
        ("model.safetensors", False)]
    assert pending[0][0].startswith(".tmp-model.safetensors.")
    assert (res.snapshot_dir / "model.safetensors").read_bytes() == \
        FILES["model.safetensors"]
