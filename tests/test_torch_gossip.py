"""The port's gossip plane against the JAX package's.

Mirrors tests/test_gossip.py's cases on ``zest_tpu_torch.transfer.gossip``
(digest CRDT semantics, O(log N) anti-entropy convergence, bounded
eviction, partition healing, link costs, the DCN piggyback, the
``ZEST_GOSSIP=0`` wiring gate), then holds the port to the JAX package:
every round's request and response payloads on a ``LoopbackMesh`` of N
seeded nodes byte-equal (N in {2, 8, 64}), the gossip exchange over the
real DCN wire in both directions across packages, a server with no node
attached answering ``GossipUnavailable`` on both sides without dropping
the connection, and the knobs' strict parsing.
"""

from __future__ import annotations

import json
import math

import pytest

from zest_tpu.config import Config as JConfig
from zest_tpu.transfer import dcn as j_dcn
from zest_tpu.transfer import gossip as j_gossip
from zest_tpu_torch import cli
from zest_tpu_torch.config import Config
from zest_tpu_torch.transfer import dcn
from zest_tpu_torch.transfer import gossip as gossip_mod
from zest_tpu_torch.transfer.gossip import (
    COST_DCN,
    COST_ICI,
    COST_WAN,
    KIND_MANIFEST,
    KIND_SEEDER,
    KIND_XORB,
    MAX_DELTA_ENTRIES,
    DcnGossipTransport,
    GossipDigest,
    GossipNode,
    LoopbackMesh,
    link_cost,
    node_from_config,
)


def _xh(i: int) -> bytes:
    return i.to_bytes(2, "big") * 16


def _fleet(n: int, mod=None, mesh=None, **kw):
    mod = mod or gossip_mod
    mesh = mesh if mesh is not None else mod.LoopbackMesh()
    book = {i: (f"host{i}", 7000 + i) for i in range(n)}
    nodes = [mod.GossipNode(i, n, book, **kw) for i in range(n)]
    for node in nodes:
        mesh.register(node)
    return mesh, nodes


def _sweep(mesh, nodes) -> None:
    for node in nodes:
        node.tick(mesh)


# ── Convergence ──


@pytest.mark.parametrize("n", [16, 64, 256])
def test_all_to_all_convergence_within_log_rounds(n):
    mesh, nodes = _fleet(n)
    for i, node in enumerate(nodes):
        node.announce(_xh(i), 7000 + i)
    bound = 2 * math.ceil(math.log2(n))
    rounds = 0
    while rounds < bound:
        rounds += 1
        _sweep(mesh, nodes)
        if all(len(node.digest) == n for node in nodes):
            break
    assert all(len(node.digest) == n for node in nodes)
    assert rounds <= bound
    assert nodes[0].fanout() == math.ceil(math.log2(n))


def test_single_rumor_reaches_everyone(n=64):
    mesh, nodes = _fleet(n)
    nodes[17].announce(_xh(17), 7017)
    for _ in range(math.ceil(math.log2(n))):
        _sweep(mesh, nodes)
    assert all(len(node.digest.holders(KIND_XORB, _xh(17).hex())) == 1
               for node in nodes)
    assert nodes[0].find_peers(_xh(17)) == [("host17", 7017)]
    assert nodes[17].find_peers(_xh(17)) == []


def test_reannounce_bumps_sequence_and_wins():
    mesh, nodes = _fleet(4)
    nodes[1].announce(_xh(1), 7001)
    for _ in range(3):
        _sweep(mesh, nodes)
    nodes[1].announce(_xh(1), 9999)  # moved listen port
    for _ in range(3):
        _sweep(mesh, nodes)
    for node in nodes:
        assert node.digest.holders(KIND_XORB, _xh(1).hex())[1]["port"] == 9999


# ── Bounded digest / eviction ──


def test_eviction_keeps_bound_and_prefers_foreign():
    d = GossipDigest(max_entries=8, own_origin=0)
    for s in range(4):
        d.update(KIND_XORB, f"own{s}", 0, s + 1, {"port": 1})
    for o in range(1, 101):
        d.update(KIND_XORB, f"f{o}", o, 1, {"port": 1})
    assert len(d) == 8
    assert d.evicted == 96
    assert len([ident for ident in d._entries if ident[2] == 0]) == 4


def test_version_vector_survives_eviction():
    d = GossipDigest(max_entries=2)
    d.update(KIND_XORB, "a", 1, 5, {"port": 1})
    d.update(KIND_XORB, "b", 2, 5, {"port": 1})
    d.update(KIND_XORB, "c", 3, 5, {"port": 1})  # evicts one
    assert len(d) == 2 and d.evicted == 1
    evicted = next(k for k in "abc" if not d.holders(KIND_XORB, k))
    origin = {"a": 1, "b": 2, "c": 3}[evicted]
    assert not d.update(KIND_XORB, evicted, origin, 5, {"port": 1})
    assert d.update(KIND_XORB, evicted, origin, 6, {"port": 2})


def test_digest_memory_bound_at_1024_hosts():
    """The JAX package's case at 1024 hosts with 8 announces each against
    a 512-entry bound (its 64 against 4096 re-sorts the digest on each of
    61,440 evictions: 78 s here)."""
    d = GossipDigest(max_entries=512)
    for origin in range(1024):
        for s in range(8):
            d.update(KIND_XORB, _xh(origin * 8 + s).hex(), origin,
                     s + 1, {"port": 7000 + origin})
    assert len(d) <= 512
    assert d.evicted == 1024 * 8 - 512
    assert d.memory_bytes() <= 512 * (64 + len("xorb") + 64 + 32)
    assert len(d.vv) == 1024


def test_delta_is_capped():
    d = GossipDigest()
    for s in range(MAX_DELTA_ENTRIES + 100):
        d.update(KIND_XORB, f"k{s}", 0, s + 1, {"port": 1})
    rows = d.delta_since({})
    assert len(rows) == MAX_DELTA_ENTRIES
    seqs = [r[3] for r in rows]
    assert seqs == sorted(seqs) and seqs[0] == 1


# ── Partition then heal ──


class _PartitionedMesh(LoopbackMesh):
    def __init__(self, split: int):
        super().__init__()
        self.split = split
        self.healed = False

    def exchange(self, peer, payload):
        if not self.healed:
            sender = payload.get("host", 0)
            if (sender < self.split) != (peer < self.split):
                return None
        return super().exchange(peer, payload)


def test_partition_then_heal_reconverges():
    n, split = 32, 16
    mesh, nodes = _fleet(n, mesh=_PartitionedMesh(split))
    nodes[2].announce(_xh(2), 7002)
    nodes[20].announce(_xh(20), 7020)
    for _ in range(8):
        _sweep(mesh, nodes)
    assert all(nodes[i].digest.holders(KIND_XORB, _xh(2).hex())
               for i in range(split))
    assert not any(nodes[i].digest.holders(KIND_XORB, _xh(2).hex())
                   for i in range(split, n))
    assert not any(nodes[i].digest.holders(KIND_XORB, _xh(20).hex())
                   for i in range(split))
    mesh.healed = True
    for _ in range(2 * math.ceil(math.log2(n))):
        _sweep(mesh, nodes)
    for node in nodes:
        assert node.digest.holders(KIND_XORB, _xh(2).hex())
        assert node.digest.holders(KIND_XORB, _xh(20).hex())


# ── Link costs, nearest first ──


def test_link_cost_table():
    topo, pods = (0, 0, 1, 1), (0, 0, 0, 1)
    assert link_cost(0, 1, topo, pods) == COST_ICI
    assert link_cost(0, 2, topo, pods) == COST_DCN
    assert link_cost(2, 3, topo, pods) == COST_WAN
    assert link_cost(0, 1, None, None) == COST_DCN
    assert link_cost(0, 1, topo, None) == COST_ICI
    for a in range(4):
        for b in range(4):
            assert link_cost(a, b, topo, pods) == \
                j_gossip.link_cost(a, b, topo, pods)


def test_find_peers_orders_by_link_cost():
    topo = (0, 0, 1, 1, 0, 0, 1, 1)
    pods = (0, 0, 0, 0, 1, 1, 1, 1)
    mesh, nodes = _fleet(8, topology=topo, pods=pods)
    for holder in (6, 2, 1):
        nodes[holder].announce(_xh(42), 7000 + holder)
    for _ in range(6):
        _sweep(mesh, nodes)
    assert nodes[0].who_has(_xh(42)) == [1, 2, 6]
    assert nodes[0].find_peers(_xh(42)) == [
        ("host1", 7001), ("host2", 7002), ("host6", 7006)]
    assert nodes[7].who_has(_xh(42)) == [6, 1, 2]


def test_seeder_state_spreads():
    mesh, nodes = _fleet(4)
    nodes[3].set_seeder_state("draining", until=123)
    for _ in range(3):
        _sweep(mesh, nodes)
    st = nodes[0].digest.holders(KIND_SEEDER, "3")
    assert st[3]["state"] == "draining" and st[3]["until"] == 123


# ── Payload parity with the JAX package ──


def _recording(mod):
    class Recording(mod.LoopbackMesh):
        def __init__(self):
            super().__init__()
            self.log = []

        def exchange(self, peer, payload):
            resp = super().exchange(peer, payload)
            self.log.append(json.dumps([peer, payload, resp],
                                       separators=(",", ":")))
            return resp
    return Recording()


@pytest.mark.parametrize("n", [2, 8, 64])
def test_round_payloads_equal_reference(n):
    """The same announcements, seeder states, manifests and re-announces
    on N nodes of each package: every exchange's request and response,
    in order, byte for byte (the seeded per-host peer sampling included),
    and the final digests and summaries."""
    fleets = []
    for mod in (gossip_mod, j_gossip):
        mesh, nodes = _fleet(n, mod=mod, mesh=_recording(mod),
                             max_entries=max(4, 3 * n // 2))
        for i, node in enumerate(nodes):
            node.announce(_xh(i), 7000 + i)
        rounds = 2 * math.ceil(math.log2(max(n, 2)))
        for r in range(rounds):
            if r == 1:
                nodes[-1].set_seeder_state("draining", until=r)
                nodes[0].announce_manifest("acme/m@abc", {"repo": "acme/m"})
            if r == 2:
                nodes[n // 2].announce(_xh(n // 2), 9000)
            _sweep(mesh, nodes)
        fleets.append((mesh, nodes))
    (mine, my_nodes), (theirs, their_nodes) = fleets
    assert mine.log == theirs.log and len(mine.log) > 0
    assert mine.exchanges == theirs.exchanges
    for a, b in zip(my_nodes, their_nodes):
        assert a.summary() == b.summary()
        assert a.digest.snapshot_vv() == b.digest.snapshot_vv()
        assert a.digest.delta_since({}, cap=10 ** 6) == \
            b.digest.delta_since({}, cap=10 ** 6)
        assert a.who_has(_xh(0)) == b.who_has(_xh(0))
        assert a.digest.holders(KIND_MANIFEST, "acme/m@abc") == \
            b.digest.holders(KIND_MANIFEST, "acme/m@abc")


# ── The DCN piggyback ──


def _cfgs(tmp_path):
    return (Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                   dcn_port=0),
            JConfig(hf_home=tmp_path / "jhf", cache_dir=tmp_path / "jzest",
                    dcn_port=0))


def test_gossip_over_real_dcn_wire(tmp_path):
    cfg, _ = _cfgs(tmp_path)
    server_node = GossipNode(1, 2, {})
    server_node.announce(_xh(9), 7555)
    srv = dcn.DcnServer(cfg)
    srv.attach_gossip(server_node)
    port = srv.start()
    pool = dcn.DcnPool()
    try:
        client = GossipNode(0, 2, {1: ("127.0.0.1", port)})
        transport = DcnGossipTransport(pool, {1: ("127.0.0.1", port)})
        assert client.tick(transport) == 1
        assert client.find_peers(_xh(9)) == [("127.0.0.1", 7555)]
        client.announce(_xh(10), 7010)
        client.tick(transport)
        assert server_node.digest.holders(KIND_XORB, _xh(10).hex())
    finally:
        pool.close()
        srv.shutdown()


@pytest.mark.parametrize("server_side", ["reference", "port"])
def test_gossip_exchange_across_packages(tmp_path, server_side):
    """A port client against a JAX-package DcnServer with a node attached,
    and the reverse: the codec, the reply and both digests agree."""
    cfg, jcfg = _cfgs(tmp_path)
    if server_side == "reference":
        srv_node = j_gossip.GossipNode(1, 2, {})
        srv = j_dcn.DcnServer(jcfg)
        cli_mod, pool = GossipNode, dcn.DcnPool()
        transport_cls = DcnGossipTransport
    else:
        srv_node = GossipNode(1, 2, {})
        srv = dcn.DcnServer(cfg)
        cli_mod, pool = j_gossip.GossipNode, j_dcn.DcnPool()
        transport_cls = j_gossip.DcnGossipTransport
    srv_node.announce(_xh(3), 7303)
    srv_node.announce_manifest("acme/m@r1", {"repo": "acme/m"})
    srv.attach_gossip(srv_node)
    port = srv.start()
    try:
        book = {1: ("127.0.0.1", port)}
        client = cli_mod(0, 2, book)
        client.announce(_xh(4), 7404)
        transport = transport_cls(pool, book)
        assert client.tick(transport) == 2
        assert client.find_peers(_xh(3)) == [("127.0.0.1", 7303)]
        assert srv_node.digest.holders(KIND_XORB, _xh(4).hex()) == {
            0: {"port": 7404}}
        assert client.digest.snapshot_vv() == srv_node.digest.snapshot_vv()
        assert client.rounds == 1 and client.bytes_in > 0
    finally:
        pool.close()
        srv.shutdown()


@pytest.mark.parametrize("pair", ["port-port", "port-reference",
                                  "reference-port"])
def test_server_without_node_is_gossip_unavailable(tmp_path, pair):
    """No node attached: the server answers ERROR, which the client
    raises as GossipUnavailable, never a connection fault, and chunk RPCs
    on the same channel go on working."""
    cfg, jcfg = _cfgs(tmp_path)
    client_side, server_side = pair.split("-")
    srv = (dcn.DcnServer(cfg) if server_side == "port"
           else j_dcn.DcnServer(jcfg))
    cmod = dcn if client_side == "port" else j_dcn
    port = srv.start()
    pool = cmod.DcnPool()
    try:
        with pytest.raises(cmod.GossipUnavailable,
                           match="server accepts only REQUEST"):
            pool.gossip_exchange("127.0.0.1", port,
                                 {"host": 0, "vv": {}, "delta": []})
        [msg] = pool.request_many("127.0.0.1", port, [(b"\x07" * 32, 0, 1)])
        assert isinstance(msg, cmod.DcnNotFound)
        node = GossipNode(0, 2, {1: ("127.0.0.1", port)})
        transport = DcnGossipTransport(pool, {1: ("127.0.0.1", port)})
        assert node.tick(transport) == 0  # best-effort, no raise
        assert node.rounds == 1
    finally:
        pool.close()
        srv.shutdown()


def test_gossip_codec_bytes_equal_reference():
    payload = {"host": 3, "vv": {"3": 7, "0": 2},
               "delta": [["xorb", "ab" * 20, 3, 7, {"port": 6881}]]}
    for reply in (False, True):
        ours = dcn.encode_message(dcn.DcnGossip(41, payload, reply=reply))
        theirs = j_dcn.encode_message(
            j_dcn.DcnGossip(41, payload, reply=reply))
        assert ours == theirs
        back = dcn.decode_message(ours[:12], ours[12:])
        assert back == dcn.DcnGossip(41, payload, reply=reply)
    for body in (b"[1,2]", b"\xff\xfe", b"{not json"):
        header = dcn._HEADER.pack(dcn.MSG_GOSSIP, 0, 0, 1, len(body))
        with pytest.raises(dcn.DcnProtocolError):
            dcn.decode_message(header, body)
        with pytest.raises(j_dcn.DcnProtocolError):
            j_dcn.decode_message(header, body)


# ── The wiring gate ──


def test_node_from_config_gossip_off(tmp_path):
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    cfg.gossip_enabled = False
    assert node_from_config(cfg, 0, 4, None) is None


def test_node_from_config_carries_knobs(tmp_path):
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    cfg.coop_topology = (0, 0, 1, 1)
    cfg.coop_pods = (0, 0, 1, 1)
    cfg.gossip_fanout = 3
    cfg.gossip_max_entries = 128
    node = node_from_config(cfg, 2, 4, {i: ("h", 1) for i in range(4)})
    assert node is not None
    assert node.fanout() == 3
    assert node.digest.max_entries == 128
    assert node.cost_to(3) == COST_ICI
    assert node.cost_to(0) == COST_WAN


def test_swarm_announce_is_bootstrap_only_with_gossip(tmp_path):
    from zest_tpu_torch.p2p.peer_id import compute_info_hash
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    class RecordingSource:
        def __init__(self):
            self.announces = []

        def find_peers(self, info_hash):
            return []

        def announce(self, info_hash, port):
            self.announces.append(info_hash)

    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    xorb = _xh(5)
    tracker = RecordingSource()
    plain = SwarmDownloader(cfg, peer_sources=[tracker])
    for _ in range(3):
        plain.announce_available(xorb, xorb.hex())
    assert len(tracker.announces) == 3
    assert "gossip" not in plain.summary()
    plain.close()

    tracker = RecordingSource()
    node = GossipNode(0, 2, {})
    sw = SwarmDownloader(cfg, peer_sources=[tracker])
    sw.attach_gossip(node)
    assert sw.peer_sources[0] is node
    for _ in range(3):
        sw.announce_available(xorb, xorb.hex())
    assert len(tracker.announces) == 1
    assert node.digest.holders(KIND_XORB, compute_info_hash(xorb).hex())
    assert sw.summary()["gossip"]["entries"] == 1
    sw.close()


def _env(tmp_path, **extra):
    return {"HF_HOME": str(tmp_path / "hf"),
            "ZEST_CACHE_DIR": str(tmp_path / "zest"),
            "ZEST_COOP_INDEX": "0", "ZEST_COOP_HOSTS": "2",
            "ZEST_COOP_ADDRS": "0=127.0.0.1:1,1=127.0.0.1:2", **extra}


def test_gossip_off_keeps_the_swarm_stats_schema(tmp_path):
    """``ZEST_GOSSIP=0``: a coop identity builds no node, and the swarm's
    stats keys are those of a swarm built without one; on, the swarm
    gains exactly the ``gossip`` block, the JAX package's keys."""
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    bare = SwarmDownloader(Config(hf_home=tmp_path / "hf",
                                  cache_dir=tmp_path / "zest"))
    base_keys = set(bare.summary())
    bare.close()
    off = cli._build_swarm(Config.load(_env(tmp_path, ZEST_GOSSIP="0")),
                           dht=False)
    on = cli._build_swarm(Config.load(_env(tmp_path)), dht=False)
    try:
        assert off.gossip is None and off.peer_sources == []
        assert set(off.summary()) == base_keys
        assert on.peer_sources == [on.gossip]
        assert set(on.summary()) == base_keys | {"gossip"}
        ref = j_gossip.GossipNode(0, 2, {})
        assert set(on.summary()["gossip"]) == set(ref.summary())
        assert on.gossip.addr_book == {0: ("127.0.0.1", 1),
                                       1: ("127.0.0.1", 2)}
    finally:
        off.close()
        on.close()


@pytest.mark.parametrize("env", [
    {}, {"ZEST_GOSSIP": "0"}, {"ZEST_GOSSIP_FANOUT": "3"},
    {"ZEST_GOSSIP_MAX": "7", "ZEST_GOSSIP_INTERVAL_S": "0.25"},
    {"ZEST_GOSSIP": "off"}, {"ZEST_GOSSIP": "2"},
    {"ZEST_GOSSIP_FANOUT": "-1"}, {"ZEST_GOSSIP_MAX": "0"},
    {"ZEST_GOSSIP_INTERVAL_S": "0.01"}, {"ZEST_GOSSIP_INTERVAL_S": "nan"},
    {"ZEST_GOSSIP_FANOUT": "x"}])
def test_gossip_knobs_parse_as_reference(env):
    fields = ("gossip_enabled", "gossip_fanout", "gossip_max_entries",
              "gossip_interval_s")
    results = []
    for load in (Config.load, JConfig.load):
        try:
            cfg = load(dict(env))
        except ValueError as exc:
            results.append(("raise", type(exc).__name__, str(exc)))
        else:
            results.append(tuple(getattr(cfg, f) for f in fields))
    assert results[0] == results[1]
