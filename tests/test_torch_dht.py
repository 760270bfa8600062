"""The port's Kademlia DHT (BEP 5) against the JAX package's.

Mirrors tests/test_dht.py's twelve cases on ``zest_tpu_torch.p2p.dht``
(metric, LRU buckets, routing, KRPC and compact codecs, live two-node
loopback, the invalid-token drop), then holds the port to the JAX
package: KRPC queries and compact codecs byte-equal for one node id and
transaction id, and a port node and a JAX-package node pinging,
announcing to and looking up each other over loopback UDP. Every node
binds port 0 and names its bootstrap seeds: nothing leaves loopback.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from zest_tpu.p2p import dht as j_dht
from zest_tpu_torch.p2p import bencode
from zest_tpu_torch.p2p.dht import (
    Dht,
    DhtError,
    KBucket,
    Node,
    RoutingTable,
    bucket_index,
    build_announce_peer,
    build_find_node,
    build_get_peers,
    build_ping,
    encode_compact_nodes,
    encode_compact_peers,
    parse_compact_nodes,
    parse_compact_peers,
    xor_distance,
)


def _id(prefix: bytes) -> bytes:
    return prefix + bytes(20 - len(prefix))


# ── Metric (dht.zig:475-520) ──


def test_xor_distance_symmetry_and_identity():
    a, b = _id(b"\x01"), _id(b"\xff")
    assert xor_distance(a, a) == bytes(20)
    assert xor_distance(a, b) == xor_distance(b, a)


def test_bucket_index_msb_rule():
    assert bucket_index(bytes(20)) == -1
    assert bucket_index(_id(b"\x80")) == 0
    assert bucket_index(_id(b"\x01")) == 7
    assert bucket_index(b"\x00" + _id(b"\x80")[:-1]) == 8
    assert bucket_index(bytes(19) + b"\x01") == 159


def test_kbucket_lru_eviction_keeps_responsive_nodes():
    b = KBucket(k=2)
    n1, n2, n3 = (Node(_id(bytes([i])), ("127.0.0.1", i)) for i in (1, 2, 3))
    b.update(n1)
    b.update(n2)
    b.update(n1)          # refresh n1: n2 becomes LRU
    b.update(n3)          # full: evict n2
    ids = [n.node_id for n in b.nodes]
    assert n1.node_id in ids and n3.node_id in ids
    assert n2.node_id not in ids


def test_routing_table_closest_sorted_by_xor():
    table = RoutingTable(_id(b"\x00"))
    for i in range(1, 30):
        table.update(_id(bytes([i])), ("127.0.0.1", i))
    target = _id(b"\x05")
    closest = table.closest(target, 4)
    dists = [xor_distance(n.node_id, target) for n in closest]
    assert dists == sorted(dists)
    assert closest[0].node_id == _id(b"\x05")


def test_routing_table_never_inserts_self():
    me = _id(b"\xaa")
    table = RoutingTable(me)
    table.update(me, ("127.0.0.1", 1))
    assert len(table) == 0


# ── KRPC codecs (dht.zig:578-671) ──


def test_krpc_queries_are_valid_bencode():
    sid, ih, tid = _id(b"s"), _id(b"i"), b"\x00\x01"
    for raw in (build_ping(sid, tid), build_find_node(sid, ih, tid),
                build_get_peers(sid, ih, tid),
                build_announce_peer(sid, ih, 6881, b"tok", tid)):
        doc = bencode.decode(raw)
        assert doc[b"t"] == tid and doc[b"y"] == b"q"
        assert bencode.dict_get_dict(doc, b"a")[b"id"] == sid


def test_compact_node_roundtrip():
    nodes = [Node(_id(b"\x01"), ("10.0.0.1", 6881)),
             Node(_id(b"\x02"), ("192.168.1.9", 51413))]
    raw = encode_compact_nodes(nodes)
    assert len(raw) == 52
    assert parse_compact_nodes(raw) == [(n.node_id, n.addr) for n in nodes]


def test_compact_peer_roundtrip_and_garbage_tolerance():
    peers = [("10.1.2.3", 6881), ("127.0.0.1", 80)]
    assert parse_compact_peers(encode_compact_peers(peers)) == peers
    assert parse_compact_peers([b"short", 42, b"x" * 7]) == []


def test_parse_compact_nodes_rejects_misaligned():
    with pytest.raises(DhtError):
        parse_compact_nodes(b"x" * 27)


# ── Live loopback ──


@pytest.fixture
def two_nodes():
    a = Dht(bind=("127.0.0.1", 0), request_timeout=2.0)
    b = Dht(bind=("127.0.0.1", 0), request_timeout=2.0)
    yield a, b
    a.close()
    b.close()


def test_ping_updates_routing_tables(two_nodes):
    a, b = two_nodes
    assert a.ping(("127.0.0.1", b.port))
    assert len(a.table) == 1       # from b's response
    assert len(b.table) == 1       # from a's query


def test_announce_and_get_peers_roundtrip(two_nodes):
    a, b = two_nodes
    a.bootstrap([("127.0.0.1", b.port)])
    info_hash = _id(b"\xfe")
    assert a.announce_peer(info_hash, 7001) == 1
    assert ("127.0.0.1", 7001) in list(b.peer_store[info_hash])
    c = Dht(bind=("127.0.0.1", 0), request_timeout=2.0)
    try:
        c.bootstrap([("127.0.0.1", b.port)])
        assert ("127.0.0.1", 7001) in c.find_peers(info_hash)
    finally:
        c.close()


def test_announce_with_invalid_token_is_dropped(two_nodes):
    a, b = two_nodes
    info_hash = _id(b"\xee")
    resp = a._request(
        lambda tid: build_announce_peer(a.node_id, info_hash, 7002,
                                        b"badtoken", tid),
        ("127.0.0.1", b.port))
    assert resp is None            # silently dropped
    assert info_hash not in b.peer_store


# ── Held to the JAX package ──


def test_krpc_queries_byte_equal_to_reference():
    rng = np.random.default_rng(5)
    sid, ih, tok = rng.bytes(20), rng.bytes(20), rng.bytes(8)
    tid = b"\x12\x34"
    assert build_ping(sid, tid) == j_dht.build_ping(sid, tid)
    assert build_find_node(sid, ih, tid) == j_dht.build_find_node(
        sid, ih, tid)
    assert build_get_peers(sid, ih, tid) == j_dht.build_get_peers(
        sid, ih, tid)
    assert build_announce_peer(sid, ih, 51413, tok, tid) == \
        j_dht.build_announce_peer(sid, ih, 51413, tok, tid)


def test_codecs_and_metric_equal_to_reference():
    rng = np.random.default_rng(6)
    addrs = [(".".join(str(int(b)) for b in rng.integers(0, 256, 4)),
              int(rng.integers(0, 65536))) for _ in range(12)]
    addrs.append(("::1", 1))  # not representable in BEP 5: skipped
    ids = [rng.bytes(20) for _ in addrs]
    ours = encode_compact_nodes([Node(i, a) for i, a in zip(ids, addrs)])
    theirs = j_dht.encode_compact_nodes(
        [j_dht.Node(i, a) for i, a in zip(ids, addrs)])
    assert ours == theirs
    assert parse_compact_nodes(ours) == j_dht.parse_compact_nodes(theirs)
    assert encode_compact_peers(addrs) == j_dht.encode_compact_peers(addrs)
    garbage = [rng.bytes(int(n)) for n in rng.integers(0, 12, 20)] + [7]
    assert parse_compact_peers(garbage) == j_dht.parse_compact_peers(garbage)
    for _ in range(50):
        a, b = rng.bytes(20), rng.bytes(20)
        assert bucket_index(xor_distance(a, b)) == \
            j_dht.bucket_index(j_dht.xor_distance(a, b))
    target = rng.bytes(20)
    mine, ref = RoutingTable(ids[0]), j_dht.RoutingTable(ids[0])
    for i, a in zip(ids, addrs):
        mine.update(i, a)
        ref.update(i, a)
    assert [n.node_id for n in mine.closest(target)] == \
        [n.node_id for n in ref.closest(target)]


@pytest.fixture
def mixed():
    port = Dht(bind=("127.0.0.1", 0), request_timeout=2.0)
    ref = j_dht.Dht(bind=("127.0.0.1", 0), request_timeout=2.0)
    yield port, ref
    port.close()
    ref.close()


def test_port_and_reference_nodes_ping_each_other(mixed):
    port, ref = mixed
    assert port.ping(("127.0.0.1", ref.port))
    assert ref.ping(("127.0.0.1", port.port))
    assert [n.node_id for n in port.table.closest(ref.node_id)] == \
        [ref.node_id]
    assert [n.node_id for n in ref.table.closest(port.node_id)] == \
        [port.node_id]


@pytest.mark.parametrize("announcer", ["port", "reference"])
def test_announce_and_lookup_across_packages(mixed, announcer):
    """Either package's node announces to the other (with the token its
    get_peers returned) and a third node of the announcer's package finds
    the peer through the store of the other's."""
    port, ref = mixed
    a, b = (port, ref) if announcer == "port" else (ref, port)
    a.bootstrap([("127.0.0.1", b.port)])
    info_hash = _id(bytes([0xA0, len(announcer)]))
    assert a.announce_peer(info_hash, 7100) == 1
    assert ("127.0.0.1", 7100) in b.peer_store[info_hash]
    third = (Dht if announcer == "port" else j_dht.Dht)(
        bind=("127.0.0.1", 0), request_timeout=2.0)
    try:
        third.bootstrap([("127.0.0.1", b.port)])
        assert third.find_peers(info_hash) == [("127.0.0.1", 7100)]
    finally:
        third.close()


def test_reference_announce_with_a_bad_token_is_dropped_by_the_port(mixed):
    port, ref = mixed
    info_hash = _id(b"\xed")
    resp = ref._request(
        lambda tid: j_dht.build_announce_peer(ref.node_id, info_hash, 7003,
                                              b"forged!!", tid),
        ("127.0.0.1", port.port))
    assert resp is None
    assert info_hash not in port.peer_store


def test_close_joins_the_receive_thread_and_closes_the_socket():
    node = Dht(bind=("127.0.0.1", 0))
    thread = node._thread
    node.close()
    assert not thread.is_alive()
    assert node.sock.fileno() == -1
    node.close()  # idempotent
    assert not any(t is thread for t in threading.enumerate())
