"""Kademlia DHT (BEP 5) — WAN peer discovery (reference: src/dht.zig).

The port's copy of ``zest_tpu/p2p/dht.py``. XOR metric over 160-bit node
IDs, K=8 buckets, KRPC (bencoded dicts over UDP) with ping / find_node /
get_peers / announce_peer, compact node (26 B) and peer (6 B) codecs,
iterative lookup.

Deliberate fixes of reference quirks, as in the JAX package: announce
uses the token returned by get_peers, not a static string
(dht.zig:453-454); k-buckets evict the least-recently-seen entry instead
of always dropping newcomers (dht.zig:81-97). Each node also *serves*
KRPC queries, so two zest nodes can find each other with no external
router. :meth:`Dht.bootstrap` with no seeds asks ``BOOTSTRAP_NODES`` on
the public internet; pass explicit seeds where there is no network.
:meth:`Dht.close` closes the socket and joins the receive thread.
"""

from __future__ import annotations

import os
import secrets
import socket
import struct
import threading
import time
from dataclasses import dataclass, field

from zest_tpu_torch.cas import hashing
from zest_tpu_torch.p2p import bencode

NODE_ID_LEN = 20
K = 8
NUM_BUCKETS = NODE_ID_LEN * 8
ALPHA = 3
COMPACT_NODE_LEN = 26  # 20B id + 4B ip + 2B port
COMPACT_PEER_LEN = 6
# peer_store bounds: this responder runs on a public UDP port, so storage
# must be capped and announcements must expire or an adversary (or a busy
# swarm) grows a seeder's memory without bound.
PEER_TTL_S = 30 * 60
MAX_PEERS_PER_HASH = 64
MAX_STORED_HASHES = 4096

BOOTSTRAP_NODES = [
    ("router.bittorrent.com", 6881),
    ("dht.transmissionbt.com", 6881),
]


class DhtError(RuntimeError):
    pass


# ── Metric + routing table (pure logic, dht.zig:41-166) ──


def xor_distance(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def bucket_index(distance: bytes) -> int:
    """Index of the highest set bit: 0 for the farthest half of the space,
    159 adjacent; -1 for self (zero distance)."""
    for i, byte in enumerate(distance):
        if byte:
            return i * 8 + (7 - byte.bit_length() + 1)
    return -1


@dataclass
class Node:
    node_id: bytes
    addr: tuple[str, int]
    last_seen: float = field(default_factory=time.monotonic)


class KBucket:
    def __init__(self, k: int = K):
        self.k = k
        self.nodes: list[Node] = []  # oldest-seen first

    def update(self, node: Node) -> None:
        for i, n in enumerate(self.nodes):
            if n.node_id == node.node_id:
                n.addr = node.addr
                n.last_seen = time.monotonic()
                self.nodes.append(self.nodes.pop(i))
                return
        if len(self.nodes) < self.k:
            self.nodes.append(node)
        else:
            # LRU eviction: the head is least recently seen.
            self.nodes.pop(0)
            self.nodes.append(node)


class RoutingTable:
    def __init__(self, self_id: bytes, k: int = K):
        self.self_id = self_id
        self.k = k
        self.buckets = [KBucket(k) for _ in range(NUM_BUCKETS)]

    def update(self, node_id: bytes, addr: tuple[str, int]) -> None:
        idx = bucket_index(xor_distance(self.self_id, node_id))
        if idx < 0:
            return  # never insert ourselves
        self.buckets[idx].update(Node(node_id, addr))

    def closest(self, target: bytes, count: int | None = None) -> list[Node]:
        count = count or self.k
        everyone = [n for b in self.buckets for n in b.nodes]
        everyone.sort(key=lambda n: xor_distance(n.node_id, target))
        return everyone[:count]

    def __len__(self) -> int:
        return sum(len(b.nodes) for b in self.buckets)


# ── KRPC codecs (dht.zig:171-299) ──


def build_ping(self_id: bytes, tid: bytes) -> bytes:
    return bencode.encode(
        {b"t": tid, b"y": b"q", b"q": b"ping", b"a": {b"id": self_id}}
    )


def build_find_node(self_id: bytes, target: bytes, tid: bytes) -> bytes:
    return bencode.encode({
        b"t": tid, b"y": b"q", b"q": b"find_node",
        b"a": {b"id": self_id, b"target": target},
    })


def build_get_peers(self_id: bytes, info_hash: bytes, tid: bytes) -> bytes:
    return bencode.encode({
        b"t": tid, b"y": b"q", b"q": b"get_peers",
        b"a": {b"id": self_id, b"info_hash": info_hash},
    })


def build_announce_peer(
    self_id: bytes, info_hash: bytes, port: int, token: bytes, tid: bytes
) -> bytes:
    return bencode.encode({
        b"t": tid, b"y": b"q", b"q": b"announce_peer",
        b"a": {b"id": self_id, b"info_hash": info_hash,
               b"port": port, b"token": token},
    })


def encode_compact_nodes(nodes: list[Node]) -> bytes:
    out = bytearray()
    for n in nodes:
        try:
            ip = socket.inet_aton(n.addr[0])
        except OSError:
            continue  # non-IPv4 addresses are not representable in BEP 5
        out += n.node_id + ip + struct.pack(">H", n.addr[1])
    return bytes(out)


def parse_compact_nodes(raw: bytes) -> list[tuple[bytes, tuple[str, int]]]:
    if len(raw) % COMPACT_NODE_LEN:
        raise DhtError(f"compact nodes length {len(raw)} not 26-aligned")
    out = []
    for off in range(0, len(raw), COMPACT_NODE_LEN):
        node_id = raw[off : off + 20]
        ip = socket.inet_ntoa(raw[off + 20 : off + 24])
        (port,) = struct.unpack_from(">H", raw, off + 24)
        out.append((node_id, (ip, port)))
    return out


def encode_compact_peers(peers: list[tuple[str, int]]) -> list[bytes]:
    out = []
    for ip, port in peers:
        try:
            out.append(socket.inet_aton(ip) + struct.pack(">H", port))
        except OSError:
            continue
    return out


def parse_compact_peers(values: list) -> list[tuple[str, int]]:
    peers = []
    for raw in values:
        if not isinstance(raw, bytes) or len(raw) != COMPACT_PEER_LEN:
            continue
        peers.append(
            (socket.inet_ntoa(raw[:4]), struct.unpack(">H", raw[4:])[0])
        )
    return peers


# ── Node (socket + responder + iterative client) ──


class Dht:
    """One DHT node: client *and* server on a single UDP socket.

    A background responder thread answers queries and routes responses to
    waiting calls by transaction ID; ``get_peers``/``announce_peer`` do
    iterative lookups from the routing table. All public methods are
    thread-safe.
    """

    def __init__(
        self,
        bind: tuple[str, int] = ("0.0.0.0", 0),
        node_id: bytes | None = None,
        request_timeout: float = 2.0,
    ):
        self.node_id = node_id or os.urandom(NODE_ID_LEN)
        self.table = RoutingTable(self.node_id)
        self.request_timeout = request_timeout
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(bind)
        self.sock.settimeout(0.25)
        self.port = self.sock.getsockname()[1]
        # info_hash -> {(ip, port): announced_at}
        self.peer_store: dict[bytes, dict[tuple[str, int], float]] = {}
        self._token_secret = secrets.token_bytes(16)
        self._pending: dict[bytes, tuple[threading.Event, list]] = {}
        self._tid_counter = 0
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()

    # ── Lifecycle ──

    def close(self) -> None:
        """Stop the receive thread (it polls the flag every 0.25 s), then
        close the socket. Idempotent."""
        self._shutdown.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=2)
        self.sock.close()

    # ── Tokens (real tokens, unlike dht.zig:453-454) ──

    def make_token(self, addr: tuple[str, int]) -> bytes:
        return hashing.blake3_keyed(
            self._token_secret + bytes(16),
            addr[0].encode() + struct.pack(">H", addr[1]),
        )[:8]

    def valid_token(self, addr: tuple[str, int], token: bytes) -> bool:
        return secrets.compare_digest(self.make_token(addr), token)

    # ── Wire I/O ──

    def _next_tid(self) -> bytes:
        with self._lock:
            self._tid_counter = (self._tid_counter + 1) % 0xFFFF
            return struct.pack(">H", self._tid_counter)

    def _request(
        self, payload_fn, addr: tuple[str, int]
    ) -> dict | None:
        """Send one KRPC query, wait for its response (matched by tid)."""
        tid = self._next_tid()
        event: tuple[threading.Event, list] = (threading.Event(), [])
        with self._lock:
            self._pending[tid] = event
        try:
            self.sock.sendto(payload_fn(tid), addr)
        except OSError:
            with self._lock:
                self._pending.pop(tid, None)
            return None
        if not event[0].wait(self.request_timeout):
            with self._lock:
                self._pending.pop(tid, None)
            return None
        return event[1][0] if event[1] else None

    def _recv_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                data, addr = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                msg = bencode.decode(data)
            except bencode.BencodeError:
                continue
            if not isinstance(msg, dict):
                continue
            kind = bencode.dict_get_bytes(msg, b"y")
            if kind == b"q":
                try:
                    self._handle_query(msg, addr)
                except (OSError, DhtError):
                    continue
            elif kind == b"r":
                tid = bencode.dict_get_bytes(msg, b"t")
                resp = bencode.dict_get_dict(msg, b"r")
                if resp is not None:
                    rid = bencode.dict_get_bytes(resp, b"id")
                    if rid and len(rid) == NODE_ID_LEN:
                        self.table.update(rid, addr)
                with self._lock:
                    waiter = self._pending.pop(tid, None) if tid else None
                if waiter is not None:
                    waiter[1].append(resp or {})
                    waiter[0].set()

    # ── Server side ──

    def _reply(self, tid: bytes, resp: dict, addr) -> None:
        self.sock.sendto(
            bencode.encode({b"t": tid, b"y": b"r", b"r": resp}), addr
        )

    def _handle_query(self, msg: dict, addr) -> None:
        tid = bencode.dict_get_bytes(msg, b"t") or b""
        q = bencode.dict_get_bytes(msg, b"q")
        args = bencode.dict_get_dict(msg, b"a") or {}
        qid = bencode.dict_get_bytes(args, b"id")
        if qid and len(qid) == NODE_ID_LEN:
            self.table.update(qid, addr)
        if q == b"ping":
            self._reply(tid, {b"id": self.node_id}, addr)
        elif q == b"find_node":
            target = bencode.dict_get_bytes(args, b"target") or self.node_id
            nodes = encode_compact_nodes(self.table.closest(target))
            self._reply(tid, {b"id": self.node_id, b"nodes": nodes}, addr)
        elif q == b"get_peers":
            ih = bencode.dict_get_bytes(args, b"info_hash") or b""
            token = self.make_token(addr)
            known = list(self._live_peers(ih))
            resp: dict = {b"id": self.node_id, b"token": token}
            if known:
                resp[b"values"] = encode_compact_peers(known)
            else:
                resp[b"nodes"] = encode_compact_nodes(self.table.closest(ih))
            self._reply(tid, resp, addr)
        elif q == b"announce_peer":
            ih = bencode.dict_get_bytes(args, b"info_hash") or b""
            token = bencode.dict_get_bytes(args, b"token") or b""
            port = bencode.dict_get_int(args, b"port") or 0
            if not self.valid_token(addr, token):
                return  # silently drop invalid-token announces
            self._store_peer(ih, (addr[0], port))
            self._reply(tid, {b"id": self.node_id}, addr)

    # ── Peer store (bounded, expiring) ──

    def _live_peers(self, info_hash: bytes) -> list[tuple[str, int]]:
        """Non-expired announcements for a hash; prunes expired in place."""
        entries = self.peer_store.get(info_hash)
        if not entries:
            return []
        cutoff = time.time() - PEER_TTL_S
        stale = [p for p, ts in entries.items() if ts < cutoff]
        for p in stale:
            del entries[p]
        if not entries:
            self.peer_store.pop(info_hash, None)
            return []
        return list(entries)

    def _store_peer(self, info_hash: bytes, peer: tuple[str, int]) -> None:
        entries = self.peer_store.get(info_hash)
        if entries is None:
            if len(self.peer_store) >= MAX_STORED_HASHES:
                # Evict the hash with the oldest newest-announcement.
                victim = min(
                    self.peer_store,
                    key=lambda ih: max(self.peer_store[ih].values()),
                )
                del self.peer_store[victim]
            entries = self.peer_store.setdefault(info_hash, {})
        if peer not in entries and len(entries) >= MAX_PEERS_PER_HASH:
            del entries[min(entries, key=entries.get)]  # oldest announce
        entries[peer] = time.time()

    # ── Client side ──

    def ping(self, addr: tuple[str, int]) -> bool:
        resp = self._request(
            lambda tid: build_ping(self.node_id, tid), addr
        )
        return resp is not None

    def bootstrap(self, seeds: list[tuple[str, int]] | None = None) -> int:
        """find_node(self) against seed routers (dht.zig:465-470)."""
        for addr in seeds or BOOTSTRAP_NODES:
            resp = self._request(
                lambda tid: build_find_node(self.node_id, self.node_id, tid),
                addr,
            )
            if resp is None:
                continue
            nodes = bencode.dict_get_bytes(resp, b"nodes") or b""
            try:
                for node_id, naddr in parse_compact_nodes(nodes):
                    if node_id != self.node_id:
                        self.table.update(node_id, naddr)
            except DhtError:
                continue
        return len(self.table)

    def get_peers(
        self, info_hash: bytes, depth: int = 2
    ) -> tuple[list[tuple[str, int]], dict[tuple[str, int], bytes]]:
        """Iterative lookup: query the K closest, follow returned nodes up
        to ``depth`` rounds. Returns (peers, token-per-responder) — tokens
        feed announce_peer (fixing dht.zig:453-454).

        The candidate set is kept sorted by XOR distance to ``info_hash``
        each round, so the walk converges toward the nodes that store
        announcements (announcements live only on the closest IDs)."""
        peers: dict[tuple[str, int], None] = {}
        tokens: dict[tuple[str, int], bytes] = {}
        asked: set[tuple[str, int]] = set()
        # addr -> node id; the sort key for convergence
        candidates: dict[tuple[str, int], bytes] = {
            n.addr: n.node_id for n in self.table.closest(info_hash)
        }
        for _ in range(depth + 1):
            batch = sorted(
                (a for a in candidates if a not in asked),
                key=lambda a: xor_distance(candidates[a], info_hash),
            )[:K]
            if not batch:
                break
            for addr in batch:
                asked.add(addr)
                resp = self._request(
                    lambda tid: build_get_peers(self.node_id, info_hash, tid),
                    addr,
                )
                if resp is None:
                    continue
                token = bencode.dict_get_bytes(resp, b"token")
                if token:
                    tokens[addr] = token
                values = bencode.dict_get_list(resp, b"values")
                if values:
                    for p in parse_compact_peers(values):
                        peers[p] = None
                nodes = bencode.dict_get_bytes(resp, b"nodes")
                if nodes:
                    try:
                        for nid, naddr in parse_compact_nodes(nodes):
                            if nid != self.node_id:  # never query ourselves
                                candidates.setdefault(naddr, nid)
                    except DhtError:
                        continue
        return list(peers), tokens

    def announce_peer(self, info_hash: bytes, port: int) -> int:
        """Announce to every node that gave us a token; returns count."""
        _peers, tokens = self.get_peers(info_hash)
        ok = 0
        for addr, token in tokens.items():
            resp = self._request(
                lambda tid: build_announce_peer(
                    self.node_id, info_hash, port, token, tid
                ),
                addr,
            )
            ok += resp is not None
        return ok

    # ── PeerSource protocol (transfer.swarm) ──

    def find_peers(self, info_hash: bytes) -> list[tuple[str, int]]:
        peers, _ = self.get_peers(info_hash)
        return peers

    def announce(self, info_hash: bytes, port: int) -> None:
        self.announce_peer(info_hash, port)
