"""Epidemic metadata spread for a trusted fleet: the gossip plane.

The port's copy of ``zest_tpu/transfer/gossip.py``. Each host keeps a
**bounded digest** of ``(xorb-key → holder set, seeder state, revision
manifests)`` entries with per-origin version vectors, and an
**anti-entropy push-pull** round runs each tick against ``fanout =
O(log N)`` seeded-random peers. One round trip both pushes what the peer
is missing and pulls what we are missing (the request carries our
version vector + a delta; the response carries the peer's), so a rumor
spreads fleet-wide in O(log N) rounds and announce traffic is O(N·log N)
per tick instead of every host to a tracker.

Three rules the implementation pins:

- **Bounded, eviction-safe**: the digest never exceeds
  ``max_entries`` (``ZEST_GOSSIP_MAX``); overflow evicts the
  least-recently-updated FOREIGN entry first (a host is authoritative
  for its own announcements — evicting them would re-rumor stale
  absence). Version vectors survive eviction, so an evicted entry is
  not re-merged from peers that still hold it unless its origin bumps
  the sequence — re-announce refreshes, exactly the tracker TTL model.
- **Deterministic merge**: entry identity is ``(kind, key, origin)``
  and merge keeps the highest origin sequence — commutative,
  idempotent, order-free. Peer sampling is ``random.Random`` seeded per
  host as in the JAX package, so a round's request and response
  payloads are the JAX package's, payload for payload.
- **Transport-agnostic, DCN-piggybacked**: a round is one
  ``request → response`` payload pair. In-process fleets wire nodes
  through :class:`LoopbackMesh`; real hosts ride the DCN chunk-RPC
  channels (:class:`DcnGossipTransport`, ``MSG_GOSSIP`` in
  :mod:`~zest_tpu_torch.transfer.dcn` — no new listener, no new port).

``ZEST_GOSSIP=0`` keeps this module out of the wiring
(:func:`node_from_config` returns None): tracker and DHT announce behave
as before and no ``gossip`` key appears in the swarm's stats. With a
node attached, the tracker and DHT demote to bootstrap — the first
announce per swarm still registers there, every refresh rides the
digest.

The digest doubles as the fleet-wide "who has which xorb" index:
``find_peers`` answers from the local digest ordered by the link-cost
table ICI(0) < DCN(1) < WAN(2) — the CDN is the implicit cost-3 tier
the waterfall falls to when the index is empty.
"""

from __future__ import annotations

import json
import math
import random
import threading
from dataclasses import dataclass

from zest_tpu_torch import telemetry

_M_GOSSIP_ROUNDS = telemetry.counter(
    "zest_gossip_rounds_total", "Anti-entropy push-pull rounds run")
_M_GOSSIP_ENTRIES = telemetry.gauge(
    "zest_gossip_entries", "Live entries in this host's gossip digest")
_M_GOSSIP_BYTES = telemetry.counter(
    "zest_gossip_bytes_total", "Gossip payload bytes by direction",
    ("direction",))
_M_GOSSIP_EVICTED = telemetry.counter(
    "zest_gossip_evicted_total",
    "Digest entries evicted under the size bound")

# Entry kinds the digest carries.
KIND_XORB = "xorb"          # key = info_hash hex, payload: listen port
KIND_SEEDER = "seeder"      # key = host index,   payload: seeder state
KIND_MANIFEST = "manifest"  # key = repo@rev,     payload: manifest meta

# A single push-pull payload never carries more than this many entries:
# anti-entropy converges over rounds, it must not turn one round into
# an unbounded state dump on a cold join.
MAX_DELTA_ENTRIES = 512

DEFAULT_MAX_ENTRIES = 65536

# Link-cost table: lower = nearer. CDN is the implicit
# final tier (cost 3) — it is not a peer, so it never appears here.
COST_ICI = 0   # same slice
COST_DCN = 1   # same pod, different slice
COST_WAN = 2   # different pod
COST_CDN = 3   # documented for the routing table; never returned


def link_cost(a: int, b: int, topology=None, pods=None) -> int:
    """Cost class of the a↔b link from the slice/pod maps (missing maps
    degrade conservatively: unknown pod ⇒ same pod, unknown slice ⇒
    cross-slice — mirroring dcn.DcnServer's anonymous-peer rule)."""
    if pods is not None and len(pods) > max(a, b) \
            and pods[a] != pods[b]:
        return COST_WAN
    if topology is not None and len(topology) > max(a, b) \
            and topology[a] == topology[b]:
        return COST_ICI
    return COST_DCN


@dataclass
class _Entry:
    seq: int        # origin's monotonic sequence (version-vector term)
    payload: dict   # small JSON-safe metadata (port, state, manifest)
    stamp: int      # local logical clock, for LRU eviction only


class GossipDigest:
    """The bounded CRDT store: ``(kind, key, origin) → _Entry`` plus
    the per-origin version vector. Thread-safe (merges arrive from the
    DCN serve plane while ticks run on the round's thread)."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES,
                 own_origin: int | None = None):
        self.max_entries = max(1, int(max_entries))
        # The hosting node's own origin: authoritative entries —
        # evicting them would rumor stale absence, so eviction sheds
        # foreign entries first.
        self.own_origin = own_origin
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, str, int], _Entry] = {}
        self.vv: dict[int, int] = {}
        self._clock = 0
        self.evicted = 0
        self.merged_in = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _tick_clock(self) -> int:
        self._clock += 1
        return self._clock

    def update(self, kind: str, key: str, origin: int, seq: int,
               payload: dict) -> bool:
        """Merge one entry; True when it was news (higher seq than the
        stored one for the same identity). Keeps the bound."""
        with self._lock:
            ident = (kind, key, origin)
            cur = self._entries.get(ident)
            if cur is not None and cur.seq >= seq:
                # Still advance the vector: a duplicate proves origin
                # reached seq even when the payload is old news.
                if seq > self.vv.get(origin, -1):
                    self.vv[origin] = seq
                return False
            if cur is None and origin != self.own_origin \
                    and seq <= self.vv.get(origin, -1):
                # Seen-and-evicted: the vector remembers the origin
                # reached this seq, so the entry stays forgotten until
                # the origin re-announces past it (the tracker TTL
                # model — eviction must not thrash against re-merge).
                return False
            self._entries[ident] = _Entry(seq, payload,
                                          self._tick_clock())
            if seq > self.vv.get(origin, -1):
                self.vv[origin] = seq
            self.merged_in += 1
            self._evict_locked(keep_origin=origin)
            _M_GOSSIP_ENTRIES.set(float(len(self._entries)))
            return True

    def _evict_locked(self, keep_origin: int | None = None) -> None:
        while len(self._entries) > self.max_entries:
            # Oldest-updated foreign entry first; own (authoritative)
            # entries and the one just merged only when nothing
            # foreign is left to shed.
            protect = {keep_origin, self.own_origin} - {None}
            victims = sorted(
                ((e.stamp, ident) for ident, e in self._entries.items()
                 if ident[2] not in protect),
                key=lambda t: t[0])
            if not victims:
                victims = sorted(
                    ((e.stamp, ident)
                     for ident, e in self._entries.items()),
                    key=lambda t: t[0])
            self._entries.pop(victims[0][1], None)
            self.evicted += 1
            _M_GOSSIP_EVICTED.inc()

    def delta_since(self, peer_vv: dict[int, int],
                    cap: int = MAX_DELTA_ENTRIES) -> list[list]:
        """Entries whose origin sequence is past ``peer_vv`` —
        oldest-sequence first so repeated capped rounds still drain
        monotonically — as JSON-safe rows
        ``[kind, key, origin, seq, payload]``."""
        with self._lock:
            rows = [
                [k, key, origin, e.seq, e.payload]
                for (k, key, origin), e in self._entries.items()
                if e.seq > int(peer_vv.get(origin,
                                           peer_vv.get(str(origin), -1)))
            ]
        rows.sort(key=lambda r: (r[3], r[0], r[1], r[2]))
        return rows[:cap]

    def merge_rows(self, rows) -> int:
        """Merge a peer's delta rows; returns how many were news."""
        fresh = 0
        for kind, key, origin, seq, payload in rows:
            if self.update(str(kind), str(key), int(origin), int(seq),
                           dict(payload)):
                fresh += 1
        return fresh

    def holders(self, kind: str, key: str) -> dict[int, dict]:
        """``{origin: payload}`` for every live entry of ``key``."""
        with self._lock:
            return {origin: e.payload
                    for (k, kk, origin), e in self._entries.items()
                    if k == kind and kk == key}

    def memory_bytes(self) -> int:
        """Conservative digest footprint estimate — what the 1024-host
        bound gate measures (identity strings + payload JSON + fixed
        per-entry overhead; an exact RSS would measure the allocator,
        not the digest)."""
        with self._lock:
            total = 0
            for (kind, key, _origin), e in self._entries.items():
                total += 64 + len(kind) + len(key)
                total += len(json.dumps(e.payload, separators=(",", ":")))
            return total

    def snapshot_vv(self) -> dict[int, int]:
        with self._lock:
            return dict(self.vv)


class LoopbackMesh:
    """In-process transport: host index → node registry. The sim/test
    fabric — ``exchange`` is a direct method call, zero wire."""

    def __init__(self) -> None:
        self.nodes: dict[int, "GossipNode"] = {}
        self.exchanges = 0

    def register(self, node: "GossipNode") -> None:
        self.nodes[node.host_index] = node

    def exchange(self, peer: int, payload: dict) -> dict | None:
        node = self.nodes.get(peer)
        if node is None:
            return None
        self.exchanges += 1
        return node.handle_exchange(payload)


class DcnGossipTransport:
    """Piggyback on the fleet's existing DCN chunk-RPC channels: one
    ``MSG_GOSSIP`` request/response per push-pull round, multiplexed on
    the same pooled sockets the exchange uses (dcn.DcnPool). A peer
    whose server predates the message type answers with a protocol
    error — treated as "gossip unavailable there", never a failure."""

    def __init__(self, pool, addrs: dict[int, tuple[str, int]]):
        self.pool = pool
        self.addrs = dict(addrs)

    def exchange(self, peer: int, payload: dict) -> dict | None:
        addr = self.addrs.get(peer)
        if addr is None:
            return None
        try:
            return self.pool.gossip_exchange(addr[0], addr[1], payload)
        except Exception:  # noqa: BLE001 - gossip is best-effort
            return None


class GossipNode:
    """One host's epidemic-metadata agent.

    Implements the swarm's ``PeerSource`` protocol (``find_peers`` /
    ``announce``) so it drops into the discovery waterfall as the
    nearest-first source; ``tick()`` runs one anti-entropy round
    against ``fanout`` seeded-random peers. The node is passive
    otherwise — callers (the daemon's serve loop, the fleet sim) own
    the tick cadence (``ZEST_GOSSIP_INTERVAL_S``)."""

    def __init__(self, host_index: int, n_hosts: int,
                 addr_book: dict[int, tuple[str, int]] | None = None,
                 *, topology=None, pods=None, fanout: int = 0,
                 max_entries: int = DEFAULT_MAX_ENTRIES,
                 seed: int | None = None):
        self.host_index = int(host_index)
        self.n_hosts = int(n_hosts)
        self.addr_book = dict(addr_book or {})
        self.topology = tuple(topology) if topology else None
        self.pods = tuple(pods) if pods else None
        self.digest = GossipDigest(max_entries, own_origin=host_index)
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._fanout = int(fanout)
        self._rng = random.Random(
            seed if seed is not None else 0x2E57 ^ self.host_index)
        self._peer_vv: dict[int, dict[int, int]] = {}
        self.rounds = 0
        self.announces = 0
        self.bytes_out = 0
        self.bytes_in = 0

    # ── Local authorship ──

    def _next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def announce(self, info_hash: bytes, port: int) -> None:
        """PeerSource announce: record "I hold this xorb" locally; the
        next push-pull rounds rumor it fleet-wide."""
        self.announces += 1
        self.digest.update(KIND_XORB, info_hash.hex(), self.host_index,
                           self._next_seq(), {"port": int(port)})

    def set_seeder_state(self, state: str, **extra) -> None:
        self.digest.update(KIND_SEEDER, str(self.host_index),
                           self.host_index, self._next_seq(),
                           {"state": state, **extra})

    def announce_manifest(self, key: str, payload: dict) -> None:
        self.digest.update(KIND_MANIFEST, key, self.host_index,
                           self._next_seq(), dict(payload))

    # ── Fleet index / content-aware routing ──

    def cost_to(self, other: int) -> int:
        return link_cost(self.host_index, other,
                         topology=self.topology, pods=self.pods)

    def who_has(self, info_hash: bytes) -> list[int]:
        """Holder host indices, nearest link class first (ICI < DCN <
        WAN), ties by host index for determinism."""
        holders = self.digest.holders(KIND_XORB, info_hash.hex())
        return sorted(holders, key=lambda h: (self.cost_to(h), h))

    def find_peers(self, info_hash: bytes) -> list[tuple[str, int]]:
        """PeerSource lookup, answered from the LOCAL digest — zero
        round trips (the tracker needs one per query). Cost-ordered so
        the swarm's candidate list tries the nearest warm host first."""
        holders = self.digest.holders(KIND_XORB, info_hash.hex())
        out: list[tuple[str, int]] = []
        for h in sorted(holders, key=lambda h: (self.cost_to(h), h)):
            if h == self.host_index:
                continue
            addr = self.addr_book.get(h)
            host = addr[0] if addr else None
            port = holders[h].get("port") or (addr[1] if addr else None)
            if host and port:
                out.append((host, int(port)))
        return out

    # ── Anti-entropy rounds ──

    def peers(self) -> list[int]:
        return sorted(h for h in self.addr_book if h != self.host_index)

    def fanout(self) -> int:
        if self._fanout > 0:
            return self._fanout
        n = max(2, len(self.peers()) + 1)
        return max(1, math.ceil(math.log2(n)))

    def request_payload(self, peer: int) -> dict:
        """The push half: our version vector + what we believe ``peer``
        is missing (sized from the vv its last response carried; a
        never-seen peer gets a capped cold delta)."""
        known = self._peer_vv.get(peer, {})
        return {"host": self.host_index,
                "vv": {str(k): v
                       for k, v in self.digest.snapshot_vv().items()},
                "delta": self.digest.delta_since(known)}

    def handle_exchange(self, payload: dict) -> dict:
        """Serve one push-pull round (the responder half — runs on the
        DCN serve plane or a LoopbackMesh call): merge the caller's
        delta, answer with our vector + their missing entries."""
        sender = payload.get("host")
        their_vv = {int(k): int(v)
                    for k, v in (payload.get("vv") or {}).items()}
        self.digest.merge_rows(payload.get("delta") or ())
        if sender is not None:
            self._peer_vv[int(sender)] = their_vv
        return {"host": self.host_index,
                "vv": {str(k): v
                       for k, v in self.digest.snapshot_vv().items()},
                "delta": self.digest.delta_since(their_vv)}

    def merge_response(self, peer: int, resp: dict) -> int:
        their_vv = {int(k): int(v)
                    for k, v in (resp.get("vv") or {}).items()}
        self._peer_vv[peer] = their_vv
        return self.digest.merge_rows(resp.get("delta") or ())

    def tick(self, transport) -> int:
        """One gossip round: push-pull with ``fanout`` random peers.
        Returns how many fresh entries arrived. Peer sampling is seeded
        per node — a fleet sim replays identically."""
        fresh = 0
        peers = self.peers()
        if not peers:
            return 0
        picks = self._rng.sample(peers, min(self.fanout(), len(peers)))
        for peer in picks:
            req = self.request_payload(peer)
            out_n = len(json.dumps(req, separators=(",", ":")))
            self.bytes_out += out_n
            _M_GOSSIP_BYTES.inc(out_n, direction="out")
            resp = transport.exchange(peer, req)
            if not resp:
                continue
            in_n = len(json.dumps(resp, separators=(",", ":")))
            self.bytes_in += in_n
            _M_GOSSIP_BYTES.inc(in_n, direction="in")
            fresh += self.merge_response(peer, resp)
        self.rounds += 1
        _M_GOSSIP_ROUNDS.inc()
        return fresh

    def summary(self) -> dict:
        return {
            "entries": len(self.digest),
            "rounds": self.rounds,
            "announces": self.announces,
            "fanout": self.fanout(),
            "evicted": self.digest.evicted,
            "bytes_out": self.bytes_out,
            "bytes_in": self.bytes_in,
            "memory_bytes": self.digest.memory_bytes(),
            "max_entries": self.digest.max_entries,
        }


def node_from_config(cfg, host_index: int, n_hosts: int,
                     addr_book=None) -> GossipNode | None:
    """Build this host's GossipNode from Config, or None when
    ``ZEST_GOSSIP=0`` — the single wiring gate: with gossip off no node
    exists anywhere, so announce paths and stats schemas are
    bit-for-bit the tracker-only build."""
    if not getattr(cfg, "gossip_enabled", True):
        return None
    return GossipNode(
        host_index, n_hosts, addr_book,
        topology=getattr(cfg, "coop_topology", None),
        pods=getattr(cfg, "coop_pods", None),
        fanout=getattr(cfg, "gossip_fanout", 0),
        max_entries=getattr(cfg, "gossip_max_entries",
                            DEFAULT_MAX_ENTRIES),
    )
