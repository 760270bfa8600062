"""Swarm download orchestrator (the src/swarm.zig equivalent).

The port's copy of ``zest_tpu/transfer/swarm.py``. Decides *which peers*
to ask for a xorb range and manages the connection pool, discovery
cache, and per-session stats. Discovery is pluggable (``PeerSource``):
direct ``--peer`` addresses are tried first, then discovered peers — an
HTTP tracker (:mod:`zest_tpu_torch.p2p.tracker`), the Kademlia DHT
(:mod:`zest_tpu_torch.p2p.dht`) and, inside a trusted fleet, the gossip
node (:meth:`SwarmDownloader.attach_gossip`), which then answers first
and demotes the tracker and DHT to bootstrap announce. A swarm built with
``own_sources=True`` closes its sources with itself (the CLI's DHT socket
and receive thread). Discovery results are cached for 30 s per swarm under
a lock (reference: swarm.zig:320-355); an *all-sources-failed* round
caches for only ~2 s, so one discovery blip can't blank peer discovery
for a whole TTL.

Failure semantics improve on the reference (swarm.zig:398-437), which
forgot failures between calls: every candidate carries per-peer health
(zest_tpu_torch.p2p.health) — a latency EWMA orders candidates fast-first and
drives adaptive connect/IO timeouts, while connect failures, IO
timeouts, and corrupt-chunk attributions from the bridge each count a
strike toward a quarantine circuit breaker. CHUNK_NOT_FOUND still keeps
the connection (the peer is healthy, it just lacks this xorb), and an
IO failure on a *reused* pooled socket gets one fresh-reconnect retry
before the peer is blamed — the pool's eviction race and server-side
idle closes both look exactly like that.

Unlike the JAX package, a peer that speaks garbage is a peer failure
too: the wire, BEP XET and bencode codecs raise ``ValueError`` subclasses
(``WireError``, ``XetMessageError``, ``BencodeError``) on a malformed or
truncated frame, and :meth:`SwarmDownloader._attempt` counts each like an
IO error — socket dropped, one retry on a reused socket, then a strike —
so one bad frame from one peer heals from the next tier instead of
failing the pull.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Protocol

from zest_tpu_torch import faults, telemetry
from zest_tpu_torch.config import Config
from zest_tpu_torch.p2p import bencode, bep_xet, wire
from zest_tpu_torch.p2p import peer_id as peer_id_mod
from zest_tpu_torch.p2p.health import HealthRegistry
from zest_tpu_torch.p2p.peer import (
    ChunkNotFoundError,
    ContentRefusedError,
    PeerChokedError,
    PeerError,
)
from zest_tpu_torch.p2p.pool import PeerPool

DISCOVERY_TTL_S = 30.0
# An empty discovery round (all sources failed or no peers yet) is
# renegotiated quickly: caching the blank list for the full TTL would
# silence the peer tier for 30 s after one transient DHT/tracker blip.
NEGATIVE_DISCOVERY_TTL_S = 2.0
# Re-announce dedup window: one health-transition
# sweep re-registers a swarm at most once per window — a quarantine
# storm at fleet scale (hundreds of transitions in seconds) must not
# emit O(swarms × transitions) tracker round trips when each swarm's
# registration is already fresh.
REANNOUNCE_WINDOW_S = 30.0

_M_SWARM = telemetry.counter(
    "zest_swarm_events_total", "Swarm events (attempts, failures, ...)",
    ("event",))
_M_PEER_BYTES = telemetry.counter(
    "zest_swarm_bytes_total", "Payload bytes served by peers")

# What a peer that speaks garbage raises: the codecs' ValueErrors. A
# peer failure like an IO error (see the module docstring).
CODEC_ERRORS = (wire.WireError, bep_xet.XetMessageError,
                bencode.BencodeError)


class PeerSource(Protocol):
    """Anything that can map an info_hash to peer addresses."""

    def find_peers(self, info_hash: bytes) -> list[tuple[str, int]]: ...

    def announce(self, info_hash: bytes, port: int) -> None: ...


@dataclass
class SwarmStats:
    """(reference: swarm.zig:150-163)"""

    peers_discovered: int = 0
    peer_attempts: int = 0
    peer_failures: int = 0
    peer_retries: int = 0          # stale-pooled-socket reconnect retries
    peer_choked: int = 0           # upload-policy denials (no strike)
    peer_refusals: int = 0         # quarantined-source refusals (no strike)
    peers_quarantined: int = 0     # circuit-breaker trips
    peers_demoted: int = 0         # proactive remediation demotions
    corrupt_from_peer: int = 0     # corruption attributions from the bridge
    chunks_from_peers: int = 0
    bytes_from_peers: int = 0
    announces: int = 0
    reannounces: int = 0           # quarantine/probation-driven re-announces
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def bump(self, name: str, amount: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + amount)
        if name == "bytes_from_peers":
            _M_PEER_BYTES.inc(amount)
        else:
            _M_SWARM.inc(amount, event=name)

    def summary(self) -> dict:
        return {
            "peers_discovered": self.peers_discovered,
            "peer_attempts": self.peer_attempts,
            "peer_failures": self.peer_failures,
            "peer_retries": self.peer_retries,
            "peer_choked": self.peer_choked,
            "peer_refusals": self.peer_refusals,
            "peers_quarantined": self.peers_quarantined,
            "peers_demoted": self.peers_demoted,
            "corrupt_from_peer": self.corrupt_from_peer,
            "chunks_from_peers": self.chunks_from_peers,
            "bytes_from_peers": self.bytes_from_peers,
            "announces": self.announces,
            "reannounces": self.reannounces,
        }


@dataclass(frozen=True)
class PeerResult:
    data: bytes
    chunk_offset: int
    # Which peer served the bytes — the bridge's corruption-attribution
    # handle (a BLAKE3 mismatch at extraction strikes this address).
    addr: tuple[str, int] | None = None


class SwarmDownloader:
    def __init__(
        self,
        cfg: Config,
        peer_sources: list[PeerSource] | None = None,
        pool: PeerPool | None = None,
        health: HealthRegistry | None = None,
        own_sources: bool = False,
    ):
        self.cfg = cfg
        self.peer_id = peer_id_mod.generate()
        self.pool = pool or PeerPool(cfg.max_peers)
        self.peer_sources = peer_sources or []
        self.direct_peers: list[tuple[str, int]] = []
        self.stats = SwarmStats()
        self.health = health or HealthRegistry()
        self._discovery_cache: dict[
            bytes, tuple[float, list[tuple[str, int]], float]
        ] = {}
        self._discovery_lock = threading.Lock()
        # Quarantine-aware announce: circuit-breaker
        # transitions change what this host effectively offers/uses, so
        # every swarm it has announced to gets a refresh — the tracker's
        # peer list must not keep routing leechers through a hole.
        self._announced: set[bytes] = set()
        self._reannounce_lock = threading.Lock()
        self._reannounce_pending = False
        self._last_reannounce: dict[bytes, float] = {}
        # The gossip node (transfer.gossip), when attached: the FIRST
        # discovery source (cost-ordered, zero round trips), and the
        # tracker/DHT sources demote to bootstrap-only announce. None
        # (ZEST_GOSSIP=0, or no coop identity): tracker/DHT only.
        self.gossip = None
        # Sources this swarm closes with itself (the caller built them
        # for it alone).
        self._owned_sources = list(self.peer_sources) if own_sources else []
        self.health.subscribe(self._on_health_transition)
        # The remediation engine's seeder scan reads the health book
        # through ``peer_health`` and demotes a collapsing seeder
        # through ``demote``. The latest swarm wins; close() takes them
        # back by identity, so each callable is bound once here.
        self._remediate_monitor = lambda: {
            "rows": self.health.detail(),
            "strike_budget": self.health.strikes_to_quarantine,
        }
        telemetry.remediate.register_target("peer_health",
                                            self._remediate_monitor)
        self._demote_fn = self._demote_peer
        telemetry.remediate.register_target("demote", self._demote_fn)

    def attach_gossip(self, node) -> None:
        """Adopt ``node`` (transfer.gossip.GossipNode) as the primary
        discovery source: its local digest answers ``find_peers``
        nearest-warm-host first (ICI < DCN < WAN), and every announce
        rumors through anti-entropy instead of a tracker round trip —
        the other sources only see the FIRST announce per swarm (the
        bootstrap seed)."""
        self.gossip = node
        self.peer_sources = [node] + [
            s for s in self.peer_sources if s is not node]

    def add_direct_peer(self, host: str, port: int) -> None:
        """--peer flag path: tried before discovered peers (swarm.zig:279-314)."""
        addr = (host, port)
        if addr not in self.direct_peers:
            self.direct_peers.append(addr)

    def _demote_peer(self, addr: tuple[str, int]) -> dict:
        """The engine's proactive demote: a strike-free re-rank window
        through :meth:`HealthRegistry.demote`, whose "demoted" transition
        drives the same re-announce sweep a breaker trip does."""
        window = self.health.demote(addr)
        self.stats.bump("peers_demoted")
        return {"window_s": round(window, 2)}

    def close(self) -> None:
        # Detach from the (possibly shared, longer-lived) health
        # registry first: a closed swarm must not keep re-announcing on
        # its transitions or be pinned in memory by the listener ref.
        self.health.unsubscribe(self._on_health_transition)
        telemetry.remediate.unregister_target("peer_health",
                                              self._remediate_monitor)
        telemetry.remediate.unregister_target("demote", self._demote_fn)
        self.pool.close_all()
        for source in self._owned_sources:
            close = getattr(source, "close", None)
            if close is not None:
                close()
        self._owned_sources = []

    def summary(self) -> dict:
        """Session stats plus the health registry's live view. The
        ``gossip`` block exists only when a node is attached — with
        ZEST_GOSSIP=0 the schema is the tracker-only one."""
        out = self.stats.summary()
        out["health"] = self.health.summary()
        if self.gossip is not None:
            out["gossip"] = self.gossip.summary()
        return out

    # ── Discovery (reference: swarm.zig:320-355) ──

    def discover_peers(self, info_hash: bytes) -> list[tuple[str, int]]:
        now = time.monotonic()
        with self._discovery_lock:
            cached = self._discovery_cache.get(info_hash)
            if cached is not None and now - cached[0] < cached[2]:
                return cached[1]

        found: list[tuple[str, int]] = []
        for source in self.peer_sources:
            try:
                for addr in source.find_peers(info_hash):
                    if addr not in found:
                        found.append(addr)
            except Exception:
                continue  # a dead source must not break the waterfall
        self.stats.bump("peers_discovered", len(found))

        ttl = DISCOVERY_TTL_S if found else NEGATIVE_DISCOVERY_TTL_S
        with self._discovery_lock:
            self._discovery_cache[info_hash] = (now, found, ttl)
        return found

    # ── Download (reference: swarm.zig:363-437) ──

    def try_peer_download(
        self,
        xorb_hash: bytes,
        hash_hex: str,
        range_start: int,
        range_end: int,
        deadline=None,  # zest_tpu_torch.resilience.Deadline | None
    ) -> PeerResult | None:
        """Fetch chunk range [range_start, range_end) of a xorb from the
        swarm; None when no peer could serve it (bridge falls to CDN).

        Candidates are health-ordered (fast, clean peers first);
        quarantined peers are skipped outright, so a peer that kept
        timing out or serving corrupt bytes stops taxing every xorb.
        ``deadline`` caps each attempt's connect/IO timeouts — when the
        budget runs dry the remaining candidates are abandoned and the
        caller's CDN tier takes over."""
        with telemetry.span("swarm.fetch", xorb=hash_hex) as sp:
            info_hash = peer_id_mod.compute_info_hash(xorb_hash)
            candidates = list(self.direct_peers)
            for addr in self.discover_peers(info_hash):
                if addr not in candidates:
                    candidates.append(addr)
            if not candidates:
                sp.set("outcome", "no_candidates")
                return None
            ready, _shunned = self.health.partition(candidates)
            sp.set("candidates", len(ready))

            for host, port in ready:
                if deadline is not None and deadline.expired():
                    sp.set("outcome", "deadline")
                    return None
                self.stats.bump("peer_attempts")
                result = self._attempt(
                    host, port, info_hash, xorb_hash, range_start, range_end,
                    deadline,
                )
                if result is None:
                    continue
                self.stats.bump("chunks_from_peers")
                self.stats.bump("bytes_from_peers", len(result.data))
                self.announce_available(xorb_hash, hash_hex)
                sp.set("outcome", "served")
                sp.set("peer", f"{host}:{port}")
                sp.add_bytes(len(result.data))
                return result
            sp.set("outcome", "exhausted")
            return None

    def _attempt(
        self,
        host: str,
        port: int,
        info_hash: bytes,
        xorb_hash: bytes,
        range_start: int,
        range_end: int,
        deadline,
    ) -> PeerResult | None:
        """One candidate, at most two tries: an IO or codec failure on a
        REUSED pooled connection earns a single fresh-reconnect retry (the
        eviction race / server idle-close case — the socket was stale,
        not the peer), then failures strike the peer's health. A codec
        error (a malformed or truncated frame) counts as an IO error: the
        JAX package's copy catches only ``(PeerError, OSError)`` and lets
        it escape into the pull."""
        addr = (host, port)
        for attempt in (0, 1):
            reused = False
            connect_s = None
            starved = False
            leased = False
            t_req = t0 = time.monotonic()
            try:
                connect_t = self.health.connect_timeout(addr)
                io_t = self.health.io_timeout(addr)
                if deadline is not None:
                    capped_c, capped_io = (deadline.cap(connect_t),
                                           deadline.cap(io_t))
                    # A timeout the deadline squeezed below the health-
                    # derived budget can fail for budget reasons alone.
                    starved = capped_c < connect_t or capped_io < io_t
                    connect_t, io_t = capped_c, capped_io
                peer, reused = self.pool.lease(
                    host, port, info_hash, self.peer_id,
                    listen_port=self.cfg.listen_port,
                    connect_timeout=connect_t, io_timeout=io_t,
                )
                leased = True
                t_req = time.monotonic()
                if not reused:
                    connect_s = t_req - t0
                result = peer.request_chunk(xorb_hash, range_start, range_end,
                                            io_timeout=io_t)
            except ContentRefusedError:
                # Deliberate refusal (quarantined-source content): the
                # peer is healthy and honest about it — no strike, the
                # next candidate/tier serves. Distinct stat so triage
                # sees refusals, not phantom cache misses.
                self.stats.bump("peer_refusals")
                self.health.record_success(
                    addr, rtt_s=time.monotonic() - t_req,
                    connect_s=connect_s)
                return None
            except ChunkNotFoundError:
                # Peer healthy, xorb absent: keep the connection
                # (swarm.zig:406-413); counts toward the latency EWMA.
                self.stats.bump("peer_failures")
                self.health.record_success(
                    addr, rtt_s=time.monotonic() - t_req,
                    connect_s=connect_s)
                return None
            except PeerChokedError:
                # Upload policy denied us a slot: healthy peer enforcing
                # fairness. Keep the pooled connection (it answered
                # promptly), no strike — striking seeders under load
                # would quarantine the whole peer tier exactly when it
                # matters.
                self.stats.bump("peer_choked")
                self.health.record_success(
                    addr, rtt_s=time.monotonic() - t_req,
                    connect_s=connect_s)
                return None
            except (PeerError, OSError, *CODEC_ERRORS) as _exc:
                self.stats.bump("peer_failures")
                self.pool.remove(host, port)
                if reused and attempt == 0:
                    # Stale pooled socket, not a peer verdict: exactly
                    # one reconnect retry, no strike yet.
                    self.stats.bump("peer_retries")
                    continue
                if starved:
                    # The pull budget, not the peer, set this timeout:
                    # quarantining a healthy peer over the deadline's
                    # tail would poison the NEXT pull's candidate list.
                    return None
                # Serving-side attribution: a peer that
                # timed out AFTER a successful lease stalled *as a
                # seeder* mid-request — struck with the distinct
                # ``seed_stall`` kind so health.detail() separates "it
                # serves, slowly-to-death" from "it is unreachable".
                kind = ("seed_stall"
                        if leased and isinstance(_exc, TimeoutError)
                        else "error")
                if self.health.record_failure(addr, kind=kind):
                    self.stats.bump("peers_quarantined")
                return None
            # nbytes feeds the reciprocity book: the seeding tier
            # unchokes the peers that served US the most bytes recently.
            self.health.record_success(
                addr, rtt_s=time.monotonic() - t_req, connect_s=connect_s,
                nbytes=len(result.data))
            data = result.data
            if faults.fire("chunk_corrupt", key=f"{host}:{port}"):
                data = faults.corrupt(data)
            return PeerResult(data, result.chunk_offset, addr=addr)
        return None

    def report_corrupt(self, addr: tuple[str, int]) -> None:
        """Corruption attribution from the bridge: the blob this peer
        served failed structural or BLAKE3 verification. Drop the
        connection and strike the peer — K strikes quarantine it, so a
        corrupting peer's traffic shifts to healthy tiers instead of
        poisoning every retry."""
        self.stats.bump("corrupt_from_peer")
        self.pool.remove(*addr)
        if self.health.record_failure(addr, kind="corrupt"):
            self.stats.bump("peers_quarantined")

    # ── Seeding announcements (reference: swarm.zig:458-470) ──

    def announce_available(self, xorb_hash: bytes, hash_hex: str) -> None:
        info_hash = peer_id_mod.compute_info_hash(xorb_hash)
        first = info_hash not in self._announced
        self._announced.add(info_hash)
        announced = False
        for source in self._announce_sources():
            # With gossip attached the tracker/DHT tier is bootstrap
            # only: it sees the FIRST announce per swarm (seeding the
            # epidemic); every refresh is a local digest update that the
            # anti-entropy rounds spread.
            if self.gossip is not None and source is not self.gossip \
                    and not first:
                continue
            announced = True
            try:
                source.announce(info_hash, self.cfg.listen_port)
            except Exception:
                continue
        if announced:
            self.stats.bump("announces")

    def _announce_sources(self) -> list:
        """The sources this node registers with. A node that does not
        seed (``listen_port`` 0) registers with no tracker or DHT, which
        would hand ``(ip, 0)`` to every later lookup; gossip keeps its
        holder record (its lookups take the port from the address
        book)."""
        if self.cfg.listen_port:
            return list(self.peer_sources)
        return [s for s in self.peer_sources if s is self.gossip]

    def _on_health_transition(self, event: str, addr: tuple[str, int]) -> None:
        """Quarantine-aware announce: a breaker trip or probation
        re-admit refreshes every swarm this host has announced to (the
        tracker tier of ``zest_tpu/p2p/tracker.py`` treats each announce
        as a registration, so a refresh both re-registers us and pulls a
        peer list that routes around the transition). The sweep runs on
        a background thread — N announced swarms × blocking tracker
        HTTP calls must never stall the observing thread (a pull worker
        or a serve loop) — and concurrent transitions coalesce into the
        one in-flight sweep. Best-effort, like every announce."""
        if not self.peer_sources or not self._announced:
            return
        with self._reannounce_lock:
            if self._reannounce_pending:
                return  # the in-flight sweep re-registers everything
            self._reannounce_pending = True
        threading.Thread(target=self._reannounce_sweep,
                         name="zest-reannounce", daemon=True).start()

    def _reannounce_sweep(self) -> None:
        try:
            now = self.health.now()
            swept = False
            for info_hash in list(self._announced):
                # Per-swarm dedup: a swarm whose registration was
                # refreshed within the window is skipped — back-to-back
                # transitions (a quarantine storm) re-register each
                # swarm once, not once per transition.
                if now - self._last_reannounce.get(info_hash, -1e9) \
                        < REANNOUNCE_WINDOW_S:
                    continue
                self._last_reannounce[info_hash] = now
                swept = True
                for source in self._announce_sources():
                    try:
                        source.announce(info_hash, self.cfg.listen_port)
                    except Exception:
                        continue
            if swept:
                self.stats.bump("reannounces")
        finally:
            with self._reannounce_lock:
                self._reannounce_pending = False

    def announce_xorbs(self, hash_hexes: list[str]) -> int:
        """``zest seed`` path: announce every cached xorb (main.zig:307-369)."""
        from zest_tpu_torch.cas import hashing

        for hex_key in hash_hexes:
            self.announce_available(hashing.hex_to_hash(hex_key), hex_key)
        return len(hash_hexes)
