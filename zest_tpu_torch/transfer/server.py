"""Seeding server: answers CHUNK_REQUESTs from the local caches.

The port's copy of ``zest_tpu/transfer/server.py``, with its four
process-registry counters (``zest_seed_bytes_total`` by unchoke slot
kind, ``zest_seed_choke_events_total``, ``zest_seed_refusals_total``,
``zest_seed_uploads_expired_total``: the tracker client's ``uploaded``
reads the first) and the same ``ServerStats`` fields; its flight-recorder
events are not ported. The src/server.zig equivalent: TCP listener, per-connection thread,
responder-side handshake (echo the requester's info_hash — the responder
serves all swarms, server.zig:122-139), BEP 10 negotiation, then a serve
loop answering each CHUNK_REQUEST from the chunk cache (plain-hex keys)
first, then the range-aware xorb cache (LE-u64-hex keys), else
CHUNK_NOT_FOUND.

Production upload policy ("the package IS the seeder" is only true if
serving survives real swarms):

- **Rate shaping**: one global :class:`zest_tpu_torch.shaping.TokenBucket`
  (``ZEST_SEED_RATE_BPS``) bounds the host's total upload rate, and a
  per-peer bucket (``ZEST_SEED_PEER_BPS``) keeps one aggressive leecher
  from starving the rest. Responses stream in shaped chunks, so the
  bound holds within a frame, not just between frames.
- **Choke/unchoke reciprocity** (BEP-XET heritage): the K
  (``ZEST_SEED_SLOTS``) peers that served *us* the most bytes recently
  — the health registry's decayed reciprocity book — hold unchoke
  slots, plus ONE optimistic-unchoke slot rotating through the rest so
  strangers can bootstrap. Choked peers get ``CHUNK_ERROR(CHOKED)``
  (the requester's swarm moves on without a health strike). The same
  K+1 bounds concurrent in-flight uploads.
- **Per-request deadlines**: a chunk response must complete within
  ``ZEST_SEED_DEADLINE_S`` end-to-end. A reader that stops draining its
  socket is disconnected and struck in the health registry with the
  distinct ``stalled_reader`` kind instead of pinning an upload slot; a
  deadline consumed by the server's OWN shaping budget or queueing
  expires the upload without blaming anyone. (The ``seed_stall`` kind
  is the mirror image, recorded by the PULL side for a peer that times
  out while serving us — see transfer.swarm.)
- **Quarantine-aware refusal**: content whose bytes came (unproven)
  from a peer this host has since quarantined is refused with a loud
  ``CHUNK_ERROR(NOT_AVAILABLE)`` — suspect bytes are never laundered
  back into the swarm (:class:`zest_tpu_torch.p2p.health.ContentProvenance`).
- **Graceful drain**: shutdown stops accepting first, then gives
  in-flight responses ``ZEST_SEED_DRAIN_S`` to complete before waking
  blocked readers — a shutdown mid-upload never hands a puller a
  truncated-but-accepted blob.

Improvements over the reference kept from the seed build:
- responds with the *negotiated* ext id, not a hardcoded 1
  (quirk at server.zig:194-213);
- when a full xorb is cached but only a range was requested, slices the
  frame stream and sends just that range (the reference ships the whole
  cached entry).
"""

from __future__ import annotations

import socket
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

from zest_tpu_torch import faults, telemetry
from zest_tpu_torch.config import Config
from zest_tpu_torch.p2p import bep_xet, peer_id as peer_id_mod, wire
from zest_tpu_torch.p2p.health import PROVENANCE, HealthRegistry
from zest_tpu_torch.p2p.peer import LOCAL_UT_XET_ID
from zest_tpu_torch.shaping import TokenBucket
from zest_tpu_torch.storage import XorbCache
from zest_tpu_torch.transfer.dcn import ConnTracker, lookup_chunk_range

# Process-registry mirrors: serving economics visible on /v1/metrics
# across sessions ("which peers do we feed, whom do we choke, what did
# we refuse").
_M_SEED_BYTES = telemetry.counter(
    "zest_seed_bytes_total",
    "Payload bytes served by the seeding tier, by unchoke slot kind",
    ("peer_state",))
_M_CHOKE_EVENTS = telemetry.counter(
    "zest_seed_choke_events_total",
    "Choke/unchoke state transitions sent to leechers")
_M_REFUSALS = telemetry.counter(
    "zest_seed_refusals_total",
    "Chunk requests refused for quarantined-source content")
_M_EXPIRED = telemetry.counter(
    "zest_seed_uploads_expired_total",
    "Uploads aborted at the per-request deadline (stalled readers)")

# How often the choke book re-ranks (and the optimistic slot rotates).
RECHOKE_INTERVAL_S = 10.0
# Shaped-send granularity: small enough that the token buckets bound
# rate within a frame, large enough that syscall overhead is noise.
_SEND_CHUNK = 256 * 1024
# Per-peer bucket book bound: honest clients key by their stable
# (host, listen_port) serving identity and reuse one bucket across
# reconnects; clients that never advertise a port key by ephemeral
# source address and would otherwise grow the book one bucket per
# connection forever. LRU-evicting past this cap bounds memory; the
# GLOBAL bucket still caps aggregate rate either way.
_PEER_BUCKET_CAP = 256


class UploadExpired(RuntimeError):
    """A response overran its per-request deadline — the connection is
    dropped. Only a genuine send timeout (the reader stopped draining)
    also strikes the peer, with kind ``stalled_reader``; a starved
    shaping budget or queue delay is the server's own doing and blames
    nobody."""


@dataclass
class ServerStats:
    active_peers: int
    chunks_served: int
    bytes_served: int = 0
    choke_events: int = 0
    refused_quarantined: int = 0
    uploads_expired: int = 0
    unchoked_peers: int = 0
    choked_peers: int = 0


class _ChokeBook:
    """Reciprocity-ranked unchoke slots over the registered leechers.

    ``slots`` reciprocal winners (most decayed bytes served to US, from
    the health registry) stay unchoked; one optimistic slot rotates
    through the rest each rechoke interval so a new peer with nothing
    to its name can still bootstrap — the standard BitTorrent answer to
    both free-riders and cold-start. With ≤ slots+1 leechers everyone
    is unchoked (the policy only bites under contention), which also
    keeps the single-leecher loopback behavior identical to the
    pre-policy server."""

    def __init__(self, slots: int, health: HealthRegistry | None,
                 rechoke_s: float = RECHOKE_INTERVAL_S,
                 time_fn=time.monotonic):
        self.slots = max(1, slots)
        self.health = health
        self.rechoke_s = rechoke_s
        self._time = time_fn
        self._lock = threading.Lock()
        self._peers: dict[int, tuple[str, int]] = {}  # conn key -> addr
        self._order: list[int] = []                   # registration order
        self._unchoked: dict[int, str] = {}           # key -> slot kind
        self._next_rechoke = 0.0
        self._rotation = 0
        self.transitions = 0

    def register(self, key: int, addr: tuple[str, int]) -> None:
        with self._lock:
            if key not in self._peers:
                self._order.append(key)
            self._peers[key] = addr
            self._next_rechoke = 0.0  # membership change: re-rank now

    def unregister(self, key: int) -> None:
        with self._lock:
            self._peers.pop(key, None)
            self._unchoked.pop(key, None)
            if key in self._order:
                self._order.remove(key)
            self._next_rechoke = 0.0

    def _recompute_locked(self, now: float) -> None:
        keys = list(self._order)
        if len(keys) <= self.slots + 1:
            self._unchoked = {k: "reciprocal" for k in keys}
        else:
            def served(k: int) -> float:
                if self.health is None:
                    return 0.0
                return self.health.served_bytes(self._peers[k])
            ranked = sorted(keys, key=served, reverse=True)  # stable:
            # ties keep registration order (sorted() stability over the
            # registration-ordered input).
            winners = ranked[: self.slots]
            rest = [k for k in keys if k not in winners]
            self._unchoked = {k: "reciprocal" for k in winners}
            self._unchoked[rest[self._rotation % len(rest)]] = "optimistic"
            self._rotation += 1
        self._next_rechoke = now + self.rechoke_s

    def slot(self, key: int) -> str | None:
        """The unchoke slot kind for this leecher (``"reciprocal"`` |
        ``"optimistic"``), or None = choked. Re-ranks lazily on the
        rechoke interval; the ``seeder_choke_flap`` fault injects a
        spurious one-query choke here (the chaos matrix's probe that a
        flapping policy can't corrupt or stall a pull)."""
        now = self._time()
        with self._lock:
            if now >= self._next_rechoke:
                self._recompute_locked(now)
            kind = self._unchoked.get(key)
            addr = self._peers.get(key)
        if kind is not None and addr is not None \
                and faults.fire("seeder_choke_flap",
                                key=f"{addr[0]}:{addr[1]}"):
            return None
        return kind

    def kind(self, key: int) -> str | None:
        """Current slot kind WITHOUT re-ranking or fault rolls — for
        labeling work already authorized by :meth:`slot`."""
        with self._lock:
            return self._unchoked.get(key)

    def count_transition(self) -> None:
        """Choke-state flip sent on some wire; serve threads race, so
        the counter lives under the book's lock."""
        with self._lock:
            self.transitions += 1

    def counts(self) -> tuple[int, int]:
        with self._lock:
            unchoked = len(self._unchoked)
            return unchoked, max(0, len(self._peers) - unchoked)


class BtServer:
    def __init__(self, cfg: Config, cache: XorbCache | None = None,
                 health: HealthRegistry | None = None,
                 rechoke_s: float = RECHOKE_INTERVAL_S):
        self.cfg = cfg
        self.cache = cache or XorbCache(cfg)
        # The health registry doubles as (a) the reciprocity book behind
        # unchoke ranking, (b) the strike target for stalled readers,
        # and (c) the quarantine oracle for source-refusal. Share the
        # swarm's registry when this process also pulls (cmd_serve
        # does); a private one still enforces slots/shaping/deadlines.
        self.health = health or HealthRegistry()
        self.peer_id = peer_id_mod.generate()
        self._listener: socket.socket | None = None
        self._shutdown = threading.Event()
        self._draining = threading.Event()
        self._active_peers = 0
        self._chunks_served = 0
        self._bytes_served = 0
        self._refused_quarantined = 0
        self._uploads_expired = 0
        self._uploads_inflight = 0
        self._stats_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self.port: int | None = None
        self._conns = ConnTracker()
        self._choke = _ChokeBook(cfg.seed_slots, self.health,
                                 rechoke_s=rechoke_s)
        # Upload transfer slots: the same K+1 bound as the unchoke set —
        # an unchoked peer pipelining requests cannot multiply past it.
        self._slots = threading.BoundedSemaphore(cfg.seed_slots + 1)
        self._rate = (TokenBucket(cfg.seed_rate_bps)
                      if cfg.seed_rate_bps else None)
        self._peer_rate_lock = threading.Lock()
        self._peer_rates: OrderedDict[tuple[str, int], TokenBucket] = \
            OrderedDict()

    # ── Lifecycle ──

    def start(self) -> int:
        """Bind + spawn the accept loop; returns the bound port."""
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("0.0.0.0", self.cfg.listen_port))
        listener.listen(64)
        # Periodic timeout so shutdown() is observed promptly — closing a
        # socket does not reliably interrupt a blocked accept().
        listener.settimeout(0.25)
        self._listener = listener
        self.port = listener.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        return self.port

    def shutdown(self, drain_s: float | None = None) -> None:
        """Graceful drain: stop accepting, let in-flight responses
        finish within ``drain_s`` (default ``cfg.seed_drain_s``), then
        wake everything. A response that completes inside the drain
        window reaches its puller whole — no truncated-but-accepted
        blobs; one that cannot is cut at the wire-frame level, which
        the puller's framing rejects loudly."""
        if drain_s is None:
            drain_s = self.cfg.seed_drain_s
        self._draining.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        deadline = time.monotonic() + max(0.0, drain_s)
        while time.monotonic() < deadline:
            with self._stats_lock:
                if self._uploads_inflight == 0:
                    break
            time.sleep(0.02)
        self._shutdown.set()
        # Wake serving threads blocked in recv so peers' connections die
        # now, not at their 120s timeout (ConnTracker invariants).
        self._conns.wake_all()

    def get_stats(self) -> ServerStats:
        unchoked, choked = self._choke.counts()
        with self._stats_lock:
            return ServerStats(
                active_peers=self._active_peers,
                chunks_served=self._chunks_served,
                bytes_served=self._bytes_served,
                choke_events=self._choke.transitions,
                refused_quarantined=self._refused_quarantined,
                uploads_expired=self._uploads_expired,
                unchoked_peers=unchoked,
                choked_peers=choked,
            )

    # ── Accept + serve (reference: server.zig:45-172) ──

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not (self._shutdown.is_set() or self._draining.is_set()):
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            conn.settimeout(None)
            threading.Thread(
                target=self._handle_peer, args=(conn,), daemon=True
            ).start()

    def _peer_bucket(self, addr: tuple[str, int]) -> TokenBucket | None:
        if not self.cfg.seed_peer_bps:
            return None
        with self._peer_rate_lock:
            bucket = self._peer_rates.get(addr)
            if bucket is None:
                bucket = self._peer_rates[addr] = TokenBucket(
                    self.cfg.seed_peer_bps)
            self._peer_rates.move_to_end(addr)
            while len(self._peer_rates) > _PEER_BUCKET_CAP:
                self._peer_rates.popitem(last=False)
            return bucket

    def _handle_peer(self, conn: socket.socket) -> None:
        conn.settimeout(120)
        self._conns.add(conn)
        stream = wire.SocketStream(conn)
        with self._stats_lock:
            self._active_peers += 1
        key = id(stream)
        try:
            host = conn.getpeername()[0]
        except OSError:
            host = "?"
        try:
            if self._shutdown.is_set():
                return  # accepted in the same beat as shutdown()
            self._handle_peer_inner(stream, key, host)
        except UploadExpired:
            # The reader stalled (or starved the shaped budget) past the
            # request deadline while holding an upload slot: drop the
            # connection and strike the peer with the SERVING-side kind,
            # so health.detail() attributes "bad leecher" distinctly
            # from "bad seeder".
            with self._stats_lock:
                self._uploads_expired += 1
            _M_EXPIRED.inc()
        except (wire.WireError, OSError, bep_xet.XetMessageError):
            pass  # peer went away or spoke garbage; drop quietly
        finally:
            self._choke.unregister(key)
            with self._stats_lock:
                self._active_peers -= 1
            stream.close()
            self._conns.discard(conn)

    def _handle_peer_inner(self, stream: wire.SocketStream, key: int,
                           host: str) -> None:
        their_hs = stream.recv_handshake()
        # Responder echoes the requester's info_hash: one server seeds
        # every xorb swarm it has data for (server.zig:122-139).
        stream.send_handshake(their_hs.info_hash, self.peer_id)
        stream.send_raw(wire.encode_extended(
            0, bep_xet.make_ext_handshake(LOCAL_UT_XET_ID, self.port)
        ))
        # Until the ext handshake names the peer's listen port, the
        # reciprocity book keys on the connection's source address (a
        # stranger entry: no history, neutral rank).
        try:
            peer_addr = (host, stream.sock.getpeername()[1])
        except OSError:
            peer_addr = (host, 0)
        self._choke.register(key, peer_addr)
        # Health strikes only target ADVERTISED identities: keying them
        # by ephemeral source port would grow the registry one entry
        # per reconnect of any client that never sends a listen_port.
        advertised = False
        sent_unchoked = self._sync_choke_state(stream, key, None)

        requester_ext_id = LOCAL_UT_XET_ID  # until their handshake arrives
        while not self._shutdown.is_set():
            msg = stream.recv_message()
            if msg.msg_id is None:
                continue
            if msg.msg_id != wire.MessageId.EXTENDED:
                continue  # interested/keepalive chatter
            ext_id, payload = wire.parse_extended(msg.payload)
            if ext_id == 0:
                caps = bep_xet.parse_ext_handshake(payload)
                if caps.ut_xet_id is not None:
                    requester_ext_id = caps.ut_xet_id
                if caps.listen_port:
                    # The peer's SERVING identity: reciprocity and
                    # strikes key on (host, listen_port) — the address
                    # our own swarm fetches from.
                    peer_addr = (host, caps.listen_port)
                    advertised = True
                    self._choke.register(key, peer_addr)
                continue
            xet = bep_xet.decode(payload)
            if isinstance(xet, bep_xet.ChunkRequest):
                sent_unchoked = self._sync_choke_state(
                    stream, key, sent_unchoked)
                self._handle_chunk_request(
                    stream, requester_ext_id, xet, key, peer_addr,
                    unchoked=bool(sent_unchoked), advertised=advertised)

    def _sync_choke_state(self, stream: wire.SocketStream, key: int,
                          last_sent: bool | None) -> bool:
        """Send CHOKE/UNCHOKE on state transitions, from the connection's
        own serve thread (all writes stay serialized). Returns the state
        just ensured on the wire."""
        unchoked = self._choke.slot(key) is not None
        if unchoked != last_sent:
            stream.send_message(wire.MessageId.UNCHOKE if unchoked
                                else wire.MessageId.CHOKE)
            if last_sent is not None:
                self._choke.count_transition()
                _M_CHOKE_EVENTS.inc()
        return unchoked

    # ── Request service (reference: server.zig:187-215) ──

    def _handle_chunk_request(
        self,
        stream: wire.SocketStream,
        ext_id: int,
        req: bep_xet.ChunkRequest,
        key: int,
        peer_addr: tuple[str, int],
        unchoked: bool = True,
        advertised: bool = True,
    ) -> None:
        from zest_tpu_torch.cas import hashing

        hash_hex = hashing.hash_to_hex(req.chunk_hash)
        if not unchoked:
            # Choked peers get a prompt, honest denial — the requester's
            # swarm moves to another candidate without a strike.
            stream.send_raw(bep_xet.encode_framed(
                ext_id,
                bep_xet.ChunkError(req.request_id, bep_xet.ERR_CHOKED,
                                   b"choked: upload policy"),
            ))
            return

        # Quarantine-aware refusal: bytes cached UNPROVEN from a peer
        # this host has since quarantined are never re-served — and the
        # key may carry several contributors' ranges, so ANY quarantined
        # source refuses. Loud — a typed wire error and a counted
        # refusal — instead of silently seeding suspect data onward.
        src = next((s for s in PROVENANCE.sources(hash_hex)
                    if self.health.is_quarantined(s)), None)
        if src is not None:
            with self._stats_lock:
                self._refused_quarantined += 1
            _M_REFUSALS.inc()
            stream.send_raw(bep_xet.encode_framed(
                ext_id,
                bep_xet.ChunkError(
                    req.request_id, bep_xet.ERR_NOT_AVAILABLE,
                    b"not available: quarantined source"),
            ))
            return

        # Shared two-tier lookup (chunk cache, then range-aware xorb
        # cache) — identical answers over BT wire and DCN RPC.
        found = lookup_chunk_range(
            self.cfg, self.cache, req.chunk_hash,
            req.range_start, req.range_end,
        )
        if found is not None:
            offset, blob = found
            self._respond(stream, ext_id, req.request_id, offset, blob,
                          key, peer_addr, advertised)
            return

        stream.send_raw(bep_xet.encode_framed(
            ext_id,
            bep_xet.ChunkNotFound(req.request_id, req.chunk_hash),
        ))

    def _respond(self, stream, ext_id: int, request_id: int,
                 chunk_offset: int, data: bytes, key: int,
                 peer_addr: tuple[str, int],
                 advertised: bool = True) -> None:
        """One upload: slot-bounded, rate-shaped, deadline-bounded.

        encode_framed copies the chunk data once (native framer) instead
        of three times through the pure concat chain — the serving hot
        loop's analog of the reference's bt_wire fast path. The frame
        then streams out in shaped pieces so the token buckets bound
        the rate *within* the transfer, and every piece re-checks the
        per-request deadline: a reader that stops draining its socket
        (or an injected ``seeder_stall``) frees the slot at the
        deadline instead of pinning it."""
        peer_key = f"{peer_addr[0]}:{peer_addr[1]}"
        give_up_at = time.monotonic() + self.cfg.seed_request_deadline_s
        if not self._slots.acquire(
                timeout=max(0.0, give_up_at - time.monotonic())):
            # All transfer slots busy for a full deadline: deny like a
            # choke (healthy server, try elsewhere), don't stall.
            stream.send_raw(bep_xet.encode_framed(
                ext_id,
                bep_xet.ChunkError(request_id, bep_xet.ERR_CHOKED,
                                   b"busy: no upload slot"),
            ))
            return
        with self._stats_lock:
            self._uploads_inflight += 1
        try:
            # Chaos sites: a seeder that stalls mid-upload,
            # and one that serves corrupt bytes (the puller's verify
            # tiers must catch it — corrupt-bytes-admitted stays 0).
            faults.sleep_if("seeder_stall", key=peer_key, default_s=2.0)
            if time.monotonic() > give_up_at:
                # The response can no longer complete inside its budget
                # (WE stalled, or it queued too long behind the slots):
                # abort BEFORE the frame starts — a partial frame would
                # desync the stream either way. No strike: this is the
                # server's own congestion, not the reader's fault.
                raise UploadExpired("request deadline exceeded pre-send")
            if faults.fire("upload_corrupt", key=peer_key):
                data = faults.corrupt(data)
            frame = bep_xet.encode_framed(
                ext_id,
                bep_xet.ChunkResponse(request_id, chunk_offset, data),
            )
            self._send_shaped(stream, frame, peer_addr, give_up_at)
        except (socket.timeout, TimeoutError):
            if advertised:
                self._strike_stalled(peer_addr)
            raise UploadExpired(f"upload to {peer_key} timed out")
        finally:
            with self._stats_lock:
                self._uploads_inflight -= 1
            self._slots.release()
        slot_kind = self._choke.kind(key) or "reciprocal"
        with self._stats_lock:
            self._chunks_served += 1
            self._bytes_served += len(data)
        _M_SEED_BYTES.inc(len(data), peer_state=slot_kind)

    def _send_shaped(self, stream, frame: bytes,
                     peer_addr: tuple[str, int], give_up_at: float) -> None:
        rate = self._rate
        peer_rate = self._peer_bucket(peer_addr)
        if rate is None and peer_rate is None:
            # Unshaped fast path: one send, deadline via socket timeout.
            stream.sock.settimeout(
                max(0.1, give_up_at - time.monotonic()))
            try:
                stream.send_raw(frame)
            finally:
                stream.sock.settimeout(120)
            return
        view = memoryview(frame)
        try:
            for off in range(0, len(view), _SEND_CHUNK):
                piece = view[off:off + _SEND_CHUNK]
                # Per-peer fairness first, then the global allocation —
                # a peer-starved wait must not hold global tokens.
                # A bucket give-up or a deadline consumed by shaping
                # waits is the SERVER's own budget running out — expire
                # the upload but never strike the reader for it. A
                # give-up refunds the buckets already debited for this
                # piece: the bytes were never sent, and the peer bucket
                # persists across reconnects — phantom debt would shape
                # the peer below its knob on every retry.
                granted: list[TokenBucket] = []
                for bucket in (peer_rate, rate):
                    if bucket is None:
                        continue
                    if not bucket.acquire(len(piece),
                                          give_up_at=give_up_at):
                        for prior in granted:
                            prior.refund(len(piece))
                        raise UploadExpired(
                            "shaping budget overran request deadline")
                    granted.append(bucket)
                if time.monotonic() > give_up_at:
                    raise UploadExpired("request deadline exceeded")
                stream.sock.settimeout(
                    max(0.1, give_up_at - time.monotonic()))
                try:
                    stream.send_raw(piece)
                finally:
                    stream.sock.settimeout(120)
        finally:
            view.release()

    def _strike_stalled(self, peer_addr: tuple[str, int]) -> None:
        """Serving-side strike attribution: a reader that stops
        draining its socket (the send itself timed out — NOT a shaping
        give-up or queue delay, which are the server's own doing) gets
        the distinct ``stalled_reader`` kind — visible in
        ``health.detail()`` next to (not conflated with) its fetch-side
        record."""
        if peer_addr[1]:
            self.health.record_failure(peer_addr, kind="stalled_reader")
