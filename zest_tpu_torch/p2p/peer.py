"""Peer connection state machine (the src/bt_peer.zig equivalent).

The port's copy of ``zest_tpu/p2p/peer.py``.

Lifecycle: TCP connect → BT handshake (verify echoed info_hash) → BEP 10
extended handshake (negotiate the peer's ut_xet id) → unchoke/interested →
range-aware chunk request/response with request-id matching. A per-peer
lock serializes use of the TCP stream (reference: bt_peer.zig:33-35) while
still allowing request pipelining: send a batch of CHUNK_REQUESTs, then
drain the responses (bt_peer.zig:188-248).

Improvement over the reference: the responder uses the *negotiated* ext id
rather than hardcoding 1 (quirk at server.zig:194-213).
"""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass

from zest_tpu_torch import faults, telemetry
from zest_tpu_torch.p2p import bep_xet, wire

# Our local id for the ut_xet extension, advertised in the ext handshake.
LOCAL_UT_XET_ID = 3

# Legacy ceilings. The swarm passes adaptive (EWMA-derived, deadline-
# capped) timeouts per connection; these remain the defaults for direct
# protocol use and the upper bound the adaptive path never exceeds.
_CONNECT_TIMEOUT_S = 5.0
_IO_TIMEOUT_S = 60.0


class PeerError(RuntimeError):
    pass


class ChunkNotFoundError(PeerError):
    """Peer answered CHUNK_NOT_FOUND — connection stays healthy."""


class PeerChokedError(PeerError):
    """Peer answered CHUNK_ERROR(CHOKED): its upload policy denied us a
    slot right now. The peer is healthy and HAS the data — the swarm
    moves to the next candidate without a health strike (striking a
    seeder for enforcing fairness would quarantine the whole tier under
    load)."""


class ContentRefusedError(ChunkNotFoundError):
    """Peer answered CHUNK_ERROR(NOT_AVAILABLE): it is refusing to serve
    this content (quarantined-source bytes it cannot vouch for). Treated
    like CHUNK_NOT_FOUND — healthy peer, no strike, next tier serves —
    but kept distinct so stats/triage show the refusal was deliberate."""


@dataclass(frozen=True)
class ChunkResult:
    data: bytes
    chunk_offset: int


class BtPeer:
    """One outgoing peer connection bound to a single swarm (info_hash)."""

    def __init__(self, stream: wire.SocketStream, peer_ut_xet_id: int,
                 remote_peer_id: bytes,
                 address: tuple[str, int] | None = None):
        self.stream = stream
        self.peer_ut_xet_id = peer_ut_xet_id
        self.remote_peer_id = remote_peer_id
        self.address = address
        self.lock = threading.Lock()
        self._next_request_id = 1

    # ── Connection + handshake (reference: bt_peer.zig:63-115) ──

    @classmethod
    def connect(
        cls,
        host: str,
        port: int,
        info_hash: bytes,
        peer_id: bytes,
        listen_port: int | None = None,
        connect_timeout: float = _CONNECT_TIMEOUT_S,
        io_timeout: float = _IO_TIMEOUT_S,
    ) -> "BtPeer":
        if faults.fire("peer_timeout", key=f"{host}:{port}"):
            raise TimeoutError(f"injected peer_timeout for {host}:{port}")
        with telemetry.span("peer.connect", peer=f"{host}:{port}"):
            return cls._connect(host, port, info_hash, peer_id, listen_port,
                                connect_timeout, io_timeout)

    @classmethod
    def _connect(
        cls,
        host: str,
        port: int,
        info_hash: bytes,
        peer_id: bytes,
        listen_port: int | None,
        connect_timeout: float,
        io_timeout: float,
    ) -> "BtPeer":
        sock = socket.create_connection((host, port), timeout=connect_timeout)
        sock.settimeout(io_timeout)
        stream = wire.SocketStream(sock)
        try:
            stream.send_handshake(info_hash, peer_id)
            their_hs = stream.recv_handshake()
            if their_hs.info_hash != info_hash:
                raise PeerError("info_hash mismatch in handshake")
            if not their_hs.supports_bep10:
                raise PeerError("peer does not support BEP 10 extensions")

            # Extended handshake (ext_id 0), then interested/unchoke.
            stream.send_raw(wire.encode_extended(
                0, bep_xet.make_ext_handshake(LOCAL_UT_XET_ID, listen_port)
            ))
            caps = cls._await_ext_handshake(stream)
            if caps.ut_xet_id is None:
                raise PeerError("peer does not support ut_xet")
            stream.send_message(wire.MessageId.INTERESTED)
            return cls(stream, caps.ut_xet_id, their_hs.peer_id,
                       address=(host, port))
        except BaseException:
            stream.close()
            raise

    @staticmethod
    def _await_ext_handshake(stream: wire.SocketStream) -> bep_xet.ExtCapabilities:
        """Read until the ext handshake arrives, tolerating choke/unchoke/
        bitfield chatter from standard clients."""
        for _ in range(16):
            msg = stream.recv_message()
            if msg.msg_id is None:
                continue
            if msg.msg_id == wire.MessageId.EXTENDED:
                ext_id, payload = wire.parse_extended(msg.payload)
                if ext_id == 0:
                    return bep_xet.parse_ext_handshake(payload)
            # ignore other pre-transfer messages
        raise PeerError("no extended handshake from peer")

    def close(self) -> None:
        """Wake a request blocked on this connection, then close the
        socket once no request holds the stream. The JAX package closes
        at once: a descriptor closed under a thread about to block on it
        can be reused by a new connection, and that thread then waits on
        another peer's socket until its IO timeout."""
        self.stream.shutdown()
        with self.lock:
            self.stream.close()

    def _arm_io_timeout_locked(self, timeout_s: float) -> None:
        """Re-arm the socket's per-op timeout — a pooled connection
        carries the timeout of the request that *created* it, and the
        adaptive/deadline-capped budget of the current request may be
        tighter. MUST be called with ``self.lock`` held: the socket is
        shared across the pull's concurrent term workers, and an
        unlocked settimeout would clobber another thread's in-flight
        recv budget. Best-effort: a torn-down socket surfaces on the
        next recv either way."""
        try:
            self.stream.sock.settimeout(timeout_s)
        except OSError:
            pass

    # ── Requesting (reference: bt_peer.zig:125-248) ──

    def _alloc_request_id(self) -> int:
        rid = self._next_request_id
        self._next_request_id += 1
        return rid

    def request_chunk(
        self, chunk_hash: bytes, range_start: int, range_end: int,
        io_timeout: float | None = None,
    ) -> ChunkResult:
        """Single request/response; holds the stream lock end-to-end.
        ``io_timeout`` re-arms the socket budget for THIS request, under
        the lock so concurrent requests on the shared connection never
        clobber each other's in-flight recv."""
        if self.address is not None:
            faults.sleep_if("peer_slow",
                            key=f"{self.address[0]}:{self.address[1]}")
        peer = (f"{self.address[0]}:{self.address[1]}"
                if self.address is not None else "?")
        with telemetry.span("peer.request", peer=peer) as sp:
            with self.lock:
                if io_timeout is not None:
                    self._arm_io_timeout_locked(io_timeout)
                rid = self._alloc_request_id()
                self._send_request(rid, chunk_hash, range_start, range_end)
                result = self._recv_response(rid)
            sp.add_bytes(len(result.data))
            return result

    def request_chunks_pipelined(
        self, requests: list[tuple[bytes, int, int]]
    ) -> list[ChunkResult | ChunkNotFoundError]:
        """Send all requests, then drain responses; results in request order.

        Per-request failures surface as ChunkNotFoundError entries so one
        missing range doesn't poison the batch.
        """
        with self.lock:
            rids = []
            for chunk_hash, start, end in requests:
                rid = self._alloc_request_id()
                self._send_request(rid, chunk_hash, start, end)
                rids.append(rid)
            by_rid: dict[int, ChunkResult | ChunkNotFoundError] = {}
            for _ in rids:
                try:
                    rid, result = self._recv_any_response()
                except ChunkNotFoundError as exc:
                    rid, result = exc.args[1], exc
                by_rid[rid] = result
            out = []
            for rid in rids:
                out.append(by_rid.get(
                    rid, ChunkNotFoundError("no response for request", rid)
                ))
            return out

    def _send_request(self, rid: int, chunk_hash: bytes,
                      range_start: int, range_end: int) -> None:
        self.stream.send_raw(bep_xet.encode_framed(
            self.peer_ut_xet_id,
            bep_xet.ChunkRequest(rid, chunk_hash, range_start, range_end),
        ))

    def _recv_response(self, expect_rid: int) -> ChunkResult:
        while True:
            rid, result = self._recv_any_response()
            if rid != expect_rid:
                continue  # stale response from a cancelled request
            if isinstance(result, ChunkNotFoundError):
                raise result
            return result

    def _recv_any_response(self) -> tuple[int, ChunkResult]:
        """Read frames until a XET response arrives."""
        while True:
            msg = self.stream.recv_message()
            if msg.msg_id is None:
                continue
            if msg.msg_id != wire.MessageId.EXTENDED:
                continue  # choke/unchoke/have chatter
            ext_id, payload = wire.parse_extended(msg.payload)
            if ext_id == 0:
                continue  # repeated ext handshake
            xet = bep_xet.decode(payload)
            if isinstance(xet, bep_xet.ChunkResponse):
                return xet.request_id, ChunkResult(xet.data, xet.chunk_offset)
            if isinstance(xet, bep_xet.ChunkNotFound):
                raise ChunkNotFoundError(
                    "peer does not have chunk", xet.request_id
                )
            if isinstance(xet, bep_xet.ChunkError):
                if xet.error_code == bep_xet.ERR_CHOKED:
                    raise PeerChokedError(
                        "peer choked us", xet.request_id)
                if xet.error_code == bep_xet.ERR_NOT_AVAILABLE:
                    raise ContentRefusedError(
                        "peer refused content (quarantined source)",
                        xet.request_id)
                raise PeerError(
                    f"peer error {xet.error_code}: "
                    f"{xet.message.decode(errors='replace')}"
                )
            # a ChunkRequest from the peer on an outgoing connection is
            # unexpected chatter; ignore.


def parse_address(spec: str) -> tuple[str, int]:
    """Parse "host:port" (reference: bt_peer.zig:313-315)."""
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"invalid peer address {spec!r}")
    return host, int(port)
