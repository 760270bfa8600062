"""DCN host-to-host chunk RPC: the cooperative exchange's transport.

The counterpart of ``zest_tpu/transfer/dcn.py``, wire-compatible with it
in both directions: a lean, pipelined request/response protocol between
zest hosts, bound to ``Config.dcn_port``, with BEP XET semantics —
REQUEST / RESPONSE / NOT_FOUND / ERROR over one long-lived TCP stream with
request-ID matching.

Wire format (all integers little-endian; both sides send an 8-byte hello
on connect, then messages flow in either direction):

    hello:   "ZDCN" u8 version(1)  u8 flags(0)  u16 hello_sub
    trace:   16B trace_id  u16 host_index  u16 flags  f64 epoch_s  4B rsvd
             (32 bytes; exchanged only when BOTH hellos advertised
             hello_sub >= 2, immediately after the hellos)
    message: u8 type  u8 flags  u16 tag  u32 req_id  u32 len
             + len payload bytes
    REQUEST   (1): 32B xorb hash + u64 chunk_start + u64 chunk_end
    RESPONSE  (2): u64 chunk_offset + frame bytes
    NOT_FOUND (3): 32B xorb hash
    ERROR     (4): utf-8 message
    GOSSIP    (5): one anti-entropy request, a JSON object
    GOSSIP_REPLY (6): its reply, a JSON object

The trace block carries the sender's trace id and coop host index from
its trace context, and its wall clock; from the peer's block a channel
estimates the peer's clock offset (the single-exchange NTP estimate,
error within half the hello's round trip), which
:meth:`DcnPool.clock_offsets` reports. A traced window carries a tag,
and the server's ``dcn.serve`` span records it beside the client's host
index: the key ``telemetry.fleet.merge_traces`` links client and server
spans by. A server
answers byte-exact by default; a request's flags let it answer lossy
(``serve_chunk_range``: ``FLAG_QUANT_OK`` invites a quantized container
of a cache hit, ``FLAG_LOSSY_OK`` accepts a staged one forwarded
verbatim, and such a response carries ``FLAG_LOSSY``). A gossip round
(:mod:`~zest_tpu_torch.transfer.gossip`) rides the same stream: a server
with a node attached (:meth:`DcnServer.attach_gossip`) answers GOSSIP with
GOSSIP_REPLY, one without answers ERROR "server accepts only REQUEST",
which the client raises as :class:`GossipUnavailable`, never as a
connection fault. Link shaping and server counters are not ported.
Ranges are chunk-index ranges
within a xorb and a response carries the ``chunk_offset`` its frames
start at — the same coordinate frames as the cache.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from dataclasses import dataclass

from zest_tpu_torch import faults, telemetry
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.xorb import XorbFormatError, XorbReader, encode_frame
from zest_tpu_torch.config import Config
from zest_tpu_torch.shaping import TokenBucket
from zest_tpu_torch.storage import XorbCache, read_chunk
from zest_tpu_torch.transfer import lossy

_M_CHUNKS_SERVED = telemetry.counter(
    "zest_dcn_chunks_served_total",
    "Chunks served to other pods over the DCN RPC")
_M_BYTES_SERVED = telemetry.counter(
    "zest_dcn_bytes_served_total",
    "Payload bytes served over the DCN RPC")

# The BT wire's message cap (zest_tpu/p2p/wire.py): a full xorb always fits.
MAX_MESSAGE_SIZE = 64 * 1024 * 1024 + 1024

MAGIC = b"ZDCN"
VERSION = 1
HELLO_SUBVERSION = 2
_HELLO_STRUCT = struct.Struct("<4sBBH")
_HELLO = _HELLO_STRUCT.pack(MAGIC, VERSION, 0, HELLO_SUBVERSION)
# v2 trace-context block: trace_id, coop host index (0xFFFF = none),
# flags, sender wall clock, reserved.
_TRACE_BLOCK = struct.Struct("<16sHHd4x")
_NO_HOST = 0xFFFF
_HEADER = struct.Struct("<BBHII")
_REQ_BODY = struct.Struct("<32sQQ")
_OFFSET = struct.Struct("<Q")

MSG_REQUEST = 1
MSG_RESPONSE = 2
MSG_NOT_FOUND = 3
MSG_ERROR = 4
# A gossip push-pull round: a JSON request/reply pair on the chunk-RPC
# stream (no new listener, no new port).
MSG_GOSSIP = 5
MSG_GOSSIP_REPLY = 6

# Per-message flag bits. On a REQUEST, FLAG_LOSSY_OK accepts a lossy
# payload and FLAG_QUANT_OK invites the server to quantize fresh data; on
# a RESPONSE, FLAG_LOSSY marks a quantized container (transfer/lossy.py).
# A request with neither bit never receives lossy bytes.
FLAG_LOSSY_OK = 0x01
FLAG_QUANT_OK = 0x02
FLAG_LOSSY = 0x01

# A silent peer releases its serving thread after this long; an expired
# client channel just reconnects.
IDLE_TIMEOUT_S = 300.0


class DcnProtocolError(ConnectionError):
    pass


class GossipUnavailable(ConnectionError):
    """The peer's server answered GOSSIP with an ERROR — one with no
    gossip node attached, or a build without gossip. Callers skip the
    peer for this round; chunk RPCs to it still work."""


@dataclass(frozen=True)
class DcnRequest:
    request_id: int
    chunk_hash: bytes
    range_start: int
    range_end: int
    tag: int = 0        # the requester's window tag (0 = untagged)
    flags: int = 0      # per-message flag bits (FLAG_LOSSY_OK, ...)


@dataclass(frozen=True)
class DcnResponse:
    request_id: int
    chunk_offset: int
    data: bytes
    flags: int = 0


@dataclass(frozen=True)
class DcnNotFound:
    request_id: int
    chunk_hash: bytes


@dataclass(frozen=True)
class DcnError:
    request_id: int
    message: str


@dataclass(frozen=True)
class DcnGossip:
    """One gossip push-pull payload (request or reply): ``payload`` is
    the transfer.gossip vv+delta dict, JSON on the wire."""

    request_id: int
    payload: dict
    reply: bool = False


DcnMessage = DcnRequest | DcnResponse | DcnNotFound | DcnError | DcnGossip


# ── Codec (no sockets) ──


def encode_response_prefix(request_id: int, chunk_offset: int,
                           data_len: int, flags: int = 0) -> bytes:
    """Header + chunk_offset prefix of a RESPONSE carrying ``data_len``
    payload bytes: what both :func:`encode_message` and the server's
    scatter-gather send build on."""
    body_len = _OFFSET.size + data_len
    if body_len > MAX_MESSAGE_SIZE:
        raise DcnProtocolError(f"payload of {body_len} bytes over cap")
    return (_HEADER.pack(MSG_RESPONSE, flags & 0xFF, 0, request_id, body_len)
            + _OFFSET.pack(chunk_offset))


def encode_message(msg: DcnMessage) -> bytes:
    if isinstance(msg, DcnRequest):
        body = _REQ_BODY.pack(msg.chunk_hash, msg.range_start, msg.range_end)
        return _HEADER.pack(MSG_REQUEST, msg.flags & 0xFF, msg.tag & 0xFFFF,
                            msg.request_id, len(body)) + body
    if isinstance(msg, DcnResponse):
        return encode_response_prefix(msg.request_id, msg.chunk_offset,
                                      len(msg.data), msg.flags) + msg.data
    if isinstance(msg, DcnNotFound):
        body, mtype = msg.chunk_hash, MSG_NOT_FOUND
    elif isinstance(msg, DcnError):
        body, mtype = msg.message.encode(), MSG_ERROR
    elif isinstance(msg, DcnGossip):
        body = json.dumps(msg.payload, separators=(",", ":")).encode()
        mtype = MSG_GOSSIP_REPLY if msg.reply else MSG_GOSSIP
    else:
        raise DcnProtocolError(f"unencodable message {msg!r}")
    if len(body) > MAX_MESSAGE_SIZE:
        raise DcnProtocolError(f"payload of {len(body)} bytes over cap")
    return _HEADER.pack(mtype, 0, 0, msg.request_id, len(body)) + body


def decode_message(header: bytes, body: bytes) -> DcnMessage:
    mtype, flags, tag, req_id, length = _HEADER.unpack(header)
    if length != len(body):
        raise DcnProtocolError("body length disagrees with header")
    if mtype == MSG_REQUEST:
        if len(body) != _REQ_BODY.size:
            raise DcnProtocolError("bad REQUEST body")
        h, start, end = _REQ_BODY.unpack(body)
        return DcnRequest(req_id, h, start, end, tag, flags)
    if mtype == MSG_RESPONSE:
        if len(body) < _OFFSET.size:
            raise DcnProtocolError("bad RESPONSE body")
        (offset,) = _OFFSET.unpack_from(body)
        return DcnResponse(req_id, offset, body[_OFFSET.size:], flags)
    if mtype == MSG_NOT_FOUND:
        if len(body) != hashing.HASH_LEN:
            raise DcnProtocolError("bad NOT_FOUND body")
        return DcnNotFound(req_id, body)
    if mtype == MSG_ERROR:
        return DcnError(req_id, body.decode(errors="replace"))
    if mtype in (MSG_GOSSIP, MSG_GOSSIP_REPLY):
        try:
            payload = json.loads(body.decode())
        except (UnicodeDecodeError, ValueError) as exc:
            raise DcnProtocolError(f"bad GOSSIP body: {exc}") from exc
        if not isinstance(payload, dict):
            raise DcnProtocolError("GOSSIP body is not an object")
        return DcnGossip(req_id, payload, reply=mtype == MSG_GOSSIP_REPLY)
    raise DcnProtocolError(f"unknown message type {mtype}")


def _sendmsg_all(sock: socket.socket, buffers: list[bytes]) -> None:
    """``sendall`` over scatter-gather buffers, without joining them."""
    views = [memoryview(b) for b in buffers if len(b)]
    while views:
        sent = sock.sendmsg(views)
        while views and sent >= len(views[0]):
            sent -= len(views[0])
            views.pop(0)
        if views and sent:
            views[0] = views[0][sent:]


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("DCN peer closed the stream")
        buf += part
    return bytes(buf)


def _recv_message(sock: socket.socket) -> DcnMessage:
    header = _recv_exact(sock, _HEADER.size)
    length = struct.unpack_from("<I", header, 8)[0]
    if length > MAX_MESSAGE_SIZE:
        raise DcnProtocolError(f"message of {length} bytes over cap")
    return decode_message(header, _recv_exact(sock, length))


# ── Hello ──


@dataclass
class HelloInfo:
    """What one connection's hello negotiated."""

    subversion: int = 1
    peer_trace_id: str | None = None    # hex, from the peer's block
    peer_host: int | None = None        # the peer's coop host index
    rtt_s: float | None = None
    # Estimated peer wall clock minus ours; error within ±rtt/2.
    clock_offset_s: float | None = None


def _our_trace_block() -> bytes:
    """This side's 32-byte trace block, from the process or thread trace
    context (the cooperative round sets it): the trace id and the coop
    host index, all-zero id and host 0xFFFF when there is none. The
    block is framing, sent whenever v2 was negotiated, so the wire's
    shape does not depend on the telemetry switch."""
    ctx = telemetry.trace.current_context()
    tid = ctx.get("trace_id")
    host = ctx.get("host")
    try:
        tid_bytes = bytes.fromhex(tid) if tid else b"\0" * 16
    except ValueError:
        tid_bytes = b"\0" * 16
    if len(tid_bytes) != 16:
        tid_bytes = (tid_bytes + b"\0" * 16)[:16]
    host_u16 = host if isinstance(host, int) and 0 <= host < _NO_HOST \
        else _NO_HOST
    return _TRACE_BLOCK.pack(tid_bytes, host_u16, 0, time.time())


def _exchange_hello(sock: socket.socket) -> HelloInfo:
    """Send-then-read hello (symmetric, so it cannot deadlock), then the
    trace-context blocks when both sides advertised sub-version >= 2.
    Raises on a non-zest or wrong-version peer."""
    t0 = time.monotonic()
    sock.sendall(_HELLO)
    magic, version, _flags, their_sub = _HELLO_STRUCT.unpack(
        _recv_exact(sock, _HELLO_STRUCT.size))
    if magic != MAGIC:
        raise DcnProtocolError("peer is not a zest DCN endpoint")
    if version != VERSION:
        raise DcnProtocolError(f"unsupported DCN version {version}")
    info = HelloInfo(subversion=min(HELLO_SUBVERSION, their_sub or 1))
    if info.subversion < 2:
        return info
    sock.sendall(_our_trace_block())
    tid_bytes, host, _bflags, peer_epoch = _TRACE_BLOCK.unpack(
        _recv_exact(sock, _TRACE_BLOCK.size))
    if tid_bytes != b"\0" * 16:
        info.peer_trace_id = tid_bytes.hex()
    if host != _NO_HOST:
        info.peer_host = host
    info.rtt_s = max(0.0, time.monotonic() - t0)
    # The peer stamped its clock about half a round trip before we read it.
    info.clock_offset_s = peer_epoch - (time.time() - info.rtt_s / 2.0)
    return info


# ── Cache lookup ──


def lookup_chunk_range(cfg: Config, cache: XorbCache, chunk_hash: bytes,
                       range_start: int, range_end: int
                       ) -> tuple[int, bytes] | None:
    """Two-tier cache read for a chunk-range request: the chunk cache
    (one chunk, wrapped into one frame), then the xorb cache with range
    rebasing. Returns ``(chunk_offset, frame bytes)`` or None."""
    data = read_chunk(cfg, chunk_hash)
    if data is not None:
        frame, _h = encode_frame(data)
        return 0, frame
    cached = cache.get_with_range(hashing.hash_to_hex(chunk_hash), range_start)
    if cached is None:
        return None
    blob, offset = cached.data, cached.chunk_offset
    try:
        reader = XorbReader(blob)
        local_start, local_end = range_start - offset, range_end - offset
        if 0 <= local_start < local_end <= len(reader):
            blob = reader.slice_range(local_start, local_end)
            offset = range_start
    except XorbFormatError:
        pass  # serve the whole entry; the requester re-slices
    return offset, blob


def serve_chunk_range(cfg: Config, cache: XorbCache, chunk_hash: bytes,
                      range_start: int, range_end: int, flags: int = 0
                      ) -> tuple[int, bytes, int] | None:
    """What a server answers to one request: ``(chunk_offset, blob,
    response flags)`` or None. The socket server and the in-process
    transports (``transfer/transport.py``) share it, so every backend
    answers alike.

    Byte-exact cache data always wins. With ``FLAG_QUANT_OK`` a cache hit
    goes out as a quantized container when that shrinks it; with
    ``FLAG_LOSSY_OK`` a cache miss falls through to this host's lossy
    staging (a container it received over a lossy link), forwarded
    verbatim so the error never compounds across hops. Either answer is
    flagged ``FLAG_LOSSY``."""
    found = lookup_chunk_range(cfg, cache, chunk_hash, range_start,
                               range_end)
    if found is not None:
        offset, blob = found
        if flags & FLAG_QUANT_OK:
            packed = lossy.quantize_blob(blob)
            if packed is not None and len(packed) < len(blob):
                return offset, packed, FLAG_LOSSY
        return offset, blob, 0
    if flags & FLAG_LOSSY_OK:
        staged = lossy.staging_for(cfg.cache_dir).get_with_range(
            hashing.hash_to_hex(chunk_hash), range_start)
        if staged is not None:
            blob, offset = staged
            return offset, blob, FLAG_LOSSY
    return None


# ── Server ──


class ConnTracker:
    """Live connections of a server, so shutdown can wake threads blocked
    in ``recv``. Only the owning thread ever closes a connection."""

    def __init__(self) -> None:
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()

    def add(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.add(conn)

    def discard(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.discard(conn)

    def wake_all(self) -> None:
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


@dataclass
class DcnServerStats:
    connections: int = 0
    chunks_served: int = 0
    bytes_served: int = 0
    not_found: int = 0


class DcnServer:
    """Chunk-RPC listener bound to ``cfg.dcn_port`` (0 = ephemeral). One
    thread per connection, requests served in order per stream; clients
    pipeline by request ID.

    Link shaping, for the in-process multi-host benches (all off by
    default; serving is unshaped): ``rate_bps`` bounds the served payload
    bytes of shaped links through one shared ``shaping.TokenBucket``, and
    ``window_rtt_s`` charges one round trip per request window (an
    untagged request, or a new tag, starts one), so a tagged
    ``request_many`` window pays it once and untagged traffic per request.
    With ``shape_slices`` (a coop topology) and ``shape_host`` (this
    server's host index) only cross-slice connections are shaped: the
    client's slice comes from its hello's ``peer_host``, and an anonymous
    client counts as cross-slice. ``shape_pods`` (a coop pod map) adds a
    third class: a cross-pod connection is WAN and pays ``wan_rtt_s`` per
    window through its own ``wan_bps`` bucket, each falling back to the
    DCN knob when unset; with a pod map an anonymous client counts as
    cross-pod."""

    def __init__(self, cfg: Config, cache: XorbCache | None = None,
                 span_attrs: dict | None = None, rate_bps: int = 0,
                 window_rtt_s: float = 0.0,
                 shape_slices: tuple[int, ...] | None = None,
                 shape_host: int | None = None,
                 shape_pods: tuple[int, ...] | None = None,
                 wan_rtt_s: float = 0.0, wan_bps: int = 0):
        self.cfg = cfg
        self.cache = cache or XorbCache(cfg)
        # Attrs stamped on every ``dcn.serve`` span (the in-process
        # multi-host runs pass {"host": i}; a server in its own process
        # takes the process trace context instead).
        self.span_attrs = dict(span_attrs or {})
        self._bucket = TokenBucket(rate_bps) if rate_bps else None
        self._wan_bucket = TokenBucket(wan_bps) if wan_bps else None
        self.window_rtt_s = float(window_rtt_s)
        self.wan_rtt_s = float(wan_rtt_s)
        self.shape_slices = shape_slices
        self.shape_host = shape_host
        self.shape_pods = shape_pods
        self.stats = DcnServerStats()
        self._stats_lock = threading.Lock()
        # The gossip responder (attach_gossip): anti-entropy rounds ride
        # this listener's connections.
        self.gossip = None
        self.port: int | None = None
        self._shutdown = threading.Event()
        self._sock: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._conns = ConnTracker()

    def attach_gossip(self, node) -> None:
        """Answer GOSSIP on this listener with ``node``'s anti-entropy
        responder (``transfer.gossip.GossipNode.handle_exchange``).
        Without a node the server answers ERROR "server accepts only
        REQUEST", which clients read as gossip-unavailable."""
        self.gossip = node

    def start(self) -> int:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind(("0.0.0.0", self.cfg.dcn_port))
            sock.listen(64)
            # A close() does not wake a thread blocked in accept(): poll
            # the shutdown flag instead.
            sock.settimeout(0.25)
        except OSError:
            sock.close()
            raise
        self._sock = sock
        self.port = sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="dcn-accept", daemon=True)
        self._accept_thread.start()
        return self.port

    def shutdown(self) -> None:
        self._shutdown.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        self._conns.wake_all()

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            with self._stats_lock:
                self.stats.connections += 1
            # Each serving thread ends when its peer disconnects, idles
            # past IDLE_TIMEOUT_S, or the listener shuts down.
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="dcn-serve", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        self._conns.add(conn)
        try:
            with conn:
                # Accepted in the same beat as shutdown(): it may have
                # missed the wake-up, so look at the flag once more.
                if self._shutdown.is_set():
                    return
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(IDLE_TIMEOUT_S)
                hello = _exchange_hello(conn)
                rtt, bucket = self._link_shaping(self._conn_link(hello))
                # The tag of the window in progress: an untagged request
                # or a new tag opens a window, which pays one round trip.
                last_tag = None
                while not self._shutdown.is_set():
                    msg = _recv_message(conn)
                    node = self.gossip
                    if isinstance(msg, DcnRequest):
                        if rtt > 0:
                            if msg.tag == 0 or msg.tag != last_tag:
                                time.sleep(rtt)
                            last_tag = msg.tag or None
                        self._serve_request(conn, msg, hello, bucket)
                    elif (isinstance(msg, DcnGossip) and not msg.reply
                          and node is not None):
                        reply = node.handle_exchange(msg.payload)
                        if rtt > 0:
                            time.sleep(rtt)
                            last_tag = None
                        conn.sendall(encode_message(DcnGossip(
                            msg.request_id, reply, reply=True)))
                    else:
                        conn.sendall(encode_message(DcnError(
                            msg.request_id, "server accepts only REQUEST")))
        except (ConnectionError, OSError):
            return  # peer went away or spoke garbage: drop the connection
        finally:
            self._conns.discard(conn)

    def _conn_link(self, hello: HelloInfo | None) -> str:
        """This connection's link class: ``"ici"`` (same slice,
        unshaped), ``"dcn"`` (cross-slice) or ``"wan"`` (cross-pod, with a
        pod map). Without a slice map, or for a client that names no host
        in range, it is the worst configured class."""
        if self._bucket is None and self._wan_bucket is None \
                and self.window_rtt_s <= 0 and self.wan_rtt_s <= 0:
            return "ici"  # shaping off
        pods = self.shape_pods
        worst = "wan" if pods is not None else "dcn"
        slices, me = self.shape_slices, self.shape_host
        if slices is None or me is None:
            return worst
        peer = getattr(hello, "peer_host", None)
        if peer is None or not 0 <= peer < len(slices) \
                or not 0 <= me < len(slices):
            return worst
        if pods is not None and peer < len(pods) and me < len(pods) \
                and pods[peer] != pods[me]:
            return "wan"
        return "dcn" if slices[peer] != slices[me] else "ici"

    def _link_shaping(self, link: str):
        """``(window_rtt_s, bucket)`` of a link class. WAN falls back to
        the DCN knobs it lacks, so a pod map alone shapes a cross-pod link
        at least as hard as a cross-slice one."""
        if link == "wan":
            return (self.wan_rtt_s or self.window_rtt_s,
                    self._wan_bucket or self._bucket)
        if link == "dcn":
            return self.window_rtt_s, self._bucket
        return 0.0, None

    def _serve_request(self, conn: socket.socket, req: DcnRequest,
                       hello: HelloInfo | None = None,
                       bucket: TokenBucket | None = None) -> None:
        # The serve span carries the window tag and the requester's host
        # and trace id from its hello: the key a merged trace links to
        # the client's ``dcn.request_many`` span by.
        attrs = dict(self.span_attrs)
        attrs["tag"] = req.tag
        if hello is not None and hello.peer_host is not None:
            attrs["client_host"] = hello.peer_host
        if hello is not None and hello.peer_trace_id is not None:
            attrs.setdefault("trace_id", hello.peer_trace_id)
        with telemetry.span("dcn.serve", **attrs) as sp:
            self._serve_request_inner(conn, req, sp, bucket)

    def _serve_request_inner(self, conn: socket.socket, req: DcnRequest,
                             sp, bucket: TokenBucket | None = None) -> None:
        if not req.range_start < req.range_end:
            conn.sendall(encode_message(DcnError(
                req.request_id,
                f"invalid range [{req.range_start},{req.range_end})")))
            return
        found = serve_chunk_range(self.cfg, self.cache, req.chunk_hash,
                                  req.range_start, req.range_end, req.flags)
        if found is None:
            with self._stats_lock:
                self.stats.not_found += 1
            sp.set("outcome", "not_found")
            conn.sendall(encode_message(
                DcnNotFound(req.request_id, req.chunk_hash)))
            return
        offset, blob, resp_flags = found
        if _OFFSET.size + len(blob) > MAX_MESSAGE_SIZE:
            conn.sendall(encode_message(DcnError(
                req.request_id, f"entry of {len(blob)} bytes over cap")))
            return
        # Counted before the send: a client holding the last response sees
        # the stats it implies. A shaped link's bucket paces the payload.
        with self._stats_lock:
            self.stats.chunks_served += 1
            self.stats.bytes_served += len(blob)
        if bucket is not None:
            bucket.acquire(len(blob))
        _M_CHUNKS_SERVED.inc()
        _M_BYTES_SERVED.inc(len(blob))
        sp.add_bytes(len(blob))
        # Scatter-gather: a whole xorb is up to 64 MiB, not to be joined
        # into one bytestring.
        _sendmsg_all(conn, [encode_response_prefix(
            req.request_id, offset, len(blob), resp_flags), blob])


# ── Client ──


class _Waiter:
    __slots__ = ("request_id", "event", "result", "error")

    def __init__(self, request_id: int):
        self.request_id = request_id
        self.event = threading.Event()
        self.result: DcnMessage | None = None
        self.error: Exception | None = None

    def wait(self, timeout: float) -> DcnMessage:
        if not self.event.wait(timeout):
            raise TimeoutError(f"DCN request {self.request_id} timed out "
                               f"after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class DcnChannel:
    """One pipelined stream to a remote host's DcnServer. Any number of
    threads may have requests in flight: senders take increasing request
    IDs and one reader thread hands each response to its waiter."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.address = (host, port)
        self.timeout = timeout
        self._sock = socket.create_connection((host, port), timeout=timeout)
        try:
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.hello = _exchange_hello(self._sock)
        except (ConnectionError, OSError):
            self._sock.close()
            raise
        # Per-request deadlines live in _Waiter.wait: the reader blocks
        # between requests for as long as the channel is idle.
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()
        self._next_id = 0
        self._pending: dict[int, _Waiter] = {}
        self._pending_lock = threading.Lock()
        self._closed = False
        self.dead = False  # the reader saw EOF or an error: reconnect
        self._reader = threading.Thread(target=self._read_loop,
                                        name="dcn-reader", daemon=True)
        self._reader.start()

    def close(self) -> None:
        self._closed = True
        self.dead = True
        try:
            self._sock.close()
        except OSError:
            pass
        self._fail_all(ConnectionError("channel closed"))

    def _fail_all(self, exc: Exception) -> None:
        with self._pending_lock:
            waiters = list(self._pending.values())
            self._pending.clear()
        for w in waiters:
            w.error = exc
            w.event.set()

    def _read_loop(self) -> None:
        try:
            while True:
                msg = _recv_message(self._sock)
                with self._pending_lock:
                    waiter = self._pending.pop(msg.request_id, None)
                if waiter is not None:
                    waiter.result = msg
                    waiter.event.set()
        except (ConnectionError, OSError) as exc:
            self.dead = True
            if not self._closed:
                self._fail_all(exc)

    def send_request(self, chunk_hash: bytes, range_start: int,
                     range_end: int, tag: int = 0,
                     flags: int = 0) -> _Waiter:
        """Fire one request; returns a waiter to collect later (send N,
        then wait N, to pipeline)."""
        if faults.fire("dcn_reset",
                       key=f"{self.address[0]}:{self.address[1]}"):
            self.dead = True
            raise ConnectionError("injected dcn_reset")
        if self.dead:
            raise ConnectionError("DCN channel is dead")
        with self._send_lock:
            req_id = self._next_id
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF
            waiter = _Waiter(req_id)
            with self._pending_lock:
                self._pending[req_id] = waiter
            try:
                self._sock.sendall(encode_message(DcnRequest(
                    req_id, chunk_hash, range_start, range_end, tag,
                    flags)))
            except OSError as exc:
                with self._pending_lock:
                    self._pending.pop(req_id, None)
                raise ConnectionError(f"DCN send failed: {exc}") from exc
        return waiter

    def request_many(self, wants: list[tuple[bytes, int, int]],
                     timeout: float | None = None, tag: int = 0,
                     flags: int = 0) -> list[DcnMessage]:
        """Pipelined batch: every request goes out before any response is
        awaited; results come back in ``wants`` order. ``timeout`` caps
        each wait for this call only."""
        waiters = [self.send_request(*w, tag=tag, flags=flags)
                   for w in wants]
        t = self.timeout if timeout is None else timeout
        return [w.wait(t) for w in waiters]

    def gossip_exchange(self, payload: dict,
                        timeout: float | None = None) -> dict:
        """One anti-entropy round trip on this channel: send our digest
        delta, return the peer's reply payload. An ERROR reply raises
        :class:`GossipUnavailable`."""
        if self.dead:
            raise ConnectionError("DCN channel is dead")
        with self._send_lock:
            req_id = self._next_id
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF
            waiter = _Waiter(req_id)
            with self._pending_lock:
                self._pending[req_id] = waiter
            try:
                self._sock.sendall(encode_message(DcnGossip(req_id,
                                                            payload)))
            except OSError as exc:
                with self._pending_lock:
                    self._pending.pop(req_id, None)
                raise ConnectionError(f"DCN send failed: {exc}") from exc
        msg = waiter.wait(self.timeout if timeout is None else timeout)
        if isinstance(msg, DcnGossip):
            return msg.payload
        if isinstance(msg, DcnError):
            raise GossipUnavailable(msg.message)
        raise DcnProtocolError(
            f"unexpected reply to GOSSIP: {type(msg).__name__}")


class DcnPool:
    """Long-lived channels keyed by ``(host, port)``."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout
        self._channels: dict[tuple[str, int], DcnChannel] = {}
        self._lock = threading.Lock()
        self._next_tag = 0
        # Wire-tag accounting: request windows sent, the REQUESTs they
        # carried, and how many went out with a window tag and without
        # (the collective exchange tags every window it sends).
        self.counters = {"windows": 0, "requests": 0,
                         "tagged_windows": 0, "untagged_windows": 0}

    def window_tag(self) -> int:
        """Next nonzero u16 window tag (wraps; 0 stays "untagged")."""
        with self._lock:
            self._next_tag = (self._next_tag % 0xFFFF) + 1
            return self._next_tag

    def clock_offsets(self) -> dict:
        """``{(host, port): {"offset_s", "rtt_s"[, "host"]}}`` from the
        hello of every live channel that measured one."""
        with self._lock:
            channels = dict(self._channels)
        out = {}
        for addr, ch in channels.items():
            hello = ch.hello
            if hello.clock_offset_s is None:
                continue
            row = {"offset_s": round(hello.clock_offset_s, 6),
                   "rtt_s": round(hello.rtt_s or 0.0, 6)}
            if hello.peer_host is not None:
                row["host"] = hello.peer_host
            out[addr] = row
        return out

    def channel(self, host: str, port: int) -> DcnChannel:
        """The pooled channel to ``(host, port)``, dialed if need be."""
        return self._lease(host, port)[0]

    def _lease(self, host: str, port: int) -> tuple[DcnChannel, bool]:
        """``(channel, reused)``. A reused channel may be stale (the
        server idle-closed it), which is why :meth:`request_many` retries
        a reused channel's failure once and lets a fresh one's raise."""
        key = (host, port)
        with self._lock:
            ch = self._channels.get(key)
            if ch is not None and ch.dead:
                del self._channels[key]
                ch.close()
                ch = None
        if ch is not None:
            return ch, True
        ch = DcnChannel(host, port, timeout=self.timeout)
        with self._lock:
            existing = self._channels.get(key)
            if existing is not None and not existing.dead:
                ch.close()  # a concurrent connect won: keep the first
                return existing, True
            self._channels[key] = ch
            return ch, False

    def request_many(self, host: str, port: int,
                     wants: list[tuple[bytes, int, int]],
                     timeout: float | None = None, tag: int | None = None,
                     flags: int = 0) -> list[DcnMessage]:
        """Pipelined batch through a pooled channel, reconnecting and
        retrying ONCE when a pooled channel turns out to be dead; a fresh
        connection's failure propagates. ``tag`` stamps every REQUEST of
        the batch with a window tag, ``flags`` with the flag byte.

        Without an explicit ``tag`` a window tag is taken only while a
        tracer records: it links this window's ``dcn.request_many`` span
        to the server's ``dcn.serve`` spans, and an untraced window keeps
        the untagged wire bytes."""
        if tag is None:
            tag = (self.window_tag() if telemetry.enabled()
                   and telemetry.trace.active() is not None else 0)
        with self._lock:
            self.counters["windows"] += 1
            self.counters["requests"] += len(wants)
            self.counters["tagged_windows" if tag
                          else "untagged_windows"] += 1
        attrs = {"peer": f"{host}:{port}", "requests": len(wants)}
        if tag:
            attrs["flow_tag"] = tag
        with telemetry.span("dcn.request_many", **attrs):
            ch, reused = self._lease(host, port)
            try:
                return ch.request_many(wants, timeout=timeout, tag=tag,
                                       flags=flags)
            except (ConnectionError, TimeoutError, OSError):
                self.drop(host, port)
                if not reused:
                    raise
            ch, _ = self._lease(host, port)
            try:
                return ch.request_many(wants, timeout=timeout, tag=tag,
                                       flags=flags)
            except (ConnectionError, TimeoutError, OSError):
                self.drop(host, port)
                raise

    def gossip_exchange(self, host: str, port: int, payload: dict,
                        timeout: float | None = None) -> dict:
        """One anti-entropy round trip through a pooled channel, with
        :meth:`request_many`'s reconnect-and-retry-once on a stale pooled
        channel. ``GossipUnavailable`` propagates without a retry: the
        peer is alive, it does not speak gossip."""
        ch, reused = self._lease(host, port)
        try:
            return ch.gossip_exchange(payload, timeout=timeout)
        except GossipUnavailable:
            raise
        except (ConnectionError, TimeoutError, OSError):
            self.drop(host, port)
            if not reused:
                raise
        ch, _ = self._lease(host, port)
        try:
            return ch.gossip_exchange(payload, timeout=timeout)
        except (ConnectionError, TimeoutError, OSError):
            self.drop(host, port)
            raise

    def drop(self, host: str, port: int) -> None:
        with self._lock:
            ch = self._channels.pop((host, port), None)
        if ch is not None:
            ch.close()

    def close(self) -> None:
        with self._lock:
            channels = list(self._channels.values())
            self._channels.clear()
        for ch in channels:
            ch.close()
