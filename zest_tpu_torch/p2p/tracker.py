"""BT HTTP tracker client (reference: src/bt_tracker.zig).

The port's copy of ``zest_tpu/p2p/tracker.py``. ``GET
/announce?info_hash=…&peer_id=…&port=…&compact=1&event=…`` with
percent-encoded binary hashes (bt_tracker.zig:65-121), bencoded response
parsed into interval + compact 6-byte peers (``:131-180``), ``failure
reason`` surfaced as a typed error. The request goes through
``urllib.request``: a transport error, or an HTTP status that is not
2xx, is a :class:`TrackerError`, as a ``requests.RequestException`` is
in the JAX package's copy.
"""

from __future__ import annotations

import enum
import socket
import struct
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.client import HTTPException
from urllib.parse import quote_from_bytes

from zest_tpu_torch import telemetry
from zest_tpu_torch.p2p import bencode


class TrackerError(RuntimeError):
    pass


class Event(enum.Enum):
    NONE = ""
    STARTED = "started"
    STOPPED = "stopped"
    COMPLETED = "completed"


@dataclass
class AnnounceResponse:
    interval: int
    peers: list[tuple[str, int]] = field(default_factory=list)


def parse_announce_response(body: bytes) -> AnnounceResponse:
    """Bencoded dict → interval + compact peers (bt_tracker.zig:131-180)."""
    try:
        doc = bencode.decode(body)
    except bencode.BencodeError as exc:
        raise TrackerError(f"malformed tracker response: {exc}") from exc
    if not isinstance(doc, dict):
        raise TrackerError("tracker response is not a dict")
    failure = bencode.dict_get_bytes(doc, b"failure reason")
    if failure is not None:
        raise TrackerError(failure.decode("utf-8", "replace"))
    interval = bencode.dict_get_int(doc, b"interval") or 1800
    raw = bencode.dict_get_bytes(doc, b"peers") or b""
    if len(raw) % 6:
        raise TrackerError(f"compact peers length {len(raw)} not 6-aligned")
    peers = []
    for off in range(0, len(raw), 6):
        ip = socket.inet_ntoa(raw[off : off + 4])
        (port,) = struct.unpack_from(">H", raw, off + 4)
        peers.append((ip, port))
    return AnnounceResponse(interval, peers)


def build_announce_url(
    base: str,
    info_hash: bytes,
    peer_id: bytes,
    port: int,
    uploaded: int = 0,
    downloaded: int = 0,
    left: int = 0,
    event: Event = Event.NONE,
) -> str:
    """Query-string construction with binary-safe percent encoding
    (bt_tracker.zig:110-121; a generic query encoder would mangle
    bytes)."""
    sep = "&" if "?" in base else "?"
    parts = [
        f"info_hash={quote_from_bytes(info_hash)}",
        f"peer_id={quote_from_bytes(peer_id)}",
        f"port={port}",
        f"uploaded={uploaded}",
        f"downloaded={downloaded}",
        f"left={left}",
        "compact=1",
    ]
    if event is not Event.NONE:
        parts.append(f"event={event.value}")
    return base + sep + "&".join(parts)


class TrackerClient:
    """PeerSource-compatible tracker client (see transfer.swarm.PeerSource)."""

    def __init__(
        self,
        announce_url: str,
        peer_id: bytes,
        listen_port: int = 0,
        timeout: float = 10.0,
    ):
        self.announce_url = announce_url
        self.peer_id = peer_id
        # Trackers treat every /announce as a registration, so even
        # lookup-style find_peers must report our real serving port.
        self.listen_port = listen_port
        self.timeout = timeout
        self.last_interval = 1800
        # Every announce's ``uploaded`` reports this process' seed-served
        # bytes, read live from the process metrics registry
        # (``zest_seed_bytes_total``, which BtServer bumps per upload), so
        # no plumbing runs between the server and whichever swarm or CLI
        # built this client; ``uploaded`` is an additive base for callers
        # with out-of-process counts.
        self.uploaded = 0

    def uploaded_total(self) -> int:
        """``uploaded`` base + the live seeding counter."""
        served = 0
        for m in telemetry.REGISTRY.metrics():
            if m.name == "zest_seed_bytes_total":
                served = int(sum(v for _labels, v in m.samples()))
                break
        return self.uploaded + served

    def announce_event(
        self,
        info_hash: bytes,
        port: int,
        event: Event = Event.NONE,
        **counters,
    ) -> AnnounceResponse:
        url = build_announce_url(
            self.announce_url, info_hash, self.peer_id, port,
            event=event, **counters,
        )
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                if not 200 <= r.status < 300:
                    raise TrackerError(f"tracker answered HTTP {r.status}")
                body = r.read()
        except (urllib.error.URLError, HTTPException, OSError,
                ValueError) as exc:
            # HTTPError (a non-2xx answer) is a URLError; ValueError is a
            # URL that urllib cannot open at all.
            raise TrackerError(f"tracker request failed: {exc}") from exc
        resp = parse_announce_response(body)
        self.last_interval = resp.interval
        return resp

    # ── PeerSource protocol ──

    def find_peers(self, info_hash: bytes) -> list[tuple[str, int]]:
        try:
            return self.announce_event(info_hash, self.listen_port,
                                       uploaded=self.uploaded_total()).peers
        except TrackerError:
            return []

    def announce(self, info_hash: bytes, port: int) -> None:
        try:
            self.announce_event(info_hash, port, Event.STARTED,
                                uploaded=self.uploaded_total())
        except TrackerError:
            pass  # announce is best-effort; CDN fallback keeps pulls alive
