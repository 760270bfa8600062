"""BitTorrent wire protocol framing (BEP 3 + BEP 10) — interop plane.

The port's copy of ``zest_tpu/p2p/wire.py``, byte for byte on the wire
(and so with the reference, src/bt_wire.zig): port hosts, JAX-package
hosts and reference/ccbittorrent clients join the same swarms:

    Handshake:  [1 pstrlen][19 "BitTorrent protocol"][8 reserved]
                [20 info_hash][20 peer_id]                       = 68 bytes
    Message:    [4 length BE][1 msg_id][payload...]
    Keepalive:  [4 zeros]
    Extended:   [4 length BE][1 msg_id=20][1 ext_id][payload...]

Reserved byte 5 bit 0x10 advertises BEP 10 support; max message size is
64 MiB + 1 KiB, matching the xorb cap (src/bt_wire.zig:19-22).

Pure codecs operate on bytes (testable fixed-buffer style, SURVEY.md §4);
``SocketStream`` adapts them to a blocking socket.
"""

from __future__ import annotations

import enum
import socket
import struct
from dataclasses import dataclass

PROTOCOL_STRING = b"BitTorrent protocol"
HANDSHAKE_SIZE = 68
RESERVED_BYTES = bytes([0, 0, 0, 0, 0, 0x10, 0, 0])
MAX_MESSAGE_SIZE = 64 * 1024 * 1024 + 1024


class WireError(ValueError):
    pass


class MessageId(enum.IntEnum):
    CHOKE = 0
    UNCHOKE = 1
    INTERESTED = 2
    NOT_INTERESTED = 3
    HAVE = 4
    BITFIELD = 5
    REQUEST = 6
    PIECE = 7
    CANCEL = 8
    EXTENDED = 20  # BEP 10


@dataclass(frozen=True)
class Handshake:
    info_hash: bytes
    peer_id: bytes
    reserved: bytes = RESERVED_BYTES

    @property
    def supports_bep10(self) -> bool:
        return bool(self.reserved[5] & 0x10)


# ── Pure codecs ──


def encode_handshake(info_hash: bytes, peer_id: bytes) -> bytes:
    if len(info_hash) != 20 or len(peer_id) != 20:
        raise WireError("info_hash and peer_id must be 20 bytes")
    return (
        bytes([len(PROTOCOL_STRING)]) + PROTOCOL_STRING + RESERVED_BYTES
        + info_hash + peer_id
    )


def decode_handshake(buf: bytes) -> Handshake:
    if len(buf) != HANDSHAKE_SIZE:
        raise WireError(f"handshake must be {HANDSHAKE_SIZE} bytes")
    if buf[0] != len(PROTOCOL_STRING) or buf[1:20] != PROTOCOL_STRING:
        raise WireError("invalid protocol string")
    return Handshake(
        info_hash=buf[28:48], peer_id=buf[48:68], reserved=buf[20:28]
    )


def encode_message(msg_id: MessageId, payload: bytes = b"") -> bytes:
    total = 1 + len(payload)
    if total > MAX_MESSAGE_SIZE:
        raise WireError(f"message too large: {total}")
    return struct.pack(">IB", total, int(msg_id)) + payload


def encode_keepalive() -> bytes:
    return b"\x00\x00\x00\x00"


def encode_extended(ext_id: int, payload: bytes) -> bytes:
    """BEP 10 framing: [len][20][ext_id][payload] (src/bt_wire.zig:136-146)."""
    return encode_message(MessageId.EXTENDED, bytes([ext_id]) + payload)


def parse_extended(payload: bytes) -> tuple[int, bytes]:
    """Split an EXTENDED message payload into (ext_id, sub-payload)."""
    if not payload:
        raise WireError("empty extended payload")
    return payload[0], payload[1:]


@dataclass(frozen=True)
class Message:
    """A decoded frame; ``msg_id is None`` for keepalives."""

    msg_id: MessageId | None
    payload: bytes = b""


def decode_message_header(header: bytes) -> int:
    """Parse the 4-byte length prefix; validates the size cap."""
    (length,) = struct.unpack(">I", header)
    if length > MAX_MESSAGE_SIZE:
        raise WireError(f"message length {length} exceeds cap")
    return length


# ── Socket adapter ──


class SocketStream:
    """Blocking framed stream over a TCP socket.

    One lock per direction is the caller's concern (``p2p.peer`` holds a
    per-peer mutex, mirroring src/bt_peer.zig:33-35).
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def shutdown(self) -> None:
        """End both directions: a thread blocked on this socket wakes
        with EOF or an error, and the descriptor stays open."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def close(self) -> None:
        self.shutdown()
        self.sock.close()

    def _recv_exactly(self, n: int) -> bytes:
        """``n`` bytes into one preallocated buffer: a whole xorb (up to
        64 MiB) arrives without a bytes object per ``recv``."""
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = self.sock.recv_into(view[got:])
            if not k:
                raise WireError("connection closed mid-frame")
            got += k
        view.release()
        return bytes(buf)

    # handshake

    def send_handshake(self, info_hash: bytes, peer_id: bytes) -> None:
        self.sock.sendall(encode_handshake(info_hash, peer_id))

    def recv_handshake(self) -> Handshake:
        return decode_handshake(self._recv_exactly(HANDSHAKE_SIZE))

    # messages

    def send_message(self, msg_id: MessageId, payload: bytes = b"") -> None:
        self.sock.sendall(encode_message(msg_id, payload))

    def send_raw(self, data: bytes) -> None:
        self.sock.sendall(data)

    def recv_message(self) -> Message:
        length = decode_message_header(self._recv_exactly(4))
        if length == 0:
            return Message(None)
        body = self._recv_exactly(length)
        try:
            msg_id = MessageId(body[0])
        except ValueError as exc:
            raise WireError(f"invalid message id {body[0]}") from exc
        return Message(msg_id, body[1:])
