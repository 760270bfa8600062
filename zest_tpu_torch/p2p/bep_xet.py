"""BEP XET extension messages: chunk-level xorb transfer over BEP 10.

The port's copy of ``zest_tpu/p2p/bep_xet.py``: byte-compatible with it,
with the reference (src/bep_xet.zig) and the BEP XET spec it implements; all messages ride on BEP 10 extended messages (msg_id=20,
ext name "ut_xet"):

    CHUNK_REQUEST  0x01: [1][4 req_id BE][32 hash][4 range_start BE][4 range_end BE] = 45B
    CHUNK_RESPONSE 0x02: [1][4 req_id BE][4 chunk_offset BE][4 len BE][data]
    CHUNK_NOT_FOUND 0x03: [1][4 req_id BE][32 hash] = 37B
    CHUNK_ERROR    0x04: [1][4 req_id BE][4 code BE][message]

The response's ``chunk_offset`` rebases the blob into the xorb's absolute
chunk index space (the range-aware partial-transfer mechanism,
SURVEY.md §5 "long-context" analog).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from zest_tpu_torch.p2p import bencode
from zest_tpu_torch.version import CLIENT_STRING

EXTENSION_NAME = b"ut_xet"

# CHUNK_ERROR codes the seeding tier emits (the wire format leaves
# codes free-form; these two are load-bearing for the requester's
# candidate handling — see transfer.swarm):
ERR_CHOKED = 1         # upload policy denied a slot — peer healthy, retry elsewhere
ERR_NOT_AVAILABLE = 2  # content refused (quarantined source) — loud, never served


class XetMessageError(ValueError):
    pass


@dataclass(frozen=True)
class ChunkRequest:
    request_id: int
    chunk_hash: bytes
    range_start: int
    range_end: int


@dataclass(frozen=True)
class ChunkResponse:
    request_id: int
    chunk_offset: int
    data: bytes


@dataclass(frozen=True)
class ChunkNotFound:
    request_id: int
    chunk_hash: bytes


@dataclass(frozen=True)
class ChunkError:
    request_id: int
    error_code: int
    message: bytes


XetMessage = ChunkRequest | ChunkResponse | ChunkNotFound | ChunkError


def encode_chunk_request(req: ChunkRequest) -> bytes:
    if len(req.chunk_hash) != 32:
        raise XetMessageError("chunk hash must be 32 bytes")
    return (
        b"\x01"
        + struct.pack(">I", req.request_id)
        + req.chunk_hash
        + struct.pack(">II", req.range_start, req.range_end)
    )


def encode_chunk_response(resp: ChunkResponse) -> bytes:
    return (
        b"\x02"
        + struct.pack(">III", resp.request_id, resp.chunk_offset, len(resp.data))
        + resp.data
    )


def encode_chunk_not_found(msg: ChunkNotFound) -> bytes:
    if len(msg.chunk_hash) != 32:
        raise XetMessageError("chunk hash must be 32 bytes")
    return b"\x03" + struct.pack(">I", msg.request_id) + msg.chunk_hash


def encode_chunk_error(msg: ChunkError) -> bytes:
    return (
        b"\x04"
        + struct.pack(">II", msg.request_id, msg.error_code)
        + msg.message
    )


def encode(msg: XetMessage) -> bytes:
    if isinstance(msg, ChunkRequest):
        return encode_chunk_request(msg)
    if isinstance(msg, ChunkResponse):
        return encode_chunk_response(msg)
    if isinstance(msg, ChunkNotFound):
        return encode_chunk_not_found(msg)
    if isinstance(msg, ChunkError):
        return encode_chunk_error(msg)
    raise XetMessageError(f"not a XET message: {type(msg).__name__}")


def decode(payload: bytes) -> XetMessage:
    """Decode one BEP XET sub-payload (reference: bep_xet.zig:129-175)."""
    if not payload:
        raise XetMessageError("empty payload")
    kind = payload[0]
    if kind == 0x01:
        if len(payload) != 45:
            raise XetMessageError(f"CHUNK_REQUEST must be 45 bytes, got {len(payload)}")
        req_id, = struct.unpack(">I", payload[1:5])
        start, end = struct.unpack(">II", payload[37:45])
        return ChunkRequest(req_id, payload[5:37], start, end)
    if kind == 0x02:
        if len(payload) < 13:
            raise XetMessageError("CHUNK_RESPONSE too short")
        req_id, offset, length = struct.unpack(">III", payload[1:13])
        data = payload[13:]
        if len(data) != length:
            raise XetMessageError(
                f"CHUNK_RESPONSE length field {length} != data {len(data)}"
            )
        return ChunkResponse(req_id, offset, data)
    if kind == 0x03:
        if len(payload) != 37:
            raise XetMessageError(f"CHUNK_NOT_FOUND must be 37 bytes, got {len(payload)}")
        req_id, = struct.unpack(">I", payload[1:5])
        return ChunkNotFound(req_id, payload[5:37])
    if kind == 0x04:
        if len(payload) < 9:
            raise XetMessageError("CHUNK_ERROR too short")
        req_id, code = struct.unpack(">II", payload[1:9])
        return ChunkError(req_id, code, payload[9:])
    raise XetMessageError(f"unknown XET message type 0x{kind:02x}")


def encode_framed(ext_id: int, msg: XetMessage) -> bytes:
    """Complete wire frame ([4 len][20][ext_id][XET payload]) for a
    message, ready for one send() call.

    Responses, requests and not-founds go through the native one-pass
    framer (``native/wire.cc``: the chunk data is copied exactly once
    instead of three times through the concat chain), byte-identical to
    ``wire.encode_extended(ext_id, encode(msg))``; a ``ChunkError`` takes
    that chain. Every guard the concat chain enforces is checked here
    BEFORE the native call: ctypes would silently truncate an
    out-of-range ext_id (c_uint8) or request_id (c_uint32) where the
    chain raises, and a silently corrupt frame desyncs the remote stream.
    """
    from zest_tpu_torch.native import lib
    from zest_tpu_torch.p2p import wire

    if not 0 <= ext_id <= 255:
        raise XetMessageError(f"ext_id {ext_id} out of range")
    if not 0 <= msg.request_id <= 0xFFFFFFFF:
        raise XetMessageError(f"request_id {msg.request_id} out of range")
    if isinstance(msg, (ChunkRequest, ChunkNotFound)) \
            and len(msg.chunk_hash) != 32:
        raise XetMessageError("chunk hash must be 32 bytes")

    if isinstance(msg, ChunkResponse):
        if not 0 <= msg.chunk_offset <= 0xFFFFFFFF:
            raise XetMessageError(
                f"chunk_offset {msg.chunk_offset} out of range")
        # Same cap the concat chain applies in wire.encode_message:
        # frame body = [20][ext][13-byte hdr + data].
        if 2 + 13 + len(msg.data) > wire.MAX_MESSAGE_SIZE:
            raise wire.WireError(
                f"message too large: {len(msg.data)} data bytes")
        return lib.frame_chunk_response(
            ext_id, msg.request_id, msg.chunk_offset, msg.data)
    if isinstance(msg, ChunkRequest):
        if not (0 <= msg.range_start <= 0xFFFFFFFF
                and 0 <= msg.range_end <= 0xFFFFFFFF):
            raise XetMessageError("chunk range out of range")
        return lib.frame_chunk_request(
            ext_id, msg.request_id, msg.chunk_hash,
            msg.range_start, msg.range_end)
    if isinstance(msg, ChunkNotFound):
        return lib.frame_chunk_not_found(
            ext_id, msg.request_id, msg.chunk_hash)
    return wire.encode_extended(ext_id, encode(msg))


# ── BEP 10 extended handshake (reference: bep_xet.zig:180-236) ──


@dataclass(frozen=True)
class ExtCapabilities:
    ut_xet_id: int | None
    listen_port: int | None
    client: bytes | None


def make_ext_handshake(ut_xet_id: int, listen_port: int | None = None) -> bytes:
    """``{"m":{"ut_xet":N},"p":port,"v":"zest-tpu/..."}`` bencoded."""
    doc: dict = {b"m": {EXTENSION_NAME: ut_xet_id}, b"v": CLIENT_STRING.encode()}
    if listen_port is not None:
        doc[b"p"] = listen_port
    return bencode.encode(doc)


def parse_ext_handshake(payload: bytes) -> ExtCapabilities:
    try:
        doc = bencode.decode(payload)
    except bencode.BencodeError as exc:
        raise XetMessageError(f"bad ext handshake: {exc}") from exc
    m = bencode.dict_get_dict(doc, b"m") or {}
    ut_xet = m.get(EXTENSION_NAME)
    return ExtCapabilities(
        ut_xet_id=ut_xet if isinstance(ut_xet, int) else None,
        listen_port=bencode.dict_get_int(doc, b"p"),
        client=bencode.dict_get_bytes(doc, b"v"),
    )
