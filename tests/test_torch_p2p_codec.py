"""The port's BT-wire codecs against the JAX package's, on the CPU.

Mirrors tests/test_bencode.py, test_peer_id.py and test_wire.py on
``zest_tpu_torch.p2p`` and holds the two packages byte-equal: seeded
values bencode to the same bytes, every frame (handshake, plain message,
extended, each BEP XET kind, framed natively or by the concat chain)
encodes to the same bytes, and hostile input raises the same error types
in both. A response frame exactly at ``MAX_MESSAGE_SIZE`` encodes and
decodes; one byte past it raises on the sending and on the receiving
side.
"""

from __future__ import annotations

import hashlib
import socket
import threading

import numpy as np
import pytest

from zest_tpu.p2p import bencode as j_bencode
from zest_tpu.p2p import bep_xet as j_bep_xet
from zest_tpu.p2p import peer_id as j_peer_id
from zest_tpu.p2p import wire as j_wire
from zest_tpu_torch.p2p import bencode, bep_xet, peer_id, wire
from zest_tpu_torch.p2p.bencode import BencodeError
from zest_tpu_torch.p2p.bep_xet import (
    ChunkError,
    ChunkNotFound,
    ChunkRequest,
    ChunkResponse,
)


def _rng(seed=0):
    return np.random.default_rng(seed)


# ── bencode (mirrors tests/test_bencode.py) ──


class TestEncode:
    def test_int(self):
        assert bencode.encode(42) == b"i42e"
        assert bencode.encode(0) == b"i0e"
        assert bencode.encode(-7) == b"i-7e"

    def test_string(self):
        assert bencode.encode(b"spam") == b"4:spam"
        assert bencode.encode("spam") == b"4:spam"
        assert bencode.encode(b"") == b"0:"

    def test_list(self):
        assert bencode.encode([b"spam", 42]) == b"l4:spami42ee"
        assert bencode.encode([]) == b"le"

    def test_dict_keys_sorted(self):
        assert bencode.encode({b"b": 2, b"a": 1}) == b"d1:ai1e1:bi2ee"

    def test_nested(self):
        assert (bencode.encode({b"m": {b"ut_xet": 3}, b"p": 6881})
                == b"d1:md6:ut_xeti3ee1:pi6881ee")

    def test_bool_rejected(self):
        with pytest.raises(BencodeError):
            bencode.encode(True)


class TestDecode:
    def test_roundtrip(self):
        for v in [0, -123, b"hello", [b"a", [1, 2]], {b"k": {b"n": [b"x"]}}]:
            assert bencode.decode(bencode.encode(v)) == v

    def test_leading_zero_int_rejected(self):
        with pytest.raises(BencodeError):
            bencode.decode(b"i042e")

    def test_negative_zero_rejected(self):
        with pytest.raises(BencodeError):
            bencode.decode(b"i-0e")

    def test_zero_ok(self):
        assert bencode.decode(b"i0e") == 0

    def test_unsorted_dict_keys_rejected(self):
        with pytest.raises(BencodeError):
            bencode.decode(b"d1:bi1e1:ai2ee")

    def test_duplicate_dict_keys_rejected(self):
        with pytest.raises(BencodeError):
            bencode.decode(b"d1:ai1e1:ai2ee")

    def test_trailing_bytes_rejected(self):
        with pytest.raises(BencodeError):
            bencode.decode(b"i1eX")

    def test_truncated_string_rejected(self):
        with pytest.raises(BencodeError):
            bencode.decode(b"10:short")

    def test_leading_zero_strlen_rejected(self):
        with pytest.raises(BencodeError):
            bencode.decode(b"04:spam")

    def test_unterminated_rejected(self):
        for bad in [b"i42", b"l1:a", b"d1:ai1e", b""]:
            with pytest.raises(BencodeError):
                bencode.decode(bad)

    def test_hostile_deep_nesting_rejected(self):
        # Untrusted input must never escape BencodeError (a RecursionError
        # would crash the handler).
        with pytest.raises(BencodeError):
            bencode.decode(b"l" * 10_000)
        with pytest.raises(BencodeError):
            bencode.decode(b"d" * 10_000)

    def test_nondigit_string_length_rejected(self):
        with pytest.raises(BencodeError):
            bencode.decode(b"1a:x")

    def test_prefix_decode(self):
        value, n = bencode.decode_prefix(b"i42eTRAILER")
        assert value == 42 and n == 4


class TestDictHelpers:
    def test_typed_lookups(self):
        d = bencode.decode(b"d1:ii7e1:ll1:xe1:s3:abce")
        assert bencode.dict_get_int(d, b"i") == 7
        assert bencode.dict_get_bytes(d, b"s") == b"abc"
        assert bencode.dict_get_list(d, b"l") == [b"x"]
        assert bencode.dict_get_int(d, b"s") is None
        assert bencode.dict_get_dict(d, b"missing") is None


def _random_value(rng, depth=0):
    kind = rng.integers(0, 4 if depth < 4 else 2)
    if kind == 0:
        return int(rng.integers(-2**40, 2**40))
    if kind == 1:
        return rng.bytes(int(rng.integers(0, 40)))
    if kind == 2:
        return [_random_value(rng, depth + 1)
                for _ in range(int(rng.integers(0, 5)))]
    return {rng.bytes(int(rng.integers(1, 8))): _random_value(rng, depth + 1)
            for _ in range(int(rng.integers(0, 5)))}


@pytest.mark.parametrize("seed", range(8))
def test_bencode_bytes_equal_reference(seed):
    rng = _rng(seed)
    for _ in range(40):
        v = _random_value(rng)
        enc = bencode.encode(v)
        assert enc == j_bencode.encode(v)
        assert bencode.decode(enc) == j_bencode.decode(enc) == v
        assert bencode.decode_prefix(enc + b"tail") == \
            j_bencode.decode_prefix(enc + b"tail")


HOSTILE = [b"", b"i42", b"i042e", b"i-0e", b"ie", b"i-e", b"l1:a", b"d1:ai1e",
           b"d1:bi1e1:ai2ee", b"d1:ai1e1:ai2ee", b"di1ei2ee", b"10:short",
           b"04:spam", b"1a:x", b"i1eX", b"x", b"l" * 10_000, b"d" * 10_000,
           b"l" * 130 + b"e" * 130]


@pytest.mark.parametrize("bad", HOSTILE, ids=range(len(HOSTILE)))
def test_hostile_bencode_raises_like_reference(bad):
    with pytest.raises(j_bencode.BencodeError) as theirs:
        j_bencode.decode(bad)
    with pytest.raises(BencodeError) as mine:
        bencode.decode(bad)
    assert str(mine.value) == str(theirs.value)


def test_bencode_error_is_a_value_error():
    assert issubclass(BencodeError, ValueError)
    assert issubclass(wire.WireError, ValueError)
    assert issubclass(bep_xet.XetMessageError, ValueError)


# ── peer_id (mirrors tests/test_peer_id.py) ──


def test_peer_id_prefix_and_length():
    pid = peer_id.generate()
    assert len(pid) == 20
    assert pid.startswith(b"-ZT0100-")
    assert pid[:8] == j_peer_id.generate()[:8]


def test_peer_ids_differ():
    assert peer_id.generate() != peer_id.generate()


def test_info_hash_deterministic():
    h = bytes(range(32))
    a = peer_id.compute_info_hash(h)
    assert a == peer_id.compute_info_hash(h) and len(a) == 20


def test_info_hash_domain_separation():
    h = b"\xab" * 32
    expected = hashlib.sha1(b"zest-xet-v1:" + h).digest()
    assert peer_id.compute_info_hash(h) == expected


@pytest.mark.parametrize("seed", range(4))
def test_info_hash_equals_reference(seed):
    h = _rng(seed).bytes(32)
    assert peer_id.compute_info_hash(h) == j_peer_id.compute_info_hash(h)


def test_info_hash_rejects_bad_length():
    with pytest.raises(ValueError):
        peer_id.compute_info_hash(b"short")


# ── wire + BEP XET (mirrors tests/test_wire.py) ──


class TestHandshake:
    def test_roundtrip(self):
        rng = _rng(1)
        ih, pid = rng.bytes(20), rng.bytes(20)
        buf = wire.encode_handshake(ih, pid)
        assert len(buf) == 68
        hs = wire.decode_handshake(buf)
        assert hs.info_hash == ih and hs.peer_id == pid
        assert hs.supports_bep10

    def test_wire_layout(self):
        buf = wire.encode_handshake(b"\x01" * 20, b"\x02" * 20)
        assert buf[0] == 19
        assert buf[1:20] == b"BitTorrent protocol"
        assert buf[25] == 0x10  # reserved byte 5: BEP 10 bit

    def test_bad_protocol_string_rejected(self):
        buf = bytearray(wire.encode_handshake(b"\x01" * 20, b"\x02" * 20))
        buf[5] ^= 0xFF
        with pytest.raises(wire.WireError):
            wire.decode_handshake(bytes(buf))

    def test_bad_length_rejected(self):
        with pytest.raises(wire.WireError):
            wire.decode_handshake(b"short")
        with pytest.raises(wire.WireError):
            wire.encode_handshake(b"short", b"\x02" * 20)


class TestFraming:
    def test_message_layout(self):
        assert wire.encode_message(wire.MessageId.UNCHOKE) == \
            b"\x00\x00\x00\x01\x01"

    def test_extended_layout(self):
        buf = wire.encode_extended(3, b"payload")
        assert buf[:4] == (2 + 7).to_bytes(4, "big")
        assert buf[4] == 20 and buf[5] == 3
        assert buf[6:] == b"payload"

    def test_keepalive(self):
        assert wire.encode_keepalive() == b"\x00" * 4

    def test_size_cap(self):
        with pytest.raises(wire.WireError):
            wire.decode_message_header(
                (wire.MAX_MESSAGE_SIZE + 1).to_bytes(4, "big"))

    def test_parse_extended(self):
        ext_id, payload = wire.parse_extended(b"\x07hello")
        assert ext_id == 7 and payload == b"hello"
        with pytest.raises(wire.WireError):
            wire.parse_extended(b"")


class TestXetMessages:
    def test_chunk_request_45_bytes(self):
        h = _rng(2).bytes(32)
        buf = bep_xet.encode(ChunkRequest(7, h, 3, 9))
        assert len(buf) == 45 and buf[0] == 0x01
        assert bep_xet.decode(buf) == ChunkRequest(7, h, 3, 9)

    def test_chunk_response_roundtrip(self):
        data = _rng(3).bytes(5000)
        buf = bep_xet.encode(ChunkResponse(9, 12, data))
        assert bep_xet.decode(buf) == ChunkResponse(9, 12, data)
        assert buf[0] == 0x02 and len(buf) == 13 + len(data)

    def test_chunk_not_found_37_bytes(self):
        h = _rng(4).bytes(32)
        buf = bep_xet.encode(ChunkNotFound(4, h))
        assert len(buf) == 37 and buf[0] == 0x03
        assert bep_xet.decode(buf) == ChunkNotFound(4, h)

    def test_chunk_error_roundtrip(self):
        buf = bep_xet.encode(ChunkError(2, 500, b"boom"))
        assert buf[0] == 0x04
        assert bep_xet.decode(buf) == ChunkError(2, 500, b"boom")

    def test_length_field_mismatch_rejected(self):
        buf = bytearray(bep_xet.encode(ChunkResponse(1, 0, b"abc")))
        buf += b"EXTRA"
        with pytest.raises(bep_xet.XetMessageError):
            bep_xet.decode(bytes(buf))

    def test_unknown_type_rejected(self):
        with pytest.raises(bep_xet.XetMessageError):
            bep_xet.decode(b"\x99" + b"\x00" * 44)

    def test_truncated_rejected(self):
        for bad in [b"", b"\x01short", b"\x02\x00\x00"]:
            with pytest.raises(bep_xet.XetMessageError):
                bep_xet.decode(bad)


class TestExtHandshake:
    def test_roundtrip(self):
        buf = bep_xet.make_ext_handshake(3, listen_port=6881)
        caps = bep_xet.parse_ext_handshake(buf)
        assert caps.ut_xet_id == 3
        assert caps.listen_port == 6881
        assert caps.client and caps.client.startswith(b"zest-tpu/")

    def test_no_ut_xet(self):
        caps = bep_xet.parse_ext_handshake(
            bencode.encode({b"m": {b"ut_other": 1}, b"v": b"x"}))
        assert caps.ut_xet_id is None

    def test_garbage_rejected(self):
        with pytest.raises(bep_xet.XetMessageError):
            bep_xet.parse_ext_handshake(b"not bencode at all \xff")


def test_encode_framed_matches_concat_chain():
    """The native framer is byte-identical to
    ``wire.encode_extended(ext, bep_xet.encode(msg))`` for every kind it
    frames, and decodes back to the message."""
    h = bytes(range(32))
    msgs = [ChunkRequest(0xABCDEF01, h, 3, 900),
            ChunkResponse(7, 12, b"\x00\x01" * 40_000),
            ChunkResponse(8, 0, b""),
            ChunkNotFound(0xFFFFFFFF, h)]
    for m in msgs:
        framed = bep_xet.encode_framed(9, m)
        assert framed == wire.encode_extended(9, bep_xet.encode(m)), \
            type(m).__name__
        assert wire.decode_message_header(framed[:4]) == len(framed) - 4
        ext_id, sub = wire.parse_extended(framed[5:])
        assert ext_id == 9
        assert bep_xet.decode(sub) == m


def test_encode_framed_error_takes_the_concat_chain():
    m = ChunkError(3, 42, b"boom")
    assert bep_xet.encode_framed(5, m) == wire.encode_extended(
        5, bep_xet.encode(m))


def test_encode_framed_validates_hash_length():
    with pytest.raises(bep_xet.XetMessageError):
        bep_xet.encode_framed(1, ChunkRequest(1, b"short", 0, 1))


def test_encode_framed_rejects_out_of_range_fields():
    """ctypes would silently truncate (c_uint8(300) → 44) where the
    concat chain raises: the framed encoder fails loudly first."""
    h = bytes(32)
    with pytest.raises(bep_xet.XetMessageError, match="ext_id"):
        bep_xet.encode_framed(300, ChunkNotFound(1, h))
    with pytest.raises(bep_xet.XetMessageError, match="request_id"):
        bep_xet.encode_framed(1, ChunkNotFound(-1, h))
    with pytest.raises(bep_xet.XetMessageError, match="request_id"):
        bep_xet.encode_framed(1, ChunkNotFound(1 << 32, h))
    with pytest.raises(bep_xet.XetMessageError, match="chunk_offset"):
        bep_xet.encode_framed(1, ChunkResponse(1, -5, b"x"))
    with pytest.raises(bep_xet.XetMessageError, match="range"):
        bep_xet.encode_framed(1, ChunkRequest(1, h, 0, 1 << 33))


def test_encode_framed_enforces_message_cap(monkeypatch):
    monkeypatch.setattr(wire, "MAX_MESSAGE_SIZE", 1024)
    with pytest.raises(wire.WireError, match="too large"):
        bep_xet.encode_framed(1, ChunkResponse(1, 0, b"x" * 2048))


# ── Byte parity with the JAX package's codecs ──


def _messages(rng):
    h = rng.bytes(32)
    req_id = int(rng.integers(0, 2**32))
    return [
        ChunkRequest(req_id, h, int(rng.integers(0, 1000)),
                     int(rng.integers(1000, 2**32))),
        ChunkResponse(req_id, int(rng.integers(0, 2**32)),
                      rng.bytes(int(rng.integers(0, 70_000)))),
        ChunkResponse(req_id, 0, b""),
        ChunkNotFound(req_id, h),
        ChunkError(req_id, int(rng.integers(0, 2**32)),
                   rng.bytes(int(rng.integers(0, 30)))),
    ]


def _theirs(m):
    return getattr(j_bep_xet, type(m).__name__)(
        *[getattr(m, f) for f in m.__dataclass_fields__])


@pytest.mark.parametrize("seed", range(6))
def test_frames_byte_equal_reference(seed):
    rng = _rng(100 + seed)
    ih, pid = rng.bytes(20), rng.bytes(20)
    assert wire.encode_handshake(ih, pid) == j_wire.encode_handshake(ih, pid)
    for mid in wire.MessageId:
        payload = rng.bytes(int(rng.integers(0, 64)))
        assert wire.encode_message(mid, payload) == \
            j_wire.encode_message(j_wire.MessageId(int(mid)), payload)
    ext = int(rng.integers(0, 256))
    port = int(rng.integers(0, 65536))
    assert bep_xet.make_ext_handshake(ext, port) == \
        j_bep_xet.make_ext_handshake(ext, port)
    for m in _messages(rng):
        assert bep_xet.encode(m) == j_bep_xet.encode(_theirs(m))
        framed = bep_xet.encode_framed(ext, m)
        assert framed == j_bep_xet.encode_framed(ext, _theirs(m))
        sub = framed[6:]
        assert bep_xet.decode(sub) == m
        assert j_bep_xet.decode(sub) == _theirs(m)


HOSTILE_XET = [b"", b"\x01short", b"\x02\x00\x00", b"\x99" + b"\x00" * 44,
               b"\x03" + b"\x00" * 30, b"\x04\x00",
               bytes(bep_xet.encode(ChunkResponse(1, 0, b"abc"))) + b"X"]


@pytest.mark.parametrize("bad", HOSTILE_XET, ids=range(len(HOSTILE_XET)))
def test_hostile_xet_raises_like_reference(bad):
    with pytest.raises(j_bep_xet.XetMessageError) as theirs:
        j_bep_xet.decode(bad)
    with pytest.raises(bep_xet.XetMessageError) as mine:
        bep_xet.decode(bad)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("bad", [b"short", b"\x13" + b"x" * 67,
                                 b"\x13BitTorrent protocoX" + b"\x00" * 48])
def test_hostile_handshake_raises_like_reference(bad):
    with pytest.raises(j_wire.WireError):
        j_wire.decode_handshake(bad)
    with pytest.raises(wire.WireError):
        wire.decode_handshake(bad)


# ── The message cap, on both sides ──


def test_response_at_the_cap_encodes_and_one_past_raises():
    """A whole xorb of the largest size the wire carries: the frame body
    is [20][ext][13-byte header + data], so MAX - 15 data bytes reach the
    cap exactly. One more byte raises on the sending side, and a length
    prefix one past the cap raises on the receiving side."""
    data = b"\xa5" * (wire.MAX_MESSAGE_SIZE - 15)
    framed = bep_xet.encode_framed(3, ChunkResponse(1, 0, data))
    assert wire.decode_message_header(framed[:4]) == wire.MAX_MESSAGE_SIZE
    assert j_wire.decode_message_header(framed[:4]) == wire.MAX_MESSAGE_SIZE
    del framed
    with pytest.raises(wire.WireError, match="too large"):
        bep_xet.encode_framed(3, ChunkResponse(1, 0, data + b"\x00"))
    with pytest.raises(wire.WireError, match="too large"):
        wire.encode_message(wire.MessageId.EXTENDED,
                            b"\x00" * wire.MAX_MESSAGE_SIZE)
    past = (wire.MAX_MESSAGE_SIZE + 1).to_bytes(4, "big")
    with pytest.raises(wire.WireError):
        wire.decode_message_header(past)
    with pytest.raises(j_wire.WireError):
        j_wire.decode_message_header(past)


def test_socket_stream_reads_a_frame_at_the_cap():
    """``SocketStream`` (one preallocated buffer per frame) receives a
    frame at the cap whole, and a prefix past it raises before any body
    byte is read."""
    a, b = socket.socketpair()
    data = bytes(range(256)) * ((wire.MAX_MESSAGE_SIZE - 15) // 256)
    data += b"\x07" * (wire.MAX_MESSAGE_SIZE - 15 - len(data))
    framed = bep_xet.encode_framed(3, ChunkResponse(5, 2, data))
    sender = threading.Thread(target=a.sendall, args=(framed,))
    sender.start()
    try:
        msg = wire.SocketStream(b).recv_message()
        sender.join()
        assert msg.msg_id == wire.MessageId.EXTENDED
        ext_id, sub = wire.parse_extended(msg.payload)
        assert ext_id == 3
        got = bep_xet.decode(sub)
        assert (got.request_id, got.chunk_offset) == (5, 2)
        assert got.data == data
        a.sendall((wire.MAX_MESSAGE_SIZE + 1).to_bytes(4, "big"))
        with pytest.raises(wire.WireError, match="exceeds cap"):
            wire.SocketStream(b).recv_message()
    finally:
        a.close()
        b.close()
