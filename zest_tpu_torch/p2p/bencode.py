"""Strict bencode codec (BEP 3 metadata encoding).

The port's copy of ``zest_tpu/p2p/bencode.py``. Used by the BT wire only:
BEP 10 extended handshakes (and, once ported, KRPC and tracker
responses). bencode exists for wire compatibility with BitTorrent peers
(reference behavior: src/bencode.zig:35-183; strictness rules verified by
its tests at src/bencode.zig:269-345).

Strictness on decode, matching the reference:
  - integers: no leading zeros (except ``i0e``), no negative zero
  - dict keys: byte strings, strictly sorted ascending, no duplicates
  - no trailing bytes after the top-level value
"""

from __future__ import annotations

Value = int | bytes | list["Value"] | dict[bytes, "Value"]

# Nesting cap so hostile input (e.g. b"d"*10000 from an untrusted DHT packet)
# raises BencodeError instead of blowing the interpreter recursion limit.
MAX_DEPTH = 128


class BencodeError(ValueError):
    pass


# ── Encoding ──


def encode(value) -> bytes:
    out = bytearray()
    _encode_into(value, out)
    return bytes(out)


def _encode_into(value, out: bytearray) -> None:
    if isinstance(value, bool):
        raise BencodeError("booleans are not bencodable")
    if isinstance(value, int):
        out += b"i%de" % value
    elif isinstance(value, (bytes, bytearray, memoryview)):
        b = bytes(value)
        out += b"%d:" % len(b)
        out += b
    elif isinstance(value, str):
        _encode_into(value.encode(), out)
    elif isinstance(value, (list, tuple)):
        out += b"l"
        for item in value:
            _encode_into(item, out)
        out += b"e"
    elif isinstance(value, dict):
        out += b"d"
        keys = sorted(k.encode() if isinstance(k, str) else bytes(k) for k in value)
        if len(set(keys)) != len(keys):
            raise BencodeError("duplicate dict keys")
        by_bytes = {
            (k.encode() if isinstance(k, str) else bytes(k)): v
            for k, v in value.items()
        }
        for k in keys:
            _encode_into(k, out)
            _encode_into(by_bytes[k], out)
        out += b"e"
    else:
        raise BencodeError(f"cannot bencode {type(value).__name__}")


# ── Decoding ──


def decode(data: bytes) -> Value:
    """Decode a single bencoded value; reject trailing bytes."""
    value, pos = _decode_at(data, 0)
    if pos != len(data):
        raise BencodeError(f"trailing bytes after value at offset {pos}")
    return value


def decode_prefix(data: bytes) -> tuple[Value, int]:
    """Decode one value from the front of ``data``; return (value, bytes consumed)."""
    return _decode_at(data, 0)


def _decode_at(data: bytes, pos: int, depth: int = 0) -> tuple[Value, int]:
    if depth > MAX_DEPTH:
        raise BencodeError(f"nesting deeper than {MAX_DEPTH}")
    if pos >= len(data):
        raise BencodeError("unexpected end of input")
    c = data[pos]
    if c == ord(b"i"):
        end = data.find(b"e", pos)
        if end < 0:
            raise BencodeError("unterminated integer")
        body = data[pos + 1 : end]
        _validate_int(body)
        return int(body), end + 1
    if c == ord(b"l"):
        pos += 1
        items: list[Value] = []
        while True:
            if pos >= len(data):
                raise BencodeError("unterminated list")
            if data[pos] == ord(b"e"):
                return items, pos + 1
            item, pos = _decode_at(data, pos, depth + 1)
            items.append(item)
    if c == ord(b"d"):
        pos += 1
        d: dict[bytes, Value] = {}
        prev_key: bytes | None = None
        while True:
            if pos >= len(data):
                raise BencodeError("unterminated dict")
            if data[pos] == ord(b"e"):
                return d, pos + 1
            key, pos = _decode_at(data, pos, depth + 1)
            if not isinstance(key, bytes):
                raise BencodeError("dict key is not a string")
            if prev_key is not None and key <= prev_key:
                raise BencodeError("dict keys not strictly sorted")
            prev_key = key
            value, pos = _decode_at(data, pos, depth + 1)
            d[key] = value
    if ord(b"0") <= c <= ord(b"9"):
        colon = data.find(b":", pos)
        if colon < 0:
            raise BencodeError("unterminated string length")
        length_body = data[pos:colon]
        if not length_body.isdigit():
            raise BencodeError(f"invalid string length {length_body!r}")
        if len(length_body) > 1 and length_body[0] == ord(b"0"):
            raise BencodeError("string length has leading zero")
        length = int(length_body)
        start = colon + 1
        if start + length > len(data):
            raise BencodeError("string extends past end of input")
        return data[start : start + length], start + length
    raise BencodeError(f"invalid type byte {bytes([c])!r} at offset {pos}")


def _validate_int(body: bytes) -> None:
    if not body:
        raise BencodeError("empty integer")
    digits = body[1:] if body[:1] == b"-" else body
    if not digits or not digits.isdigit():
        raise BencodeError(f"invalid integer {body!r}")
    if body == b"-0":
        raise BencodeError("negative zero")
    if len(digits) > 1 and digits[0] == ord(b"0"):
        raise BencodeError("integer has leading zero")


# ── Typed dict lookups (reference: src/bencode.zig:188-220) ──


def dict_get_int(d: Value, key: bytes) -> int | None:
    if isinstance(d, dict):
        v = d.get(key)
        if isinstance(v, int):
            return v
    return None


def dict_get_bytes(d: Value, key: bytes) -> bytes | None:
    if isinstance(d, dict):
        v = d.get(key)
        if isinstance(v, bytes):
            return v
    return None


def dict_get_dict(d: Value, key: bytes) -> dict | None:
    if isinstance(d, dict):
        v = d.get(key)
        if isinstance(v, dict):
            return v
    return None


def dict_get_list(d: Value, key: bytes) -> list | None:
    if isinstance(d, dict):
        v = d.get(key)
        if isinstance(v, list):
            return v
    return None
