"""The port's DCN chunk RPC is wire-compatible with the JAX package's.

- the codec writes the same bytes as ``zest_tpu.transfer.dcn`` for every
  message kind the port speaks, each side decodes the other's, and both
  refuse the same malformed input;
- over loopback, a port ``DcnPool`` fetches from a reference
  ``DcnServer`` and a reference ``DcnPool`` from a port ``DcnServer``,
  both serving one cache, with the same replies (``DcnResponse`` /
  ``DcnNotFound`` / ``DcnError``) as the same-package pairs;
- a cached entry over ``MAX_MESSAGE_SIZE`` is refused alike.
"""

from __future__ import annotations

import numpy as np
import pytest

from zest_tpu.config import Config as JConfig
from zest_tpu.p2p import wire as j_wire
from zest_tpu.transfer import dcn as j_dcn
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.xorb import XorbBuilder, XorbReader
from zest_tpu_torch.config import Config
from zest_tpu_torch.storage import XorbCache, atomic_write
from zest_tpu_torch.transfer import dcn

H = bytes(range(32))
MESSAGES = [
    ("request", dict(request_id=7, chunk_hash=H, range_start=3, range_end=9)),
    ("request", dict(request_id=0xFFFFFFFF, chunk_hash=H, range_start=0,
                     range_end=1, tag=513, flags=1)),
    ("response", dict(request_id=8, chunk_offset=2, data=b"framebytes")),
    ("response", dict(request_id=9, chunk_offset=0, data=b"", flags=1)),
    ("not_found", dict(request_id=10, chunk_hash=H)),
    ("error", dict(request_id=11, message="nope ✗")),
]
_KINDS = {"request": "DcnRequest", "response": "DcnResponse",
          "not_found": "DcnNotFound", "error": "DcnError"}


def _msg(mod, kind, fields):
    return getattr(mod, _KINDS[kind])(**fields)


def _split(encoded: bytes):
    return encoded[:dcn._HEADER.size], encoded[dcn._HEADER.size:]


@pytest.mark.parametrize("kind,fields", MESSAGES,
                         ids=[f"{k}{i}" for i, (k, _f) in enumerate(MESSAGES)])
def test_codec_bytes_identical_both_ways(kind, fields):
    mine = dcn.encode_message(_msg(dcn, kind, fields))
    ref = j_dcn.encode_message(_msg(j_dcn, kind, fields))
    assert mine == ref
    assert dcn.decode_message(*_split(ref)) == _msg(dcn, kind, fields)
    assert j_dcn.decode_message(*_split(mine)) == _msg(j_dcn, kind, fields)


def test_constants_match_reference():
    assert dcn.MAX_MESSAGE_SIZE == j_wire.MAX_MESSAGE_SIZE
    assert dcn._HELLO == j_dcn._HELLO
    assert dcn._TRACE_BLOCK.size == j_dcn._TRACE_BLOCK.size


def test_codec_rejects_what_reference_rejects():
    header, body = _split(dcn.encode_message(dcn.DcnRequest(1, H, 0, 4)))
    nf_header, nf_body = _split(dcn.encode_message(dcn.DcnNotFound(1, H)))
    bad_nf = (nf_header[:-4] + (20).to_bytes(4, "little"), nf_body[:20])
    for mod in (dcn, j_dcn):
        with pytest.raises(mod.DcnProtocolError):
            mod.decode_message(header, body[:-1])            # length
        with pytest.raises(mod.DcnProtocolError):
            mod.decode_message(bytes([99]) + header[1:], body)  # type
        with pytest.raises(mod.DcnProtocolError):
            mod.decode_message(*bad_nf)                      # short hash
        with pytest.raises(mod.DcnProtocolError):
            mod.encode_message(mod.DcnResponse(
                1, 0, bytes(dcn.MAX_MESSAGE_SIZE)))


# ── Loopback interop ──


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One cache dir served by a port and a reference server."""
    root = tmp_path_factory.mktemp("dcn")
    cfg = Config(hf_home=root / "hf", cache_dir=root / "zest", dcn_port=0)
    jcfg = JConfig(hf_home=root / "hf", cache_dir=root / "zest", dcn_port=0)
    rng = np.random.default_rng(5)
    builder = XorbBuilder()
    chunks = [rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
              for _ in range(6)]
    for c in chunks:
        builder.add_chunk(c)
    xh = builder.xorb_hash()
    XorbCache(cfg).put(hashing.hash_to_hex(xh), builder.serialize_full())
    single = b"single chunk payload" * 100
    atomic_write(cfg.chunk_cache_path(hashing.chunk_hash(single).hex()),
                 single)
    huge = hashing.blake3_hash(b"huge")
    XorbCache(cfg).put(hashing.hash_to_hex(huge),
                       bytes(dcn.MAX_MESSAGE_SIZE))
    servers = {"port": dcn.DcnServer(cfg), "ref": j_dcn.DcnServer(jcfg)}
    ports = {name: s.start() for name, s in servers.items()}
    wants = [
        (xh, 0, len(chunks)),                      # whole xorb
        (xh, 2, 5),                                # rebased sub-range
        (hashing.chunk_hash(single), 0, 1),        # chunk-cache tier
        (bytes(32), 0, 1),                         # not found
        (xh, 4, 4),                                # invalid range
        (huge, 0, 1),                              # over the message cap
    ]
    try:
        yield ports, wants, chunks
    finally:
        for s in servers.values():
            s.shutdown()


def _fetch(pool_mod, port, wants):
    pool = pool_mod.DcnPool(timeout=10.0)
    try:
        return pool.request_many("127.0.0.1", port, wants, timeout=10.0)
    finally:
        pool.close()


def _shape(reply):
    """A reply without its request id, as comparable plain data."""
    name = type(reply).__name__
    if name == "DcnResponse":
        return name, reply.chunk_offset, reply.data, reply.flags
    if name == "DcnNotFound":
        return name, reply.chunk_hash
    return name, reply.message


@pytest.mark.parametrize("client,server", [
    ("port", "ref"), ("ref", "port"), ("port", "port"), ("ref", "ref")])
def test_pools_interoperate(served, client, server):
    ports, wants, chunks = served
    got = [_shape(r) for r in _fetch(dcn if client == "port" else j_dcn,
                                     ports[server], wants)]
    want = [_shape(r) for r in _fetch(j_dcn, ports["ref"], wants)]
    assert got == want
    kinds = [g[0] for g in got]
    assert kinds == ["DcnResponse"] * 3 + ["DcnNotFound", "DcnError",
                                           "DcnError"]
    assert "over cap" in got[5][1]
    whole = XorbReader(got[0][2])
    assert [whole.extract_chunk(i) for i in range(len(chunks))] == chunks
    assert got[1][1] == 2 and len(XorbReader(got[1][2])) == 3


def test_port_channel_sees_reference_hello(served):
    ports, wants, _chunks = served
    ch = dcn.DcnChannel("127.0.0.1", ports["ref"])
    try:
        assert ch.hello_subversion == 2
        assert isinstance(ch.request_many(wants[:1])[0], dcn.DcnResponse)
    finally:
        ch.close()
