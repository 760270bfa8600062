"""The port's HTTP tracker client against the JAX package's.

``build_announce_url`` and ``parse_announce_response`` give the JAX
package's URLs, responses and error messages on seeded inputs, garbage
included; a live announce against a canned loopback tracker; transport
failures and non-2xx answers become ``TrackerError`` (``urllib``, where
the JAX package maps ``requests`` errors); and the announce's
``uploaded`` reads ``zest_seed_bytes_total`` after a real ``BtServer``
upload (mirrors tests/test_seeding.py's
``test_tracker_uploaded_counter_reads_seed_metric``).
"""

from __future__ import annotations

import ast
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import pytest

from tests.fixtures import FixtureRepo, _safetensors_blob
from zest_tpu.p2p import bencode as j_bencode
from zest_tpu.p2p import tracker as j_tracker
from zest_tpu_torch import storage, telemetry
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.config import Config
from zest_tpu_torch.p2p import bencode, tracker
from zest_tpu_torch.p2p import peer_id as peer_id_mod
from zest_tpu_torch.p2p.peer import BtPeer
from zest_tpu_torch.p2p.tracker import (
    AnnounceResponse,
    Event,
    TrackerClient,
    TrackerError,
    build_announce_url,
    parse_announce_response,
)
from zest_tpu_torch.transfer.server import BtServer

SEED = 20261017


def _compact(peers):
    return b"".join(socket.inet_aton(ip) + struct.pack(">H", port)
                    for ip, port in peers)


def _outcome(mod, body):
    try:
        r = mod.parse_announce_response(body)
    except mod.TrackerError as exc:
        return ("error", str(exc))
    return ("ok", r.interval, r.peers)


def _bodies(rng):
    """Valid responses, failure reasons, misaligned and garbage bodies."""
    out = []
    for _ in range(40):
        n = int(rng.integers(0, 8))
        peers = [(".".join(str(int(b)) for b in rng.integers(0, 256, 4)),
                  int(rng.integers(1, 65536))) for _ in range(n)]
        doc = {b"peers": _compact(peers)}
        if rng.random() < 0.7:
            doc[b"interval"] = int(rng.integers(0, 4000))
        out.append(bencode.encode(doc))
    out += [bencode.encode({b"failure reason": rng.bytes(12)}),
            bencode.encode({b"failure reason": b"unregistered torrent"}),
            bencode.encode({b"interval": 1, b"peers": b"x" * 7}),
            bencode.encode([b"not", b"a", b"dict"]),
            bencode.encode({b"interval": 5}),
            b"", b"d", b"d8:intervali", b"i-0e", b"l" * 600]
    out += [rng.bytes(int(rng.integers(1, 64))) for _ in range(20)]
    return out


def test_parse_announce_response_equals_reference():
    for body in _bodies(np.random.default_rng(SEED)):
        assert _outcome(tracker, body) == _outcome(j_tracker, body), body


def test_build_announce_url_equals_reference():
    rng = np.random.default_rng(SEED + 1)
    for i in range(60):
        base = ("http://t.example/announce", "http://t.example/a?k=1",
                "http://[::1]:8080/ann")[i % 3]
        ih, pid = rng.bytes(20), rng.bytes(20)
        port = int(rng.integers(0, 65536))
        kw = {"uploaded": int(rng.integers(0, 1 << 40)),
              "downloaded": int(rng.integers(0, 1 << 30)),
              "left": int(rng.integers(0, 1 << 20))}
        ev = list(Event)[i % 4]
        ours = build_announce_url(base, ih, pid, port, event=ev, **kw)
        theirs = j_tracker.build_announce_url(
            base, ih, pid, port, event=j_tracker.Event(ev.value), **kw)
        assert ours == theirs
    url = build_announce_url("http://t.example/announce", bytes(range(20)),
                             b"-ZE0200-abcdefghijkl", 6881,
                             event=Event.STARTED)
    assert "info_hash=%00%01%02" in url
    assert "event=started" in url and "compact=1" in url


def test_parse_roundtrip_and_typed_errors():
    peers = [("10.0.0.1", 6881), ("10.0.0.2", 6882)]
    body = bencode.encode({b"interval": 900, b"peers": _compact(peers)})
    assert parse_announce_response(body) == AnnounceResponse(900, peers)
    # Parsed by the JAX package's bencode too: one wire format.
    assert j_bencode.decode(body)[b"interval"] == 900
    with pytest.raises(TrackerError, match="unregistered"):
        parse_announce_response(
            bencode.encode({b"failure reason": b"unregistered torrent"}))
    with pytest.raises(TrackerError, match="6-aligned"):
        parse_announce_response(
            bencode.encode({b"interval": 1, b"peers": b"x" * 7}))


class _Canned:
    """A loopback tracker answering each GET with ``status`` and one peer,
    recording the request paths."""

    def __init__(self, status=200):
        self.seen = []
        owner = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                owner.seen.append(self.path)
                body = bencode.encode({
                    b"interval": 60,
                    b"peers": _compact([("127.0.0.1", 7777)])})
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/announce"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


@pytest.fixture
def canned():
    t = _Canned()
    yield t
    t.close()


def test_live_announce_and_peer_source(canned):
    client = TrackerClient(canned.url, b"-ZE0200-abcdefghijkl")
    resp = client.announce_event(b"\xab" * 20, 6881, Event.STARTED)
    assert resp.peers == [("127.0.0.1", 7777)]
    assert client.last_interval == 60
    assert "info_hash=%AB" in canned.seen[0]
    assert canned.seen[0] == "/announce?" + build_announce_url(
        canned.url, b"\xab" * 20, b"-ZE0200-abcdefghijkl", 6881,
        event=Event.STARTED).split("?", 1)[1]
    assert client.find_peers(b"\xab" * 20) == [("127.0.0.1", 7777)]
    client.announce(b"\xab" * 20, 6881)
    assert len(canned.seen) == 3


def test_transport_and_status_errors_are_tracker_errors():
    refused = TrackerClient("http://127.0.0.1:1/announce", b"p" * 20,
                            timeout=0.5)
    with pytest.raises(TrackerError, match="tracker request failed"):
        refused.announce_event(b"\x01" * 20, 1)
    assert refused.find_peers(b"\x01" * 20) == []
    refused.announce(b"\x01" * 20, 1)  # best-effort: no raise
    bad = _Canned(status=503)
    try:
        client = TrackerClient(bad.url, b"p" * 20, timeout=5)
        with pytest.raises(TrackerError, match="503"):
            client.announce_event(b"\x02" * 20, 1)
        assert client.find_peers(b"\x02" * 20) == []
    finally:
        bad.close()
    with pytest.raises(TrackerError):
        TrackerClient("not a url", b"p" * 20).announce_event(b"\x03" * 20, 1)


def test_tracker_uses_urllib_not_requests():
    tree = ast.parse(Path(tracker.__file__).read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert "requests" not in mods and "urllib" in mods


def test_uploaded_reads_seed_bytes_after_a_real_upload(canned, tmp_path):
    """A real upload from the port's ``BtServer`` bumps
    ``zest_seed_bytes_total``; the next announce carries it as
    ``uploaded``, on top of the additive base."""
    blob = _safetensors_blob({"w": np.random.default_rng(SEED).integers(
        0, 256, 300_000, dtype=np.uint8)})
    repo = FixtureRepo("acme/upload", {"model.safetensors": blob})
    key, fx = next(iter(repo.xorbs.items()))
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 listen_port=0)
    storage.XorbCache(cfg).put(key, fx.blob)
    client = TrackerClient(canned.url, b"p" * 20)
    base = client.uploaded_total()
    server = BtServer(cfg)
    port = server.start()
    try:
        xorb_hash = hashing.hex_to_hash(key)
        peer = BtPeer.connect("127.0.0.1", port,
                              peer_id_mod.compute_info_hash(xorb_hash),
                              peer_id_mod.generate())
        try:
            got = peer.request_chunk(xorb_hash, 0,
                                     len(fx.frame_offsets) - 1)
        finally:
            peer.close()
    finally:
        server.shutdown()
    served = server.get_stats().bytes_served
    assert served == len(got.data) > 0
    assert client.uploaded_total() == base + served
    seed_bytes = {m.name: m for m in telemetry.REGISTRY.metrics()}[
        "zest_seed_bytes_total"]
    assert {"peer_state": "reciprocal"} in [
        labels for labels, _ in seed_bytes.samples()]
    client.uploaded = 79  # an out-of-process base stays additive
    client.announce(b"\xcd" * 20, 6881)
    assert f"uploaded={base + served + 79}" in canned.seen[-1]
    assert "event=started" in canned.seen[-1]
