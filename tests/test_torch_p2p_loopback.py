"""The port's peer tier over loopback, and interop with the JAX package.

Mirrors tests/test_p2p_loopback.py on ``zest_tpu_torch``: a seeder (a
``BtServer`` over a warm cache) and a leecher (``pull_model(device=
"cpu")`` with a direct peer) in one process, the raw peer protocol
(handshake, whole and sliced ranges, not-found, the chunk-cache tier,
pipelining), seed-while-downloading and a dead peer. The checkpoint is a
valid safetensors file holding seeded random bytes (stored chunks), since
the port's pull always lands.

Interop both ways: the port's ``BtServer`` serves the JAX package's
``BtPeer`` and ``SwarmDownloader`` (its pull lands the same files), and
the JAX package's ``BtServer`` serves the port's, with the same payload
bytes.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.fixtures import FixtureHub, FixtureRepo, _safetensors_blob
from zest_tpu import storage as j_storage
from zest_tpu.config import Config as JConfig
from zest_tpu.p2p import peer_id as j_peer_id
from zest_tpu.p2p.peer import BtPeer as JBtPeer
from zest_tpu.p2p.peer import ChunkNotFoundError as JChunkNotFoundError
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer.server import BtServer as JBtServer
from zest_tpu.transfer.swarm import SwarmDownloader as JSwarmDownloader
from zest_tpu_torch import faults, storage
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.xorb import XorbReader
from zest_tpu_torch.config import Config
from zest_tpu_torch.p2p import peer_id as peer_id_mod
from zest_tpu_torch.p2p.health import PROVENANCE
from zest_tpu_torch.p2p.peer import BtPeer, ChunkNotFoundError
from zest_tpu_torch.transfer.pull import pull_model
from zest_tpu_torch.transfer.server import BtServer
from zest_tpu_torch.transfer.swarm import SwarmDownloader

REPO = "acme/p2p-model"
FILES = {
    "config.json": b'{"model_type": "loopback"}',
    "model.safetensors": _safetensors_blob({"w": np.random.default_rng(
        11).integers(0, 256, 500_000, dtype=np.uint8)}),
}


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO, FILES, chunks_per_xorb=2)) as h:
        yield h


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.install(None)
    PROVENANCE.reset()
    yield
    faults.install(None)
    PROVENANCE.reset()


def _cfg(hub, root, listen_port=0):
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url,
                  listen_port=listen_port)


def _jcfg(hub, root):
    return JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                   hf_token="hf_test", endpoint=hub.url, listen_port=0)


@pytest.fixture
def seeder(hub, tmp_path):
    """A port host that pulled from the CDN and now serves its cache."""
    cfg = _cfg(hub, tmp_path / "seeder")
    pull_model(cfg, REPO, device="cpu", no_p2p=True, log=_quiet)
    server = BtServer(cfg)
    port = server.start()
    yield cfg, port
    server.shutdown()


def _connect(port, xorb_hash, cls=BtPeer, ids=peer_id_mod):
    return cls.connect("127.0.0.1", port,
                       ids.compute_info_hash(xorb_hash), ids.generate())


def _assert_files(res):
    for name, data in FILES.items():
        assert (res.snapshot_dir / name).read_bytes() == data, name


class TestRawPeerProtocol:
    def test_handshake_and_chunk_fetch(self, seeder):
        seeder_cfg, port = seeder
        cached = storage.list_cached_xorbs(seeder_cfg)
        assert cached
        xorb_hash = hashing.hex_to_hash(cached[0])
        peer = _connect(port, xorb_hash)
        try:
            blob = storage.XorbCache(seeder_cfg).get(cached[0])
            result = peer.request_chunk(xorb_hash, 0, len(XorbReader(blob)))
            assert result.chunk_offset == 0
            assert result.data == blob
        finally:
            peer.close()

    def test_range_request_gets_sliced_frames(self, seeder):
        seeder_cfg, port = seeder
        cached = storage.list_cached_xorbs(seeder_cfg)
        key = next(k for k in cached if len(XorbReader(
            storage.XorbCache(seeder_cfg).get(k))) >= 2)
        xorb_hash = hashing.hex_to_hash(key)
        peer = _connect(port, xorb_hash)
        try:
            result = peer.request_chunk(xorb_hash, 1, 2)
            assert result.chunk_offset == 1
            reader = XorbReader(result.data)
            assert len(reader) == 1
            full = XorbReader(storage.XorbCache(seeder_cfg).get(key))
            assert reader.extract_chunk(0) == full.extract_chunk(1)
        finally:
            peer.close()

    def test_unknown_chunk_not_found(self, seeder):
        _, port = seeder
        missing = np.random.default_rng(1).bytes(32)
        peer = _connect(port, missing)
        try:
            with pytest.raises(ChunkNotFoundError):
                peer.request_chunk(missing, 0, 1)
        finally:
            peer.close()

    def test_chunk_cache_tier_served_as_frame_stream(self, seeder):
        """Chunk-cache responses are parseable frame streams, the shape of
        every other waterfall tier."""
        seeder_cfg, port = seeder
        chunk = np.random.default_rng(2).bytes(4000)
        h = hashing.chunk_hash(chunk)
        storage.atomic_write(seeder_cfg.chunk_cache_path(h.hex()), chunk)
        peer = _connect(port, h)
        try:
            reader = XorbReader(peer.request_chunk(h, 0, 1).data)
            assert len(reader) == 1
            assert reader.extract_chunk(0) == chunk
        finally:
            peer.close()

    def test_pipelined_requests(self, seeder):
        seeder_cfg, port = seeder
        cached = storage.list_cached_xorbs(seeder_cfg)
        xorb_hash = hashing.hex_to_hash(cached[0])
        blob = storage.XorbCache(seeder_cfg).get(cached[0])
        n = len(XorbReader(blob))
        peer = _connect(port, xorb_hash)
        try:
            results = peer.request_chunks_pipelined(
                [(xorb_hash, 0, n),
                 (np.random.default_rng(3).bytes(32), 0, 1),
                 (xorb_hash, 0, n)])
            assert results[0].data == blob
            assert isinstance(results[1], ChunkNotFoundError)
            assert results[2].data == blob
        finally:
            peer.close()


class TestLeecherPull:
    def test_pull_via_peer_not_cdn(self, hub, seeder, tmp_path):
        """All xorb bytes from the peer, no CDN xorb fetch; the landing
        streams from the cache the peer filled."""
        _, seeder_port = seeder
        leecher_cfg = _cfg(hub, tmp_path / "leecher")
        swarm = SwarmDownloader(leecher_cfg)
        swarm.add_direct_peer("127.0.0.1", seeder_port)
        try:
            result = pull_model(leecher_cfg, REPO, device="cpu",
                                swarm=swarm, log=_quiet)
        finally:
            swarm.close()
        _assert_files(result)
        fetch = result.stats["fetch"]
        assert fetch["bytes"]["peer"] > 0, "no bytes from peers"
        assert fetch["xorbs"]["cdn"] == 0, fetch
        assert fetch["p2p_ratio"] == 1.0
        assert result.stats["swarm"]["chunks_from_peers"] > 0
        assert result.stats["hbm"]["direct"] is True
        assert result.stats["hbm"]["streamed"] is True

    def test_leecher_becomes_seeder(self, hub, seeder, tmp_path):
        """Seed-while-downloading: after a peer pull, the leecher's cache
        serves a second leecher."""
        _, seeder_port = seeder
        l1_cfg = _cfg(hub, tmp_path / "l1")
        swarm1 = SwarmDownloader(l1_cfg)
        swarm1.add_direct_peer("127.0.0.1", seeder_port)
        pull_model(l1_cfg, REPO, device="cpu", swarm=swarm1, log=_quiet)
        swarm1.close()

        l1_server = BtServer(l1_cfg)
        l1_port = l1_server.start()
        try:
            l2_cfg = _cfg(hub, tmp_path / "l2")
            swarm2 = SwarmDownloader(l2_cfg)
            swarm2.add_direct_peer("127.0.0.1", l1_port)
            result = pull_model(l2_cfg, REPO, device="cpu", swarm=swarm2,
                                log=_quiet)
            swarm2.close()
            assert result.stats["fetch"]["xorbs"]["cdn"] == 0
            _assert_files(result)
        finally:
            l1_server.shutdown()

    def test_dead_peer_falls_back_to_cdn(self, hub, tmp_path):
        """An unreachable peer never breaks the pull."""
        cfg = _cfg(hub, tmp_path / "orphan")
        swarm = SwarmDownloader(cfg)
        swarm.add_direct_peer("127.0.0.1", 1)  # nothing listens there
        try:
            result = pull_model(cfg, REPO, device="cpu", swarm=swarm,
                                log=_quiet)
        finally:
            swarm.close()
        _assert_files(result)
        assert result.stats["fetch"]["bytes"]["cdn"] > 0
        assert result.stats["swarm"]["peer_failures"] > 0


# ── Interop with the JAX package ──


def test_port_server_serves_reference_peer(seeder):
    """The JAX package's ``BtPeer`` against the port's ``BtServer``:
    whole xorbs, sliced ranges and not-found, the same bytes the port's
    own client receives."""
    seeder_cfg, port = seeder
    cache = storage.XorbCache(seeder_cfg)
    for key in storage.list_cached_xorbs(seeder_cfg):
        xorb_hash = hashing.hex_to_hash(key)
        blob = cache.get(key)
        n = len(XorbReader(blob))
        theirs = _connect(port, xorb_hash, JBtPeer, j_peer_id)
        mine = _connect(port, xorb_hash)
        try:
            for lo, hi in {(0, n), (n - 1, n), (0, max(1, n - 1))}:
                a = theirs.request_chunk(xorb_hash, lo, hi)
                b = mine.request_chunk(xorb_hash, lo, hi)
                assert (a.data, a.chunk_offset) == (b.data, b.chunk_offset)
            assert theirs.request_chunk(xorb_hash, 0, n).data == blob
            with pytest.raises(JChunkNotFoundError):
                theirs.request_chunk(bytes(32), 0, 1)
        finally:
            theirs.close()
            mine.close()


def test_port_server_feeds_reference_pull(hub, seeder, tmp_path):
    """The JAX package's swarm and pull, served by the port's seeder:
    every xorb byte from the peer, files exact."""
    _, port = seeder
    cfg = _jcfg(hub, tmp_path / "ref")
    swarm = JSwarmDownloader(cfg)
    swarm.add_direct_peer("127.0.0.1", port)
    try:
        res = j_pull.pull_model(cfg, REPO, swarm=swarm, pod=False,
                                log=_quiet)
    finally:
        swarm.close()
    _assert_files(res)
    assert res.stats["fetch"]["xorbs"]["cdn"] == 0
    assert res.stats["fetch"]["bytes"]["peer"] > 0


def test_reference_server_serves_port_peer_and_pull(hub, tmp_path):
    """The port's ``BtPeer``, swarm and pull against the JAX package's
    ``BtServer``: the same payload bytes, every xorb from the peer, files
    exact."""
    ref_cfg = _jcfg(hub, tmp_path / "ref_seeder")
    j_pull.pull_model(ref_cfg, REPO, no_p2p=True, pod=False, log=_quiet)
    server = JBtServer(ref_cfg)
    port = server.start()
    try:
        jcache = j_storage.XorbCache(ref_cfg)
        for key in j_storage.list_cached_xorbs(ref_cfg):
            xorb_hash = hashing.hex_to_hash(key)
            blob = jcache.get(key)
            peer = _connect(port, xorb_hash)
            try:
                n = len(XorbReader(blob))
                assert peer.request_chunk(xorb_hash, 0, n).data == blob
                got = peer.request_chunk(xorb_hash, n - 1, n)
                assert got.chunk_offset == n - 1
                assert XorbReader(got.data).extract_chunk(0) == \
                    XorbReader(blob).extract_chunk(n - 1)
            finally:
                peer.close()
        cfg = _cfg(hub, tmp_path / "leecher")
        swarm = SwarmDownloader(cfg)
        swarm.add_direct_peer("127.0.0.1", port)
        try:
            res = pull_model(cfg, REPO, device="cpu", swarm=swarm,
                             log=_quiet)
        finally:
            swarm.close()
        _assert_files(res)
        assert res.stats["fetch"]["xorbs"]["cdn"] == 0
        assert res.stats["fetch"]["p2p_ratio"] == 1.0
        assert res.stats["swarm"]["peer_failures"] == 0
    finally:
        server.shutdown()


def test_server_drops_a_peer_past_the_cap(seeder):
    """A request frame whose length prefix is one byte past
    ``MAX_MESSAGE_SIZE`` ends that connection (no body byte is read, no
    desynchronized stream), and the server goes on serving others."""
    import socket

    from zest_tpu_torch.p2p import wire

    seeder_cfg, port = seeder
    key = storage.list_cached_xorbs(seeder_cfg)[0]
    xorb_hash = hashing.hex_to_hash(key)
    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        stream = wire.SocketStream(sock)
        stream.send_handshake(peer_id_mod.compute_info_hash(xorb_hash),
                              peer_id_mod.generate())
        stream.recv_handshake()
        sock.sendall((wire.MAX_MESSAGE_SIZE + 1).to_bytes(4, "big"))
        with pytest.raises(wire.WireError, match="closed"):
            while True:
                stream.recv_message()  # unchoke, ext handshake, then EOF
    peer = _connect(port, xorb_hash)
    try:
        blob = storage.XorbCache(seeder_cfg).get(key)
        got = peer.request_chunk(xorb_hash, 0, len(XorbReader(blob)))
        assert got.data == blob
    finally:
        peer.close()
