"""The port's seeding tier: upload policy, refusal, drain and chaos sites.

Mirrors tests/test_seeding.py on ``zest_tpu_torch``: the token bucket,
the choke book's reciprocity ranking and optimistic rotation (injected
clock), content provenance, and a ``BtServer`` over loopback — default
knobs keep a leecher's pull all-peer, the upload rate holds within 20%,
a choke flap costs no strike, a seeder stall expires without blaming the
reader, a stalled reader is struck as ``stalled_reader``, corrupt uploads
are never admitted, quarantined-source content is refused, and shutdown
drains in-flight uploads. The JAX package's surface tests of routes the
port has not taken (``/v1/status``'s seeding block, ``stats --watch``,
the tracker's counter, the swarm bench) give way to the port's own
``serve`` entry point: a seeder in its own process, configured through
the environment, serving ``pull --peer`` of the CLI.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from tests.fixtures import FixtureHub, FixtureRepo, _safetensors_blob
from zest_tpu_torch import faults, storage
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.config import Config
from zest_tpu_torch.p2p import peer_id as peer_id_mod
from zest_tpu_torch.p2p.health import (
    PROVENANCE,
    ContentProvenance,
    HealthRegistry,
)
from zest_tpu_torch.p2p.peer import BtPeer, ContentRefusedError
from zest_tpu_torch.shaping import TokenBucket
from zest_tpu_torch.transfer.pull import pull_model
from zest_tpu_torch.transfer.server import BtServer, _ChokeBook
from zest_tpu_torch.transfer.swarm import SwarmDownloader

FILES = {
    "config.json": b'{"model_type": "seedtest"}',
    "model.safetensors": _safetensors_blob({"w": np.random.default_rng(
        12).integers(0, 256, 1_500_000, dtype=np.uint8)}),
}


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    # chunks_per_xorb high enough that the checkpoint lands as ONE big
    # xorb (~1.5 MB): the shaping/drain tests need a transfer long
    # enough to time, and the single-xorb shape is the worst case for
    # fairness anyway.
    repo = FixtureRepo("acme/seed-model", FILES, chunks_per_xorb=64)
    with FixtureHub(repo) as h:
        yield h


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.install(None)
    PROVENANCE.reset()
    yield
    faults.install(None)
    PROVENANCE.reset()


def _cfg(hub, root, **kw):
    return Config(
        hf_home=root / "hf",
        cache_dir=root / "zest",
        hf_token="hf_test",
        endpoint=hub.url,
        listen_port=0,
        **kw,
    )


def _warm_seeder(hub, root, **cfg_kw):
    cfg = _cfg(hub, root, **cfg_kw)
    pull_model(cfg, "acme/seed-model", device="cpu", no_p2p=True,
               log=_quiet)
    return cfg


def _largest_cached_xorb(cfg):
    cache = storage.XorbCache(cfg)
    best, best_len = None, -1
    for key in storage.list_cached_xorbs(cfg):
        blob = cache.get(key)
        if blob is not None and len(blob) > best_len:
            best, best_len = key, len(blob)
    return best


# ── shaping.TokenBucket (promoted from tests/fixtures) ──


def test_token_bucket_enforces_rate():
    bucket = TokenBucket(1_000_000, capacity=50_000)
    t0 = time.monotonic()
    sent = 0
    while sent < 400_000:
        assert bucket.acquire(50_000)
        sent += 50_000
    elapsed = time.monotonic() - t0
    # 400 KB minus the 50 KB burst at 1 MB/s >= ~0.35 s.
    assert elapsed >= 0.25, f"rate not enforced: {elapsed:.3f}s"
    assert elapsed < 2.0


def test_token_bucket_give_up_rolls_back():
    bucket = TokenBucket(10_000, capacity=1_000)
    assert bucket.acquire(1_000)  # drain the burst
    # 100k tokens at 10kB/s = 10s wait; a 50ms deadline must refuse...
    assert not bucket.acquire(100_000,
                              give_up_at=time.monotonic() + 0.05)
    # ...and roll the debit back: a small acquire is near-instant again.
    t0 = time.monotonic()
    assert bucket.acquire(500)
    assert time.monotonic() - t0 < 1.0


# ── _ChokeBook (reciprocity ranking + optimistic rotation) ──


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_choke_book_all_unchoked_under_capacity():
    book = _ChokeBook(slots=4, health=None)
    for i in range(5):  # slots + 1
        book.register(i, ("h", i))
    assert all(book.slot(i) == "reciprocal" for i in range(5))
    assert book.counts() == (5, 0)


def test_choke_book_reciprocity_ranks_by_served_bytes():
    clock = _Clock()
    health = HealthRegistry(time_fn=clock)
    book = _ChokeBook(slots=2, health=health, rechoke_s=10.0,
                      time_fn=clock)
    for i in range(5):
        book.register(i, ("h", i))
    health.record_success(("h", 3), nbytes=5_000_000)
    health.record_success(("h", 1), nbytes=2_000_000)
    clock.t += 11  # force a re-rank
    assert book.slot(3) == "reciprocal"
    assert book.slot(1) == "reciprocal"
    unchoked, choked = book.counts()
    assert (unchoked, choked) == (3, 2)  # 2 reciprocal + 1 optimistic
    optimistic = [i for i in (0, 2, 4) if book.slot(i) == "optimistic"]
    assert len(optimistic) == 1


def test_choke_book_optimistic_slot_rotates():
    clock = _Clock()
    health = HealthRegistry(time_fn=clock)
    book = _ChokeBook(slots=1, health=health, rechoke_s=5.0,
                      time_fn=clock)
    for i in range(4):
        book.register(i, ("h", i))
    health.record_success(("h", 0), nbytes=1_000_000)  # permanent winner
    seen = set()
    for _ in range(6):
        clock.t += 6
        for i in (1, 2, 3):
            if book.slot(i) == "optimistic":
                seen.add(i)
    assert seen == {1, 2, 3}, f"rotation stuck: only {seen} got the slot"


def test_choke_book_unregister_reranks():
    book = _ChokeBook(slots=1, health=None)
    for i in range(4):
        book.register(i, ("h", i))
    choked = [i for i in range(4) if book.slot(i) is None]
    assert choked
    for i in choked:
        book.unregister(i)
    remaining = [i for i in range(4) if i not in choked]
    assert all(book.slot(i) is not None for i in remaining)


# ── ContentProvenance ──


def test_provenance_record_clear_and_bound():
    book = ContentProvenance(capacity=3)
    for i in range(5):
        book.record(f"x{i}", ("peer", i))
    assert len(book) == 3
    assert book.source("x0") is None  # oldest aged out
    assert book.source("x4") == ("peer", 4)
    book.clear("x4")
    assert book.source("x4") is None
    book.record("y", None)  # no source, no entry
    assert book.source("y") is None


# ── Server integration (loopback) ──


def test_default_knobs_preserve_loopback_pull(hub, tmp_path):
    """Acceptance pin: with every seed knob unset the serving path is
    behaviorally identical to the pre-policy server — a leecher pull is
    all-peer, zero CDN xorbs, bytes exact."""
    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    server = BtServer(seeder_cfg)
    port = server.start()
    try:
        leech = _cfg(hub, tmp_path / "leech")
        swarm = SwarmDownloader(leech)
        swarm.add_direct_peer("127.0.0.1", port)
        try:
            result = pull_model(leech, "acme/seed-model", device="cpu",
                                    swarm=swarm, log=_quiet)
        finally:
            swarm.close()
        for name, want in FILES.items():
            assert (result.snapshot_dir / name).read_bytes() == want
        assert result.stats["fetch"]["xorbs"]["cdn"] == 0
        assert result.stats["fetch"]["bytes"]["peer"] > 0
        # No seeding keys leak into PULL stats (serving economics are
        # server-side state, surfaced via /v1/status).
        assert "seeding" not in result.stats
        st = server.get_stats()
        assert st.chunks_served > 0
        assert st.bytes_served > 0
        assert st.refused_quarantined == 0
        assert st.uploads_expired == 0
    finally:
        server.shutdown()


def test_upload_rate_enforced_within_20pct(hub, tmp_path):
    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    seeder_cfg.seed_rate_bps = 1_500_000
    server = BtServer(seeder_cfg)
    port = server.start()
    try:
        key = _largest_cached_xorb(seeder_cfg)
        blob = storage.XorbCache(seeder_cfg).get(key)
        assert len(blob) > 1_000_000, "fixture xorb too small to time"
        from zest_tpu_torch.cas.xorb import XorbReader

        n = len(XorbReader(blob))
        xorb_hash = hashing.hex_to_hash(key)
        peer = BtPeer.connect(
            "127.0.0.1", port,
            peer_id_mod.compute_info_hash(xorb_hash),
            peer_id_mod.generate(),
        )
        try:
            t0 = time.monotonic()
            result = peer.request_chunk(xorb_hash, 0, n)
            elapsed = time.monotonic() - t0
        finally:
            peer.close()
        assert result.data == blob
        # Burst capacity is rate/4; the remainder must flow at the knob.
        floor = (len(blob) - seeder_cfg.seed_rate_bps / 4) \
            / seeder_cfg.seed_rate_bps
        assert elapsed >= 0.8 * floor, (
            f"shaping not enforced: {len(blob)}B in {elapsed:.3f}s "
            f"(expected >= {floor:.3f}s)")
    finally:
        server.shutdown()


def test_choke_flap_pull_survives_without_strikes(hub, tmp_path):
    """A seeder that chokes every request (seeder_choke_flap at 1.0)
    must cost the leecher nothing but a tier change: the pull completes
    via CDN, the choked denials are counted distinctly, and the seeder
    is NOT struck or quarantined — choking is policy, not failure."""
    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    server = BtServer(seeder_cfg)
    port = server.start()
    faults.install("seeder_choke_flap:1.0")
    try:
        leech = _cfg(hub, tmp_path / "leech")
        swarm = SwarmDownloader(leech)
        swarm.add_direct_peer("127.0.0.1", port)
        try:
            result = pull_model(leech, "acme/seed-model", device="cpu",
                                    swarm=swarm, log=_quiet)
        finally:
            swarm.close()
        for name, want in FILES.items():
            assert (result.snapshot_dir / name).read_bytes() == want
        assert result.stats["swarm"]["peer_choked"] > 0
        assert result.stats["swarm"]["peers_quarantined"] == 0
        assert result.stats["fetch"]["bytes"]["cdn"] > 0
        addr = ("127.0.0.1", port)
        assert not swarm.health.is_quarantined(addr)
        detail = {r["peer"]: r for r in swarm.health.detail()}
        row = detail.get(f"127.0.0.1:{port}")
        assert row is None or row["strikes"] == 0
        assert faults.counters().get("seeder_choke_flap", 0) > 0
    finally:
        faults.install(None)
        server.shutdown()


def test_seeder_stall_expires_without_blaming_reader(hub, tmp_path):
    """seeder_stall past the request deadline: the upload slot frees
    and the connection drops — but the reader is NOT struck, because
    the stall was the server's own (an injected fault / its queue), not
    the reader's. Misattribution here would quarantine healthy leechers
    whenever the seeder itself is congested."""
    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    seeder_cfg.seed_request_deadline_s = 0.2
    server = BtServer(seeder_cfg)
    port = server.start()
    faults.install("seeder_stall:1.0@0.6")
    try:
        key = storage.list_cached_xorbs(seeder_cfg)[0]
        xorb_hash = hashing.hex_to_hash(key)
        peer = BtPeer.connect(
            "127.0.0.1", port,
            peer_id_mod.compute_info_hash(xorb_hash),
            peer_id_mod.generate(),
            listen_port=7777,  # our serving identity, for attribution
        )
        try:
            with pytest.raises(Exception):  # conn dropped mid-protocol
                peer.request_chunk(xorb_hash, 0, 1)
        finally:
            peer.close()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if server.get_stats().uploads_expired:
                break
            time.sleep(0.02)
        st = server.get_stats()
        assert st.uploads_expired >= 1
        rows = {r["peer"]: r for r in server.health.detail()}
        assert "127.0.0.1:7777" not in rows, (
            f"reader blamed for the server's own stall: {rows}")
        assert faults.counters().get("seeder_stall", 0) >= 1
    finally:
        faults.install(None)
        server.shutdown()


def test_stalled_reader_struck_with_distinct_kind(hub, tmp_path):
    """A reader that stops draining its socket mid-upload (tiny RCVBUF,
    never recv()s) times the send out at the request deadline: the
    upload expires AND the reader is struck with ``stalled_reader`` —
    the genuinely-their-fault case, visible in health.detail()."""
    import socket as _socket

    from zest_tpu_torch.p2p import wire

    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    seeder_cfg.seed_request_deadline_s = 0.5
    server = BtServer(seeder_cfg)
    port = server.start()
    try:
        key = _largest_cached_xorb(seeder_cfg)
        blob = storage.XorbCache(seeder_cfg).get(key)
        from zest_tpu_torch.cas.xorb import XorbReader

        n = len(XorbReader(blob))
        xorb_hash = hashing.hex_to_hash(key)
        sock = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        # A few KB of receive window: the ~1.5 MB response must block
        # the server's send once our window + its buffer fill.
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_RCVBUF, 4096)
        sock.connect(("127.0.0.1", port))
        stream = wire.SocketStream(sock)
        try:
            from zest_tpu_torch.p2p import bep_xet
            from zest_tpu_torch.p2p.peer import LOCAL_UT_XET_ID

            info_hash = peer_id_mod.compute_info_hash(xorb_hash)
            stream.send_handshake(info_hash, peer_id_mod.generate())
            stream.recv_handshake()
            stream.send_raw(wire.encode_extended(
                0, bep_xet.make_ext_handshake(LOCAL_UT_XET_ID, 7778)))
            # Pipeline enough requests that the aggregate response
            # exceeds any autotuned send buffer (tcp_wmem caps at
            # ~4 MB): one ~1.5 MB response alone can be absorbed
            # whole by the kernel, and then the send never blocks.
            for rid in range(1, 7):
                stream.send_raw(bep_xet.encode_framed(
                    LOCAL_UT_XET_ID,
                    bep_xet.ChunkRequest(rid, xorb_hash, 0, n)))
            # ...and never read: the server's send must hit its
            # deadline and attribute the stall to US.
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if server.get_stats().uploads_expired:
                    break
                time.sleep(0.05)
        finally:
            stream.close()
        assert server.get_stats().uploads_expired >= 1
        rows = {r["peer"]: r for r in server.health.detail()}
        row = rows.get("127.0.0.1:7778")
        assert row is not None, f"no stalled-reader strike: {rows}"
        assert row["strike_kinds"].get("stalled_reader", 0) >= 1
    finally:
        server.shutdown()


def test_upload_corrupt_detected_healed_never_admitted(hub, tmp_path):
    """Serving-side corruption (upload_corrupt at 1.0): every peer
    response is poisoned — the leecher's verify tiers must reject at
    the trust boundary, strike/quarantine the seeder, heal via CDN,
    and land byte-exact files. corrupt-bytes-admitted == 0 is THE
    seeding-tier invariant."""
    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    server = BtServer(seeder_cfg)
    port = server.start()
    faults.install("upload_corrupt:1.0")
    try:
        leech = _cfg(hub, tmp_path / "leech")
        swarm = SwarmDownloader(leech)
        swarm.add_direct_peer("127.0.0.1", port)
        try:
            result = pull_model(leech, "acme/seed-model", device="cpu",
                                    swarm=swarm, log=_quiet)
        finally:
            swarm.close()
        for name, want in FILES.items():
            got = (result.snapshot_dir / name).read_bytes()
            assert got == want, f"{name}: corrupt bytes admitted"
        detected = (
            result.stats["swarm"]["corrupt_from_peer"]
            + result.stats["fetch"]["resilience"]["corrupt_from_peer"])
        assert detected > 0, "corruption was never even detected"
        assert faults.counters().get("upload_corrupt", 0) > 0
    finally:
        faults.install(None)
        server.shutdown()


def test_quarantined_source_content_refused(hub, tmp_path):
    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    server = BtServer(seeder_cfg)
    port = server.start()
    try:
        keys = storage.list_cached_xorbs(seeder_cfg)
        suspect, clean = keys[0], keys[1] if len(keys) > 1 else None
        bad_peer = ("10.0.0.9", 6881)
        PROVENANCE.record(suspect, bad_peer)
        for _ in range(3):
            server.health.record_failure(bad_peer, kind="corrupt")
        assert server.health.is_quarantined(bad_peer)

        xorb_hash = hashing.hex_to_hash(suspect)
        peer = BtPeer.connect(
            "127.0.0.1", port,
            peer_id_mod.compute_info_hash(xorb_hash),
            peer_id_mod.generate(),
        )
        try:
            with pytest.raises(ContentRefusedError):
                peer.request_chunk(xorb_hash, 0, 1)
            if clean is not None:
                # Unsuspected content still serves on the same conn.
                from zest_tpu_torch.cas.xorb import XorbReader

                blob = storage.XorbCache(seeder_cfg).get(clean)
                n = len(XorbReader(blob))
                res = peer.request_chunk(hashing.hex_to_hash(clean), 0, n)
                assert res.data == blob
        finally:
            peer.close()
        assert server.get_stats().refused_quarantined == 1
    finally:
        server.shutdown()


def test_refusal_degrades_to_cdn_in_full_pull(hub, tmp_path):
    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    server = BtServer(seeder_cfg)
    port = server.start()
    try:
        bad_peer = ("10.0.0.9", 6881)
        for key in storage.list_cached_xorbs(seeder_cfg):
            PROVENANCE.record(key, bad_peer)
        for _ in range(3):
            server.health.record_failure(bad_peer, kind="corrupt")

        leech = _cfg(hub, tmp_path / "leech")
        swarm = SwarmDownloader(leech)
        swarm.add_direct_peer("127.0.0.1", port)
        try:
            result = pull_model(leech, "acme/seed-model", device="cpu",
                                    swarm=swarm, log=_quiet)
        finally:
            swarm.close()
        for name, want in FILES.items():
            assert (result.snapshot_dir / name).read_bytes() == want
        assert result.stats["swarm"]["peer_refusals"] > 0
        assert result.stats["fetch"]["bytes"]["cdn"] > 0
        # A deliberate refusal is not a failure: the seeder stays clean.
        assert not swarm.health.is_quarantined(("127.0.0.1", port))
    finally:
        server.shutdown()


def test_graceful_drain_completes_inflight_upload(hub, tmp_path):
    """Shutdown mid-upload: the in-flight response finishes whole
    within the drain window — never a truncated-but-accepted blob."""
    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    # ~1 s transfer: the shutdown lands mid-flight.
    seeder_cfg.seed_rate_bps = 1_500_000
    server = BtServer(seeder_cfg)
    port = server.start()
    key = _largest_cached_xorb(seeder_cfg)
    blob = storage.XorbCache(seeder_cfg).get(key)
    from zest_tpu_torch.cas.xorb import XorbReader

    n = len(XorbReader(blob))
    xorb_hash = hashing.hex_to_hash(key)
    peer = BtPeer.connect(
        "127.0.0.1", port,
        peer_id_mod.compute_info_hash(xorb_hash), peer_id_mod.generate(),
    )
    got: list = [None]
    err: list = [None]

    def fetch():
        try:
            got[0] = peer.request_chunk(xorb_hash, 0, n)
        except Exception as exc:  # noqa: BLE001 - asserted below
            err[0] = exc

    t = threading.Thread(target=fetch)
    t.start()
    time.sleep(0.25)  # the shaped upload is now mid-frame
    server.shutdown(drain_s=10.0)
    t.join(timeout=15)
    peer.close()
    assert not t.is_alive()
    assert err[0] is None, f"drained upload failed: {err[0]!r}"
    assert got[0].data == blob, "drained upload delivered wrong bytes"
    # And the listener really is closed.
    import socket as _socket

    with pytest.raises(OSError):
        s = _socket.create_connection(("127.0.0.1", port), timeout=0.5)
        s.close()
        raise OSError("port still accepting")  # reached only if connect worked


def test_abrupt_shutdown_never_truncates_accepted(hub, tmp_path):
    """Even with drain_s=0 (abort), a cut upload surfaces as a WIRE
    error at the puller, never as short-but-accepted data: the frame
    length prefix makes truncation loud."""
    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    seeder_cfg.seed_rate_bps = 300_000  # slow enough to cut mid-frame
    server = BtServer(seeder_cfg)
    port = server.start()
    key = _largest_cached_xorb(seeder_cfg)
    blob = storage.XorbCache(seeder_cfg).get(key)
    from zest_tpu_torch.cas.xorb import XorbReader

    n = len(XorbReader(blob))
    xorb_hash = hashing.hex_to_hash(key)
    peer = BtPeer.connect(
        "127.0.0.1", port,
        peer_id_mod.compute_info_hash(xorb_hash), peer_id_mod.generate(),
    )
    got: list = [None]
    err: list = [None]

    def fetch():
        try:
            got[0] = peer.request_chunk(xorb_hash, 0, n)
        except Exception as exc:  # noqa: BLE001 - asserted below
            err[0] = exc

    t = threading.Thread(target=fetch)
    t.start()
    time.sleep(0.3)
    server.shutdown(drain_s=0.0)
    t.join(timeout=15)
    peer.close()
    assert not t.is_alive()
    if got[0] is not None:  # the send won the race: must be whole
        assert got[0].data == blob
    else:
        assert err[0] is not None  # loud failure, not silent truncation


# ── Surfaces ──


def test_seed_env_knobs_parse_and_raise():
    env = {"ZEST_SEED_RATE_BPS": "1000000", "ZEST_SEED_PEER_BPS": "2000",
           "ZEST_SEED_SLOTS": "3", "ZEST_SEED_DEADLINE_S": "1.5",
           "ZEST_SEED_DRAIN_S": "2"}
    cfg = Config.load(env)
    assert cfg.seed_rate_bps == 1_000_000
    assert cfg.seed_peer_bps == 2_000
    assert cfg.seed_slots == 3
    assert cfg.seed_request_deadline_s == 1.5
    assert cfg.seed_drain_s == 2.0
    # Unset = policy off / defaults.
    cfg = Config.load({})
    assert cfg.seed_rate_bps == 0
    assert cfg.seed_peer_bps == 0
    with pytest.raises(ValueError):
        Config.load({"ZEST_SEED_RATE_BPS": "fast"})
    with pytest.raises(ValueError):
        Config.load({"ZEST_SEED_SLOTS": "many"})
    with pytest.raises(ValueError):
        Config.load({"ZEST_SEED_DEADLINE_S": "soon"})
    # A sign slip must raise, never silently mean "unshaped"/"tiny".
    with pytest.raises(ValueError):
        Config.load({"ZEST_SEED_RATE_BPS": "-25000000"})
    with pytest.raises(ValueError):
        Config.load({"ZEST_SEED_PEER_BPS": "-1"})
    with pytest.raises(ValueError):
        Config.load({"ZEST_SEED_SLOTS": "0"})
    with pytest.raises(ValueError):
        Config.load({"ZEST_SEED_DEADLINE_S": "-3"})
    with pytest.raises(ValueError):
        Config.load({"ZEST_SEED_DRAIN_S": "-1"})


def test_token_bucket_refund_restores_tokens():
    bucket = TokenBucket(10_000, capacity=1_000)
    assert bucket.acquire(1_000)   # drain the burst
    bucket.refund(1_000)
    t0 = time.monotonic()
    assert bucket.acquire(1_000)   # refunded: immediate again
    assert time.monotonic() - t0 < 0.05
    bucket.refund(10_000_000)      # clamped at capacity, never above
    assert bucket.tokens <= bucket.capacity


def test_provenance_multi_source_any_quarantined_refuses():
    """One key can carry several unproven contributors; a later
    recording must not displace an earlier peer's attribution, and
    the refusal check is 'ANY source quarantined'."""
    book = ContentProvenance()
    book.record("xx", ("p1", 1))
    book.record("xx", ("p2", 2))
    book.record("xx", ("p1", 1))  # dedup: no growth
    assert book.sources("xx") == (("p1", 1), ("p2", 2))
    assert book.source("xx") == ("p2", 2)  # latest
    h = HealthRegistry(strikes_to_quarantine=1)
    h.record_failure(("p1", 1))
    assert any(h.is_quarantined(s) for s in book.sources("xx"))


# ── The port's own surfaces: the bucket, `serve` as a seeder process ──


@pytest.mark.parametrize("rate", [1, 1000, 10_000_000])
def test_token_bucket_burst_matches_reference(rate):
    from zest_tpu.shaping import TokenBucket as JTokenBucket

    mine, theirs = TokenBucket(rate), JTokenBucket(rate)
    assert (mine.rate, mine.capacity) == (theirs.rate, theirs.capacity)


class _Seeder:
    """``python -m zest_tpu_torch serve`` over ``cfg``'s cache, in its own
    process; ``stop()`` sends SIGTERM and returns the seeder's stats."""

    def __init__(self, cfg, **env):
        child_env = {**os.environ, "HF_HOME": str(cfg.hf_home),
                     "ZEST_CACHE_DIR": str(cfg.cache_dir),
                     "JAX_PLATFORMS": "cpu", **env}
        if "ZEST_FAULTS" not in env:
            child_env.pop("ZEST_FAULTS", None)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "zest_tpu_torch", "serve",
             "--listen-port", "0", "--dcn-port", "0", "--port", "0"],
            cwd=Path(__file__).resolve().parent.parent, env=child_env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.lines = []
        while not any(ln.startswith("publisher endpoint")
                      for ln in self.lines):
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(f"seeder died: {self.proc.stderr.read()}")
            self.lines.append(line.strip())
        ports = [int(ln.split(":")[1].split()[0]) for ln in self.lines
                 if ln.startswith("seeding on :")]
        self.bt_port, self.dcn_port = ports

    def stop(self) -> dict:
        self.proc.terminate()
        out, err = self.proc.communicate(timeout=30)
        assert self.proc.returncode == 0, err
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("seeder stats: "))
        return json.loads(line[len("seeder stats: "):])


def _cli_pull(monkeypatch, capsys, cfg, hub, *flags):
    from zest_tpu_torch import cli

    for k, v in {"HF_HOME": cfg.hf_home, "ZEST_CACHE_DIR": cfg.cache_dir,
                 "HF_ENDPOINT": hub.url, "HF_TOKEN": "hf_test",
                 "ZEST_LISTEN_PORT": "0"}.items():
        monkeypatch.setenv(k, str(v))
    capsys.readouterr()
    assert cli.main(["pull", "acme/seed-model", "--device", "cpu",
                     *flags]) == 0
    return capsys.readouterr().out


def test_serve_seeds_a_cli_pull_over_bt_and_dcn(hub, tmp_path, monkeypatch,
                                                capsys):
    """A seeder process (`serve --listen-port 0 --dcn-port 0`) over a warm
    cache: `pull --peer` takes every xorb byte from it, its DCN listener
    answers on the same cache, and SIGTERM drains it and prints its
    ServerStats."""
    from zest_tpu_torch.transfer.dcn import DcnPool

    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    seeder = _Seeder(seeder_cfg)
    try:
        out = _cli_pull(monkeypatch, capsys, _cfg(hub, tmp_path / "leech"),
                        hub, "--peer", f"127.0.0.1:{seeder.bt_port}")
        key = storage.list_cached_xorbs(seeder_cfg)[0]
        blob = storage.XorbCache(seeder_cfg).get(key)
        pool = DcnPool()
        try:
            from zest_tpu_torch.cas.xorb import XorbReader

            n = len(XorbReader(blob))
            (reply,) = pool.request_many(
                "127.0.0.1", seeder.dcn_port,
                [(hashing.hex_to_hash(key), 0, n)], timeout=10)
            assert reply.data == blob
        finally:
            pool.close()
    finally:
        stats = seeder.stop()
    peer_line = next(ln for ln in out.splitlines() if "From peers:" in ln)
    assert int(peer_line.split()[2]) > 0
    assert "From CDN:   0 bytes" in out
    assert "P2P ratio:  100.0%" in out
    assert stats["chunks_served"] > 0
    assert stats["bytes_served"] >= int(peer_line.split()[2])
    leech = _cfg(hub, tmp_path / "leech")
    snap = leech.model_snapshot_dir("acme/seed-model",
                                    hub.repos["acme/seed-model"].commit_sha)
    for name, want in FILES.items():
        assert (snap / name).read_bytes() == want


def test_serve_takes_faults_from_the_environment(hub, tmp_path, monkeypatch,
                                                 capsys):
    """`ZEST_FAULTS=upload_corrupt:1.0` configures a seeder process: every
    upload is corrupt, no peer byte is admitted, and the pull heals from
    the CDN and lands exact files."""
    seeder_cfg = _warm_seeder(hub, tmp_path / "seeder")
    seeder = _Seeder(seeder_cfg, ZEST_FAULTS="upload_corrupt:1.0")
    try:
        out = _cli_pull(monkeypatch, capsys, _cfg(hub, tmp_path / "leech"),
                        hub, "--peer", f"127.0.0.1:{seeder.bt_port}")
    finally:
        stats = seeder.stop()
    assert "From peers: 0 bytes" in out
    assert stats["chunks_served"] > 0
    leech = _cfg(hub, tmp_path / "leech")
    snap = leech.model_snapshot_dir("acme/seed-model",
                                    hub.repos["acme/seed-model"].commit_sha)
    for name, want in FILES.items():
        assert (snap / name).read_bytes() == want


def test_pull_no_p2p_and_bad_peer_flag(hub, tmp_path, monkeypatch, capsys):
    """`--no-p2p` runs cache and CDN only; a malformed `--peer` leaves the
    pull CDN-only and says so, as the JAX package's CLI does."""
    out = _cli_pull(monkeypatch, capsys, _cfg(hub, tmp_path / "a"), hub,
                    "--no-p2p")
    assert "From peers: 0 bytes" in out
    from zest_tpu_torch import cli

    monkeypatch.setenv("HF_HOME", str(tmp_path / "b" / "hf"))
    monkeypatch.setenv("ZEST_CACHE_DIR", str(tmp_path / "b" / "zest"))
    assert cli.main(["pull", "acme/seed-model", "--device", "cpu",
                     "--peer", "nonsense"]) == 0
    captured = capsys.readouterr()
    assert "p2p unavailable" in captured.err
    assert "From peers: 0 bytes" in captured.out


@pytest.mark.parametrize("env", [
    {},
    {"ZEST_LISTEN_PORT": "7000", "ZEST_MAX_PEERS": "9",
     "ZEST_PULL_DEADLINE_S": "12.5", "ZEST_SEED_RATE_BPS": "1000",
     "ZEST_SEED_PEER_BPS": "10", "ZEST_SEED_SLOTS": "2",
     "ZEST_SEED_DEADLINE_S": "0.5", "ZEST_SEED_DRAIN_S": "0"},
    {"ZEST_PULL_DEADLINE_S": "0"},
    {"ZEST_PULL_DEADLINE_S": "-3"},
], ids=["defaults", "set", "deadline_off", "deadline_negative"])
def test_peer_tier_knobs_parse_like_reference(env):
    from zest_tpu.config import Config as JConfig

    mine, theirs = Config.load(env), JConfig.load(env)
    for field in ("listen_port", "max_peers", "pull_deadline_s",
                  "seed_rate_bps", "seed_peer_bps", "seed_slots",
                  "seed_request_deadline_s", "seed_drain_s"):
        assert getattr(mine, field) == getattr(theirs, field), field
