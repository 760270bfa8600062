"""The port's resilience layer under injected faults, and pull parity.

Mirrors tests/test_cas_retry.py (the urllib CAS client: retries with
backoff, mid-stream resume through an adjusted ``Range``, the xet-token
refresh, deadline-capped budgets; a scripted opener in place of the
``requests`` session) and tests/test_chaos.py (the seeded fault matrix
against full ``pull_model(device="cpu")`` landings, marked ``chaos``).

Then the codec-error repair: a peer that answers a direct landing with a
malformed BEP XET frame, or closes mid-frame, is struck and the landing
heals from the CDN and still streams (``hbm.direct``, ``streamed``),
with the clean pull's digest. And pull parity: the port's pull and the
JAX package's (``device="tpu"``, ``pod=False``) through one seeder — a
clean one, one whose every upload is corrupt, and one that closes
mid-frame — agree on ``params_digest``, the files, the fetch bytes by
tier, ``p2p_ratio`` and the ``swarm`` keys, except where the JAX package
lets the mid-frame ``WireError`` escape its swarm (recorded here).
"""

from __future__ import annotations

import hashlib
import http.client
import socket
import threading
import time

import numpy as np
import pytest

from tests.fixtures import FixtureHub, FixtureRepo, _safetensors_blob
from zest_tpu.config import Config as JConfig
from zest_tpu.models import loader as j_loader
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer.swarm import SwarmDownloader as JSwarmDownloader
from zest_tpu_torch import faults
from zest_tpu_torch.cas.client import CasClient, CasError
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import loader
from zest_tpu_torch.p2p import bep_xet, wire
from zest_tpu_torch.p2p.health import PROVENANCE
from zest_tpu_torch.p2p.peer import LOCAL_UT_XET_ID
from zest_tpu_torch.resilience import Deadline, DeadlineExceeded
from zest_tpu_torch.transfer.pull import pull_model
from zest_tpu_torch.transfer.server import BtServer
from zest_tpu_torch.transfer.swarm import SwarmDownloader

pytestmark = pytest.mark.chaos

SEED = 1337


def _quiet(*a, **k):
    pass


# ── CasClient (mirrors tests/test_cas_retry.py) ──


class FakeResp:
    """A urllib response: ``status``, ``read(n)``, ``headers``; a
    ``die_after`` body raises a connection reset after that many
    bytes."""

    def __init__(self, status, body=b"", doc=None, die_after=None):
        import json

        self.status = status
        self._body = body if doc is None else json.dumps(doc).encode()
        self._die_after = die_after
        self._pos = 0
        self.headers = {"Content-Length": str(len(self._body))}
        self.closed = False

    def read(self, n=-1):
        end = len(self._body) if n is None or n < 0 else self._pos + n
        if self._die_after is not None and end > self._die_after:
            if self._pos < self._die_after:
                piece = self._body[self._pos:self._die_after]
                self._pos = self._die_after
                return piece
            raise ConnectionResetError("connection reset mid-body")
        piece = self._body[self._pos:end]
        self._pos += len(piece)
        return piece

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.closed = True


class FakeOpener:
    """Pops one scripted outcome per GET; records (url, headers)."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []
        self.timeouts = []

    def __call__(self, url, headers=None, timeout=None):
        self.calls.append((url, dict(headers or {})))
        self.timeouts.append(timeout)
        step = self.script.pop(0)
        if isinstance(step, BaseException):
            raise step
        return step


def _client(script, **kw):
    kw.setdefault("backoff_base_s", 0.001)
    opener = FakeOpener(script)
    return CasClient("http://cas.test", "tok0", opener=opener, **kw), opener


BODY = bytes(range(256)) * 64  # 16 KiB


class TestFetchRetries:
    def test_5xx_then_success(self):
        events = []
        client, _ = _client([FakeResp(503), FakeResp(200, BODY)],
                            on_event=events.append)
        assert client.fetch_xorb_from_url("http://cdn.test/x") == BODY
        assert events == ["cdn_retries"]

    def test_connection_error_then_success(self):
        client, _ = _client([ConnectionResetError("reset"),
                             FakeResp(200, BODY)])
        assert client.fetch_xorb_from_url("http://cdn.test/x") == BODY

    def test_retries_exhausted_raises(self):
        client, opener = _client([FakeResp(503)] * 3, retries=2)
        with pytest.raises(CasError, match="after 3 attempts"):
            client.fetch_xorb_from_url("http://cdn.test/x")
        assert len(opener.calls) == 3

    def test_non_retryable_status_fails_fast(self):
        client, opener = _client([FakeResp(418)])
        with pytest.raises(CasError, match="418"):
            client.fetch_xorb_from_url("http://cdn.test/x")
        assert len(opener.calls) == 1

    def test_mid_stream_reset_resumes_from_offset(self):
        """A reset after N bytes re-requests bytes N..: the consumer sees
        one seamless, byte-exact stream."""
        cut = 5000
        client, opener = _client([FakeResp(206, BODY, die_after=cut),
                                  FakeResp(206, BODY[cut:])])
        got = client.fetch_xorb_from_url("http://cdn.test/x",
                                         byte_range=(0, len(BODY)))
        assert got == BODY
        assert opener.calls[0][1]["Range"] == f"bytes=0-{len(BODY) - 1}"
        assert opener.calls[1][1]["Range"] == f"bytes={cut}-{len(BODY) - 1}"

    def test_unranged_fetch_resumes_with_range_header(self):
        cut = 1024
        client, opener = _client([FakeResp(200, BODY, die_after=cut),
                                  FakeResp(206, BODY[cut:])])
        assert client.fetch_xorb_from_url("http://cdn.test/x") == BODY
        assert "Range" not in opener.calls[0][1]
        assert opener.calls[1][1]["Range"] == f"bytes={cut}-"

    def test_resume_when_origin_ignores_range(self):
        """The second attempt answers 200 with the whole body despite the
        resume Range: the client trims the already-delivered prefix."""
        cut = 3000
        client, _ = _client([FakeResp(200, BODY, die_after=cut),
                             FakeResp(200, BODY)])
        assert client.fetch_xorb_from_url("http://cdn.test/x") == BODY

    def test_body_cut_short_resumes(self):
        """urllib ends a body cut short without an error: the client
        compares against the window (or Content-Length) and resumes."""
        short = FakeResp(206, BODY[:7000])
        short.headers = {"Content-Length": str(len(BODY))}
        client, opener = _client([short, FakeResp(206, BODY[7000:])])
        got = client.fetch_xorb_from_url("http://cdn.test/x",
                                         byte_range=(0, len(BODY)))
        assert got == BODY
        assert opener.calls[1][1]["Range"] == f"bytes=7000-{len(BODY) - 1}"

    def test_incomplete_read_is_retried(self):
        client, _ = _client([http.client.IncompleteRead(b"x"),
                             FakeResp(200, BODY)])
        assert client.fetch_xorb_from_url("http://cdn.test/x") == BODY


class TestTokenRefresh:
    def test_401_refreshes_once_and_retries(self):
        events = []
        client, opener = _client(
            [FakeResp(401), FakeResp(200, BODY)],
            token_refresher=lambda: ("http://cas.test", "tok1"),
            on_event=events.append)
        assert client.fetch_xorb_from_url("http://cas.test/v1/x") == BODY
        assert opener.calls[0][1]["Authorization"] == "Bearer tok0"
        assert opener.calls[1][1]["Authorization"] == "Bearer tok1"
        assert events == ["token_refreshes"]

    def test_second_401_is_fatal(self):
        client, _ = _client([FakeResp(401), FakeResp(401)],
                            token_refresher=lambda: ("http://cas.test",
                                                     "tok1"))
        with pytest.raises(CasError, match="401"):
            client.fetch_xorb_from_url("http://cas.test/v1/x")

    def test_403_without_refresher_is_fatal(self):
        client, opener = _client([FakeResp(403)])
        with pytest.raises(CasError, match="403"):
            client.fetch_xorb_from_url("http://cas.test/v1/x")
        assert len(opener.calls) == 1

    def test_presigned_url_403_not_refreshed(self):
        """Off-origin (presigned) URLs carry no bearer token, so a 403
        there is not a token problem: fail, don't refresh."""
        called = []
        client, opener = _client(
            [FakeResp(403)],
            token_refresher=lambda: called.append(1) or ("", "t"))
        with pytest.raises(CasError, match="403"):
            client.fetch_xorb_from_url("http://cdn.elsewhere/x")
        assert not called
        assert "Authorization" not in opener.calls[0][1]

    def test_reconstruction_retries_and_refreshes(self):
        doc = {"terms": [], "fetch_info": {}}
        client, opener = _client(
            [FakeResp(503), FakeResp(401), FakeResp(200, doc=doc)],
            token_refresher=lambda: ("http://cas.test", "tok1"))
        rec = client.get_reconstruction("ab" * 32)
        assert rec.terms == []
        assert opener.calls[-1][1]["Authorization"] == "Bearer tok1"

    def test_reconstruction_404_fails_fast(self):
        client, opener = _client([FakeResp(404)])
        with pytest.raises(CasError, match="no reconstruction"):
            client.get_reconstruction("ab" * 32)
        assert len(opener.calls) == 1


class TestDeadline:
    def test_expired_deadline_stops_retrying(self):
        client, opener = _client([FakeResp(503)] * 10, retries=9,
                                 deadline=Deadline(0.05))
        with pytest.raises((DeadlineExceeded, CasError)):
            client.fetch_xorb_from_url("http://cdn.test/x")
        assert len(opener.calls) < 10

    def test_deadline_caps_request_timeout(self):
        opener = FakeOpener([FakeResp(200, BODY)])
        client = CasClient("http://cas.test", opener=opener,
                           deadline=Deadline(5.0))
        client.fetch_xorb_from_url("http://cdn.test/x")
        assert opener.timeouts[0] <= 5.0


# ── The chaos matrix (mirrors tests/test_chaos.py) ──

# Deterministic, non-periodic payload (a repeating pattern would dedup
# into one xorb and starve the matrix of requests to inject into).
_RNG_BYTES = b"".join(
    hashlib.blake2b(i.to_bytes(4, "little"), digest_size=64).digest()
    for i in range(16384))
REPO = "acme/chaos-model"
FILES = {
    "config.json": b'{"model_type": "chaos"}',
    "model.safetensors": _safetensors_blob(
        {"w": np.frombuffer(_RNG_BYTES, dtype=np.uint8)}),
    "tokenizer.json": b'{"tok": 1}' * 40,
}


@pytest.fixture(scope="module")
def hub():
    # One chunk per xorb: enough peer/CDN requests to accumulate K
    # strikes and to give the pinned fault sequences trials to fire on.
    with FixtureHub(FixtureRepo(REPO, FILES, chunks_per_xorb=1)) as h:
        yield h


@pytest.fixture(autouse=True)
def _pinned_faults():
    faults.reset()
    PROVENANCE.reset()
    yield
    faults.reset()
    PROVENANCE.reset()


def _cfg(hub, root, **kw):
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _jcfg(hub, root, **kw):
    return JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                   hf_token="hf_test", endpoint=hub.url, **kw)


@pytest.fixture(scope="module")
def seeder_cfg(hub, tmp_path_factory):
    cfg = _cfg(hub, tmp_path_factory.mktemp("seeder"), listen_port=0)
    pull_model(cfg, REPO, device="cpu", no_p2p=True, log=_quiet)
    return cfg


@pytest.fixture(scope="module")
def seeder(seeder_cfg):
    """A warm port host serving its cache over the BT wire."""
    server = BtServer(seeder_cfg)
    port = server.start()
    yield port
    server.shutdown()


@pytest.fixture(scope="module")
def clean(hub, tmp_path_factory):
    """The fault-free CDN pull every scenario's tree is held to."""
    return pull_model(_cfg(hub, tmp_path_factory.mktemp("clean")), REPO,
                      device="cpu", no_p2p=True, log=_quiet)


def _pull_with_peer(cfg, seeder_port):
    swarm = SwarmDownloader(cfg)
    swarm.add_direct_peer("127.0.0.1", seeder_port)
    try:
        return pull_model(cfg, REPO, device="cpu", swarm=swarm, log=_quiet)
    finally:
        swarm.close()


def _assert_bytes_identical(result):
    for name, data in FILES.items():
        assert (result.snapshot_dir / name).read_bytes() == data, \
            f"{name} differs from the fault-free bytes"


def test_peer_timeouts_bounded_quarantined_healed(hub, seeder, tmp_path):
    """Every connect to the only peer times out: the pull falls to the CDN
    without stalling, and the dead peer is quarantined."""
    faults.install(f"peer_timeout:1.0@127.0.0.1:{seeder}", seed=SEED)
    t0 = time.monotonic()
    result = _pull_with_peer(_cfg(hub, tmp_path), seeder)
    elapsed = time.monotonic() - t0
    _assert_bytes_identical(result)
    swarm_stats = result.stats["swarm"]
    assert result.stats["fetch"]["bytes"]["cdn"] > 0
    assert result.stats["fetch"]["bytes"]["peer"] == 0
    assert swarm_stats["peer_failures"] > 0
    assert swarm_stats["peers_quarantined"] >= 1
    assert swarm_stats["health"]["quarantined_now"] >= 1
    assert elapsed < 30.0


def test_corrupt_peer_attributed_quarantined_healed(hub, seeder, tmp_path):
    """Every chunk the seeder serves arrives with a flipped byte: the
    bridge attributes it to that peer (strikes → quarantine), refetches
    from the CDN and lands exact bytes."""
    faults.install(f"chunk_corrupt:1.0@127.0.0.1:{seeder}", seed=SEED)
    result = _pull_with_peer(_cfg(hub, tmp_path), seeder)
    _assert_bytes_identical(result)
    swarm_stats = result.stats["swarm"]
    res = result.stats["fetch"]["resilience"]
    assert swarm_stats["corrupt_from_peer"] >= 1, "corruption unattributed"
    assert res["corrupt_from_peer"] >= 1
    assert swarm_stats["peers_quarantined"] >= 1
    assert result.stats["fetch"]["bytes"]["cdn"] > 0


def _serial_cfg(hub, root, **kw):
    """Single-threaded fetches: the fault trial sequence maps to requests
    deterministically, so the pinned seed replays exactly."""
    return _cfg(hub, root, max_concurrent_downloads=1, decode_workers=1,
                **kw)


def test_cdn_503s_retried(hub, tmp_path):
    faults.install("cdn_503:0.4", seed=SEED)
    result = pull_model(_serial_cfg(hub, tmp_path), REPO, device="cpu",
                        no_p2p=True, log=_quiet)
    _assert_bytes_identical(result)
    assert result.stats["fetch"]["resilience"]["cdn_retries"] >= 1


def test_cdn_connection_resets_retried(hub, tmp_path):
    faults.install("cdn_reset:0.4", seed=SEED)
    result = pull_model(_serial_cfg(hub, tmp_path), REPO, device="cpu",
                        no_p2p=True, log=_quiet)
    _assert_bytes_identical(result)
    assert result.stats["fetch"]["resilience"]["cdn_retries"] >= 1


def test_slow_peer_hedged_under_deadline(hub, seeder, tmp_path):
    """The peer serves correct bytes but sleeps 4 s per request; with an
    8 s pull deadline the bridge hedges to the CDN instead of waiting."""
    faults.install(f"peer_slow:1.0@4.0@127.0.0.1:{seeder}", seed=SEED)
    deadline_s = 8.0
    cfg = _cfg(hub, tmp_path, pull_deadline_s=deadline_s)
    t0 = time.monotonic()
    result = _pull_with_peer(cfg, seeder)
    elapsed = time.monotonic() - t0
    _assert_bytes_identical(result)
    res = result.stats["fetch"]["resilience"]
    assert res["hedges"] >= 1, "deadline at risk but no hedge fired"
    assert res["hedges_won"] >= 1, "CDN racer never beat the slow peer"
    assert elapsed < deadline_s + 2.0, (
        f"pull took {elapsed:.1f}s against a {deadline_s}s deadline")
    assert result.stats["deadline"]["budget_s"] == deadline_s


def test_full_matrix_combined(hub, seeder, tmp_path, monkeypatch):
    """Flaky connects, corrupt chunks, CDN hiccups and a sluggish peer at
    once, under a deadline: exact bytes inside the budget."""
    import zest_tpu_torch.cas.client as cas_client

    # Overlapping fault streams can stack more consecutive CDN failures
    # onto one request than the default 3.
    monkeypatch.setattr(cas_client, "DEFAULT_RETRIES", 8)
    faults.install(
        f"peer_timeout:0.3@127.0.0.1:{seeder},"
        f"chunk_corrupt:0.3@127.0.0.1:{seeder},"
        f"peer_slow:0.3@1.0@127.0.0.1:{seeder},"
        "cdn_503:0.1,cdn_reset:0.1",
        seed=SEED)
    deadline_s = 25.0
    cfg = _cfg(hub, tmp_path, pull_deadline_s=deadline_s)
    t0 = time.monotonic()
    result = _pull_with_peer(cfg, seeder)
    elapsed = time.monotonic() - t0
    _assert_bytes_identical(result)
    assert elapsed < deadline_s + 2.0
    assert faults.counters(), "matrix ran but nothing injected"


def test_faultfree_pull_records_zero_resilience_events(hub, seeder,
                                                      tmp_path):
    """Control arm: with injection off the resilience layer is silent and
    the peer tier serves the bytes."""
    result = _pull_with_peer(_cfg(hub, tmp_path), seeder)
    _assert_bytes_identical(result)
    res = result.stats["fetch"]["resilience"]
    assert res == {k: 0 for k in res}
    assert result.stats["swarm"]["peers_quarantined"] == 0
    assert result.stats["swarm"]["corrupt_from_peer"] == 0
    assert result.stats["fetch"]["bytes"]["peer"] > 0


def test_resilience_block_keys_match_reference():
    from zest_tpu.transfer.bridge import FetchStats as JFetchStats
    from zest_tpu_torch.transfer.bridge import FetchStats

    mine, theirs = FetchStats().summary(), JFetchStats().summary()
    assert set(mine) == set(theirs)
    for block in ("xorbs", "bytes", "resilience"):
        assert mine[block] == theirs[block]


# ── A peer that speaks garbage (the codec-error repair) ──


class GarbledPeer:
    """A BT-wire peer that completes both handshakes, then answers every
    chunk request with a frame the codecs reject: ``mode="xet"`` an
    EXTENDED message of unknown BEP XET type (``XetMessageError``),
    ``mode="midframe"`` a length prefix and half a body, then a close,
    ``mode="pastcap"`` a length prefix one byte past ``MAX_MESSAGE_SIZE``
    (both ``WireError``)."""

    def __init__(self, mode: str):
        self.mode = mode
        self.requests = 0
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        self.sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                continue
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        stream = wire.SocketStream(conn)
        try:
            hs = stream.recv_handshake()
            stream.send_handshake(hs.info_hash, b"-GARBLE-" + bytes(12))
            stream.send_raw(wire.encode_extended(
                0, bep_xet.make_ext_handshake(LOCAL_UT_XET_ID)))
            while True:
                msg = stream.recv_message()
                if msg.msg_id != wire.MessageId.EXTENDED:
                    continue
                ext_id, payload = wire.parse_extended(msg.payload)
                if ext_id == 0:
                    continue
                self.requests += 1
                if self.mode == "xet":
                    stream.send_raw(wire.encode_extended(
                        LOCAL_UT_XET_ID, b"\x99" + bytes(44)))
                elif self.mode == "pastcap":
                    stream.send_raw((wire.MAX_MESSAGE_SIZE + 1).to_bytes(
                        4, "big") + bytes([20, LOCAL_UT_XET_ID, 2]))
                else:
                    stream.send_raw((100_000).to_bytes(4, "big")
                                    + bytes([20, LOCAL_UT_XET_ID, 2])
                                    + bytes(1000))
                    return
        except (OSError, ValueError):
            pass
        finally:
            stream.close()

    def close(self):
        self._stop.set()
        self.sock.close()


@pytest.fixture(params=["xet", "midframe", "pastcap"])
def garbled(request):
    peer = GarbledPeer(request.param)
    yield peer
    peer.close()


def test_codec_error_strikes_peer_and_landing_heals(hub, clean, garbled,
                                                    tmp_path):
    """A direct landing whose only peer speaks garbage: the peer is struck
    (and quarantined after ``strikes_to_quarantine``), every unit heals
    from the CDN, the landing still streams, and the tree is the clean
    pull's."""
    result = _pull_with_peer(_cfg(hub, tmp_path), garbled.port)
    _assert_bytes_identical(result)
    assert garbled.requests >= 1
    hbm = result.stats["hbm"]
    assert hbm["direct"] is True and hbm["streamed"] is True
    assert loader.params_digest(result.params) == \
        loader.params_digest(clean.params)
    st = result.stats["swarm"]
    assert st["peer_failures"] >= 1
    assert st["peers_quarantined"] >= 1
    fetch = result.stats["fetch"]
    assert fetch["bytes"]["peer"] == 0
    assert fetch["bytes"]["cdn"] == clean.stats["fetch"]["bytes"]["cdn"]
    assert result.stats["fallback_files"] == 0


# ── Pull parity with the JAX package through one seeder ──


def _ref_pull(hub, root, port):
    cfg = _jcfg(hub, root, listen_port=0, max_concurrent_downloads=1)
    swarm = JSwarmDownloader(cfg)
    swarm.add_direct_peer("127.0.0.1", port)
    try:
        return j_pull.pull_model(cfg, REPO, device="tpu", pod=False,
                                 swarm=swarm, log=_quiet)
    finally:
        swarm.close()


def _port_pull(hub, root, port):
    cfg = _cfg(hub, root, listen_port=0, max_concurrent_downloads=1)
    return _pull_with_peer(cfg, port)


def _assert_parity(mine, theirs):
    assert loader.params_digest(mine.params) == \
        j_loader.params_digest(theirs.params)
    _assert_bytes_identical(mine)
    _assert_bytes_identical(theirs)
    assert set(mine.stats["swarm"]) == set(theirs.stats["swarm"])
    assert set(mine.stats["swarm"]["health"]) == \
        set(theirs.stats["swarm"]["health"])


@pytest.mark.parametrize("fault", [None, "upload_corrupt:1.0"])
def test_pull_parity_through_one_seeder(hub, seeder, tmp_path, fault):
    faults.install(fault, seed=SEED)
    mine = _port_pull(hub, tmp_path / "mine", seeder)
    theirs = _ref_pull(hub, tmp_path / "theirs", seeder)
    _assert_parity(mine, theirs)
    # By tier over the network. The cache tier's count is the landing's
    # own bookkeeping, which differs between the packages with or
    # without a swarm (the JAX package's landing books one more read).
    for tier in ("peer", "cdn"):
        assert mine.stats["fetch"]["bytes"][tier] == \
            theirs.stats["fetch"]["bytes"][tier]
        assert mine.stats["fetch"]["xorbs"][tier] == \
            theirs.stats["fetch"]["xorbs"][tier]
    assert mine.stats["fetch"]["p2p_ratio"] == \
        theirs.stats["fetch"]["p2p_ratio"]
    if fault is None:
        assert mine.stats["fetch"]["p2p_ratio"] == 1.0
    else:
        assert mine.stats["fetch"]["p2p_ratio"] == 0.0
        assert mine.stats["swarm"]["corrupt_from_peer"] >= 1
        assert theirs.stats["swarm"]["corrupt_from_peer"] >= 1
        # The port's corruption strikes outlive the transport successes
        # that delivered the bytes; the JAX package's are reset by them.
        assert mine.stats["swarm"]["peers_quarantined"] >= 1
        assert theirs.stats["swarm"]["peers_quarantined"] == 0


def test_pull_parity_with_a_peer_closing_mid_frame(hub, clean, tmp_path):
    """Both packages land the clean tree and files past a peer that
    closes mid-frame. The port strikes the peer and takes every unit
    from the CDN, as for any failed peer; in the JAX package the
    ``WireError`` escapes the swarm, so its landing gives up the direct
    path (no ``streamed``) and its files come through the fallback."""
    peer = GarbledPeer("midframe")
    try:
        mine = _port_pull(hub, tmp_path / "mine", peer.port)
        theirs = _ref_pull(hub, tmp_path / "theirs", peer.port)
    finally:
        peer.close()
    _assert_parity(mine, theirs)
    assert mine.stats["fetch"]["p2p_ratio"] == \
        theirs.stats["fetch"]["p2p_ratio"] == 0.0
    assert mine.stats["fetch"]["bytes"]["peer"] == \
        theirs.stats["fetch"]["bytes"]["peer"] == 0
    assert mine.stats["hbm"]["streamed"] is True
    assert mine.stats["fetch"]["bytes"]["cdn"] == \
        clean.stats["fetch"]["bytes"]["cdn"]
    assert not theirs.stats["hbm"].get("streamed")


class _SlowSwarm:
    """A swarm stand-in whose peer answers after ``delay_s``."""

    def __init__(self, delay_s):
        self.delay_s = delay_s
        self.calls = 0

    def try_peer_download(self, *args, deadline=None):
        self.calls += 1
        time.sleep(self.delay_s)
        return None

    def announce_available(self, *args):
        pass


def test_armed_hedge_races_a_slow_peer_without_deadline(hub, tmp_path):
    """``arm_hedge`` hedges with no pull deadline: the peer gets the fixed
    head start, then the CDN racer serves the term, through the same
    counters as the deadline path."""
    from zest_tpu_torch.transfer import bridge as bridge_mod

    slow = _SlowSwarm(bridge_mod._HEDGE_EVIDENCE_WAIT_S + 2.0)
    b = bridge_mod.XetBridge(_cfg(hub, tmp_path), swarm=slow)
    try:
        b.authenticate(REPO)
        assert b.arm_hedge("stall")["armed"]
        rec = b.get_reconstruction(
            hub.repos[REPO].files["model.safetensors"].xet_hash)
        t0 = time.monotonic()
        result = b.fetch_xorb_for_term(rec.terms[0], rec)
        elapsed = time.monotonic() - t0
    finally:
        b.close()
    assert result.source == "cdn"
    assert slow.calls == 1
    assert elapsed < slow.delay_s
    res = b.stats.summary()["resilience"]
    assert (res["hedges"], res["hedges_won"], res["hedges_lost"]) == (1, 1, 0)
