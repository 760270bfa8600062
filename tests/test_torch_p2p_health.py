"""Peer pool, health registry and swarm candidate logic of the port.

Mirrors tests/test_peer_pool.py (true-LRU eviction among idle
connections) and tests/test_swarm_health.py (strikes, quarantine and
probation, latency ordering, adaptive timeouts, the stale-pooled-socket
retry, deadline starvation, discovery TTLs, reciprocity, transition
events and re-announce) on ``zest_tpu_torch``, with an injected clock
where the module takes one. Then the port's two deliberate divergences,
each held against the JAX package's behavior:

- a codec error (``WireError``, ``XetMessageError``, ``BencodeError``)
  from a peer is a peer failure in ``SwarmDownloader._attempt`` (one
  retry on a reused socket, then a strike); the JAX package's lets it
  escape;
- a corruption strike survives the transport success that delivered the
  corrupt bytes, so a peer whose every response is corrupt is quarantined
  after ``strikes_to_quarantine`` of them; in the JAX package it never is.
"""

import threading
import time

import pytest

import zest_tpu_torch.transfer.swarm as swarm_mod
from zest_tpu.p2p import health as j_health
from zest_tpu.p2p import wire as j_wire
from zest_tpu.transfer import swarm as j_swarm
from zest_tpu.config import Config as JConfig
from zest_tpu_torch.config import Config
from zest_tpu_torch.p2p import bencode, bep_xet, wire
from zest_tpu_torch.p2p.health import HealthRegistry
from zest_tpu_torch.p2p.pool import PeerPool
from zest_tpu_torch.transfer.swarm import SwarmDownloader


# ── PeerPool (mirrors tests/test_peer_pool.py) ──


class IdlePeer:
    def __init__(self):
        self.lock = threading.Lock()
        self.closed = False

    def close(self):
        self.closed = True


@pytest.fixture
def pool(monkeypatch):
    import zest_tpu_torch.p2p.pool as pool_mod

    monkeypatch.setattr(
        pool_mod.BtPeer, "connect",
        staticmethod(lambda *a, **k: IdlePeer()),
    )
    return PeerPool(max_peers=2)


def _get(pool, host):
    return pool.get_or_connect(host, 6881, b"i" * 20, b"p" * 20)


def test_eviction_drops_least_recently_used(pool):
    a = _get(pool, "a")
    b = _get(pool, "b")
    assert _get(pool, "a") is a  # touch refreshes recency
    c = _get(pool, "c")  # at cap: evicts b (LRU), never a (just touched)
    assert len(pool) == 2
    assert b.closed and not a.closed and not c.closed
    assert _get(pool, "a") is a  # a survived
    assert _get(pool, "c") is c


def test_eviction_skips_busy_peer_even_if_lru(pool):
    a = _get(pool, "a")
    b = _get(pool, "b")
    assert _get(pool, "a") is a  # b is now LRU...
    with b.lock:  # ...but mid-request: closing it would kill a transfer
        _get(pool, "c")
    assert not b.closed
    assert a.closed  # the next-least-recent idle peer went instead


def test_all_busy_soft_caps_instead_of_closing(pool):
    a = _get(pool, "a")
    b = _get(pool, "b")
    with a.lock, b.lock:
        c = _get(pool, "c")  # admitted over the cap; nothing closed
    assert len(pool) == 3
    assert not a.closed and not b.closed and not c.closed


def test_remove_and_reconnect(pool):
    a = _get(pool, "a")
    pool.remove("a", 6881)
    assert a.closed and len(pool) == 0
    assert _get(pool, "a") is not a  # fresh connection after removal


def _lease(pool, host):
    return pool.lease(host, 6881, b"i" * 20, b"p" * 20)


def test_lease_reports_reuse(pool):
    a, reused = _lease(pool, "a")
    assert not reused  # fresh connect
    a2, reused2 = _lease(pool, "a")
    assert a2 is a and reused2  # pooled


def test_eviction_race_closes_leased_but_unlocked_peer(pool):
    """The race _evict_one_locked concedes: a thread that leased a peer
    but hasn't taken its stream lock yet can lose the connection to an
    eviction. The contract is (1) the evicted socket is observably
    closed — the victim's request fails rather than hanging — and
    (2) the lease carried reused=True, which is exactly the signal the
    swarm uses to retry once on a fresh connection instead of failing
    the pull (pinned end-to-end by
    test_swarm_health.test_stale_pooled_socket_gets_one_reconnect_retry).
    """
    a = _get(pool, "a")
    _get(pool, "b")
    leased, reused = _lease(pool, "a")  # victim thread's lease...
    assert leased is a and reused
    # ...then, before the victim locks, a third connect evicts at cap.
    # The lease touched `a`, so LRU order protects it — hold b's lock to
    # force the eviction onto `a` (the leased-but-unlocked peer).
    b2, _ = _lease(pool, "b")
    with b2.lock:
        _get(pool, "c")
    assert leased.closed, "evicted peer must be closed, not leaked"
    # The victim's request on the closed peer now fails fast; the swarm
    # turns (reused=True, IO error) into exactly one reconnect retry.
    fresh, fresh_reused = _lease(pool, "a")
    assert fresh is not leased and not fresh_reused


# ── Health and swarm (mirrors tests/test_swarm_health.py) ──
# ── HealthRegistry unit behavior (fake clock) ──


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock():
    return Clock()


@pytest.fixture
def reg(clock):
    return HealthRegistry(strikes_to_quarantine=3, quarantine_base_s=10.0,
                          time_fn=clock)


A, B, C = ("a", 1), ("b", 2), ("c", 3)


def test_strikes_trip_quarantine(reg):
    assert not reg.record_failure(A)
    assert not reg.record_failure(A)
    assert reg.record_failure(A)  # third strike trips the breaker
    assert reg.is_quarantined(A)
    assert reg.summary()["quarantine_events"] == 1


def test_success_resets_strikes(reg):
    reg.record_failure(A)
    reg.record_failure(A)
    reg.record_success(A, rtt_s=0.05)
    assert not reg.record_failure(A)  # back to strike 1 of 3
    assert not reg.is_quarantined(A)


def test_readmit_on_probation_with_doubled_window(reg, clock):
    for _ in range(3):
        reg.record_failure(A)
    assert reg.is_quarantined(A)
    clock.t += 10.1  # base window expires
    assert not reg.is_quarantined(A)
    # Probation: ONE more strike re-quarantines, window doubled.
    assert reg.record_failure(A)
    assert reg.is_quarantined(A)
    clock.t += 10.1
    assert reg.is_quarantined(A), "second window must be longer than base"
    clock.t += 10.0
    assert not reg.is_quarantined(A)


def test_partition_orders_by_latency_and_drops_quarantined(reg):
    reg.record_success(A, rtt_s=0.5)    # known slow
    reg.record_success(B, rtt_s=0.01)   # known fast
    for _ in range(3):
        reg.record_failure(C)           # quarantined
    healthy, shunned = reg.partition([A, B, C])
    assert healthy == [B, A]
    assert shunned == [C]
    # Unknown peers slot between known-fast and known-slow.
    D = ("d", 4)
    healthy, _ = reg.partition([A, B, D])
    assert healthy == [B, D, A]


def test_partition_is_stable_for_unknowns(reg):
    healthy, _ = reg.partition([A, B, C])
    assert healthy == [A, B, C]  # caller priority preserved on ties


def test_adaptive_timeouts_track_ewma(reg):
    assert reg.connect_timeout(A) == 3.0      # tight default, no history
    assert reg.io_timeout(A) == 20.0
    reg.record_success(A, rtt_s=0.02, connect_s=0.01)
    assert reg.connect_timeout(A) == 0.75     # 4x ewma clamped to floor
    assert reg.io_timeout(A) == 2.0           # 8x ewma clamped to floor
    reg.record_success(B, rtt_s=30.0, connect_s=30.0)
    assert reg.connect_timeout(B) == 5.0      # never past legacy ceiling
    assert reg.io_timeout(B) == 60.0


# ── Swarm-level behavior with scripted peers ──


class FakePeer:
    def __init__(self, behavior):
        self.behavior = behavior
        self.lock = threading.Lock()
        self.closed = False
        self.io_timeouts = []

    def request_chunk(self, chunk_hash, start, end, io_timeout=None):
        self.io_timeouts.append(io_timeout)
        return self.behavior(chunk_hash, start, end)

    def close(self):
        self.closed = True


class ScriptedPool:
    """lease() serves a pre-pooled peer once (reused=True), then pops
    scripted connect outcomes (a FakePeer, or an exception to raise)."""

    def __init__(self):
        self.pooled: dict[tuple, FakePeer] = {}
        self.scripts: dict[tuple, list] = {}
        self.leases: list[tuple] = []

    def lease(self, host, port, info_hash, peer_id, listen_port=None,
              connect_timeout=None, io_timeout=None):
        addr = (host, port)
        self.leases.append(addr)
        peer = self.pooled.get(addr)
        if peer is not None:
            return peer, True
        outcome = self.scripts.get(addr, [ConnectionRefusedError("no route")])
        step = outcome.pop(0) if len(outcome) > 1 else outcome[0]
        if isinstance(step, BaseException):
            raise step
        self.pooled[addr] = step
        return step, False

    def remove(self, host, port):
        peer = self.pooled.pop((host, port), None)
        if peer is not None:
            peer.close()

    def close_all(self):
        for addr in list(self.pooled):
            self.remove(*addr)


def _result(data=b"blob", offset=0):
    class R:
        pass

    r = R()
    r.data = data
    r.chunk_offset = offset
    return r


def _swarm(tmp_path, pool, clock=None, strikes=3):
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    health = HealthRegistry(strikes_to_quarantine=strikes,
                            quarantine_base_s=10.0,
                            time_fn=clock or time.monotonic)
    return SwarmDownloader(cfg, peer_sources=[], pool=pool, health=health)


XH = b"x" * 32


def test_dead_peer_quarantined_and_skipped(tmp_path, clock):
    pool = ScriptedPool()
    pool.scripts[("dead", 1)] = [ConnectionRefusedError("refused")]
    swarm = _swarm(tmp_path, pool, clock=clock, strikes=2)
    swarm.add_direct_peer("dead", 1)

    for _ in range(2):
        assert swarm.try_peer_download(XH, "aa", 0, 1) is None
    assert swarm.stats.peers_quarantined == 1
    attempts_before = swarm.stats.peer_attempts
    # Quarantined: the candidate is skipped outright, no new attempts.
    assert swarm.try_peer_download(XH, "aa", 0, 1) is None
    assert swarm.stats.peer_attempts == attempts_before
    summary = swarm.summary()
    assert summary["health"]["quarantined_now"] == 1


def test_corruption_reports_strike_toward_quarantine(tmp_path, clock):
    pool = ScriptedPool()
    swarm = _swarm(tmp_path, pool, clock=clock, strikes=2)
    addr = ("corrupt", 9)
    swarm.report_corrupt(addr)
    assert not swarm.health.is_quarantined(addr)
    swarm.report_corrupt(addr)
    assert swarm.health.is_quarantined(addr)
    assert swarm.stats.corrupt_from_peer == 2
    assert swarm.stats.peers_quarantined == 1
    assert swarm.summary()["health"]["corrupt_strikes"] == 2


def test_stale_pooled_socket_gets_one_reconnect_retry(tmp_path):
    """The PeerPool eviction race / server idle-close contract: an IO
    failure on a REUSED pooled connection surfaces as exactly one
    retried request on a fresh connection — never a failed download,
    never a strike against the innocent peer."""
    pool = ScriptedPool()
    addr = ("peer", 7)

    def stale(*a):
        raise ConnectionResetError("socket closed under us (evicted)")

    pool.pooled[addr] = FakePeer(stale)
    pool.scripts[addr] = [FakePeer(lambda *a: _result(b"payload"))]
    swarm = _swarm(tmp_path, pool, strikes=1)
    swarm.add_direct_peer(*addr)

    got = swarm.try_peer_download(XH, "aa", 0, 1)
    assert got is not None and got.data == b"payload"
    assert got.addr == addr
    assert swarm.stats.peer_retries == 1
    assert swarm.stats.peer_failures == 1
    # With strikes_to_quarantine=1 ANY strike would quarantine: the
    # stale socket must not have been blamed on the peer.
    assert not swarm.health.is_quarantined(addr)
    assert swarm.health._peers[addr].successes == 1


def test_fresh_connection_failure_strikes_without_retry(tmp_path):
    pool = ScriptedPool()
    pool.scripts[("down", 3)] = [ConnectionRefusedError("refused")]
    swarm = _swarm(tmp_path, pool, strikes=1)
    swarm.add_direct_peer("down", 3)
    assert swarm.try_peer_download(XH, "aa", 0, 1) is None
    assert swarm.stats.peer_retries == 0
    assert swarm.health.is_quarantined(("down", 3))


def test_candidates_ordered_by_observed_health(tmp_path):
    pool = ScriptedPool()
    fast, slow = ("fast", 1), ("slow", 2)
    pool.scripts[fast] = [FakePeer(lambda *a: _result(b"f"))]
    pool.scripts[slow] = [FakePeer(lambda *a: _result(b"s"))]
    swarm = _swarm(tmp_path, pool)
    swarm.add_direct_peer(*slow)  # direct order: slow first
    swarm.add_direct_peer(*fast)
    swarm.health.record_success(slow, rtt_s=0.8)
    swarm.health.record_success(fast, rtt_s=0.01)

    got = swarm.try_peer_download(XH, "aa", 0, 1)
    assert got is not None and got.data == b"f"
    assert pool.leases[0] == fast  # health ordering beat direct order


def test_deadline_starved_timeout_does_not_strike(tmp_path):
    """A connect/IO timeout the deadline squeezed below the health-
    derived budget is the BUDGET's failure, not the peer's: no strike,
    or healthy peers would start the next pull quarantined."""
    from zest_tpu_torch.resilience import Deadline

    pool = ScriptedPool()
    pool.scripts[("p", 1)] = [ConnectionRefusedError("budget ran out")]
    swarm = _swarm(tmp_path, pool, strikes=1)
    swarm.add_direct_peer("p", 1)
    tight = Deadline(0.5)  # remaining << default 3s connect budget
    assert swarm.try_peer_download(XH, "aa", 0, 1, deadline=tight) is None
    assert swarm.stats.peer_failures == 1
    assert not swarm.health.is_quarantined(("p", 1))


def test_deadline_abandons_peer_tier(tmp_path):
    from zest_tpu_torch.resilience import Deadline

    pool = ScriptedPool()
    pool.scripts[("p", 1)] = [FakePeer(lambda *a: _result())]
    swarm = _swarm(tmp_path, pool)
    swarm.add_direct_peer("p", 1)
    expired = Deadline(0.0)
    assert swarm.try_peer_download(XH, "aa", 0, 1, deadline=expired) is None
    assert swarm.stats.peer_attempts == 0


# ── Discovery TTLs ──


class CountingSource:
    def __init__(self, results):
        self.results = results  # list of lists, popped per call
        self.calls = 0

    def find_peers(self, info_hash):
        self.calls += 1
        return self.results.pop(0) if len(self.results) > 1 \
            else self.results[0]

    def announce(self, info_hash, port):
        pass


def test_empty_discovery_uses_short_negative_ttl(tmp_path, monkeypatch):
    monkeypatch.setattr(swarm_mod, "NEGATIVE_DISCOVERY_TTL_S", 0.05)
    source = CountingSource([[], [("peer", 1)]])
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    swarm = SwarmDownloader(cfg, peer_sources=[source], pool=ScriptedPool())

    assert swarm.discover_peers(b"i" * 20) == []
    assert swarm.discover_peers(b"i" * 20) == []  # within negative TTL
    assert source.calls == 1
    time.sleep(0.06)
    assert swarm.discover_peers(b"i" * 20) == [("peer", 1)]
    assert source.calls == 2


def test_successful_discovery_keeps_full_ttl(tmp_path):
    source = CountingSource([[("peer", 1)]])
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    swarm = SwarmDownloader(cfg, peer_sources=[source], pool=ScriptedPool())
    for _ in range(3):
        assert swarm.discover_peers(b"i" * 20) == [("peer", 1)]
    assert source.calls == 1


# ── Reciprocity book, strike kinds, transition events ──


def test_served_bytes_accumulates_and_decays(reg, clock):
    reg.record_success(A, nbytes=1_000_000)
    assert reg.served_bytes(A) == pytest.approx(1_000_000)
    reg.record_success(A, nbytes=500_000)
    assert reg.served_bytes(A) == pytest.approx(1_500_000, rel=1e-3)
    clock.t += 120.0  # one reciprocity tau: ~1/e remains
    assert reg.served_bytes(A) == pytest.approx(1_500_000 / 2.718, rel=0.01)
    assert reg.served_bytes(B) == 0.0  # stranger


def test_strike_kinds_visible_in_detail(reg):
    reg.record_failure(A, kind="seed_stall")
    reg.record_failure(A, kind="corrupt")
    reg.record_failure(B, kind="io")
    rows = {r["peer"]: r for r in reg.detail()}
    assert rows["a:1"]["strike_kinds"] == {"corrupt": 1, "seed_stall": 1}
    assert rows["b:2"]["strike_kinds"] == {"io": 1}


def test_transition_events_quarantine_then_probation(reg, clock):
    events = []
    reg.subscribe(lambda ev, addr: events.append((ev, addr)))
    for _ in range(3):
        reg.record_failure(A)
    assert events == [("quarantined", A)]
    # The window expires; the FIRST observation (a partition or
    # is_quarantined query) flips the peer to probation — once.
    clock.t += 10.1
    reg.partition([A, B])
    reg.partition([A])
    assert events == [("quarantined", A), ("probation", A)]
    # Probation re-admit semantics: one more strike re-quarantines.
    assert reg.record_failure(A)
    assert events[-1] == ("quarantined", A)


def test_probation_success_clears_to_full_strikes(reg, clock):
    for _ in range(3):
        reg.record_failure(A)
    clock.t += 10.1
    assert not reg.is_quarantined(A)       # re-admitted on probation
    reg.record_success(A, rtt_s=0.01)      # good behavior clears it
    assert not reg.record_failure(A)       # 1 of 3 again, no trip
    assert not reg.record_failure(A)
    assert reg.record_failure(A)           # full K strikes needed anew


def test_listener_exception_does_not_break_recording(reg):
    reg.subscribe(lambda ev, addr: (_ for _ in ()).throw(RuntimeError()))
    for _ in range(3):
        reg.record_failure(A)              # must not raise
    assert reg.is_quarantined(A)


class RecordingSource:
    def __init__(self):
        self.announces = []

    def find_peers(self, info_hash):
        return []

    def announce(self, info_hash, port):
        self.announces.append((info_hash, port))


def _eventually(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def test_quarantine_transition_triggers_reannounce(tmp_path, clock):
    """Quarantine-aware announce: a breaker trip (and the later
    probation re-admit) replays the announce for every swarm this host
    registered with. The sweep is asynchronous — the observing thread
    (a pull worker, a serve loop) must never block on tracker HTTP —
    so the assertions poll."""
    source = RecordingSource()
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    health = HealthRegistry(strikes_to_quarantine=2,
                            quarantine_base_s=10.0, time_fn=clock)
    swarm = SwarmDownloader(cfg, peer_sources=[source],
                            pool=ScriptedPool(), health=health)
    swarm.announce_available(XH, "aa")
    base = len(source.announces)
    assert base == 1

    for _ in range(2):
        health.record_failure(("bad", 9))
    assert _eventually(                        # quarantine re-announce
        lambda: len(source.announces) >= base + 1
        and swarm.stats.reannounces == 1), (
        source.announces, swarm.stats.reannounces)

    clock.t += 10.1
    health.partition([("bad", 9)])             # probation observation
    # Within the coalescing window the transition still fires, but the
    # per-swarm dedup skips the tracker round trip — a quarantine
    # storm re-registers each swarm once per window, not once per
    # transition.
    time.sleep(0.2)
    assert len(source.announces) == base + 1
    assert swarm.stats.reannounces == 1

    clock.t += swarm_mod.REANNOUNCE_WINDOW_S + 0.1
    for _ in range(2):
        health.record_failure(("bad", 9))      # re-trip past the window
    assert _eventually(
        lambda: len(source.announces) >= base + 2
        and swarm.stats.reannounces == 2), (
        source.announces, swarm.stats.reannounces)


def test_reannounce_without_prior_announce_is_noop(tmp_path, clock):
    source = RecordingSource()
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    health = HealthRegistry(strikes_to_quarantine=2,
                            quarantine_base_s=10.0, time_fn=clock)
    swarm = SwarmDownloader(cfg, peer_sources=[source],
                            pool=ScriptedPool(), health=health)
    for _ in range(2):
        health.record_failure(("bad", 9))
    time.sleep(0.1)  # nothing async should have been spawned either
    assert source.announces == []
    assert swarm.stats.reannounces == 0


def test_io_timeout_after_lease_attributed_as_seed_stall(tmp_path):
    """A peer that leases fine but times out mid-request stalled AS A
    SEEDER — struck with the distinct seed_stall kind (health.detail()
    separates 'serves, slowly-to-death' from 'unreachable'). A connect
    failure stays kind 'error'."""
    pool = ScriptedPool()
    stall_peer = FakePeer(lambda *a: (_ for _ in ()).throw(
        TimeoutError("stalled serving us")))
    pool.scripts[("stall", 1)] = [stall_peer]
    pool.scripts[("dead", 2)] = [ConnectionRefusedError("refused")]
    swarm = _swarm(tmp_path, pool)
    swarm.add_direct_peer("stall", 1)
    assert swarm.try_peer_download(XH, "aa", 0, 1) is None
    swarm.add_direct_peer("dead", 2)
    assert swarm.try_peer_download(XH, "aa", 0, 1) is None
    rows = {r["peer"]: r for r in swarm.health.detail()}
    assert rows["stall:1"]["strike_kinds"].get("seed_stall", 0) >= 1
    assert "error" not in rows["stall:1"]["strike_kinds"]
    assert rows["dead:2"]["strike_kinds"] == {"error": 1}


def test_close_unsubscribes_from_shared_registry(tmp_path, clock):
    """A closed swarm must not keep re-announcing on a shared
    registry's later transitions (zombie announces for a listen_port
    nobody serves)."""
    source = RecordingSource()
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    health = HealthRegistry(strikes_to_quarantine=2,
                            quarantine_base_s=10.0, time_fn=clock)
    swarm = SwarmDownloader(cfg, peer_sources=[source],
                            pool=ScriptedPool(), health=health)
    swarm.announce_available(XH, "aa")
    swarm.close()
    for _ in range(2):
        health.record_failure(("bad", 9))
    time.sleep(0.1)  # an async sweep would have landed by now
    assert len(source.announces) == 1  # only the original announce
    assert swarm.stats.reannounces == 0


# ── The port's divergences, against the JAX package ──


CODEC_ERRORS = [wire.WireError("connection closed mid-frame"),
                bep_xet.XetMessageError("unknown XET message type 0x99"),
                bencode.BencodeError("invalid type byte")]


def _raiser(exc):
    def behave(*a):
        raise exc
    return behave


@pytest.mark.parametrize("exc", CODEC_ERRORS,
                         ids=lambda e: type(e).__name__)
def test_codec_error_on_reused_socket_gets_one_retry(tmp_path, exc):
    """A malformed or truncated frame on a pooled socket is handled like
    a stale socket: one fresh-reconnect retry, no strike."""
    pool = ScriptedPool()
    addr = ("peer", 7)
    pool.pooled[addr] = FakePeer(_raiser(exc))
    pool.scripts[addr] = [FakePeer(lambda *a: _result(b"payload"))]
    swarm = _swarm(tmp_path, pool, strikes=1)
    swarm.add_direct_peer(*addr)
    got = swarm.try_peer_download(XH, "aa", 0, 1)
    assert got is not None and got.data == b"payload"
    assert swarm.stats.peer_retries == 1
    assert swarm.stats.peer_failures == 1
    assert not swarm.health.is_quarantined(addr)


@pytest.mark.parametrize("exc", CODEC_ERRORS,
                         ids=lambda e: type(e).__name__)
def test_codec_error_on_fresh_socket_strikes(tmp_path, exc):
    """On a fresh connection the same error is the peer's: the socket is
    dropped, the peer struck (kind ``error``), and the caller gets None
    (the next tier serves)."""
    pool = ScriptedPool()
    addr = ("garbled", 3)
    pool.scripts[addr] = [FakePeer(_raiser(exc))]
    swarm = _swarm(tmp_path, pool, strikes=1)
    swarm.add_direct_peer(*addr)
    assert swarm.try_peer_download(XH, "aa", 0, 1) is None
    assert swarm.stats.peer_failures == 1
    assert swarm.stats.peers_quarantined == 1
    assert addr not in pool.pooled  # the socket was dropped
    rows = {r["peer"]: r for r in swarm.health.detail()}
    assert rows["garbled:3"]["strike_kinds"] == {"error": 1}


def test_reference_attempt_lets_a_wire_error_escape(tmp_path):
    """The JAX package's ``_attempt`` catches ``(PeerError, OSError)``
    only: the same scripted peer's ``WireError`` escapes
    ``try_peer_download`` there (the fault the port's copy repairs)."""
    pool = ScriptedPool()
    addr = ("garbled", 3)
    pool.scripts[addr] = [FakePeer(_raiser(
        j_wire.WireError("connection closed mid-frame")))]
    cfg = JConfig(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    swarm = j_swarm.SwarmDownloader(
        cfg, peer_sources=[], pool=pool,
        health=j_health.HealthRegistry(strikes_to_quarantine=1))
    swarm.add_direct_peer(*addr)
    try:
        with pytest.raises(j_wire.WireError):
            swarm.try_peer_download(XH, "aa", 0, 1)
    finally:
        swarm.close()


def _corrupting_rounds(reg, addr, rounds):
    """What a peer whose every response is corrupt produces: the swarm
    records the delivery, then the bridge's verify reports it."""
    tripped = []
    for _ in range(rounds):
        reg.record_success(addr, rtt_s=0.01, nbytes=1000)
        tripped.append(reg.record_failure(addr, kind="corrupt"))
    return tripped


def test_corrupt_strikes_survive_transport_success(clock):
    reg = HealthRegistry(strikes_to_quarantine=3, quarantine_base_s=10.0,
                         time_fn=clock)
    assert _corrupting_rounds(reg, A, 3) == [False, False, True]
    assert reg.is_quarantined(A)
    theirs = j_health.HealthRegistry(strikes_to_quarantine=3,
                                     quarantine_base_s=10.0, time_fn=clock)
    assert _corrupting_rounds(theirs, A, 6) == [False] * 6
    assert not theirs.is_quarantined(A)


def test_quarantine_discharges_corrupt_strikes(reg, clock):
    """A trip discharges the corruption strikes: after the window the
    peer is on probation like any other, and a clean success clears
    it."""
    _corrupting_rounds(reg, A, 3)
    clock.t += 10.1
    assert not reg.is_quarantined(A)
    reg.record_success(A, rtt_s=0.01)
    assert not reg.record_failure(A)
    assert not reg.record_failure(A)
    assert reg.record_failure(A)


def test_transport_strikes_still_clear_on_success(reg):
    reg.record_failure(A, kind="corrupt")
    reg.record_failure(A, kind="seed_stall")
    reg.record_success(A, rtt_s=0.01)
    assert reg.detail()[0]["strikes"] == 1  # the corruption stands
    assert not reg.record_failure(A)
    assert reg.record_failure(A)


def test_demote_shifts_ordering_without_a_strike(reg, clock):
    """A demotion takes the peer out of candidate ordering for one base
    window and re-admits it with the record its behaviour earned: no
    strike, no failure, the same events as a trip."""
    events = []
    reg.subscribe(lambda ev, addr: events.append((ev, addr)))
    reg.record_success(A, rtt_s=0.01)
    assert reg.demote(A) == 10.0
    assert reg.partition([A, B]) == ([B], [A])
    row = reg.detail()[0]
    assert (row["strikes"], row["failures"], row["quarantines"]) == (0, 0, 0)
    assert reg.summary()["demotions"] == 1
    clock.t += 10.1
    assert reg.partition([A, B])[1] == []
    assert events == [("demoted", A), ("probation", A)]


def test_announce_xorbs_announces_each_cached_xorb(tmp_path):
    source = RecordingSource()
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 listen_port=6999)
    swarm = SwarmDownloader(cfg, peer_sources=[source], pool=ScriptedPool())
    keys = ["%064x" % i for i in (1, 2, 3)]
    assert swarm.announce_xorbs(keys) == 3
    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.p2p import peer_id

    assert source.announces == [
        (peer_id.compute_info_hash(hashing.hex_to_hash(k)), 6999)
        for k in keys]
    assert swarm.stats.announces == 3
