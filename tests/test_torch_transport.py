"""The port's exchange transports against the JAX package's, on the CPU.

Mirrors tests/test_transport.py without the lossy cases (the port refuses
``ZEST_COLLECTIVE_LOSSY`` other than 0). One conformance suite runs the
three backends — the DCN wire, the loopback fabric, and the device lane
(``jax``, on ``device="cpu"`` here) — against one warm owner served over
a socket and registered in the fabric under the same address: tagged
windows with byte-identical payloads, NOT_FOUND, an abort on
``dcn_reset``, clock offsets. The lane width equals the reference's
``JaxIciTransport`` lane for the same plan; ``serve_chunk_range`` answers
as the reference's with byte-exact flags; the default REQUEST's wire bytes
are the reference's; and rounds over the loopback and device-lane
backends keep the reference's stats.
"""

from __future__ import annotations

import struct
import threading

import numpy as np
import pytest

from tests.fixtures import FixtureHub, FixtureRepo
from zest_tpu.cas.hub import HubClient as JHubClient
from zest_tpu.config import Config as JConfig
from zest_tpu.transfer import coop as j_coop
from zest_tpu.transfer import dcn as j_dcn
from zest_tpu.transfer import transport as j_transport
from zest_tpu.transfer.bridge import XetBridge as JXetBridge
from zest_tpu.transfer.federated import (
    warm_units_parallel as j_warm_units_parallel,
)
from zest_tpu_torch import faults
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.config import Config
from zest_tpu_torch.transfer import collective as coll
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.coop import CoopPlan, coop_round
from zest_tpu_torch.transfer.dcn import (
    FLAG_LOSSY,
    FLAG_LOSSY_OK,
    FLAG_QUANT_OK,
    DcnNotFound,
    DcnPool,
    DcnRequest,
    DcnResponse,
    DcnServer,
    encode_message,
    serve_chunk_range,
)
from zest_tpu_torch.transfer.federated import warm_units_parallel
from zest_tpu_torch.transfer.transport import (
    LINK_ICI,
    DeviceLaneTransport,
    TransportUnavailable,
    make_transport,
    register_loopback,
    reset_loopback,
)

REPO_ID = "acme/transport-model"
# weights.bin: float32 (BG4-compressible); blob.bin: incompressible bytes
# (stored chunks); config.json: a small non-float file.
_RNG = np.random.default_rng(11)
FILES = {
    "config.json": b'{"model_type": "transport"}',
    "weights.bin": _RNG.standard_normal(100_000).astype("<f4").tobytes(),
    "blob.bin": _RNG.bytes(300_000),
}
BACKENDS = ("dcn", "loopback", "jax")


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO_ID, FILES, chunks_per_xorb=2)) as h:
        yield h


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    reset_loopback()
    j_transport.reset_loopback()
    yield
    faults.reset()
    reset_loopback()
    j_transport.reset_loopback()


def _cfg(hub, root, **kw):
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, dcn_port=0, **kw)


def _bridge(hub, root, **kw):
    b = XetBridge(_cfg(hub, root, **kw))
    b.authenticate(REPO_ID)
    return b


def _jbridge(hub, root, **kw):
    b = JXetBridge(JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                           hf_token="hf_test", endpoint=hub.url, dcn_port=0,
                           **kw))
    b.authenticate(REPO_ID)
    return b


def _recs(bridge):
    return [bridge.get_reconstruction(e.xet_hash)
            for e in HubClient(bridge.cfg).list_files(REPO_ID) if e.is_xet]


def _jrecs(bridge):
    return [bridge.get_reconstruction(e.xet_hash)
            for e in JHubClient(bridge.cfg).list_files(REPO_ID) if e.is_xet]


@pytest.fixture
def owner(hub, tmp_path):
    """A fully warmed owner, over a DCN socket and in the loopback fabric
    under the same address."""
    b = _bridge(hub, tmp_path / "owner")
    recs = _recs(b)
    warm_units_parallel(b, recs)
    server = DcnServer(b.cfg, b.cache)
    addr = ("127.0.0.1", server.start())
    register_loopback(addr, b.cfg, b.cache)
    yield b, recs, CoopPlan.build(recs, 2), addr
    server.shutdown()


def _wants(bridge, recs, k=3):
    rec = next(r for r in recs if len(r.fetch_info) >= 1)
    wants, expect = [], []
    for hh, entries in sorted(rec.fetch_info.items())[:k]:
        fi = entries[0]
        wants.append((hashing.hex_to_hash(hh), fi.range.start,
                      fi.range.end))
        found = serve_chunk_range(bridge.cfg, bridge.cache, wants[-1][0],
                                  fi.range.start, fi.range.end)
        assert found is not None
        expect.append(found)
    return wants, expect


def _link(backend):
    return LINK_ICI if backend == "jax" else "dcn"


def _transport(backend, pool, plan):
    return make_transport(backend, pool, plan=plan, device="cpu")


# ── conformance: one suite, three backends ──


@pytest.mark.parametrize("backend", BACKENDS)
def test_tagged_window_roundtrip(owner, backend):
    b, recs, plan, addr = owner
    pool = DcnPool()
    try:
        t = _transport(backend, pool, plan)
        assert t.name == backend
        wants, expect = _wants(b, recs)
        wants.append((b"\xab" * 32, 0, 1))  # unknown → NOT_FOUND
        tag = t.window_tag()
        assert 0 < tag <= 0xFFFF
        replies = t.request_window(0, addr, wants, timeout=10.0, tag=tag,
                                   link=_link(backend))
        assert len(replies) == len(wants)
        for reply, (off, blob, flags) in zip(replies, expect):
            assert isinstance(reply, DcnResponse)
            assert (reply.chunk_offset, reply.data, reply.flags) == \
                (off, blob, flags) and flags == 0
        assert isinstance(replies[-1], DcnNotFound)
        c = t.counters
        assert c["tagged_windows"] >= 1 and c["untagged_windows"] == 0
        assert c["requests"] >= len(wants)
        if backend == "jax":
            assert c["ici_windows"] == 1 and c["lane_overflows"] == 0
            assert c["ici_lane_bytes"] == len(expect) * t.lane_bytes
    finally:
        pool.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_abort_mid_phase_raises_connection_error(owner, backend):
    b, recs, plan, addr = owner
    faults.install("dcn_reset:1.0", seed=1)
    pool = DcnPool()
    try:
        t = _transport(backend, pool, plan)
        with pytest.raises((ConnectionError, TimeoutError, OSError)):
            t.request_window(0, addr, _wants(b, recs, k=1)[0], timeout=5.0,
                             tag=t.window_tag(), link=_link(backend))
    finally:
        pool.close()
    assert faults.counters().get("dcn_reset", 0) > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_clock_offsets_shape(owner, backend):
    b, recs, plan, addr = owner
    pool = DcnPool()
    try:
        t = _transport(backend, pool, plan)
        t.request_window(0, addr, _wants(b, recs, k=1)[0], timeout=10.0,
                         tag=t.window_tag(), link=_link(backend))
        offs = t.clock_offsets()
        assert isinstance(offs, dict)
        if backend == "dcn":
            assert list(offs) == [addr]
            for row in offs.values():
                assert isinstance(row["offset_s"], float)
                assert isinstance(row["rtt_s"], float)
    finally:
        pool.close()


def test_lane_overflow_passes_on_the_host(owner):
    b, recs, plan, addr = owner
    pool = DcnPool()
    try:
        t = DeviceLaneTransport(pool, device="cpu")  # one 64 KiB lane
        wants, expect = _wants(b, recs)
        big = [i for i, (_o, blob, _f) in enumerate(expect)
               if len(blob) > t.lane_bytes]
        assert big, "the fixture has no unit wider than one quantum"
        replies = t.request_window(0, addr, wants, timeout=10.0,
                                   tag=t.window_tag(), link=LINK_ICI)
        assert [r.data for r in replies] == [blob for _o, blob, _f in expect]
        assert t.counters["lane_overflows"] == len(big)
    finally:
        pool.close()


def test_lane_width_matches_reference(hub, tmp_path):
    """A pure function of the fingerprint-identical plan: every host gets
    the same lane, and it is the reference's for that plan."""
    recs = _recs(_bridge(hub, tmp_path / "p"))
    jrecs = _jrecs(_jbridge(hub, tmp_path / "j"))
    pool, jpool = DcnPool(), j_dcn.DcnPool()
    try:
        for n in (2, 4):
            ours = {DeviceLaneTransport(pool, CoopPlan.build(r, n),
                                        device="cpu").lane_bytes
                    for r in (recs, list(reversed(recs)))}
            ref = j_transport.JaxIciTransport(
                jpool, j_coop.CoopPlan.build(jrecs, n)).lane_bytes
            assert ours == {ref}
            assert ref % (64 * 1024) == 0
    finally:
        pool.close()
        jpool.close()


def test_unknown_backend_raises():
    with pytest.raises(TransportUnavailable):
        make_transport("carrier-pigeon", None)


def test_device_lane_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        make_transport("jax", DcnPool())


# ── the serving decision and the wire ──


def test_serve_chunk_range_is_byte_exact_whatever_the_flags(owner, hub,
                                                            tmp_path):
    b, recs, _plan, _addr = owner
    jb = _jbridge(hub, tmp_path / "jowner")
    j_warm_units_parallel(jb, _jrecs(jb))
    wants, _ = _wants(b, recs)
    wants.append((b"\xcd" * 32, 0, 1))
    for h, start, end in wants:
        want = j_dcn.serve_chunk_range(jb.cfg, jb.cache, h, start, end)
        for flags in (0, FLAG_LOSSY_OK, FLAG_LOSSY_OK | FLAG_QUANT_OK):
            assert serve_chunk_range(b.cfg, b.cache, h, start, end,
                                     flags) == want
    assert (FLAG_LOSSY, FLAG_LOSSY_OK, FLAG_QUANT_OK) == (
        j_dcn.FLAG_LOSSY, j_dcn.FLAG_LOSSY_OK, j_dcn.FLAG_QUANT_OK)


def test_default_request_wire_bytes_pinned():
    h = bytes(range(32))
    body = struct.pack("<32sQQ", h, 3, 9)
    for ours, theirs in (
            (DcnRequest(7, h, 3, 9, tag=5),
             j_dcn.DcnRequest(7, h, 3, 9, tag=5)),
            (DcnRequest(7, h, 3, 9, tag=5, flags=FLAG_LOSSY_OK),
             j_dcn.DcnRequest(7, h, 3, 9, tag=5, flags=FLAG_LOSSY_OK)),
            (DcnResponse(7, 42, b"abc"), j_dcn.DcnResponse(7, 42, b"abc"))):
        assert encode_message(ours) == j_dcn.encode_message(theirs)
    assert encode_message(DcnRequest(7, h, 3, 9, tag=5)) == \
        struct.pack("<BBHII", 1, 0, 5, 7, len(body)) + body


# ── rounds per backend ──


class _SpyPool(DcnPool):
    """Records the keyword shape of every window the pool sends."""

    def __init__(self):
        super().__init__()
        self.window_kwargs: list[dict] = []

    def request_many(self, host, port, wants, **kwargs):
        self.window_kwargs.append(dict(kwargs))
        return super().request_many(host, port, wants, **kwargs)


def _run_hosts(hub, tmp_path, n, ref=False, pools=None, **cfg_kw):
    make, recs_of, server_cls, round_fn, register = (
        (_jbridge, _jrecs, j_dcn.DcnServer, j_coop.coop_round,
         j_transport.register_loopback) if ref else
        (_bridge, _recs, DcnServer, coop_round, register_loopback))
    bridges, servers, addrs = [], [], {}
    for i in range(n):
        b = make(hub, tmp_path / f"{'ref' if ref else 'h'}{i}", **cfg_kw)
        s = server_cls(b.cfg, b.cache)
        addrs[i] = ("127.0.0.1", s.start())
        register(addrs[i], b.cfg, b.cache)
        bridges.append(b)
        servers.append(s)
    results, errors = [None] * n, []

    def run(i):
        kw = {} if ref else {"device": "cpu"}
        if pools and i in pools:
            kw["dcn_pool"] = pools[i]
        try:
            results[i] = round_fn(bridges[i], recs_of(bridges[i]), i, n,
                                  addrs, server=servers[i], **kw)
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append((i, exc))

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for s in servers:
        s.shutdown()
    assert not errors, errors
    return bridges, results


def _assert_fully_cached(bridge, root):
    before = bridge.stats.bytes_from_cdn
    for e in HubClient(bridge.cfg).list_files(REPO_ID):
        if e.is_xet:
            bridge.reconstruct_to_file(e.xet_hash, root / "check.bin")
            assert (root / "check.bin").read_bytes() == FILES[e.path]
    assert bridge.stats.bytes_from_cdn == before


@pytest.mark.parametrize("backend,topo", [("loopback", None),
                                          ("jax", (0, 0, 1, 1))])
def test_round_per_backend_matches_reference(hub, tmp_path, backend, topo):
    kw = {"collective_backend": backend, "coop_topology": topo}
    bridges, results = _run_hosts(hub, tmp_path, 4, **kw)
    _jb, ref = _run_hosts(hub, tmp_path, 4, ref=True, **kw)
    for i, (b, r) in enumerate(zip(bridges, results)):
        cx, rx = r["collective"], ref[i]["collective"]
        assert set(r) == set(ref[i]) and set(cx) == set(rx)
        assert cx["backend"] == rx["backend"] == backend
        for key in ("schedule", "phases", "matrix_skew", "link_bytes",
                    "unit_round_trips"):
            assert cx[key] == rx[key], key
        assert "aborted" not in cx and "lossy" not in cx
        assert r["fallbacks"] == 0 and r["exchange"]["units"] > 0
        assert r["exchange"]["wire_bytes"] == ref[i]["exchange"]["wire_bytes"]
        assert sum(cx["link_bytes"].values()) == r["exchange"]["wire_bytes"]
        if topo:
            assert cx["link_bytes"]["ici"] > 0 and cx["link_bytes"]["dcn"] > 0
        _assert_fully_cached(b, tmp_path / f"h{i}")


def test_dcn_backend_keeps_the_point_to_point_call_shape(hub, tmp_path):
    spies = {i: _SpyPool() for i in range(2)}
    try:
        bridges, results = _run_hosts(hub, tmp_path, 2, pools=spies)
    finally:
        for spy in spies.values():
            spy.close()
    for i, (b, r) in enumerate(zip(bridges, results)):
        cx = r["collective"]
        assert "backend" not in cx and "aborted" not in cx
        _assert_fully_cached(b, tmp_path / f"h{i}")
    for spy in spies.values():
        assert spy.window_kwargs
        for kw in spy.window_kwargs:
            assert set(kw) == {"timeout", "tag"} and kw["tag"]


def test_collective_env_defaults(tmp_path):
    env = {"HF_HOME": str(tmp_path / "hf"),
           "ZEST_CACHE_DIR": str(tmp_path / "z")}
    cfg, ref = Config.load(env), JConfig.load(env)
    assert (cfg.collective_backend, cfg.collective_lossy) == \
        (ref.collective_backend, ref.collective_lossy) == ("dcn", "0")
    assert coll.slice_topology(2, cfg=cfg) == (0, 0)
