"""The port's streaming landing against the JAX package's, on the CPU.

Mirrors tests/test_streaming.py on its Llama-shaped fixture
(``llama_checkpoint_files(0.012, shard_bytes=3 MiB, scale=8)``: five
shards of bf16 random bytes):

- the landing order (``layer_priority``, ``order_names``,
  ``first_layer_names``) equals ``zest_tpu.models.registry``'s;
- the streamed and the stream-off ``pull_model(device="cpu")`` land trees
  whose ``params_digest`` equals the JAX package's direct landing, in the
  checkpoint's dtype and with ``land_dtype="bf16"``; files exact; stats,
  ``hbm`` and stage keys equal to the reference's;
- ``0 < time_to_first_layer_s < time_to_hbm_s``, the ring's byte bound
  under a tiny budget, the oversized-alone admission, ``HostRing`` close,
  reuse and detach accounting, and no reuse where landed tensors alias
  their slots;
- the cooperative round's plan fingerprint does not depend on the
  priorities, and a cooperative pull ordered by them takes one copy of
  the units from the CDN;
- the ring knobs parse from the environment, strictly.
"""

from __future__ import annotations

import threading
import time

import pytest

from tests.fixtures import FixtureHub, FixtureRepo
from zest_tpu.bench_scale import llama_checkpoint_files
from zest_tpu.config import Config as JConfig
from zest_tpu.models import loader as j_loader
from zest_tpu.models import registry as j_registry
from zest_tpu.transfer import pull as j_pull
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import loader, registry
from zest_tpu_torch.models.direct import unit_layer_priorities
from zest_tpu_torch.models.loader import HostRing, RingClosed
from zest_tpu_torch.transfer import coop
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.dcn import DcnServer
from zest_tpu_torch.transfer.pod import fetch_file_header
from zest_tpu_torch.transfer.pull import pull_model

REPO = "acme/streaming"
FILES = llama_checkpoint_files(0.012, shard_bytes=3 * 1024 * 1024, scale=8)
SHARDS = sorted(n for n in FILES if n.endswith(".safetensors"))
# Port-only pull stats: the device name and the whole-file fallbacks.
PORT_ONLY = {"device", "fallback_files"}


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO, FILES, chunks_per_xorb=8)) as h:
        yield h


def _cfg(hub, root, **kw) -> Config:
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _pull(hub, root, **kw):
    return pull_model(_cfg(hub, root, **kw), REPO, device="cpu",
                      no_p2p=True, log=_quiet)


def _ref_pull(hub, root, **kw):
    return j_pull.pull_model(
        JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                hf_token="hf_test", endpoint=hub.url, **kw),
        REPO, device="tpu", pod=False, no_p2p=True, log=_quiet)


def _assert_files_exact(res):
    for name, data in FILES.items():
        assert (res.snapshot_dir / name).read_bytes() == data, name


# ── Landing order (models/registry.py) ──

NAMES = ["model.embed_tokens.weight", "transformer.wte.weight",
         "transformer.wpe.weight", "model.layers.0.mlp.up_proj.weight",
         "model.layers.17.input_layernorm.weight", "h.3.attn.c_attn.weight",
         "blocks.2.norm.weight", "lm_head.weight", "model.norm.weight",
         "totally.unknown.tensor", "h.11.ln_2.bias", "ln_f.weight",
         "wte.weight", "model.layers.10.self_attn.q_proj.weight"]
NAME_LISTS = [
    ["lm_head.weight", "model.layers.1.a", "model.layers.0.b",
     "model.embed_tokens.weight", "model.layers.0.a", "model.norm.weight"],
    ["model.embed_tokens.weight", "model.layers.2.a", "model.layers.5.a",
     "model.norm.weight"],
    ["alpha.weight", "beta.weight"],
    ["h.1.mlp.c_fc.weight", "wpe.weight", "h.0.ln_1.weight", "ln_f.bias",
     "wte.weight", "h.0.attn.c_proj.bias"],
    [],
]


@pytest.mark.parametrize("name", NAMES)
def test_layer_priority_matches_reference(name):
    assert registry.layer_priority(name) == j_registry.layer_priority(name)


@pytest.mark.parametrize("names", NAME_LISTS)
def test_order_and_first_layer_match_reference(names):
    assert registry.order_names(names) == j_registry.order_names(names)
    assert registry.first_layer_names(names) == \
        j_registry.first_layer_names(names)


# ── End to end: identity and schema ──


@pytest.mark.parametrize("land_dtype", [None, "bf16"])
def test_streamed_pull_identical_and_first_layer_early(hub, tmp_path,
                                                       land_dtype):
    on = _pull(hub, tmp_path / "on", land_dtype=land_dtype)
    off = _pull(hub, tmp_path / "off", land_stream=False,
                land_dtype=land_dtype)
    ref = _ref_pull(hub, tmp_path / "ref", land_dtype=land_dtype)
    ref_off = _ref_pull(hub, tmp_path / "ref_off", land_stream=False,
                        land_dtype=land_dtype)
    digest = j_loader.params_digest(ref.params)
    assert loader.params_digest(on.params) == digest
    assert loader.params_digest(off.params) == digest
    _assert_files_exact(on)
    _assert_files_exact(off)

    hbm = on.stats["hbm"]
    assert hbm["direct"] is hbm["streamed"] is True
    ring = hbm["ring"]
    assert ring["buffers_allocated"] > 0
    assert ring["peak_bytes"] <= ring["budget_bytes"]
    assert ring["buffer_reuses"] == 0  # cpu: landed tensors alias slots
    tfl = on.stats["time_to_first_layer_s"]
    assert 0 < tfl < on.stats["time_to_hbm_s"]
    assert on.stats["stages"]["first_layer"] == pytest.approx(tfl, abs=0.05)

    # The reference's schema, less the parts not ported.
    for mine, theirs in ((on, ref), (off, ref_off)):
        assert set(mine.stats) - PORT_ONLY == set(theirs.stats)
        assert set(mine.stats["hbm"]) == set(theirs.stats["hbm"])
        assert set(mine.stats["hbm"].get("ring", {})) == set(
            theirs.stats["hbm"].get("ring", {}))
        assert set(mine.stats["hbm"]["warm"]) == set(
            theirs.stats["hbm"]["warm"])
        assert set(mine.stats["stages"]) == set(theirs.stats["stages"])
        assert set(mine.stats["files_pipeline"]) == set(
            theirs.stats["files_pipeline"])
        assert mine.stats["files_pipeline"]["lane_bytes"].get(
            "tensors", 0) > 0
        assert mine.stats["hbm"]["warm"]["units"] == \
            theirs.stats["hbm"]["warm"]["units"]
    assert "time_to_first_layer_s" not in off.stats
    assert "first_layer" not in off.stats["stages"]
    assert off.stats["hbm"]["decode_ahead"] is True


def test_tiny_ring_budget_bound_holds(hub, tmp_path):
    """A ring far below the fixture's tensors: in-flight staging stays
    within max(budget, largest read), a read being its run's bytes (a
    tensor alone when it is larger than the ring) plus its slot's 16-byte
    alignment."""
    largest = 512 * 1024
    res = _pull(hub, tmp_path, land_ring_bytes=largest, land_ring_slots=2)
    ring = res.stats["hbm"]["ring"]
    biggest_tensor = max(t.numel() * t.element_size()
                         for t in res.params.values())
    assert ring["budget_bytes"] == largest
    assert ring["peak_bytes"] <= max(largest, biggest_tensor + 15)
    assert ring["oversized"] > 0
    _assert_files_exact(res)


def test_oversized_alone_never_deadlocks(hub, tmp_path):
    res = _pull(hub, tmp_path, land_ring_bytes=1, land_ring_slots=1)
    assert res.stats["hbm"]["ring"]["oversized"] > 0
    assert res.stats["hbm"]["streamed"] is True
    _assert_files_exact(res)


# ── HostRing ──


def test_hostring_close_wakes_blocked_acquire():
    ring = HostRing(100, 1)
    slot = ring.acquire(100)
    errors: list = []

    def blocked():
        try:
            ring.acquire(100)
        except RingClosed as exc:
            errors.append(exc)

    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    time.sleep(0.15)  # let it stall (counted)
    ring.close()
    t.join(timeout=5)
    assert not t.is_alive()
    assert errors and isinstance(errors[0], RingClosed)
    assert ring.stalls >= 1
    slot.release()


def test_hostring_reuse_and_detach_accounting():
    ring = HostRing(1000, 8)
    a = ring.acquire(400)
    a.release()
    b = ring.acquire(300)  # smallest-fit reuse of the 400-byte buffer
    assert ring.reuses == 1 and ring.allocs == 1
    assert b.view.nbytes == 300 and b.acct == 400
    b.addref()
    b.detach()  # the detached bytes leave the bound
    c = ring.acquire(900)
    assert ring.peak_bytes <= 1000 + 400
    b.release()
    b.release()
    assert ring.detached == 1
    c.release()
    ring.close()


def test_hostring_pools_detached_buffer_after_last_release():
    """A slot the file sink detached goes back to the pool once the sink
    releases it too, if the budget has room."""
    ring = HostRing(1000, 8)
    a = ring.acquire(400)
    a.addref()
    a.detach()
    a.release()  # the device copy's reference
    assert ring.acquire(100, block=False) is not None  # bytes surrendered
    a.release()  # the sink's
    assert ring.detached == 1
    ring.acquire(300)
    assert (ring.allocs, ring.reuses) == (2, 1)
    ring.close()


def test_hostring_single_use_when_landed_tensors_alias_slots():
    ring = HostRing(1000, 8, reuse=False)
    for _ in range(3):
        ring.acquire(200).release()
    assert ring.allocs == 3 and ring.reuses == 0


# ── Cooperative round: priorities order, never plan ──


def _coop_hosts(hub, root, n, run):
    """``n`` in-process hosts with a DCN server each, ``run(i, bridge,
    addrs, server)`` in a thread per host; returns the results."""
    bridges, servers, addrs = [], [], {}
    for i in range(n):
        b = XetBridge(_cfg(hub, root / f"h{i}", dcn_port=0))
        b.authenticate(REPO)
        bridges.append(b)
        s = DcnServer(b.cfg, b.cache)
        addrs[i] = ("127.0.0.1", s.start())
        servers.append(s)
    results: list = [None] * n
    errors: list = []

    def host(i):
        try:
            results[i] = run(i, bridges[i], addrs, servers[i])
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    threads = [threading.Thread(target=host, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for s in servers:
        s.shutdown()
    for b in bridges:
        b.close()
    assert not errors, errors
    return results


def test_coop_fingerprint_unchanged_by_priorities(hub, tmp_path):
    def recs_of(bridge):
        return [bridge.get_reconstruction(e.xet_hash)
                for e in HubClient(bridge.cfg).list_files(REPO) if e.is_xet]

    def priorities(bridge, recs):
        shards = [r for r in recs if r.file_hash.hex() in {
            hub.repos[REPO].files[n].xet_hash for n in SHARDS}]
        return unit_layer_priorities(
            [(r, fetch_file_header(bridge, r)) for r in shards])

    unordered: list = []

    def ordered(i, b, addrs, server):
        recs = recs_of(b)
        unordered.append(
            coop.CoopPlan.build(recs, 2, frozenset()).fingerprint()[:16])
        return coop.coop_round(b, recs, i, 2, addrs, device="cpu",
                               server=server,
                               priorities=priorities(b, recs))

    results = _coop_hosts(hub, tmp_path, 2, ordered)
    assert len({r["plan"]["fingerprint"] for r in results}
               | set(unordered)) == 1
    for r in results:
        assert r["exchange"]["units"] > 0


def test_coop_pull_ordered_by_priorities_takes_one_copy(hub, tmp_path):
    """Two hosts' cooperative pulls, ordered by the head-frame probe's
    headers: one copy of the units from the CDN between them (plus the
    few KB the probes read), both landing directly with the solo digest."""
    def run(i, b, addrs, server):
        return pull_model(b.cfg, REPO, device="cpu", coop=True,
                          coop_hosts=2, coop_index=i,
                          coop_addrs={j: a for j, a in addrs.items()
                                      if j != i},
                          coop_server=server, log=_quiet)

    results = _coop_hosts(hub, tmp_path, 2, run)
    solo = _ref_pull(hub, tmp_path / "ref")
    plan_bytes = results[0].stats["coop"]["plan"]["total_bytes"]
    cdn = sum(r.stats["fetch"]["bytes"]["cdn"] for r in results)
    assert plan_bytes <= cdn <= 1.05 * plan_bytes
    for r in results:
        assert r.stats["coop"]["fallbacks"] == 0
        assert r.stats["hbm"]["direct"] is True
        assert loader.params_digest(r.params) == j_loader.params_digest(
            solo.params)
        _assert_files_exact(r)


# ── Config ──


def test_config_ring_env_parsing():
    base = {"HF_HOME": "/tmp/x", "ZEST_CACHE_DIR": "/tmp/y"}
    cfg = Config.load({**base, "ZEST_LAND_STREAM": "1",
                       "ZEST_LAND_RING_BYTES": "8388608",
                       "ZEST_LAND_RING_SLOTS": "7",
                       "ZEST_TPU_DTYPE": "bf16"})
    assert cfg.land_stream is True
    assert cfg.land_ring_bytes == 8 * 1024 * 1024
    assert cfg.land_ring_slots == 7
    assert cfg.land_dtype == "bf16"
    assert Config.load({**base, "ZEST_LAND_STREAM": "0"}).land_stream is False
    defaults, ref = Config.load(base), JConfig.load(base)
    for key in ("land_stream", "land_ring_bytes", "land_ring_slots",
                "land_decode_ahead", "decode_workers", "decode_cache_bytes",
                "files_async", "files_workers", "pull_inflight_bytes",
                "land_dtype"):
        assert getattr(defaults, key) == getattr(ref, key), key
    for bad in ({"ZEST_LAND_RING_BYTES": "256mb"},
                {"ZEST_LAND_RING_SLOTS": "many"},
                {"ZEST_LAND_STREAM": "false"}):
        with pytest.raises(ValueError):
            Config.load({**base, **bad})
