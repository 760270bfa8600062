"""The multi-tenant pull service of the port, held to the JAX package's.

Mirrors ``tests/test_tenancy.py``: singleflight outcomes, the admission
controller's deficit-round-robin order, eviction under pins and the
strict knobs are driven through both packages and must agree; two
concurrent ``pull_model`` calls fetch each xorb once and land the JAX
package's ``params_digest``; a cancel stops a pull (queued, mid-transfer
or mid-landing, the token fired from the landing's first-layer hook)
with nothing left behind; ENOSPC surfaces as ``CacheFullError``; and
``ZEST_TENANCY=0`` keeps the stats schema. Everything runs on the CPU
over a loopback fixture hub.
"""

from __future__ import annotations

import errno
import hashlib
import os
import random
import shutil
import threading
import time

import pytest

from tests.fixtures import FixtureHub, FixtureRepo, gpt2_checkpoint_files
from zest_tpu import storage as j_storage
from zest_tpu import telemetry as j_telemetry
from zest_tpu.config import Config as JConfig
from zest_tpu.models import loader as j_loader
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer import tenancy as j_tenancy
from zest_tpu_torch import storage, telemetry
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import direct, loader
from zest_tpu_torch.telemetry import session as session_mod
from zest_tpu_torch.transfer import pull as pull_mod
from zest_tpu_torch.transfer import tenancy
from zest_tpu_torch.transfer.pull import pull_model
from zest_tpu_torch.transfer.tenancy import (
    AdmissionController,
    AdmissionRejected,
    CacheEvictor,
    CancelToken,
    PinBook,
    PullCancelled,
)

PACKAGES = {"port": tenancy, "reference": j_tenancy}


@pytest.fixture(autouse=True)
def clean_state():
    for mod, tel in ((tenancy, telemetry), (j_tenancy, j_telemetry)):
        tel.reset_all()
        mod.reset()
    yield
    for mod, tel in ((tenancy, telemetry), (j_tenancy, j_telemetry)):
        tel.reset_all()
        mod.reset()


# Two revisions sharing most content: rev B chunk-dedups against rev A's
# xorbs, so two pulls contend for the same fetch units. Seeded random
# bytes: incompressible, so a shaped hub bounds the wire rate.
_MODEL_A = random.Random(7).randbytes(768 * 1024)
BASE_FILES = {
    "config.json": b'{"model_type": "test"}',
    "model.safetensors": _MODEL_A,
    "tokenizer.json": b'{"tok": 1}' * 64,
}
REV_B_FILES = dict(BASE_FILES)
REV_B_FILES["model.safetensors"] = (
    _MODEL_A[:-65536] + random.Random(8).randbytes(65536))
GPT2_FILES = gpt2_checkpoint_files(n_embd=64, n_layer=4, vocab_size=256,
                                   seed=15)


def _quiet(*_a, **_k):
    pass


def _cfg(hub, root, **kw):
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _jcfg(hub, root, **kw):
    return JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                   hf_token="hf_test", endpoint=hub.url, **kw)


def _files_only(cfg, repo, **kw):
    """The JAX package's ``device=None`` pull: files, no landing."""
    return pull_model(cfg, repo, device="cpu", land=False, no_p2p=True,
                      log=_quiet, **kw)


def _digests(snapshot_dir) -> dict:
    return {str(f.relative_to(snapshot_dir)):
            hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(snapshot_dir.rglob("*")) if f.is_file()}


def _ref_digest(hub, root, repo, revision="main") -> str:
    """The JAX package's landing of ``repo@revision`` on the CPU."""
    ref = j_pull.pull_model(_jcfg(hub, root), repo, revision=revision,
                            no_p2p=True, log=_quiet)
    params, _ = j_loader.stage_snapshot_to_hbm(ref.snapshot_dir)
    return j_loader.params_digest(params)


# ── Singleflight: the same sequence through both packages ──


def _sf_leader_then_waiter(mod):
    sf = mod.Singleflight()
    role, flight = sf.join("k")
    got = []
    t = threading.Thread(target=lambda: got.append(sf.wait(sf.join("k")[1])))
    t.start()
    time.sleep(0.05)
    sf.resolve(flight)
    t.join(2)
    return [role, *got, sf.join("k")[0]]


def _sf_failed(mod):
    sf = mod.Singleflight()
    _role, flight = sf.join("k")
    got = []
    t = threading.Thread(target=lambda: got.append(sf.wait(sf.join("k")[1])))
    t.start()
    time.sleep(0.05)
    boom = RuntimeError("cdn exploded")
    sf.fail(flight, boom)
    t.join(2)
    return [*got, flight.error is boom]


def _sf_abdicate_to_waiter(mod):
    sf = mod.Singleflight()
    _role, flight = sf.join("k")
    got = []
    t = threading.Thread(target=lambda: got.append(sf.wait(sf.join("k")[1])))
    t.start()
    time.sleep(0.05)
    sf.abdicate(flight)  # the leader's session was cancelled
    t.join(2)
    return [*got, sf.summary()["outcomes"]]


def _sf_abdicate_alone(mod):
    sf = mod.Singleflight()
    _role, flight = sf.join("k")
    sf.abdicate(flight)
    return [sf.join("k")[0]]  # a fresh flight, not poisoned


def _sf_cancelled_waiter(mod):
    sf = mod.Singleflight()
    _role, flight = sf.join("k")
    token = mod.CancelToken()
    got = []
    t = threading.Thread(target=lambda: got.append(
        sf.wait(sf.join("k")[1], cancel=token)))
    t.start()
    time.sleep(0.05)
    token.cancel()
    t.join(2)
    t2 = threading.Thread(target=lambda: got.append(sf.wait(sf.join("k")[1])))
    t2.start()
    sf.resolve(flight)
    t2.join(2)
    return got


@pytest.mark.parametrize("scenario, expected", [
    (_sf_leader_then_waiter, ["lead", "done", "lead"]),
    (_sf_failed, ["failed", True]),
    (_sf_abdicate_to_waiter,
     ["lead", {"leader": 1, "waiter": 0, "handoff": 1}]),
    (_sf_abdicate_alone, ["lead"]),
    (_sf_cancelled_waiter, ["cancelled", "done"]),
], ids=["leader_then_waiter", "failed_flight", "abdicate_to_waiter",
        "abdicate_alone", "cancelled_waiter"])
def test_singleflight_outcomes_equal_reference(scenario, expected):
    assert scenario(tenancy) == scenario(j_tenancy) == expected


# ── Concurrent overlapping pulls ──


def test_one_fetch_per_shared_xorb_and_identical_files(tmp_path):
    repo = FixtureRepo("acme/tenants", dict(BASE_FILES), chunks_per_xorb=2)
    rev_b = repo.add_revision(dict(REV_B_FILES))
    rev_a = repo._rev_order[0]
    with FixtureHub(repo) as hub:
        solo = {rev: _digests(_files_only(_cfg(hub, tmp_path / f"solo{i}"),
                                          "acme/tenants",
                                          revision=rev).snapshot_dir)
                for i, rev in enumerate((rev_a, rev_b))}
        hub.xorb_fetches.clear()
        cfg = _cfg(hub, tmp_path / "shared")
        results: dict = {}
        barrier = threading.Barrier(2)

        def pull(rev, tenant):
            barrier.wait()
            results[rev] = _files_only(cfg, "acme/tenants", revision=rev,
                                       tenant=tenant)

        ts = [threading.Thread(target=pull, args=(rev_a, "t-a")),
              threading.Thread(target=pull, args=(rev_b, "t-b"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        gets = list(hub.xorb_fetches)
    assert set(results) == {rev_a, rev_b}
    for rev, res in results.items():
        assert _digests(res.snapshot_dir) == solo[rev]
    assert len(gets) == len(set(gets)), f"duplicate fetches: {sorted(gets)}"


def test_concurrent_landings_fetch_once_and_land_reference_digest(tmp_path):
    """Two tenants land one GPT-2 revision at once: every CDN unit moves
    once (the other tenant waits on the flight, or hits the cache), both
    trees are the JAX package's landing, and both sessions end ok under
    their tenants."""
    with FixtureHub(FixtureRepo("acme/gpt2", GPT2_FILES,
                                chunks_per_xorb=2)) as hub:
        want = _ref_digest(hub, tmp_path / "ref", "acme/gpt2")
        hub.xorb_fetches.clear()
        cfg = _cfg(hub, tmp_path / "shared")
        results: dict = {}
        barrier = threading.Barrier(2)

        def pull(tenant):
            barrier.wait()
            results[tenant] = pull_model(cfg, "acme/gpt2", device="cpu",
                                         no_p2p=True, tenant=tenant,
                                         log=_quiet)

        ts = [threading.Thread(target=pull, args=(t,)) for t in ("t0", "t1")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        gets = list(hub.xorb_fetches)
    assert len(gets) == len(set(gets)), f"duplicate fetches: {sorted(gets)}"
    for res in results.values():
        assert loader.params_digest(res.params) == want
    cdn = sum(r.stats["fetch"]["bytes"]["cdn"] for r in results.values())
    one_copy = sum(r.stats["fetch"]["bytes"]["cdn"]
                   + r.stats["fetch"]["bytes"]["cache"]
                   for r in results.values()) / 2
    assert cdn <= 1.02 * one_copy
    assert {(s.tenant, s.status) for s in session_mod.SESSIONS.recent()} \
        == {("t0", "ok"), ("t1", "ok")}
    assert tenancy.summary(cfg)["active"] == 0


def test_knob_off_pulls_are_independent_and_schema_identical(tmp_path):
    with FixtureHub(FixtureRepo("acme/knoboff", dict(BASE_FILES),
                                chunks_per_xorb=2)) as hub:
        on = _files_only(_cfg(hub, tmp_path / "on"), "acme/knoboff")
        off = _files_only(_cfg(hub, tmp_path / "off", tenancy_enabled=False),
                          "acme/knoboff")
        j_on = j_pull.pull_model(_jcfg(hub, tmp_path / "jon"),
                                 "acme/knoboff", no_p2p=True, log=_quiet)
        j_off = j_pull.pull_model(
            _jcfg(hub, tmp_path / "joff", tenancy_enabled=False),
            "acme/knoboff", no_p2p=True, log=_quiet)
    assert _digests(on.snapshot_dir) == _digests(off.snapshot_dir)
    # Tenancy adds no key to a pull's stats, in either package.
    assert set(on.stats) == set(off.stats)
    assert set(j_on.stats) == set(j_off.stats)
    assert (on.stats["files_pipeline"]["budget_bytes"]
            == off.stats["files_pipeline"]["budget_bytes"])


def test_knob_off_status_has_no_tenancy_block(tmp_path):
    def blocks(mod, config):
        off = config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "z",
                     tenancy_enabled=False)
        on = config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "z")
        first = mod.summary(off)
        mod.state(on)
        return first, mod.summary(off), mod.summary(on)

    port, ref = blocks(tenancy, Config), blocks(j_tenancy, JConfig)
    assert port[:2] == ref[:2] == (None, None)
    # The same status block, key for key, nested blocks included.
    assert port[2] == ref[2]


# ── Admission control ──


def test_immediate_admit_within_budget():
    c = AdmissionController(max_pulls=2, max_queue=4)
    c.acquire("a")
    c.acquire("b")
    assert c.summary()["active"] == 2


def _drr_order(mod) -> list[str]:
    c = mod.AdmissionController(max_pulls=1, max_queue=8)
    c.acquire("warm")  # hold the only slot
    order: list[str] = []
    lock = threading.Lock()

    def enter(name, tenant):
        c.acquire(tenant)
        with lock:
            order.append(name)

    threads = []
    # Tenant a queues three sessions before tenant b's one: deficit
    # round-robin still alternates.
    for name, tenant in (("a1", "a"), ("a2", "a"), ("a3", "a"),
                         ("b1", "b")):
        t = threading.Thread(target=enter, args=(name, tenant))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 2
        while c.summary()["queued"] < len(threads) \
                and time.monotonic() < deadline:
            time.sleep(0.005)
    for i in range(4):
        c.release()
        deadline = time.monotonic() + 2
        while len(order) < i + 1 and time.monotonic() < deadline:
            time.sleep(0.005)
    for t in threads:
        t.join(2)
    return order


def test_fair_queue_deficit_round_robin_equals_reference():
    assert _drr_order(tenancy) == _drr_order(j_tenancy) \
        == ["a1", "b1", "a2", "a3"]


def test_queue_full_rejects_typed_with_retry_after():
    c = AdmissionController(max_pulls=1, max_queue=0)
    c.acquire("a")
    with pytest.raises(AdmissionRejected) as ei:
        c.acquire("b")
    assert ei.value.retry_after_s >= 1.0
    assert c.summary()["rejected_total"] == 1
    assert c.probe_reject() == (True, ei.value.retry_after_s)


def test_cancel_token_callbacks_run_once_and_untie():
    token = CancelToken()
    calls: list[str] = []
    token.on_cancel(lambda: calls.append("a"))
    untie = token.on_cancel(lambda: calls.append("b"))
    untie()
    token.cancel("first")
    token.cancel("second")
    assert calls == ["a"] and token.reason == "first"
    token.on_cancel(lambda: calls.append("late"))()  # fired: runs at once
    assert calls == ["a", "late"]
    with pytest.raises(PullCancelled, match="first"):
        token.check()


def test_cancel_while_queued_leaves_the_queue():
    c = AdmissionController(max_pulls=1, max_queue=4)
    c.acquire("a")
    token = CancelToken()
    errs = []

    def waiter():
        try:
            c.acquire("b", cancel=token)
        except PullCancelled as exc:
            errs.append(exc)

    t = threading.Thread(target=waiter)
    t.start()
    deadline = time.monotonic() + 2
    while c.summary()["queued"] < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    token.cancel("test abort")
    t.join(2)
    assert len(errs) == 1
    assert c.summary()["queued"] == 0
    c.release()
    c.acquire("c")  # the slot was never consumed


def test_queued_phase_visible_on_session():
    c = AdmissionController(max_pulls=1, max_queue=4)
    c.acquire("a")
    sess = session_mod.begin("x/y", "main", tenant="b")
    done = threading.Event()

    def waiter():
        c.acquire("b", session=sess)
        done.set()

    t = threading.Thread(target=waiter)
    t.start()
    deadline = time.monotonic() + 2
    while sess.snapshot()["phase"] != "queued" \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    assert sess.snapshot()["phase"] == "queued"
    c.release()
    assert done.wait(2)
    assert sess.snapshot()["phase"] == "starting"
    t.join(2)


def test_shed_evicts_queued_waiters_with_retry_after():
    c = AdmissionController(max_pulls=1, max_queue=4)
    c.acquire("a")
    errs = []
    t = threading.Thread(target=lambda: errs.append(
        pytest.raises(AdmissionRejected, c.acquire, "b")))
    t.start()
    deadline = time.monotonic() + 2
    while c.summary()["queued"] < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    shed = c.shed()
    t.join(2)
    assert shed["tenant"] == "b" and shed["shed"] == 1 and len(errs) == 1
    with pytest.raises(AdmissionRejected):
        c.acquire("c")  # shedding: a session that would queue is refused
    assert c.recover() == {"was_shedding": True, "queued": 0}


def test_state_registers_the_shed_target_and_no_timeline_probe(
        tmp_path, monkeypatch):
    """The process state registers the ``shed`` remediation target, as
    the JAX package's does; with ``ZEST_TIMELINE=0`` it registers no
    timeline probe (the knob-off store stays empty)."""
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "z")
    st = tenancy.state(cfg)
    assert telemetry.remediate.invoke("shed", "shed")["shed"] == 0
    assert st.controller.shedding
    assert telemetry.remediate.invoke("shed", "recover") \
        == {"was_shedding": True, "queued": 0}
    tenancy.reset()
    assert telemetry.remediate.invoke("shed", "recover") is None
    monkeypatch.setenv("ZEST_TIMELINE", "0")
    telemetry.reset_all()
    tenancy.state(cfg)
    assert telemetry.timeline.STORE._probes == {}
    assert telemetry.remediate.invoke("shed", "shed") is None


def test_state_registers_the_four_timeline_probes_and_unregisters_them(
        tmp_path):
    """The JAX package's four tenancy probes, by name and by value on
    the same controller state; ``reset`` takes them back."""
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "z")
    jcfg = JConfig(hf_home=tmp_path / "hf", cache_dir=tmp_path / "jz")
    states = {"port": tenancy.state(cfg), "reference": j_tenancy.state(jcfg)}
    probes = {"port": telemetry.timeline.STORE._probes,
              "reference": j_telemetry.timeline.STORE._probes}
    assert set(probes["port"]) == set(probes["reference"]) \
        == set(tenancy.TIMELINE_PROBES)
    for st in states.values():
        st.controller.acquire("a")
    values = {k: {n: float(fn()) for n, fn in probes[k].items()}
              for k in probes}
    assert values["port"] == values["reference"]
    assert values["port"]["tenancy.active_pulls"] == 1.0
    for st in states.values():
        st.controller.release()
    tenancy.reset()
    assert not set(tenancy.TIMELINE_PROBES) & \
        set(telemetry.timeline.STORE._probes)


def test_pull_model_rejects_when_saturated(tmp_path):
    with FixtureHub(FixtureRepo("acme/reject", dict(BASE_FILES),
                                chunks_per_xorb=2)) as hub:
        cfg = _cfg(hub, tmp_path, tenant_max_pulls=1, tenant_queue=0)
        st = tenancy.state(cfg)
        st.controller.acquire("hog")  # the only slot
        try:
            with pytest.raises(AdmissionRejected):
                _files_only(cfg, "acme/reject")
        finally:
            st.controller.release()
    recent = session_mod.SESSIONS.recent()
    assert recent and recent[0].snapshot()["status"] == "rejected"


# ── Eviction and pins ──


def _fake_entry(cache_dir, hash_hex, size, age_s, suffix=""):
    p = cache_dir / hash_hex[:2] / (hash_hex + suffix)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(b"x" * size)
    old = time.time() - age_s
    os.utime(p, (old, old))
    return p


def test_eviction_evicts_the_reference_hashes(tmp_path):
    """One cache directory, copied: the port's evictor and the JAX
    package's, with the same pins and watermarks, leave the same
    entries."""
    src = tmp_path / "src"
    rng = random.Random(3)
    hashes = [f"{i:02x}" + rng.randbytes(31).hex() for i in range(12)]
    for i, h in enumerate(hashes):
        _fake_entry(src, h, 1024 * (1 + i % 3), age_s=100 + 37 * i,
                    suffix=".8" if i % 4 == 3 else "")
    pinned = hashes[::5]
    left = {}
    for name, mod in PACKAGES.items():
        root = tmp_path / name
        shutil.copytree(src, root, copy_function=shutil.copy2)
        pins = mod.PinBook()
        pins.pin("sess:1", pinned)
        ev = mod.CacheEvictor(root, high_bytes=10000, low_bytes=6000,
                              pins=pins)
        assert ev.maybe_evict() > 0
        left[name] = sorted(p.name for p in root.rglob("*") if p.is_file())
        assert all(any(n.startswith(h) for n in left[name])
                   for h in pinned)
    assert left["port"] == left["reference"]


def test_lru_eviction_never_evicts_pinned(tmp_path):
    cache = tmp_path / "xorbs"
    pinned_hash, old_hash, new_hash = ("aa" + "0" * 62, "bb" + "1" * 62,
                                       "cc" + "2" * 62)
    p_pin = _fake_entry(cache, pinned_hash, 4096, age_s=300)
    p_old = _fake_entry(cache, old_hash, 4096, age_s=200)
    p_new = _fake_entry(cache, new_hash, 4096, age_s=10)
    pins = PinBook()
    pins.pin("sess:1", [pinned_hash])
    ev = CacheEvictor(cache, high_bytes=10000, low_bytes=8192, pins=pins)
    assert ev.maybe_evict() > 0
    assert p_pin.exists() and p_new.exists() and not p_old.exists()
    assert ev.pinned_survivals >= 1
    assert ev.usage_bytes() <= 8192


def test_partial_entries_pin_under_their_xorb_hash(tmp_path):
    cache = tmp_path / "xorbs"
    h = "dd" + "3" * 62
    part = _fake_entry(cache, h, 2048, age_s=100, suffix=".4")
    pins = PinBook()
    pins.pin("sess:1", [h])
    CacheEvictor(cache, high_bytes=1024, low_bytes=512,
                 pins=pins).maybe_evict()
    assert part.exists()


def test_enospc_trigger_evicts_unconditionally(tmp_path):
    cache = tmp_path / "xorbs"
    _fake_entry(cache, "ee" + "4" * 62, 1024, age_s=50)
    ev = CacheEvictor(cache, high_bytes=1 << 30, low_bytes=0, pins=PinBook())
    assert ev.maybe_evict() == 0       # well under the watermark
    assert ev.on_enospc() is True      # frees down to half the usage
    assert ev.usage_bytes() == 0


def test_eviction_events_reach_the_flight_recorder(tmp_path):
    cache = tmp_path / "xorbs"
    _fake_entry(cache, "ff" + "5" * 62, 2048, age_s=50)
    CacheEvictor(cache, high_bytes=1024, low_bytes=0,
                 pins=PinBook()).maybe_evict()
    assert "cache_evict" in [e["kind"] for e in telemetry.recorder.tail()]


def test_reads_touch_mtime_so_eviction_is_lru_not_fifo(tmp_path):
    """A recently read entry outlives a colder one written later, in the
    port's cache as in the JAX package's."""
    for name, (store, config, mod) in {
            "port": (storage, Config, tenancy),
            "reference": (j_storage, JConfig, j_tenancy)}.items():
        cfg = config(hf_home=tmp_path / name / "hf",
                     cache_dir=tmp_path / name / "z")
        cache = store.XorbCache(cfg)
        hot, cold = "aa" + "6" * 62, "bb" + "7" * 62
        cache.put(hot, b"h" * 2048)
        os.utime(cfg.xorb_cache_path(hot), (time.time() - 500,) * 2)
        cache.put(cold, b"c" * 2048)
        os.utime(cfg.xorb_cache_path(cold), (time.time() - 100,) * 2)
        assert cache.get(hot) is not None  # the read freshens it
        mod.CacheEvictor(cfg.xorb_cache_dir(), high_bytes=2048,
                         low_bytes=2048, pins=mod.PinBook()).maybe_evict()
        assert cfg.xorb_cache_path(hot).exists(), name
        assert not cfg.xorb_cache_path(cold).exists(), name


def test_release_unpins():
    pins = PinBook()
    pins.pin("sess:1", ["h1", "h2"])
    pins.pin("sess:2", ["h2"])
    pins.release("sess:1")
    assert not pins.pinned("h1") and pins.pinned("h2")
    pins.release("sess:2")
    assert not pins.pinned("h2")
    pins.replace("tree:a/b", ["h3"])
    pins.replace("tree:a/b", ["h4"])  # a newer revision's tree
    assert not pins.pinned("h3") and pins.pinned("h4")


def test_eviction_mid_pull_degrades_to_refetch(tmp_path):
    with FixtureHub(FixtureRepo("acme/evict", dict(BASE_FILES),
                                chunks_per_xorb=2)) as hub:
        cfg = _cfg(hub, tmp_path)
        d1 = _digests(_files_only(cfg, "acme/evict").snapshot_dir)
        for sub in cfg.xorb_cache_dir().iterdir():
            for f in sub.iterdir():
                f.unlink()
        cfg2 = Config(hf_home=tmp_path / "hf2", cache_dir=cfg.cache_dir,
                      hf_token="hf_test", endpoint=hub.url)
        assert _digests(_files_only(cfg2, "acme/evict").snapshot_dir) == d1


def test_landed_tree_pins_its_xorbs(tmp_path):
    """A landed tree pins every xorb of its revision past its session's
    pins (``tree:<repo>``), and the serving pool's ``release_tree``
    drops them."""
    with FixtureHub(FixtureRepo("acme/pin", GPT2_FILES,
                                chunks_per_xorb=2)) as hub:
        cfg = _cfg(hub, tmp_path)
        pull_model(cfg, "acme/pin", device="cpu", no_p2p=True, log=_quiet)
    pins = tenancy.state(cfg).pins
    cached = storage.list_cached_xorbs(cfg)
    assert cached and all(pins.pinned(h) for h in cached)
    assert pins.summary()["owners"] == 1  # the session's own pins went
    assert tenancy.release_tree(cfg, "acme/pin") is True
    assert not any(pins.pinned(h) for h in cached)


# ── Cancellation ──


def test_cancel_mid_pull_terminal_status_cancelled(tmp_path):
    with FixtureHub(FixtureRepo("acme/cancel", dict(BASE_FILES),
                                chunks_per_xorb=2),
                    throttle_bps=200_000) as hub:
        cfg = _cfg(hub, tmp_path, max_concurrent_downloads=2)
        token = CancelToken()
        errs: list = []

        def run():
            try:
                _files_only(cfg, "acme/cancel", cancel=token)
            except PullCancelled as exc:
                errs.append(exc)

        t = threading.Thread(target=run)
        t.start()
        deadline = time.monotonic() + 10
        while not session_mod.SESSIONS.active_ids() \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)  # into the transfer
        token.cancel("test kill")
        t.join(30)
    assert len(errs) == 1
    assert session_mod.SESSIONS.recent()[0].snapshot()["status"] \
        == "cancelled"
    assert tenancy.state(cfg).controller.summary()["active"] == 0
    leftovers = [p for p in cfg.hub_dir().rglob("*.safetensors")
                 if p.is_file()
                 and p.stat().st_size != len(BASE_FILES["model.safetensors"])]
    assert leftovers == []


def test_cancelled_tenant_leaves_concurrent_tenant_unharmed(tmp_path):
    repo = FixtureRepo("acme/iso", dict(BASE_FILES), chunks_per_xorb=2)
    rev_b = repo.add_revision(dict(REV_B_FILES))
    rev_a = repo._rev_order[0]
    with FixtureHub(repo) as hub:
        solo = _digests(_files_only(_cfg(hub, tmp_path / "solo"),
                                    "acme/iso", revision=rev_b).snapshot_dir)
        cfg = _cfg(hub, tmp_path / "shared")
        token = CancelToken()
        token.cancel("pre-cancelled tenant")  # dies at its first boundary
        out: dict = {}

        def victim():
            try:
                _files_only(cfg, "acme/iso", revision=rev_a,
                            tenant="victim", cancel=token)
            except PullCancelled as exc:
                out["victim"] = exc

        def healthy():
            out["res"] = _files_only(cfg, "acme/iso", revision=rev_b,
                                     tenant="healthy")

        ts = [threading.Thread(target=victim),
              threading.Thread(target=healthy)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
    assert isinstance(out["victim"], PullCancelled)
    assert _digests(out["res"].snapshot_dir) == solo


def test_cancel_mid_landing_leaves_nothing_behind(tmp_path, monkeypatch):
    """The token fires from the streaming landing's first-layer hook:
    the pull raises ``PullCancelled``, its session ends ``cancelled``, no
    thread of the pull is alive, every ring slot is back, no
    complete-named partial file is in the snapshot, and the admission
    slot and the session's pins are released."""
    rings: list = []

    class _Ring(loader.HostRing):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            rings.append(self)

    monkeypatch.setattr(loader, "HostRing", _Ring)
    token = CancelToken()
    real = pull_mod.stage_cached_to_hbm

    def hooked(*a, on_first_layer=None, **k):
        def fire():
            if on_first_layer is not None:
                on_first_layer()
            token.cancel("first layer committed")
        return real(*a, on_first_layer=fire, **k)

    monkeypatch.setattr(pull_mod, "stage_cached_to_hbm", hooked)
    # The timeline sampler and the term-decode pool are the process's,
    # started by the first pull and kept for the process's life (the
    # pool grows a thread a task up to its width): start both in full
    # before counting, so that what is left is the pull's own.
    telemetry.timeline.ensure_started()
    width = direct.resolve_decode_workers()
    pool = direct._shared_decode_pool(width)
    if pool is not None:
        gate = threading.Barrier(width + 1)
        for _ in range(width):
            pool.submit(gate.wait, 10)
        gate.wait(10)
    before = set(threading.enumerate())
    with FixtureHub(FixtureRepo("acme/land", GPT2_FILES,
                                chunks_per_xorb=2)) as hub:
        # A small ring and one slot a group: many commit groups.
        cfg = _cfg(hub, tmp_path, land_ring_bytes=256 * 1024,
                   land_ring_slots=4)
        with pytest.raises(PullCancelled):
            pull_model(cfg, "acme/land", device="cpu", no_p2p=True,
                       cancel=token, tenant="t2", log=_quiet)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        alive = [t for t in set(threading.enumerate()) - before
                 if t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    assert alive == []
    assert token.fired and len(rings) == 1
    ring = rings[0]
    assert ring.summary()["buffers_allocated"] > 1  # it got under way
    assert ring._in_use == 0 and ring._in_use_bytes == 0
    snap = session_mod.SESSIONS.recent()[0].snapshot()
    assert (snap["status"], snap["tenant"]) == ("cancelled", "t2")
    for f in cfg.hub_dir().rglob("*"):
        if f.is_file() and f.name in GPT2_FILES:
            assert f.stat().st_size == len(GPT2_FILES[f.name]), f
        assert not f.name.endswith(".safetensors"), f
    st = tenancy.state(cfg)
    assert st.controller.summary()["active"] == 0
    assert st.pins.summary() == {"owners": 0, "pinned_hashes": 0}


def test_delete_endpoint_fires_token(tmp_path):
    from zest_tpu_torch.api.http_api import HttpApi

    api = HttpApi(Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "z"),
                  device="cpu")
    try:
        sess = session_mod.begin("a/b", "main")
        sess.cancel_token = CancelToken()
        payload, code = api.cancel_pull(sess.id)
        assert code == 202 and payload["status"] == "cancelling"
        assert sess.cancel_token.fired
        assert api.cancel_pull("nope")[1] == 404
        session_mod.finish(sess, "cancelled", error="test")
        assert api.cancel_pull(sess.id)[1] == 409
    finally:
        api.close()


# ── ENOSPC → CacheFullError ──


class _FlakyDisk:
    """``os.fdopen`` whose first ``failures`` writes raise ENOSPC."""

    def __init__(self, failures: int):
        self.left = failures

    def install(self, monkeypatch):
        real = os.fdopen
        flaky = self

        def fake(fd, *a, **kw):
            f = real(fd, *a, **kw)
            if flaky.left <= 0:
                return f
            flaky.left -= 1

            class _Full:
                def __enter__(self):
                    return self

                def __exit__(self, *exc):
                    f.close()
                    return False

                def write(self, b):
                    raise OSError(errno.ENOSPC, "No space left on device")

            return _Full()

        monkeypatch.setattr(storage.os, "fdopen", fake)


def test_typed_error_cleans_temps_and_fires_event(tmp_path, monkeypatch):
    _FlakyDisk(failures=10).install(monkeypatch)
    dest = tmp_path / "cache" / "aa" / "entry"
    with pytest.raises(storage.CacheFullError) as ei:
        storage.atomic_write(dest, b"payload")
    assert ei.value.errno == errno.ENOSPC
    assert not dest.exists() and list(dest.parent.glob(".tmp-*")) == []
    assert "disk_pressure" in [e["kind"] for e in telemetry.recorder.tail()]


def test_eviction_hook_earns_one_retry(tmp_path, monkeypatch):
    _FlakyDisk(failures=1).install(monkeypatch)
    calls = []
    storage.set_disk_full_hook(lambda: calls.append(1) or True)
    dest = tmp_path / "cache" / "aa" / "entry"
    storage.atomic_write(dest, b"payload")  # the retry succeeds
    assert dest.read_bytes() == b"payload" and calls == [1]


def test_second_enospc_after_the_retry_raises(tmp_path, monkeypatch):
    """One retry only: a disk still full after the eviction pass raises
    (and the hook ran once)."""
    _FlakyDisk(failures=2).install(monkeypatch)
    calls = []
    storage.set_disk_full_hook(lambda: calls.append(1) or True)
    dest = tmp_path / "cache" / "aa" / "entry"
    with pytest.raises(storage.CacheFullError):
        storage.atomic_write(dest, b"payload")
    assert calls == [1] and not dest.exists()


def test_bridge_fetch_survives_cache_full(tmp_path, monkeypatch):
    """ENOSPC on the xorb-cache write does not fail the pull: the fetched
    bytes serve uncached."""
    def full(*_a, **_k):
        raise storage.CacheFullError("disk full (test)", None)

    repo = FixtureRepo("acme/full", dict(BASE_FILES), chunks_per_xorb=2)
    with FixtureHub(repo) as hub:
        monkeypatch.setattr(storage.XorbCache, "put", full)
        monkeypatch.setattr(storage.XorbCache, "put_partial", full)
        res = _files_only(_cfg(hub, tmp_path), "acme/full")
    for path, fx in repo.files_for(None).items():
        assert (res.snapshot_dir / path).read_bytes() == fx.data
    assert "cache_write_skipped" in [e["kind"]
                                     for e in telemetry.recorder.tail()]


# ── Strict knobs, equal to the JAX package's ──


def _tenancy_knobs(cfg) -> tuple:
    return (cfg.tenancy_enabled, cfg.tenant_max_pulls, cfg.tenant_queue,
            cfg.tenant_inflight_bytes, cfg.tenant_disk_high,
            cfg.tenant_disk_low, cfg.tenant, cfg.slo_tthbm_s,
            cfg.slo_ttfl_s)


@pytest.mark.parametrize("env", [
    {},
    {"ZEST_TENANCY": "0"},
    {"ZEST_TENANT_MAX_PULLS": "2", "ZEST_TENANT_QUEUE": "0",
     "ZEST_TENANT_INFLIGHT": str(1 << 20),
     "ZEST_TENANT_DISK_HIGH": str(1 << 30),
     "ZEST_TENANT_DISK_LOW": str(1 << 29), "ZEST_TENANT": "t9",
     "ZEST_SLO_TTHBM_S": "12.5", "ZEST_SLO_TTFL_S": "0"},
], ids=["defaults", "knob_off", "explicit"])
def test_knobs_parse_to_the_reference_values(env):
    assert _tenancy_knobs(Config.load(env)) \
        == _tenancy_knobs(JConfig.load(env))


@pytest.mark.parametrize("env", [
    {"ZEST_TENANCY": "false"},
    {"ZEST_TENANCY": "yes"},
    {"ZEST_TENANT_MAX_PULLS": "-1"},
    {"ZEST_TENANT_MAX_PULLS": "0"},
    {"ZEST_TENANT_QUEUE": "-2"},
    {"ZEST_TENANT_INFLIGHT": "0"},
    {"ZEST_TENANT_INFLIGHT": "-5"},
    {"ZEST_TENANT_DISK_HIGH": "-1"},
    {"ZEST_TENANT_DISK_LOW": "-1"},
    {"ZEST_TENANT_MAX_PULLS": "two"},
    {"ZEST_TENANT_DISK_LOW": "1024"},
    {"ZEST_TENANT_DISK_HIGH": "1024", "ZEST_TENANT_DISK_LOW": "2048"},
    {"ZEST_TENANT_DISK_HIGH": "1024", "ZEST_TENANT_DISK_LOW": "1024"},
    {"ZEST_SLO_TTHBM_S": "fast"},
    {"ZEST_SLO_TTFL_S": "-30"},
])
def test_malformed_values_raise_as_in_the_reference(env):
    with pytest.raises(ValueError):
        JConfig.load(env)
    with pytest.raises(ValueError):
        Config.load(env)


# ── The daemon's pull memo ──


def test_pinned_key_never_expires_under_a_reader(tmp_path, monkeypatch):
    from zest_tpu_torch.api.http_api import HttpApi

    with FixtureHub(FixtureRepo("acme/memo", dict(BASE_FILES),
                                chunks_per_xorb=2)) as hub:
        api = HttpApi(_cfg(hub, tmp_path), device="cpu")
        try:
            calls = []
            real = pull_mod.pull_model

            def counting(*a, **kw):
                calls.append(1)
                return real(*a, **kw)

            monkeypatch.setattr(pull_mod, "pull_model", counting)
            key = ("acme/memo", "main")
            d1 = api._pull_memo(*key)
            api._pin_snapshot(key)
            api._pulled[key] = (api._pulled[key][0], 0.0)
            assert api._pull_memo(*key) == d1 and len(calls) == 1
            api._unpin_snapshot(key)
            assert api._pull_memo(*key) == d1 and len(calls) == 2
        finally:
            api.close()


def test_concurrent_misses_share_one_pull(tmp_path, monkeypatch):
    from zest_tpu_torch.api.http_api import HttpApi

    with FixtureHub(FixtureRepo("acme/memo2", dict(BASE_FILES),
                                chunks_per_xorb=2)) as hub:
        api = HttpApi(_cfg(hub, tmp_path), device="cpu")
        try:
            calls = []
            real = pull_mod.pull_model

            def slow(*a, **kw):
                calls.append(1)
                time.sleep(0.2)
                return real(*a, **kw)

            monkeypatch.setattr(pull_mod, "pull_model", slow)
            got = []
            ts = [threading.Thread(target=lambda: got.append(
                api._pull_memo("acme/memo2", "main"))) for _ in range(3)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
            assert len(calls) == 1 and len(set(map(str, got))) == 1
        finally:
            api.close()
