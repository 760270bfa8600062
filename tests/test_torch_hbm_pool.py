"""The port's serving pool against ``zest_tpu.models.hbm_pool``, on the CPU.

Mirrors tests/test_hbm_pool.py's knob, admission, re-land, parity,
pager, knob-off and observability cases for the port (its timeline and
remediation cases are in tests/test_torch_remediate.py), and holds the two pools
to each other: the landed tree's ``params_digest``, and the tokens,
greedy and sampled under the JAX key grid's injected Gumbel noise, for
Llama and Mixtral. The port's pool also matches its own family paths
(greedy and seeded sampling), frees what it evicts, and records the
divergences: a paging entry makes room for its pager's budget, and
``watch_and_swap`` records only checkpoint and disk errors of a pool
swap.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import llama_checkpoint_files, mixtral_checkpoint_files
from zest_tpu import telemetry as j_telemetry
from zest_tpu.config import Config as JConfig
from zest_tpu.models import hbm_pool as j_pool
from zest_tpu_torch import telemetry
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import hbm_pool
from zest_tpu_torch.models.generate import load_generator, snapshot_tensors
from zest_tpu_torch.models.loader import params_digest


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("ZEST_HBM_POOL", "ZEST_HBM_POOL_BYTES", "ZEST_SLO_TTFT_S",
                 "ZEST_TELEMETRY", "ZEST_TIMELINE", "ZEST_REMEDIATE",
                 "ZEST_TENANCY"):
        monkeypatch.delenv(name, raising=False)
    for mod in (hbm_pool, j_pool):
        mod.reset()
    telemetry.reset_all()
    j_telemetry.reset_all()
    yield
    for mod in (hbm_pool, j_pool):
        mod.reset()
    telemetry.reset_all()
    j_telemetry.reset_all()


def _snap(root, files, name="snap"):
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    for fname, data in files.items():
        (d / fname).write_bytes(data)
    return d


def _cfg(root, **kw) -> Config:
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", **kw)


@pytest.fixture
def make_pool(tmp_path):
    pools: list[hbm_pool.HbmPool] = []

    def make(**kw) -> hbm_pool.HbmPool:
        p = hbm_pool.HbmPool(_cfg(tmp_path, **kw), "cpu")
        pools.append(p)
        return p

    yield make
    for p in pools:
        p.close()


@pytest.fixture
def make_jpool(tmp_path):
    pools = []

    def make(**kw):
        p = j_pool.HbmPool(JConfig(hf_home=tmp_path / "jhf",
                                   cache_dir=tmp_path / "jzest",
                                   hf_token="hf_test", **kw))
        pools.append(p)
        return p

    yield make
    for p in pools:
        p.close()


def _wait_state(entry, want, timeout=30.0):
    t0 = time.monotonic()
    while entry.state != want:
        assert time.monotonic() - t0 < timeout, \
            f"entry stuck in {entry.state!r}, wanted {want!r}"
        time.sleep(0.01)


def _samples(name: str) -> dict:
    for m in telemetry.REGISTRY.metrics():
        if m.name == name:
            return {tuple(sorted(lbl.items())): v for lbl, v in m.samples()}
    return {}


def _jax_gumbel(seed: int, positions: int, batch: int, vocab: int):
    """The noise the JAX pool draws for ``seed``: one (vocab,) Gumbel
    draw per (position, row) of its key grid."""
    keys = jax.random.split(jax.random.key(seed), positions * batch) \
        .reshape(positions, batch)
    return torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.gumbel(k, (vocab,), jnp.float32)))(keys)))


# ── Config knobs (strict env parsing) ──


class TestKnobs:
    def test_defaults_match_reference(self):
        cfg, jcfg = Config.load({}), JConfig.load({})
        assert cfg.hbm_pool_enabled is True is jcfg.hbm_pool_enabled
        assert cfg.hbm_pool_bytes == 2 << 30 == jcfg.hbm_pool_bytes
        assert cfg.slo_ttft_s is None is jcfg.slo_ttft_s

    def test_pool_off(self):
        assert Config.load({"ZEST_HBM_POOL": "0"}).hbm_pool_enabled is False

    @pytest.mark.parametrize("bad", ["false", "yes", "2", ""])
    def test_pool_knob_strict(self, bad):
        for cls in (Config, JConfig):
            with pytest.raises(ValueError):
                cls.load({"ZEST_HBM_POOL": bad})

    def test_pool_bytes(self):
        assert Config.load({"ZEST_HBM_POOL_BYTES": "1048576"}) \
            .hbm_pool_bytes == 1048576
        assert Config.load({"ZEST_HBM_POOL_BYTES": "0"}).hbm_pool_bytes == 0

    @pytest.mark.parametrize("bad", ["2GB", "-1", "1.5"])
    def test_pool_bytes_strict(self, bad):
        for cls in (Config, JConfig):
            with pytest.raises(ValueError):
                cls.load({"ZEST_HBM_POOL_BYTES": bad})

    def test_slo_ttft(self):
        assert Config.load({"ZEST_SLO_TTFT_S": "1.5"}).slo_ttft_s == 1.5
        assert Config.load({"ZEST_SLO_TTFT_S": "0"}).slo_ttft_s is None
        assert Config.load({"ZEST_SLO_TTFT_S": ""}).slo_ttft_s is None

    @pytest.mark.parametrize("bad", ["-1", "soon", "inf"])
    def test_slo_ttft_strict(self, bad):
        for cls in (Config, JConfig):
            with pytest.raises(ValueError):
                cls.load({"ZEST_SLO_TTFT_S": bad})


# ── Admission / eviction / pinning ──


class TestAdmission:
    def test_acquire_miss_then_hit(self, make_pool, tmp_path):
        snap = _snap(tmp_path, llama_checkpoint_files())
        pool = make_pool()
        entry, hot = pool.acquire(snap, "acme/a")
        assert hot is False and entry.pins == 2  # caller + land thread
        _wait_state(entry, "resident")
        pool.release(entry)
        entry2, hot2 = pool.acquire(snap, "acme/a")
        assert entry2 is entry and hot2 is True
        pool.release(entry2)
        assert pool.hits == 1 and pool.misses == 1
        assert entry.bytes == entry.reserved > 0
        assert pool.used_bytes() == entry.bytes
        assert all(t.device.type == "cpu" for t in entry.params.values())

    def test_unsupported_family_rejected(self, make_pool, tmp_path):
        snap = _snap(tmp_path, {
            "config.json": json.dumps({"model_type": "gpt2"}).encode()})
        pool = make_pool()
        with pytest.raises(ValueError, match="not pool-served"):
            pool.acquire(snap, "acme/gpt2")
        assert pool.supports("gpt2") is False
        assert pool.supports("mixtral") is True
        assert hbm_pool.POOL_FAMILIES == j_pool.POOL_FAMILIES

    def test_missing_checkpoint_unpins(self, make_pool, tmp_path):
        snap = _snap(tmp_path, {
            "config.json": json.dumps({"model_type": "llama"}).encode()})
        pool = make_pool()
        with pytest.raises(FileNotFoundError):
            pool.acquire(snap, "acme/empty")
        assert pool._entries[str(snap.resolve())].pins == 0

    def test_pressure_evicts_lru_not_pinned(self, make_pool, tmp_path):
        snap_a = _snap(tmp_path, llama_checkpoint_files(), "a")
        snap_b = _snap(tmp_path, llama_checkpoint_files(seed=1), "b")
        snap_c = _snap(tmp_path, llama_checkpoint_files(seed=2), "c")
        pool = make_pool()
        ea, _ = pool.acquire(snap_a, "acme/a")
        _wait_state(ea, "resident")
        pool.release(ea)
        pool.budget = int(ea.reserved * 2.5)
        eb, _ = pool.acquire(snap_b, "acme/b")
        _wait_state(eb, "resident")
        ec, _ = pool.acquire(snap_c, "acme/c")
        _wait_state(ec, "resident")
        assert ea.state == "evicted" and ea.bytes == 0 and ea.params == {}
        assert eb.state == "resident"
        assert pool.evictions == 1
        assert _samples("zest_hbm_pool_evictions_total") == {
            (("reason", "pressure"),): 1}
        pool.release(eb)
        pool.release(ec)

    def test_all_pinned_survives_over_budget(self, make_pool, tmp_path):
        snap_a = _snap(tmp_path, llama_checkpoint_files(), "a")
        snap_b = _snap(tmp_path, llama_checkpoint_files(seed=1), "b")
        pool = make_pool()
        ea, _ = pool.acquire(snap_a, "acme/a")
        _wait_state(ea, "resident")
        pool.budget = ea.reserved + 1
        eb, _ = pool.acquire(snap_b, "acme/b")
        _wait_state(eb, "resident")
        assert ea.state == "resident" and pool.evictions == 0
        assert pool.pinned_survivals >= 1
        assert pool.used_bytes() > pool.budget
        pool.release(ea)
        pool.release(eb)

    def test_manual_evict_refuses_pinned(self, make_pool, tmp_path):
        snap = _snap(tmp_path, llama_checkpoint_files())
        pool = make_pool()
        entry, _ = pool.acquire(snap, "acme/a")
        _wait_state(entry, "resident")
        assert pool.evict(snap) is False
        assert entry.state == "resident"
        pool.release(entry)
        assert pool.evict(snap) is True
        assert entry.state == "evicted"
        assert pool.evict(snap) is False  # not resident any more

    def test_shed_coldest_picks_lru(self, make_pool, tmp_path):
        snap_a = _snap(tmp_path, llama_checkpoint_files(), "a")
        snap_b = _snap(tmp_path, llama_checkpoint_files(seed=1), "b")
        pool = make_pool()
        for snap, repo in ((snap_a, "acme/a"), (snap_b, "acme/b")):
            e, _ = pool.acquire(snap, repo)
            _wait_state(e, "resident")
            pool.release(e)
        eb, _ = pool.acquire(snap_b, "acme/b")
        pool.release(eb)
        assert pool.shed_coldest() == "acme/a"
        assert pool.shed_coldest() == "acme/b"
        assert pool.shed_coldest() is None

    def test_paging_admission_makes_room_for_the_pager(self, make_pool,
                                                       tmp_path):
        """A divergence: a Mixtral admission makes room for its dense core
        and its pager's budget, so a watermark that holds either tree
        alone, not both, evicts the other (the JAX package counts the
        pager only once its pages are in, and keeps both here)."""
        snap_l = _snap(tmp_path, llama_checkpoint_files(), "l")
        snap_m = _snap(tmp_path, mixtral_checkpoint_files(), "m")
        pool = make_pool()
        el, _ = pool.acquire(snap_l, "acme/l")
        _wait_state(el, "resident")
        pool.release(el)
        em, _ = pool.acquire(snap_m, "acme/m")
        _wait_state(em, "resident")
        pool.release(em)
        need_m = em.reserved + em.pager.budget_bytes
        assert el.reserved + em.reserved < el.reserved + need_m
        pool.evict(snap_m)
        pool.budget = el.reserved + em.reserved + 1  # not the pager too
        em, _ = pool.acquire(snap_m, "acme/m")
        _wait_state(em, "resident")
        pool.release(em)
        assert el.state == "evicted" and pool.evictions == 2


# ── Scale-to-zero re-landing ──


class TestReLand:
    def test_resident_only_once_the_land_is_over(self, make_pool, tmp_path,
                                                 monkeypatch):
        """A divergence: the tree is published resident only after its
        landing dropped its own pin and cleared the rush, so whoever sees
        it resident can evict it (the JAX package publishes first, and
        an evict racing the land thread's exit finds the tree pinned)."""
        from zest_tpu_torch.models import safetensors_io

        real_close = safetensors_io.SafetensorsFile.close

        def slow_close(sf):  # holds the land thread just before its exit
            time.sleep(0.2)
            real_close(sf)

        monkeypatch.setattr(safetensors_io.SafetensorsFile, "close",
                            slow_close)
        snap = _snap(tmp_path, llama_checkpoint_files())
        pool = make_pool()
        pool._rush.set()
        entry, _ = pool.acquire(snap, "acme/a")
        pool.release(entry)
        _wait_state(entry, "resident")
        assert entry.pins == 0 and not pool._rush.is_set()
        assert pool.evict(snap) is True

    def test_digest_equals_disk_and_reference_pool(self, make_pool,
                                                   make_jpool, tmp_path):
        snap = _snap(tmp_path, llama_checkpoint_files())
        pool, jpool = make_pool(), make_jpool()
        out1, info1 = pool.generate_for(snap, "acme/a", [1, 2, 3], 4)
        jout, _ = jpool.generate_for(snap, "acme/a", [1, 2, 3], 4)
        assert info1["temp"] == "cold"
        d_cold = pool.digest(snap)
        assert d_cold == params_digest(snapshot_tensors(snap))
        assert d_cold == jpool.digest(snap)
        np.testing.assert_array_equal(out1, np.asarray(jout))
        assert pool.evict(snap) is True
        assert pool.digest(snap) is None
        out2, info2 = pool.generate_for(snap, "acme/a", [1, 2, 3], 4)
        assert info2["temp"] == "cold"
        assert pool.digest(snap) == d_cold
        np.testing.assert_array_equal(out1, out2)
        assert pool._entries[str(snap.resolve())].lands == 2

    def test_decode_starts_before_land_end(self, make_pool, tmp_path):
        snap = _snap(tmp_path, llama_checkpoint_files(n_layer=4))
        pool = make_pool()
        pool.group_bytes = 4096
        pool.land_delay_s = 0.05
        out, info = pool.generate_for(snap, "acme/a", [1, 2, 3], 2)
        entry = pool._entries[str(snap.resolve())]
        assert info["temp"] == "cold"
        assert info["decode_start_before_land_end"] is True
        _wait_state(entry, "resident")  # the last flush's delay may run on
        assert entry.t_decode_start < entry.t_land_end
        assert entry.t_first_layer < entry.t_land_end
        assert info["ttft_s"] > 0 and info["gate_stall_s"] > 0

    def test_rush_flushes_every_layer(self, make_pool, tmp_path):
        snap = _snap(tmp_path, llama_checkpoint_files(n_layer=3))
        pool = make_pool()
        seen = []
        from zest_tpu_torch.models import loader

        real = loader.commit_tensors

        def spy(batch, *a, **kw):
            seen.append(len(batch))
            return real(batch, *a, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(loader, "commit_tensors", spy)
            pool._rush.set()
            entry, _ = pool.acquire(snap, "acme/a")
            _wait_state(entry, "resident")
            pool.release(entry)
        assert seen == [1, 9, 9, 9, 2]  # embed, 3 layers, norm + head
        assert not pool._rush.is_set()  # cleared once no land runs

    def test_concurrent_hot_and_cold(self, make_pool, tmp_path):
        snap_a = _snap(tmp_path, llama_checkpoint_files(), "a")
        snap_b = _snap(tmp_path, llama_checkpoint_files(seed=1), "b")
        pool = make_pool()
        warm, _ = pool.generate_for(snap_a, "acme/a", [1, 2, 3], 4)
        pool.land_delay_s = 0.02
        results: dict = {}

        def hot():
            results["hot"] = pool.generate_for(snap_a, "acme/a", [1, 2, 3],
                                               4)

        t = threading.Thread(target=hot)
        t.start()
        results["cold"] = pool.generate_for(snap_b, "acme/b", [1, 2, 3], 4)
        t.join(timeout=60)
        assert not t.is_alive()
        (out_hot, info_hot), (out_cold, info_cold) = (results["hot"],
                                                      results["cold"])
        assert info_hot["temp"] == "hot" and info_cold["temp"] == "cold"
        np.testing.assert_array_equal(out_hot, warm)
        assert not np.array_equal(out_cold, out_hot)

    def test_concurrent_requests_under_pressure(self, make_pool,
                                                tmp_path):
        """Eight threads, three requests each, over two Llama trees and a
        Mixtral tree in a pool with room for about one, the interpreter
        switching threads every 10 µs: every request gets its model's
        tokens, no pin leaks and the pager's accounting holds."""
        import sys

        snaps = [_snap(tmp_path, llama_checkpoint_files(seed=s), f"l{s}")
                 for s in (0, 1)]
        snaps.append(_snap(tmp_path, mixtral_checkpoint_files(), "m"))
        pool = make_pool()
        want = [pool.generate_for(snap, snap.name, [[1, 2], [3, 4]], 3)[0]
                for snap in snaps]
        pool.budget = max(e.hbm_bytes for e in pool._entries.values()) + 1
        for snap in snaps:
            assert pool.evict(snap)
        results, errors = [], []

        def worker(i):
            try:
                for j in range(3):
                    k = (i + j) % 3
                    out, _ = pool.generate_for(snaps[k], snaps[k].name,
                                               [[1, 2], [3, 4]], 3)
                    results.append((k, out))
            except Exception as exc:  # noqa: BLE001 - asserted below
                errors.append(exc)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert errors == [] and len(results) == 24
        for k, out in results:
            np.testing.assert_array_equal(out, want[k])
        for entry in pool._entries.values():
            _wait_state(entry, entry.state if entry.state != "landing"
                        else "resident")
            assert entry.pins == 0
        pager = pool._entries[str(snaps[2].resolve())].pager
        # Racing page-ins of one group verify and then drop the loser.
        assert pager.verified % 3 == 0
        assert pager.verified >= 3 * pager.page_ins > 0
        assert pager.bytes == sum(pager._sizes.values()) <= \
            pager.budget_bytes
        assert pool.evictions + pool.pinned_survivals > 0  # pressure

    def test_land_abort_strands_no_bytes(self, make_pool, tmp_path):
        """A landing that dies mid-flight drops every tensor it committed,
        keeps its error without the traceback (whose frames would hold
        them), reports it at the gates, and a later acquire retries."""
        import gc
        import weakref

        from zest_tpu_torch.models import loader

        snap = _snap(tmp_path, llama_checkpoint_files(n_layer=4))
        pool = make_pool()
        pool.group_bytes = 4096
        real = loader.commit_tensors
        calls, landed = {"n": 0}, []

        def flaky(batch, *a, **kw):
            calls["n"] += 1
            if calls["n"] > 2:
                raise RuntimeError("injected mid-land fault")
            out = real(batch, *a, **kw)
            landed.extend(weakref.ref(t) for t in out.values())
            return out

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(loader, "commit_tensors", flaky)
            entry, _ = pool.acquire(snap, "acme/a")
            _wait_state(entry, "error")
            with pytest.raises(hbm_pool.PoolLandError,
                               match="landing .* failed"):
                entry.wait_for(entry.first_layer)
            pool.release(entry)
        assert calls["n"] > 2 and landed
        assert entry.params == {} and entry.bytes == 0
        assert entry.committed == set()
        assert entry.land_error.__traceback__ is None
        gc.collect()
        assert all(r() is None for r in landed)
        entry2, hot = pool.acquire(snap, "acme/a")
        assert entry2 is entry and hot is False
        _wait_state(entry, "resident")
        assert entry.bytes == entry.reserved
        pool.release(entry)

    def test_evict_releases_the_tree(self, make_pool, tmp_path):
        import gc
        import weakref

        snap = _snap(tmp_path, mixtral_checkpoint_files())
        pool = make_pool()
        pool.generate_for(snap, "acme/m", [[1, 2], [3, 4]], 3,
                          temperature=0.7, seed=1)
        entry = pool._entries[str(snap.resolve())]
        refs = [weakref.ref(t) for t in entry.params.values()]
        refs += [weakref.ref(t) for grp in entry.pager._lru.values()
                 for t in grp.values()]
        assert pool.evict(snap) is True
        gc.collect()
        assert refs and all(r() is None for r in refs)
        assert entry.pager.bytes == 0 and entry.hbm_bytes == 0

    def test_swap_to_lands_new_then_evicts_old(self, make_pool, tmp_path):
        snap_a = _snap(tmp_path, llama_checkpoint_files(), "a")
        snap_b = _snap(tmp_path, llama_checkpoint_files(seed=3), "b")
        pool = make_pool()
        pool.generate_for(snap_a, "acme/a", [1, 2], 2)
        entry, swap_s = pool.swap_to(snap_a, snap_b, repo="acme/a")
        assert entry.state == "resident" and entry.pins == 1 and swap_s > 0
        pool.release(entry)
        assert pool._entries[str(snap_a.resolve())].state == "evicted"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:  # the land thread records last
            kinds = [e["kind"] for e in telemetry.recorder.tail()]
            if kinds.count("pool_land_done") == 2:
                break
            time.sleep(0.01)
        assert kinds.count("pool_land") == 2 and "pool_swap" in kinds
        assert kinds.count("pool_land_done") == 2 and "pool_evict" in kinds


# ── Decode parity: the family paths and the reference pool ──


class TestParity:
    def test_llama_matches_family_and_reference(self, make_pool, make_jpool,
                                                tmp_path):
        snap = _snap(tmp_path, llama_checkpoint_files())
        _mt, family = load_generator(snap, device="cpu")
        pool, jpool = make_pool(), make_jpool()
        for kwargs in (dict(), dict(temperature=0.8, top_k=20, seed=3)):
            want = family([1, 2, 3], 6, **kwargs)
            got, _ = pool.generate_for(snap, "acme/a", [1, 2, 3], 6,
                                       **kwargs)
            np.testing.assert_array_equal(got, want)
        jgot, _ = jpool.generate_for(snap, "acme/a", [[1, 2, 3], [4, 5, 6]],
                                     6)
        got, _ = pool.generate_for(snap, "acme/a", [[1, 2, 3], [4, 5, 6]], 6)
        np.testing.assert_array_equal(got, np.asarray(jgot))
        # Sampled under the reference pool's own key grid's noise.
        kw = dict(temperature=0.8, top_k=20, top_p=0.9)
        jgot, _ = jpool.generate_for(snap, "acme/a", [[1, 2, 3], [4, 5, 6]],
                                     6, seed=5, **kw)
        noise = _jax_gumbel(5, 3 + 6 - 1, 2, 256)
        got, _ = pool.generate_for(snap, "acme/a", [[1, 2, 3], [4, 5, 6]], 6,
                                   noise=noise, **kw)
        np.testing.assert_array_equal(got, np.asarray(jgot))

    def test_mixtral_matches_family_and_reference(self, make_pool,
                                                  make_jpool, tmp_path):
        snap = _snap(tmp_path, mixtral_checkpoint_files())
        _mt, family = load_generator(snap, device="cpu")
        pool, jpool = make_pool(), make_jpool()
        for kwargs in (dict(), dict(temperature=0.9, top_k=40, seed=2)):
            want = family([1, 2, 3], 5, **kwargs)
            got, info = pool.generate_for(snap, "acme/moe", [1, 2, 3], 5,
                                          **kwargs)
            np.testing.assert_array_equal(got, want)
        ex = info["experts"]
        assert 0 < ex["residency"] < 0.5
        assert ex["page_ins"] > 0 and ex["verified"] == 3 * ex["page_ins"]
        jgot, jinfo = jpool.generate_for(snap, "acme/moe", [1, 2, 3], 5)
        got, info = pool.generate_for(snap, "acme/moe", [1, 2, 3], 5)
        np.testing.assert_array_equal(got, np.asarray(jgot))
        assert set(info) == set(jinfo)
        assert set(info["experts"]) == set(jinfo["experts"])
        assert pool.digest(snap) == jpool.digest(snap)
        noise = _jax_gumbel(4, 3 + 5 - 1, 1, 256)
        jgot, _ = jpool.generate_for(snap, "acme/moe", [[1, 2, 3]], 5,
                                     temperature=0.9, seed=4)
        got, _ = pool.generate_for(snap, "acme/moe", [[1, 2, 3]], 5,
                                   temperature=0.9, noise=noise)
        np.testing.assert_array_equal(got, np.asarray(jgot))

    def test_family_drops_overflow_where_the_pool_routes_all(self,
                                                             tmp_path):
        """The family's batch dispatch drops tokens past an expert's
        capacity; the pool routes every token. At a capacity that drops
        nothing (``capacity_factor`` >= experts / top_k) the family's
        batch forward equals the pool's decode."""
        from zest_tpu_torch.models import moe

        snap = _snap(tmp_path, mixtral_checkpoint_files(seed=6))
        cfg_json = json.loads((snap / "config.json").read_text())
        cfg = moe.MoEConfig.from_hf(cfg_json)
        params = moe.params_from_hf(snapshot_tensors(snap), cfg)
        ids = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (4, 16)))
        full = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                   / cfg.top_k)
        tight = dataclasses.replace(cfg, capacity_factor=0.5)
        want, _ = moe.forward(params, ids, full)
        dropped, _ = moe.forward(params, ids, tight)
        cache = moe.init_kv_cache(cfg, 4, 16)
        got, _ = moe.decode_window(params, cache, ids, 0, cfg)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
        assert float((dropped - want).abs().max()) > 1e-3

    def test_validation(self, make_pool, tmp_path):
        snap = _snap(tmp_path, llama_checkpoint_files())
        pool = make_pool()
        for args, kw, match in (([256], {}, "prompt ids"),
                                ([1] * 60, {}, "n_ctx"),
                                ([1], dict(temperature=1.0, top_p=0.0),
                                 "top_p"),
                                ([[1], [2]],
                                 dict(temperature=1.0,
                                      noise=torch.zeros(5, 1, 256)),
                                 "noise")):
            with pytest.raises(ValueError, match=match):
                pool.generate_for(snap, "acme/a", args, 5, **kw)
        entry = pool._entries[str(snap.resolve())]
        _wait_state(entry, "resident")  # the land thread's own pin goes
        assert entry.pins == 0


# ── Lazy MoE expert paging ──


def _fake_expert_store(n_layer=2, n_expert=4, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    store = {}
    for layer in range(n_layer):
        for e in range(n_expert):
            pre = f"model.layers.{layer}.block_sparse_moe.experts.{e}."
            for leaf in ("w1", "w3", "w2"):
                store[pre + leaf + ".weight"] = torch.from_numpy(rng.normal(
                    size=(dim, dim)).astype(np.float32))
    return store


class TestExpertPager:
    GROUP = 3 * 8 * 8 * 4

    def _pager(self, store, groups: float):
        pager = hbm_pool.ExpertPager(lambda n: store[n],
                                     int(self.GROUP * groups), "cpu")
        pager.total_expert_bytes = self.GROUP * 8
        return pager

    def test_lru_bound_and_eviction(self):
        pager = self._pager(_fake_expert_store(), 2)
        for e in range(3):
            pager.get(0, e)
        assert pager.bytes <= pager.budget_bytes
        assert pager.evictions == 1 and pager.page_ins == 3
        pager.get(0, 0)
        assert pager.page_ins == 4 and pager.hits == 0
        assert pager.verified == 12

    def test_hit_refreshes_lru(self):
        pager = self._pager(_fake_expert_store(), 2)
        pager.get(0, 0)
        pager.get(0, 1)
        pager.get(0, 0)
        assert pager.hits == 1
        pager.get(0, 2)
        pager.get(0, 0)
        assert pager.hits == 2

    def test_single_over_budget_group_serves(self):
        pager = self._pager(_fake_expert_store(), 0.5)
        grp = pager.get(0, 0)
        assert set(grp) == {"w1", "w3", "w2"}
        assert pager.bytes == self.GROUP
        assert pager.stats()["residency"] == pytest.approx(1 / 8)
        assert set(pager.stats()) == set(j_pool.ExpertPager(
            lambda n: None, 1).stats())

    def test_corrupt_page_in_refused(self):
        store = _fake_expert_store()
        pager = self._pager(store, 2)
        name = "model.layers.0.block_sparse_moe.experts.0.w1.weight"
        grp = pager.get(0, 0)
        torch.testing.assert_close(grp["w1"], store[name])
        store[name][0, 0] += 1.0
        torch.testing.assert_close(grp["w1"][0, 0],
                                   store[name][0, 0] - 1.0)  # a copy
        pager.clear()
        with pytest.raises(RuntimeError, match="changed on disk"):
            pager.get(0, 0)
        assert _samples("zest_hbm_pool_expert_pages_total")[
            (("outcome", "corrupt"),)] == 1

    def test_routed_miss_pages_in_through_pool(self, make_pool, tmp_path):
        snap = _snap(tmp_path, mixtral_checkpoint_files())
        pool = make_pool()
        pool.generate_for(snap, "acme/moe", [1, 2, 3], 4)
        entry = pool._entries[str(snap.resolve())]
        pager = entry.pager
        assert pager.bytes <= pager.budget_bytes
        assert pager.stats()["residency"] < 0.5
        assert entry.hbm_bytes == entry.bytes + pager.bytes
        assert not any(hbm_pool._is_expert_name(n) for n in entry.expected)
        assert pager.budget_bytes == int(
            pager.total_expert_bytes * hbm_pool.EXPERT_BUDGET_FRACTION)
        outcomes = {k[0][1]: v for k, v in _samples(
            "zest_hbm_pool_expert_pages_total").items()}
        assert outcomes.get("miss", 0) == pager.page_ins > 0


# ── Knob-off and the singleton ──


class TestSingleton:
    def test_pool_none_when_disabled(self, tmp_path):
        assert hbm_pool.pool(_cfg(tmp_path, hbm_pool_enabled=False)) is None

    def test_one_pool_one_device(self, tmp_path):
        cfg = _cfg(tmp_path)
        p = hbm_pool.pool(cfg, "cpu")
        assert hbm_pool.pool(cfg, "cpu") is p
        with pytest.raises(ValueError, match="lives on cpu"):
            hbm_pool.pool(cfg, "meta")
        hbm_pool.reset()
        assert hbm_pool.pool(cfg, "cpu") is not p

    def test_snapshot_meta(self, tmp_path):
        snap = _snap(tmp_path, mixtral_checkpoint_files())
        assert hbm_pool.snapshot_meta(snap) == j_pool.snapshot_meta(snap)
        assert hbm_pool.snapshot_meta(tmp_path / "none") == (None, ())


# ── Observability ──


class TestObservability:
    def test_metrics_and_summary(self, make_pool, tmp_path):
        snap = _snap(tmp_path, llama_checkpoint_files())
        pool = make_pool()
        pool.generate_for(snap, "acme/a", [1, 2, 3], 3)
        states = {k[0][1]: v for k, v in _samples(
            "zest_hbm_pool_bytes").items()}
        assert set(states) == {"pinned", "resident"}
        assert states["pinned"] == 0 and states["resident"] > 0
        assert (("temp", "cold"),) in _samples("zest_ttft_seconds")
        row = pool.summary()
        assert row["models"][0]["state"] == "resident"
        assert row["enabled"] is True
        jpool = j_pool.HbmPool(JConfig(hf_home=tmp_path / "j",
                                       cache_dir=tmp_path / "jz"))
        try:
            assert set(row) == set(jpool.summary())
        finally:
            jpool.close()
        assert set(row["models"][0]) == {
            "repo", "model_type", "state", "bytes", "pins", "lands",
            "gate_stall_s", "idle_s"}
        assert pool.resident()[0]["repo"] == "acme/a"

    def test_ttft_slo_breach(self, make_pool, tmp_path):
        snap = _snap(tmp_path, llama_checkpoint_files())
        pool = make_pool(slo_ttft_s=1e-6)
        pool.generate_for(snap, "acme/a", [1, 2, 3], 2)
        assert _samples("zest_slo_breaches_total") == {(("slo", "ttft"),): 1}
        ev = [e for e in telemetry.recorder.tail()
              if e["kind"] == "slo_breach"]
        assert ev and ev[0]["slo"] == "ttft" and ev[0]["blamed_stage"] == \
            "cold"
        burn = telemetry.session.SESSIONS.slo_burn()
        assert burn["ttft"]["breaches"] == 1
        assert burn["ttft"]["burn"] == 1.0


# ── The subscriber's pool branch ──


class TestWatchSwap:
    def _run(self, tmp_path, monkeypatch, fail_with=None):
        """``watch_and_swap`` over a scripted revision stream and pull:
        the pool holds revision A; the event names B."""
        from zest_tpu_torch.transfer import pull as pull_mod
        from zest_tpu_torch.transfer import push

        cfg = _cfg(tmp_path)
        snap_a = _snap(cfg.model_cache_dir("acme/a") / "snapshots",
                       llama_checkpoint_files(), "a" * 40)
        _snap(cfg.model_cache_dir("acme/a") / "snapshots",
              llama_checkpoint_files(seed=9), "b" * 40)
        pool = hbm_pool.pool(cfg, "cpu")
        pool.generate_for(snap_a, "acme/a", [1, 2], 2)
        monkeypatch.setattr(push, "watch_events", lambda *a, **k: iter([
            {"event": "revision", "repo": "acme/a", "revision": "b" * 40}]))

        class Res:
            stats = {"elapsed_s": 0.1}
            params = None

        monkeypatch.setattr(pull_mod, "pull_model", lambda *a, **k: Res())
        if fail_with is not None:
            def broken(*a, **k):
                raise fail_with
            monkeypatch.setattr(pool, "swap_to", broken)
        return pool, push.watch_and_swap(
            cfg, "acme/a", publisher_url="http://127.0.0.1:9", device="cpu",
            base_revision="a" * 40, log=lambda *a, **k: None)

    def test_pool_resident_revision_swaps_in_the_pool(self, tmp_path,
                                                      monkeypatch):
        pool, records = self._run(tmp_path, monkeypatch)
        (rec,) = records
        assert rec["pool_swap_s"] > 0 and "pool_swap_error" not in rec
        states = {e.repo + e.key[-1]: e.state for e in pool._entries.values()}
        assert states == {"acme/aa": "evicted", "acme/ab": "resident"}

    @pytest.mark.parametrize("exc,recorded", [
        (FileNotFoundError("gone"), "FileNotFoundError"),
        (ValueError("bad header"), "ValueError"),
    ])
    def test_checkpoint_errors_are_recorded(self, tmp_path, monkeypatch,
                                            exc, recorded):
        _, (rec,) = self._run(tmp_path, monkeypatch, exc)
        assert rec["pool_swap_error"] == recorded and "pool_swap_s" not in rec

    def test_landing_cause_is_recorded(self, tmp_path, monkeypatch):
        err = hbm_pool.PoolLandError("landing acme/a failed")
        err.__cause__ = OSError("short read")
        _, (rec,) = self._run(tmp_path, monkeypatch, err)
        assert rec["pool_swap_error"] == "OSError"

    @pytest.mark.parametrize("cause", [
        RuntimeError("CUDA error: an illegal memory access"), None])
    def test_device_errors_raise(self, tmp_path, monkeypatch, cause):
        """A divergence: the JAX package records every exception of the
        pool swap; the port raises one that is not the checkpoint's or
        the disk's."""
        err = hbm_pool.PoolLandError("landing acme/a failed")
        err.__cause__ = cause
        with pytest.raises(hbm_pool.PoolLandError):
            self._run(tmp_path, monkeypatch, err)
        with pytest.raises(RuntimeError, match="CUDA"):
            self._run(tmp_path / "2", monkeypatch,
                      RuntimeError("CUDA error: out of memory"))
