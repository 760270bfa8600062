"""The port's distribution plane against the JAX package's, on the CPU.

Mirrors tests/test_parallel.py. The JAX package runs on the 8-device
virtual CPU mesh of conftest; the port's slot mesh is ``["cpu"] * 8`` (a
device may stand in several slots). The same seeded fixture repo goes
through both, and every comparison is exact: owners, plans, row layouts,
waves, the gathered rows and the caches they fill.

Also: the HBM staging tier on ``device="cpu"`` (LRU, counters, tiered
promotion), the registries (in-memory, and the store-backed one over a
``TCPStore``), and a two-process gloo round of ``PodDistributor`` with
``CoordinatorRegistry`` (slow, as the reference's multi-process test).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.fixtures import FixtureRepo
from zest_tpu.cas import reconstruction as j_recon
from zest_tpu.config import Config as JConfig
from zest_tpu.parallel import collectives as j_coll
from zest_tpu.parallel import mesh as j_mesh
from zest_tpu.parallel import plan as j_plan
from zest_tpu.storage import XorbCache as JXorbCache
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas import reconstruction as recon
from zest_tpu_torch.cas.reconstruction import ChunkRange, FetchInfo
from zest_tpu_torch.config import Config
from zest_tpu_torch.parallel import (
    DistributionPlan,
    FetchAssignment,
    HbmStagingCache,
    InMemoryRegistry,
    PodDistributor,
    PoolLayout,
    TieredCache,
    all_gather_throughput,
    num_slots,
    owner_host,
    pod_mesh,
    split_waves,
)
from zest_tpu_torch.parallel.coordinator import CoordinatorRegistry
from zest_tpu_torch.storage import XorbCache

ROOT = Path(__file__).resolve().parent.parent
SLOTS = ["cpu"] * 8


def _repo(n_files=3, chunks_per_xorb=2, size=40_000):
    rng = np.random.default_rng(7)
    files = {f"model-{i}.safetensors": rng.bytes(size + i * 1111)
             for i in range(n_files)}
    return FixtureRepo("acme/tiny", files, chunks_per_xorb=chunks_per_xorb)


def _recs(repo):
    """The fixture's reconstructions, as the port parses them and as the
    JAX package holds them."""
    jrecs = list(repo.reconstructions.values())
    return [recon.from_json(fh, j_recon.to_json(r))
            for fh, r in repo.reconstructions.items()], jrecs


def _assignments(plan):
    return [(a.hash_hex, a.fetch_info.range.start, a.owner, a.est_bytes)
            for a in plan.assignments]


# ── the slot mesh ──


def test_pod_mesh_slots_and_devices():
    mesh = pod_mesh(SLOTS)
    assert mesh == [torch.device("cpu")] * 8
    assert num_slots(mesh) == j_mesh.num_slots(j_mesh.pod_mesh()) == 8
    assert PodDistributor(mesh).local_slots() == list(range(8))
    with pytest.raises(ValueError):
        pod_mesh([])


def test_pod_mesh_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        pod_mesh()


# ── ownership plan ──


def test_owner_host_matches_reference():
    for i in range(64):
        h = hashing.blake3_hash(f"xorb {i}".encode())
        for start in (0, 3, 1024):
            for n in (1, 2, 3, 5, 8):
                assert owner_host(h, start, n) == \
                    j_plan.owner_host(h, start, n)
    with pytest.raises(ValueError):
        owner_host(b"x" * 32, 0, 0)


def test_owner_stability_under_host_removal():
    hashes = [hashing.blake3_hash(f"h{i}".encode()) for i in range(200)]
    before = {h: owner_host(h, 0, 8) for h in hashes}
    moved = [h for h in hashes if owner_host(h, 0, 7) != before[h]]
    assert all(before[h] == 7 for h in moved)
    counts = np.bincount(list(before.values()), minlength=8)
    assert counts.min() > 10


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_distribution_plan_matches_reference(n):
    recs, jrecs = _recs(_repo())
    plan = DistributionPlan.build(recs + [recs[0]], n)
    ref = j_plan.DistributionPlan.build(jrecs + [jrecs[0]], n)
    assert _assignments(plan) == _assignments(ref)
    assert plan.summary() == ref.summary()
    for h in range(n):
        assert _assignments(DistributionPlan(n, plan.for_host(h))) == \
            _assignments(j_plan.DistributionPlan(n, ref.for_host(h)))
    again = DistributionPlan.build(list(reversed(recs)), n)
    assert _assignments(again) == _assignments(
        DistributionPlan.build(recs, n))


# ── the HBM staging tier (on the CPU here) ──


def test_hbm_cache_roundtrip_lru_and_counters():
    hbm = HbmStagingCache(1 << 20, device="cpu")
    hbm.put("a" * 64, b"full blob")
    hbm.put_partial("b" * 64, 5, b"partial blob")
    got = hbm.get_with_range("a" * 64, 0)
    assert (got.data, got.chunk_offset) == (b"full blob", 0)
    got = hbm.get_with_range("b" * 64, 5)
    assert (got.data, got.chunk_offset) == (b"partial blob", 5)
    assert hbm.get_with_range("b" * 64, 6) is None
    assert hbm.get_device("a" * 64).tensor.device == torch.device("cpu")
    assert hbm.get_device("c" * 64) is None
    s = hbm.summary()
    assert (s["hits"], s["misses"]) == (3, 2)
    # covers: a full entry that does not cover falls through
    hbm.put_partial("a" * 64, 9, b"nine")
    got = hbm.get_with_range("a" * 64, 9,
                             covers=lambda r: r.chunk_offset == 9)
    assert got.data == b"nine"

    lru = HbmStagingCache(1000, device="cpu")
    lru.put("a" * 64, b"x" * 400)
    lru.put("b" * 64, b"y" * 400)
    assert lru.get_with_range("a" * 64, 0) is not None  # refresh a
    lru.put("c" * 64, b"z" * 400)                        # evicts b
    assert lru.has("a" * 64) and lru.has("c" * 64)
    assert not lru.has("b" * 64)
    assert lru.summary()["evictions"] == 1 and lru.used_bytes <= 1000
    lru.put("d" * 64, b"w" * 1001)                       # over the budget
    assert not lru.has("d" * 64)


def test_hbm_cache_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        HbmStagingCache(1 << 20)


def test_tiered_cache_promotion(tmp_path):
    disk = XorbCache(Config(hf_home=tmp_path / "hf",
                            cache_dir=tmp_path / "zest"))
    hbm = HbmStagingCache(1 << 20, device="cpu")
    tiered = TieredCache(disk, hbm)
    disk.put("d" * 64, b"cold data")
    assert tiered.get_with_range("d" * 64, 0).data == b"cold data"
    assert hbm.has("d" * 64)
    tiered.put("e" * 64, b"warm")
    tiered.put_partial("f" * 64, 3, b"part")
    assert disk.has("e" * 64) and hbm.has("e" * 64) and tiered.has("e" * 64)
    assert disk.get_with_range("f" * 64, 3).data == b"part"
    assert hbm.get_with_range("f" * 64, 3).chunk_offset == 3


# ── the gather ──


def _fetchers(repo, plan):
    def fetch(a):
        return repo.xorbs[a.hash_hex].blob

    shards = {h: {(a.hash_hex, a.fetch_info.range.start):
                  repo.xorbs[a.hash_hex].blob for a in plan.for_host(h)}
              for h in range(plan.num_hosts)}
    return fetch, shards


def test_pool_layout_matches_reference():
    recs, jrecs = _recs(_repo(n_files=4))
    layout = PoolLayout.from_plan(DistributionPlan.build(recs, 8))
    ref = j_coll.PoolLayout.from_plan(j_plan.DistributionPlan.build(jrecs, 8))
    assert (layout.num_hosts, layout.rows_per_host, layout.row_len,
            layout.index, layout.host_keys, layout.full_xorbs) == (
        ref.num_hosts, ref.rows_per_host, ref.row_len, ref.index,
        ref.host_keys, ref.full_xorbs)
    assert layout.pool_bytes == ref.pool_bytes
    assert len({r for r, _ in layout.index.values()}) == len(layout.index)


def test_gathered_rows_match_reference(tmp_path):
    repo = _repo(n_files=4)
    recs, jrecs = _recs(repo)
    plan = DistributionPlan.build(recs, 8)
    jplan = j_plan.DistributionPlan.build(jrecs, 8)
    fetch, shards = _fetchers(repo, plan)
    pool = PodDistributor(pod_mesh(SLOTS)).distribute(
        plan, fetch, host=0, local_shards=shards)
    ref = j_coll.PodDistributor(j_mesh.pod_mesh()).distribute(
        jplan, fetch, host=0, local_shards=shards)
    want = np.asarray(ref.pool)
    assert len(pool.replicas) == 8
    for replica in pool.replicas:
        assert np.array_equal(replica.numpy(), want)
    for a in plan.assignments:
        assert pool.blob(a.hash_hex, a.fetch_info.range.start) == \
            (repo.xorbs[a.hash_hex].blob, a.fetch_info.range.start)

    cfg = Config(hf_home=tmp_path / "p/hf", cache_dir=tmp_path / "p/z")
    jcfg = JConfig(hf_home=tmp_path / "j/hf", cache_dir=tmp_path / "j/z")
    assert pool.fill_cache(XorbCache(cfg)) == \
        ref.fill_cache(JXorbCache(jcfg)) == (len(plan.assignments), 0)
    for a in plan.assignments:
        key = a.hash_hex if a.hash_hex in pool.layout.full_xorbs \
            else f"{a.hash_hex}.{a.fetch_info.range.start}"
        assert cfg.xorb_cache_path(key).read_bytes() == \
            jcfg.xorb_cache_path(key).read_bytes()


def test_missing_unit_leaves_zero_row_and_rejects_count():
    repo = _repo(n_files=2)
    recs, _ = _recs(repo)
    plan = DistributionPlan.build(recs, 8)
    fetch, shards = _fetchers(repo, plan)
    victim = plan.assignments[0]
    vkey = (victim.hash_hex, victim.fetch_info.range.start)
    shards[victim.owner].pop(vkey)

    def failing(a):
        if (a.hash_hex, a.fetch_info.range.start) == vkey:
            raise OSError("CDN down for this unit")
        return repo.xorbs[a.hash_hex].blob

    pool = PodDistributor(pod_mesh(SLOTS)).distribute(
        plan, failing, host=victim.owner, local_shards=shards)
    assert pool.blob(*vkey) is None
    assert all(pool.blob(a.hash_hex, a.fetch_info.range.start) is not None
               for a in plan.assignments[1:])

    class Sink:
        def put(self, *a):
            pass

        put_partial = put

    filled, rejected = pool.fill_cache(Sink(), verify=lambda hh, d: False)
    full = sum(1 for a in plan.assignments[1:]
               if a.hash_hex in pool.layout.full_xorbs)
    assert (filled, rejected) == (len(plan.assignments) - 1 - full, full)


def test_fetch_error_that_is_not_a_transfer_failure_raises():
    repo = _repo(n_files=1)
    recs, _ = _recs(repo)
    plan = DistributionPlan.build(recs, 2)

    def broken(_a):
        raise RuntimeError("kernel launch failed")

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        PodDistributor(pod_mesh(["cpu"] * 2)).distribute(plan, broken)


def test_plan_mesh_size_mismatch_raises():
    recs, _ = _recs(_repo(n_files=1))
    with pytest.raises(ValueError):
        PodDistributor(pod_mesh(SLOTS)).distribute(
            DistributionPlan.build(recs, 4), lambda a: b"")


def test_all_gather_throughput_is_a_rate():
    assert all_gather_throughput(pod_mesh(["cpu"] * 4), 1, 2) > 0


# ── waves ──


def _units(ref: bool, specs):
    """Synthetic one-chunk units ``(index, bytes, owner)``, as the port's
    or the JAX package's assignments."""
    if ref:
        return [j_plan.FetchAssignment(f"{i:064x}", j_recon.FetchInfo(
            "/u", 0, size, j_recon.ChunkRange(0, 1)), owner)
            for i, size, owner in specs]
    return [FetchAssignment(f"{i:064x}", FetchInfo(
        "/u", 0, size, ChunkRange(0, 1)), owner) for i, size, owner in specs]


WAVE_CASES = [
    ([(i, 100_000, i % 8) for i in range(64)], 2 << 20),
    ([(0, 8 << 20, 0)] + [(i + 1, 4096, i % 8) for i in range(80)],
     64 << 20),
    ([(i, 1000, i % 8) for i in range(10)], 0),
    ([(i, 1 << 20, i % 8) for i in range(4)], 1024),
    ([(i, 1000 + 97 * (i % 7), i % 8) for i in range(40)], 1 << 20),
]


@pytest.mark.parametrize("specs,budget", WAVE_CASES)
def test_split_waves_matches_reference(specs, budget):
    waves = split_waves(DistributionPlan(8, _units(False, specs)), budget)
    ref = j_coll.split_waves(j_plan.DistributionPlan(8, _units(True, specs)),
                             budget)
    assert [_assignments(w) for w in waves] == [_assignments(w) for w in ref]
    keys = sorted(k for w in waves for k in _assignments(w))
    assert keys == sorted(_assignments(DistributionPlan(
        8, _units(False, specs))))
    for w in waves:
        lay = PoolLayout.from_plan(w)
        assert lay.pool_bytes <= budget or len(w.assignments) == 1 \
            or budget <= 0


# ── discovery ──


def test_in_memory_registry_protocol():
    reg = InMemoryRegistry()
    ih = b"\x01" * 20
    assert reg.find_peers(ih) == []
    reg.self_addr = ("10.0.0.1", 6881)
    reg.announce(ih, 6881)
    assert reg.find_peers(ih) == []
    reg.add(ih, "10.0.0.2", 6881)
    assert reg.find_peers(ih) == [("10.0.0.2", 6881)]


def test_coordinator_registry_over_a_store():
    import torch.distributed as dist

    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="not initialized"):
            CoordinatorRegistry("127.0.0.1")
    store = dist.HashStore()
    regs = [CoordinatorRegistry(f"10.0.0.{i}", process_id=i, store=store,
                                world_size=3) for i in range(3)]
    ih = b"\x02" * 20
    regs[0].announce(ih, 7000)
    regs[2].announce(ih, 7002)
    assert regs[0].find_peers(ih) == [("10.0.0.2", 7002)]
    assert regs[1].find_peers(ih) == [("10.0.0.0", 7000),
                                      ("10.0.0.2", 7002)]
    regs[0].announce(ih, 7100)  # idempotent overwrite
    assert ("10.0.0.0", 7100) in regs[2].find_peers(ih)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_gloo_pod_round(tmp_path):
    """Two processes, gloo, two CPU slots each: store discovery through
    ``CoordinatorRegistry`` and one ``PodDistributor`` round whose
    gathered rows equal the single-process round over the same plan."""
    repo = _repo(n_files=4)
    blobs = {hh: x.blob for hh, x in repo.xorbs.items()}
    (tmp_path / "blobs.json").write_text(json.dumps(
        {hh: b.hex() for hh, b in blobs.items()}))
    (tmp_path / "recs.json").write_text(json.dumps(
        {fh: j_recon.to_json(r) for fh, r in repo.reconstructions.items()}))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).parent / "_torch_mp_worker.py"),
         str(rank), "2", str(port), str(tmp_path)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
        assert p.returncode == 0, out
    recs, _ = _recs(repo)
    plan = DistributionPlan.build(recs, 4)
    want = PodDistributor(pod_mesh(["cpu"] * 4)).distribute(
        plan, lambda a: blobs[a.hash_hex]).replicas[0].numpy()
    for rank in range(2):
        got = np.load(tmp_path / f"rows_{rank}.npy")
        assert np.array_equal(got, want)
        doc = json.loads((tmp_path / f"peers_{rank}.json").read_text())
        assert doc == [["10.0.0.%d" % (1 - rank), 7000 + 1 - rank]]
