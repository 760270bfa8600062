"""The port's hierarchical distributor against the JAX package's, on the
CPU.

Mirrors tests/test_hierarchy.py: the JAX package runs on conftest's
8-device virtual CPU mesh as 2 pods × 4 hosts, the port on a
``["cpu"] * 8`` ``(pods, hosts)`` slot mesh. The same seeded fixture goes
through both, and every comparison is exact: the two-level owners, the
plans and their summaries, the gathered rows of every slot and the stage
byte counts. Also: a failed fetch leaves a zero row, the fill verifies
every whole-xorb unit and rejects one corrupted in flight, mismatched
meshes raise, and a two-process gloo round gathers the same rows.
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

from tests.fixtures import FixtureRepo
from zest_tpu.cas import hashing as j_hashing
from zest_tpu.cas import reconstruction as j_recon
from zest_tpu.parallel import hierarchy as j_hier
from zest_tpu.parallel.collectives import PoolLayout as JPoolLayout
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas import reconstruction as recon
from zest_tpu_torch.config import Config
from zest_tpu_torch.parallel import (
    HierarchicalDistributor,
    HierarchicalPlan,
    PoolLayout,
    hier_mesh,
    owner_pod_host,
)
from zest_tpu_torch.parallel.mesh import model_mesh
from zest_tpu_torch.storage import XorbCache
from zest_tpu_torch.transfer.pod import make_unit_verifier

ROOT = Path(__file__).resolve().parent.parent


def _repo(n_files=4, size=60_000):
    rng = np.random.default_rng(11)
    files = {f"w-{i}.safetensors": rng.bytes(size + i * 777)
             for i in range(n_files)}
    return FixtureRepo("acme/hier", files, chunks_per_xorb=2)


def _recs(repo):
    """The fixture's reconstructions as the port parses them, and as the
    JAX package holds them."""
    jrecs = [repo.reconstructions[f.xet_hash]
             for f in repo.files.values() if f.xet_hash]
    return [recon.from_json(r.file_hash.hex(), j_recon.to_json(r))
            for r in jrecs], jrecs


def _plans(repo, n_pods=2, hosts_per_pod=4):
    recs, jrecs = _recs(repo)
    return (HierarchicalPlan.build(recs, n_pods, hosts_per_pod),
            j_hier.HierarchicalPlan.build(jrecs, n_pods, hosts_per_pod))


def _fetch_fn(repo):
    def fetch(a):
        xf = repo.xorbs[a.hash_hex]
        return xf.blob[a.fetch_info.url_range_start:
                       a.fetch_info.url_range_end]
    return fetch


def _owners(plan):
    return [(a.hash_hex, a.fetch_info.range.start, a.owner, a.est_bytes)
            for a in plan.flat.assignments]


def test_hier_mesh_shape_and_mismatch():
    mesh = hier_mesh(2, 4, ["cpu"] * 8)
    assert mesh.shape == {"pods": 2, "hosts": 4}
    assert mesh.shape == dict(j_hier.hier_mesh(2, 4).shape)
    with pytest.raises(ValueError):
        hier_mesh(3, 3, ["cpu"] * 8)
    with pytest.raises(ValueError, match="pods, hosts"):
        HierarchicalDistributor(model_mesh({"model": 8}, ["cpu"] * 8))


@pytest.mark.parametrize("n_pods,hosts", [(2, 4), (4, 16), (3, 2), (1, 8)])
def test_owner_pod_host_matches_reference(n_pods, hosts):
    for i in range(64):
        h = hashing.blake3_hash(f"unit-{i}".encode())
        assert h == j_hashing.blake3_hash(f"unit-{i}".encode())
        for start in (0, 64 * i):
            got = owner_pod_host(h, start, n_pods, hosts)
            assert got == j_hier.owner_pod_host(h, start, n_pods, hosts)
            assert 0 <= got[0] < n_pods and 0 <= got[1] < hosts


def test_pod_and_host_draws_independent():
    both = 0
    for i in range(256):
        p, s = owner_pod_host(hashing.blake3_hash(f"unit-{i}".encode()), 0,
                              2, 2)
        both += p == s
    assert 64 < both < 192


@pytest.mark.parametrize("n_pods,hosts", [(2, 4), (4, 2), (2, 2)])
def test_plan_and_summary_match_reference(n_pods, hosts):
    plan, jplan = _plans(_repo(n_files=8, size=120_000), n_pods, hosts)
    assert _owners(plan) == _owners(jplan)
    assert plan.summary() == jplan.summary()
    assert plan.bytes_per_pod() == jplan.bytes_per_pod()
    s = plan.summary()
    assert sum(s["bytes_per_pod"]) == s["total_bytes"]
    if n_pods == 2:
        assert s["pod_balance"] > 0.5


def test_distribute_rows_match_reference(tmp_config):
    """Every slot's gathered rows byte-equal to the JAX package's pool,
    each unit's blob intact, and the stages timed over the reference's
    byte basis."""
    repo = _repo()
    plan, jplan = _plans(repo)
    fetch = _fetch_fn(repo)
    shards = {s: {(a.hash_hex, a.fetch_info.range.start): fetch(a)
                  for a in plan.flat.for_host(s)}
              for s in range(plan.flat.num_hosts)}
    hd = HierarchicalDistributor(hier_mesh(2, 4, ["cpu"] * 8))
    pool = hd.distribute(plan, fetch, slot=0, local_shards=shards)
    jd = j_hier.HierarchicalDistributor(j_hier.hier_mesh(2, 4))
    jpool = jd.distribute(jplan, fetch, slot=0, local_shards=shards)
    want = np.asarray(jpool.pool)
    assert len(pool.replicas) == 8
    for replica in pool.replicas:
        np.testing.assert_array_equal(replica.numpy(), want)
    for a in plan.flat.assignments:
        got = pool.blob(a.hash_hex, a.fetch_info.range.start)
        assert got is not None and got[0] == fetch(a)
    assert set(hd.stage_seconds) == set(jd.stage_seconds) == {"dcn", "ici"}
    stats, jstats = hd.stage_stats(), jd.stage_stats()
    assert set(stats) == set(jstats)
    for k in ("pool_bytes", "dcn_bytes", "ici_bytes"):
        assert stats[k] == jstats[k]
    pool_bytes = PoolLayout.from_plan(plan.flat).pool_bytes
    assert pool_bytes == JPoolLayout.from_plan(jplan.flat).pool_bytes
    assert stats["pool_bytes"] == pool_bytes >= plan.flat.total_bytes
    assert stats["dcn_bytes"] == pool_bytes           # (P - 1) = 1
    assert stats["ici_bytes"] == pool_bytes * 2 * 3   # P · (H - 1)
    assert stats["dcn_gbps"] > 0 and stats["ici_gbps"] > 0


def test_distribute_failed_fetch_leaves_zero_row(tmp_config):
    repo = _repo(n_files=2)
    plan, _ = _plans(repo)

    def failing(a):
        raise IOError("cdn down")

    pool = HierarchicalDistributor(hier_mesh(2, 4, ["cpu"] * 8)).distribute(
        plan, failing, slot=0)
    for a in plan.flat.for_host(0):
        assert pool.blob(a.hash_hex, a.fetch_info.range.start) is None


def test_fill_verifies_and_rejects_a_corrupted_band(tmp_path):
    """Every unit distributed whole fills a fresh cache through the
    receipt verifier; one unit corrupted in flight is rejected and
    counted, never cached under its key."""
    repo = _repo(n_files=2)
    plan, _ = _plans(repo, 2, 2)
    fetch = _fetch_fn(repo)
    layout = PoolLayout.from_plan(plan.flat)
    victim = sorted(layout.full_xorbs)[0]

    def corrupting(a):
        data = fetch(a)
        if a.hash_hex != victim:
            return data
        bad = bytearray(data)
        bad[len(bad) // 2] ^= 0xFF
        return bytes(bad)

    mesh = hier_mesh(2, 2, ["cpu"] * 4)
    verify = make_unit_verifier(device="cpu")
    for fn, rejected in ((fetch, 0), (corrupting, 1)):
        cfg = Config(hf_home=tmp_path / f"{rejected}/hf",
                     cache_dir=tmp_path / f"{rejected}/zest")
        cache = XorbCache(cfg)
        pool = HierarchicalDistributor(mesh).distribute(plan, fn)
        filled, bad = pool.fill_cache(cache, verify=verify)
        assert (filled, bad) == (len(plan.flat.assignments) - rejected,
                                 rejected)
        assert (cache.get(victim) is None) == bool(rejected)


def test_plan_mesh_mismatch_raises():
    plan, _ = _plans(_repo(n_files=1), n_pods=4, hosts_per_pod=2)
    hd = HierarchicalDistributor(hier_mesh(2, 4, ["cpu"] * 8))
    with pytest.raises(ValueError, match="4×2"):
        hd.distribute(plan, lambda a: b"")
    with pytest.raises(RuntimeError):
        HierarchicalDistributor(hier_mesh(2, 4, ["cpu"] * 8)).stage_stats()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_round_gathers_the_same_rows(tmp_path):
    """Two processes, gloo, two CPU slots each of a (2, 2) mesh: each
    fetches only its slots' units, and every slot's gathered rows equal
    the one-process round's."""
    repo = _repo(n_files=2)
    blobs = {hh: x.blob for hh, x in repo.xorbs.items()}
    (tmp_path / "blobs.json").write_text(json.dumps(
        {hh: b.hex() for hh, b in blobs.items()}))
    (tmp_path / "recs.json").write_text(json.dumps(
        {fh: j_recon.to_json(r) for fh, r in repo.reconstructions.items()}))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_mp_worker.py"),
         str(rank), "2", str(port), str(tmp_path), "hier"], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    plan, _ = _plans(repo, 2, 2)
    hd = HierarchicalDistributor(hier_mesh(2, 2, ["cpu"] * 4))
    want = hd.distribute(plan, _fetch_fn(repo)).replicas[0].numpy()
    for rank in range(2):
        for j in range(2):
            got = np.load(tmp_path / f"hier_{rank}_{j}.npy")
            np.testing.assert_array_equal(got, want)
        assert json.loads((tmp_path / f"stats_{rank}.json").read_text()) \
            == sorted(hd.stage_stats())
