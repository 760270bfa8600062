"""The port's scale benches, held to ``zest_tpu.bench_scale`` on the CPU
at MB sizes.

- ``llama_checkpoint_files`` (both ``smooth`` modes, with and without
  ``mutate_fraction``) and ``mutate_tensors`` give the JAX package's
  bytes for a seed; the geometry is Llama-8B's divided by ``scale``;
- ``bench_fleet`` returns the JAX package's artifact, field for field;
- ``bench_gb_pull`` lands directly with the JAX package's artifact keys,
  and its budget trims runs and promotes a warm-up as the JAX package's
  does (``tests/test_bench_scale.py``);
- ``bench_swarm``, ``bench_delta_pull``, ``bench_tenants``,
  ``bench_serve_pool`` and ``bench_coop_pull`` run tiny on the CPU with
  their gates.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from zest_tpu import bench_scale as j_bench
from zest_tpu_torch import bench_scale
from zest_tpu_torch.models.safetensors_io import parse_header


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("mutate", [None, 0.02])
def test_llama_checkpoint_files_equal_reference(smooth, mutate):
    kw = dict(scale=8, smooth=smooth, mutate_fraction=mutate,
              mutate_seed=3, shard_bytes=8 * 1024 * 1024)
    mine = bench_scale.llama_checkpoint_files(0.02, seed=5, **kw)
    theirs = j_bench.llama_checkpoint_files(0.02, seed=5, **kw)
    assert list(mine) == list(theirs)
    for name in theirs:
        assert mine[name] == theirs[name], name


def test_llama_checkpoint_files_geometry():
    files = bench_scale.llama_checkpoint_files(
        0.03, shard_bytes=8 * 1024 * 1024, scale=8)
    cfg = json.loads(files["config.json"])
    assert cfg["model_type"] == "llama"
    assert cfg["hidden_size"] == 512
    shards = sorted(n for n in files if n.endswith(".safetensors"))
    assert all("-of-" in n for n in shards) or len(shards) == 1
    assert sum(len(b) for b in files.values()) > 0.02e9
    names = [n for s in shards for n in parse_header(files[s]).tensors]
    assert "model.embed_tokens.weight" in names
    assert any("self_attn.q_proj" in n for n in names)
    # The tensor bytes the layer count gives, headers excluded.
    tensor_bytes = sum(t.nbytes for s in shards
                       for t in parse_header(files[s]).tensors.values())
    assert tensor_bytes == bench_scale.llama_tensor_bytes(0.03, scale=8)
    assert cfg["num_hidden_layers"] == bench_scale.llama_layers(0.03, 8)


def test_full_width_layer_count():
    """Full Llama-8B width (scale 1): the smallest checkpoint with two
    layers is 0.961 GB asked, 1,396,744,192 tensor bytes."""
    assert bench_scale.llama_layers(0.96) == 1
    assert bench_scale.llama_layers(0.961) == 2
    assert bench_scale.llama_tensor_bytes(0.961) == 1_396_744_192
    assert bench_scale._LAYER_BYTES == j_bench._LAYER_BYTES
    assert bench_scale._EDGE_BYTES == j_bench._EDGE_BYTES


@pytest.mark.parametrize("fraction,seed", [(0.01, 1), (0.2, 7), (1e-6, 2)])
def test_mutate_tensors_equal_reference(fraction, seed):
    rng = np.random.default_rng(11)
    base = {f"t{i}": rng.standard_normal(shape).astype(np.float32)
            for i, shape in enumerate([(64, 32), (128,), (7, 9, 5), (300,)])}
    theirs = {k: v.copy() for k, v in base.items()}
    j_bench.mutate_tensors(theirs, fraction, seed=seed)
    as_numpy = {k: v.copy() for k, v in base.items()}
    bench_scale.mutate_tensors(as_numpy, fraction, seed=seed)
    as_torch = {k: torch.from_numpy(v.copy()) for k, v in base.items()}
    bench_scale.mutate_tensors(as_torch, fraction, seed=seed)
    for k in base:
        assert as_numpy[k].tobytes() == theirs[k].tobytes(), k
        assert as_torch[k].numpy().tobytes() == theirs[k].tobytes(), k
    assert any(theirs[k].tobytes() != base[k].tobytes() for k in base)


# bench_fleet's artifact has no wall-clock field: its clock is modelled.
FLEET_WALL_CLOCK_FIELDS: tuple[str, ...] = ()


@pytest.mark.parametrize("sizes,pod_size,units",
                         [((16, 32), 4, 64), ((32,), 8, 128)])
def test_bench_fleet_equals_reference(sizes, pod_size, units):
    kw = dict(fleet_sizes=sizes, pod_size=pod_size, n_units=units)
    mine = bench_scale.bench_fleet(**kw)
    theirs = j_bench.bench_fleet(**kw)
    for field in FLEET_WALL_CLOCK_FIELDS:
        mine.pop(field, None)
        theirs.pop(field, None)
    assert mine == theirs
    assert mine["gates"]["all_ok"] is True


def test_bench_fleet_writes_out_path(tmp_path):
    out = tmp_path / "fleet.json"
    r = bench_scale.bench_fleet(fleet_sizes=(16,), pod_size=4, n_units=32,
                                out_path=str(out))
    assert json.loads(out.read_text()) == json.loads(json.dumps(r))


def _keys(d: dict, prefix: str = "") -> set[str]:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("ring",):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.fixture(scope="module")
def gb_small():
    return bench_scale.bench_gb_pull(gb=0.03, runs=2, chunks_per_xorb=64,
                                     scale=8, device="cpu")


def test_bench_gb_pull_small(gb_small):
    r = gb_small
    assert r["runs"] == 2
    assert r["time_to_hbm_s"] > 0 and r["pull_gbps"] > 0
    assert isinstance(r["stable"], bool) and "spread" in r
    for stage in ("resolve", "cas_metadata", "fetch", "hbm_commit",
                  "files"):
        assert stage in r["stages"], r["stages"]
    assert r["direct"] is True
    assert r["xorbs"] > 1
    assert r["time_to_hbm_s"] <= r["total_pull_s"] + 0.1
    for v in r["stages"].values():
        assert v["s"] <= r["total_pull_s"] * 1.1 + 0.1
        assert v["busy_s"] >= v["s"] - 0.05
    ov = r["overlap"]
    assert ov["files_hbm_span_s"] >= 0 and ov["overlap_s"] >= 0
    assert isinstance(ov["overlapped"], bool)
    assert len(r["time_to_hbm_runs_s"]) == 2
    assert np.isfinite(r["hbm_gbps"])
    assert r["geometry"] == "llama-8B-shapes/8 bf16"
    assert r["page_cache"] == "warm"


def test_bench_gb_pull_keys_equal_reference(gb_small):
    theirs = j_bench.bench_gb_pull(gb=0.03, runs=2, chunks_per_xorb=64,
                                   scale=8)
    assert _keys(gb_small) == _keys(theirs)
    assert gb_small["checkpoint_gb"] == theirs["checkpoint_gb"]
    assert gb_small["xorbs"] == theirs["xorbs"]
    assert gb_small["direct"] is theirs["direct"] is True


def test_bench_gb_pull_budget_trims_runs():
    r = bench_scale.bench_gb_pull(gb=0.03, runs=3, chunks_per_xorb=64,
                                  scale=8, budget_s=0.01, device="cpu")
    assert r["runs"] == 1
    assert r["warmup_skipped"] is True
    assert r["stable"] is False
    assert r["time_to_hbm_s"] > 0
    r2 = bench_scale.bench_gb_pull(gb=0.03, runs=2, chunks_per_xorb=64,
                                   scale=8, budget_s=600, device="cpu")
    assert r2["runs"] == 2
    assert r2["warmup_skipped"] is False


def test_bench_gb_pull_budget_dying_mid_warmup(monkeypatch):
    """A budget that dies during the warm-up pull promotes it to the one
    recorded run: exactly one pull, counted."""
    import time as _time

    import zest_tpu_torch.transfer.pull as pull_mod

    orig = pull_mod.pull_model
    calls = []

    def slow_pull(*args, **kwargs):
        calls.append(1)
        res = orig(*args, **kwargs)
        _time.sleep(3.2)  # longer than the whole budget
        return res

    monkeypatch.setattr(pull_mod, "pull_model", slow_pull)
    r = bench_scale.bench_gb_pull(gb=0.005, runs=3, chunks_per_xorb=64,
                                  scale=8, budget_s=3.0, device="cpu")
    assert r["runs"] == 1
    assert r["warmup_skipped"] is True
    assert r["stable"] is False
    assert len(calls) == 1


def test_drop_caches_degrades_to_warm_without_root(monkeypatch):
    import builtins

    real_open = builtins.open

    def refuse(path, *a, **k):
        if str(path) == "/proc/sys/vm/drop_caches":
            raise PermissionError(13, "Permission denied")
        return real_open(path, *a, **k)

    monkeypatch.setattr(builtins, "open", refuse)
    assert bench_scale._settle_page_cache(True) == "warm"
    assert bench_scale._settle_page_cache(False) == "warm"


def test_bench_swarm_tiny_end_to_end():
    r = bench_scale.bench_swarm(
        gb=0.008, m_pullers=2, k_seeders=2, scale=8, chunks_per_xorb=16,
        fault_spec="upload_corrupt:0.02,seeder_choke_flap:0.1",
        fault_seed=7, device="cpu")
    assert r["pulls_completed"] == 2
    assert r["corrupt_bytes_admitted"] == 0
    assert r["peer_served_ratio"] is not None
    assert r["peer_served_ratio"] >= 0.5
    assert r["faults_fired"].get("seeder_choke_flap", 0) > 0
    assert r["upload_fairness"]["skew"] is not None
    assert r["pull_latency_s"]["p50"] is not None
    assert "errors" not in r


def test_bench_delta_pull_tiny():
    r = bench_scale.bench_delta_pull(gb=0.02, runs=1, chunks_per_xorb=64,
                                     scale=8, device="cpu")
    assert r["runs"] == 1
    assert r["digest_identical"] is True
    assert 0 < r["delta_bytes_ratio"] < 0.5
    assert r["tensors_reused"] > 0


def test_bench_tenants_tiny(monkeypatch):
    """Six tenants, two admitted at once, the last one cancelled. The
    bench's killer waits 40% of the solo median, which on a loaded host
    can outlast pulls that read a warm shared cache; here it fires at
    once, so the cancel always meets the pull it is meant for."""
    import time as _time

    class NoWait:
        def __getattr__(self, name):
            return getattr(_time, name)

        @staticmethod
        def sleep(_s):
            pass

    monkeypatch.setattr(bench_scale, "time", NoWait())
    r = bench_scale.bench_tenants(gb=0.02, k_tenants=6, n_models=2,
                                  max_pulls=2, shaped_bps=32_000_000,
                                  fault_spec=None, chunks_per_xorb=16,
                                  scale=8, device="cpu")
    sat = r["saturation"]
    assert r["gates"]["all_ok"] is True, (r["gates"], sat["statuses"],
                                          sat["terminal_statuses"])
    assert sat["statuses"]["5"] == "cancelled"
    assert sat["dedupe"]["dedupe_hits"] > 0
    assert r["pressure"]["pinned_survived_on_disk"] == \
        r["pressure"]["pinned_entries"] > 0


def test_bench_serve_pool_tiny():
    r = bench_scale.bench_serve_pool(gb=0.004, runs=1, scale=8, steps=2,
                                     device="cpu")
    g = r["gates"]
    assert g["digest_identical"] and g["pinned_never_evicted"]
    assert g["experts_ok"], r["moe_experts"]
    assert r["runs"] == 1 and r["ttft_cold_s"] > 0


def test_bench_coop_pull_tiny_shaped():
    """Two hosts over shaped DCN servers: every unit arrives, nothing
    falls back, and the shaped servers served what their peers got."""
    r = bench_scale.bench_coop_pull(gb=0.008, n_hosts=2, scale=8,
                                    dcn_bps=50_000_000, dcn_rtt_s=0.002,
                                    device="cpu")
    assert "errors" not in r
    assert r["coop"]["hosts_completed"] == 2
    assert r["coop"]["fallbacks"] == 0
    assert r["coop"]["peer_served_ratio"] > 0.3
    for leg in ("p2p", "collective"):
        assert r["exchange"][leg]["hosts_completed"] == 2
        assert r["exchange"][leg]["fallbacks"] == 0
    assert r["dcn_shaping"] == {"rtt_s": 0.002, "bps": 50_000_000}
