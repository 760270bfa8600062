"""The port stands alone: no jax, nothing of zest_tpu, cuda by default.

- importing every ``zest_tpu_torch`` module in a fresh interpreter leaves
  ``jax`` and ``zest_tpu`` out of ``sys.modules``;
- no source file of the port (nor ``chip_smoke.py``) imports them;
- the entry points default to ``cuda`` and raise where there is no card
  instead of falling back to the CPU;
- the timeline's probes and the remediation engine's targets launch no
  kernel and never synchronize a card.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "zest_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names() -> list[str]:
    names = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


SLICE_MODULES = [
    "zest_tpu_torch.faults", "zest_tpu_torch.ops.bg4",
    "zest_tpu_torch.ops.bg4_cuda", "zest_tpu_torch.ops.nvcc",
    "zest_tpu_torch.parallel", "zest_tpu_torch.parallel.plan",
    "zest_tpu_torch.transfer.coop", "zest_tpu_torch.transfer.dcn",
    "zest_tpu_torch.transfer.federated", "zest_tpu_torch.transfer.pod",
    "zest_tpu_torch.models.llama", "zest_tpu_torch.models.sampling",
    "zest_tpu_torch.models.generate", "zest_tpu_torch.cli",
    "zest_tpu_torch.version", "zest_tpu_torch.shaping",
    "zest_tpu_torch.resilience", "zest_tpu_torch.p2p",
    "zest_tpu_torch.p2p.bencode", "zest_tpu_torch.p2p.peer_id",
    "zest_tpu_torch.p2p.wire", "zest_tpu_torch.p2p.bep_xet",
    "zest_tpu_torch.p2p.peer", "zest_tpu_torch.p2p.pool",
    "zest_tpu_torch.p2p.health", "zest_tpu_torch.transfer.server",
    "zest_tpu_torch.transfer.swarm", "zest_tpu_torch.telemetry",
    "zest_tpu_torch.telemetry.state", "zest_tpu_torch.telemetry.metrics",
    "zest_tpu_torch.telemetry.trace", "zest_tpu_torch.telemetry.recorder",
    "zest_tpu_torch.models.moe", "zest_tpu_torch.models.hbm_pool",
    "zest_tpu_torch.api.http_api", "zest_tpu_torch.parallel.mesh",
    "zest_tpu_torch.parallel.collectives", "zest_tpu_torch.parallel.hbm",
    "zest_tpu_torch.parallel.coordinator",
    "zest_tpu_torch.transfer.transport", "zest_tpu_torch.transfer.collective",
    "zest_tpu_torch.telemetry.timeline", "zest_tpu_torch.telemetry.remediate",
    "zest_tpu_torch.parallel.sharding", "zest_tpu_torch.parallel.expert",
    "zest_tpu_torch.models.tensor_parallel", "zest_tpu_torch.models.registry",
    "zest_tpu_torch.models.direct", "zest_tpu_torch.models.loader",
    "zest_tpu_torch.transfer.lossy", "zest_tpu_torch.parallel.hierarchy",
    "zest_tpu_torch.telemetry.fleet", "zest_tpu_torch.p2p.tracker",
    "zest_tpu_torch.p2p.dht", "zest_tpu_torch.transfer.gossip",
    "zest_tpu_torch.transfer.parallel", "zest_tpu_torch.transfer.tenancy",
    "zest_tpu_torch.telemetry.session", "zest_tpu_torch.api.client",
    "zest_tpu_torch.api.daemon", "zest_tpu_torch.api.hf_backend",
    "zest_tpu_torch.telemetry.critpath", "zest_tpu_torch.bench_suite",
    "zest_tpu_torch.bench_scale", "zest_tpu_torch.bench_hub",
]


def test_every_module_imports_without_jax_or_zest_tpu():
    names = _module_names()
    assert len(names) >= 67
    assert set(SLICE_MODULES) <= set(names)
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "new = set(sys.modules) - before\n"
        "print(json.dumps(sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zest_tpu'))))\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
        "in ('jax', 'zest_tpu'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    added, present = (json.loads(line)
                      for line in proc.stdout.strip().splitlines()[-2:])
    assert added == [] and present == []


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_zest_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        bad += [m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                       "zest_tpu")]
    assert bad == []


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no CUDA device")


def test_entry_points_default_to_cuda_and_raise(no_card, tmp_path):
    from zest_tpu_torch import ops
    from zest_tpu_torch.cli import main
    from zest_tpu_torch.config import Config, MeshConfig, resolve_device
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import stage_snapshot_to_hbm
    from zest_tpu_torch.parallel import HbmStagingCache, hier_mesh, pod_mesh
    from zest_tpu_torch.parallel.mesh import mesh_from_config, model_mesh
    from zest_tpu_torch.transfer.dcn import DcnPool
    from zest_tpu_torch.transfer.pod import make_unit_verifier, pod_round
    from zest_tpu_torch.transfer.transport import make_transport
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint, watch_and_swap

    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 endpoint="http://127.0.0.1:9")
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    llama_dir = tmp_path / "llama"
    llama_dir.mkdir()
    (llama_dir / "config.json").write_text(json.dumps(
        {"model_type": "llama"}))
    calls = [
        lambda: resolve_device(),
        lambda: ops.unit_verify_hasher(),
        lambda: ops.fused_verifier_for_backend(),
        lambda: make_unit_verifier(),
        lambda: push_checkpoint(cfg, "org/m", files={"a.bin": b"x"}),
        lambda: pull_model(cfg, "org/m"),
        lambda: stage_snapshot_to_hbm(tmp_path),
        lambda: load_generator(tmp_path),
        lambda: load_generator(llama_dir),
        lambda: main(["generate", "org/m", "--ids", "1,2", "--temperature",
                      "0.8", "--top-k", "50", "--top-p", "0.9"]),
        lambda: main(["pull", "org/m"]),
        lambda: main(["pull", "org/m", "--peer", "127.0.0.1:9"]),
        lambda: main(["pull", "org/m", "--no-p2p"]),
        lambda: main(["generate", "org/m", "--ids", "1,2", "--peer",
                      "127.0.0.1:9"]),
        lambda: pull_model(cfg, "org/m", swarm=object()),
        lambda: main(["pull", "org/m", "--coop", "--coop-hosts", "2",
                      "--coop-index", "0", "--coop-addr", "1=127.0.0.1:9"]),
        lambda: watch_and_swap(cfg, "org/m",
                               publisher_url="http://127.0.0.1:9"),
        lambda: main(["watch", "org/m", "--publisher",
                      "http://127.0.0.1:9"]),
        lambda: pod_mesh(),
        lambda: model_mesh(),
        lambda: model_mesh({"model": 1}),
        lambda: mesh_from_config(cfg.mesh),
        lambda: pull_model(Config(hf_home=tmp_path / "hf",
                                  cache_dir=tmp_path / "zest",
                                  mesh=MeshConfig(mesh_axes={"model": 1})),
                           "org/m"),
        lambda: HbmStagingCache(1 << 20),
        lambda: make_transport("jax", DcnPool()),
        lambda: pod_round(None, []),
        lambda: main(["pull", "org/m", "--pod"]),
        lambda: main(["pull", "org/m", "--pods", "2", "--pod-index", "1",
                      "--pod-addr", "0=127.0.0.1:9"]),
        lambda: hier_mesh(2, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not (tmp_path / "zest").exists()  # nothing ran before the raise


def test_serving_defaults_to_cuda_and_raises(no_card, tmp_path):
    """The pool, its pager and the daemon's serving routes run on
    ``cuda`` unless asked for the CPU; without a card they raise (a
    generate request answers the raise as its ``error`` event) instead
    of serving from the CPU."""
    from zest_tpu_torch.api.http_api import HttpApi
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models import hbm_pool

    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 endpoint="http://127.0.0.1:9")
    llama_dir = tmp_path / "llama"
    llama_dir.mkdir()
    (llama_dir / "config.json").write_text(json.dumps(
        {"model_type": "llama"}))
    api = HttpApi(cfg)
    hbm_pool.reset()
    try:
        for call in (lambda: hbm_pool.HbmPool(cfg),
                     lambda: hbm_pool.pool(cfg),
                     lambda: hbm_pool.ExpertPager(lambda n: None, 1),
                     api.status_payload, api.models_payload,
                     lambda: api._decode_path(llama_dir, "org/m")):
            with pytest.raises(RuntimeError, match="cuda"):
                call()
        events = list(api.generate_events("org/m", {"ids": [1, 2]}))
        assert [e["event"] for e in events] == ["start", "error"]
        assert "cuda" in events[-1]["message"]
        off = HttpApi(Config(hf_home=tmp_path / "hf",
                             cache_dir=tmp_path / "zest",
                             hbm_pool_enabled=False))
        try:
            assert "hbm_pool" not in off.status_payload()
            with pytest.raises(RuntimeError, match="cuda"):
                off._decode_path(llama_dir, "org/m")
        finally:
            off.close()
    finally:
        api.close()
        hbm_pool.reset()
    assert not (tmp_path / "zest").exists()


def test_sharded_paths_default_to_cuda_and_raise(no_card, tmp_path):
    """The sharded swap and sharded training start on ``cuda``: the mesh
    over every CUDA device, a hot-swap pull over ``Config.mesh``, the
    watcher over it, and the families' random trees; without a card each
    raises before any work instead of running on the CPU."""
    import torch as _torch

    from zest_tpu_torch.config import Config, MeshConfig
    from zest_tpu_torch.models import llama, moe
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import watch_and_swap

    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 endpoint="http://127.0.0.1:9",
                 mesh=MeshConfig(mesh_axes={"data": 2, "model": 2}))
    gen = _torch.Generator().manual_seed(0)
    for call in (
            lambda: model_mesh({"data": 2, "model": 2}),
            lambda: model_mesh({"seq": 2, "model": 2}),
            lambda: model_mesh({"expert": 4}),
            lambda: pull_model(cfg, "org/m", base_params={},
                               base_revision="a" * 40),
            lambda: watch_and_swap(cfg, "org/m",
                                   publisher_url="http://127.0.0.1:9",
                                   base_params={}, base_revision="a" * 40),
            lambda: llama.init_params(gen, llama.LlamaConfig.tiny()),
            lambda: moe.init_params(gen, moe.MoEConfig.tiny())):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not (tmp_path / "zest").exists()


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """The wrapper routes a CUDA tensor to the kernel launch only."""
    from zest_tpu_torch.ops import blake3_cuda

    seen = []
    monkeypatch.setattr(blake3_cuda, "launch",
                        lambda *a: seen.append("kernel"))
    monkeypatch.setattr(blake3_cuda.plain, "hash_words",
                        lambda *a: seen.append("plain"))
    words = torch.zeros((1, 256), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        blake3_cuda.CudaHasher().hash_device(words, words[:, 0])
    assert seen == []


def test_fused_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """The fused verifier routes a CUDA tensor to the fused kernel only;
    on the CPU it counts no fused and no regroup launch."""
    from zest_tpu_torch.ops import bg4, bg4_cuda

    seen = []
    monkeypatch.setattr(bg4_cuda, "launch_fused",
                        lambda *a: seen.append("kernel"))
    monkeypatch.setattr(bg4, "fused_regroup_hash",
                        lambda *a: seen.append("plain"))
    words = torch.zeros((1, 256), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bg4.FusedBg4Verifier().hash_planar_device(words, words[:, 0])
    assert seen == []
    monkeypatch.undo()
    bg4_cuda.COUNTER.reset()
    bg4_cuda.FUSED_COUNTER.reset()
    got = bg4.FusedBg4Verifier(device="cpu").hash_planar_batch(
        [b"abcd"], [4])
    assert len(got) == 1
    assert (bg4_cuda.FUSED_COUNTER.launches, bg4_cuda.COUNTER.launches) == (
        0, 0)


def test_probes_and_targets_launch_nothing(tmp_path, monkeypatch):
    """Every timeline probe and remediation target the port registers is
    host bookkeeping: a sampling pass over all of them and a call of each
    target launch no kernel and never synchronize a card, so the
    sampler's "a dying probe drops out" and the engine's "failed target"
    catches can hide no device fault."""
    from zest_tpu_torch import telemetry
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models import hbm_pool
    from zest_tpu_torch.models.loader import HostRing
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.transfer import tenancy
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    def forbidden(*_a, **_k):
        raise AssertionError("a probe or target touched the card")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    telemetry.reset_all()
    tenancy.reset()
    assert telemetry.remediate.ensure_started()
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    for c in (blake3_cuda.COUNTER, bg4_cuda.COUNTER, bg4_cuda.FUSED_COUNTER):
        c.reset()
    pool = hbm_pool.HbmPool(cfg, "cpu")
    ring = HostRing(1 << 20, 2)
    swarm = SwarmDownloader(cfg)
    tenancy.state(cfg)
    try:
        probes = dict(telemetry.timeline.STORE._probes)
        assert len(probes) == 12
        for name, fn in probes.items():
            assert fn() is not None, name
        telemetry.timeline.STORE.tick()
        eng = telemetry.remediate.ENGINE
        assert set(eng._targets) == {"pool_land", "pool_shed", "shed",
                                     "peer_health", "demote"}
        assert telemetry.remediate.invoke("pool_land", "rush") is True
        assert telemetry.remediate.invoke("pool_shed", "shed") is False
        assert telemetry.remediate.invoke("shed", "shed")["shed"] == 0
        assert telemetry.remediate.invoke("shed", "recover")["was_shedding"]
        assert telemetry.remediate.invoke("peer_health")["rows"] == []
        assert telemetry.remediate.invoke(
            "demote", ("127.0.0.1", 9))["window_s"] > 0
    finally:
        swarm.close()
        ring.close()
        pool.close()
        tenancy.reset()
        telemetry.reset_all()
    assert (blake3_cuda.COUNTER.launches, bg4_cuda.COUNTER.launches,
            bg4_cuda.FUSED_COUNTER.launches) == (0, 0, 0)
