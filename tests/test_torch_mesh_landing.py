"""The landing over a named slot mesh against the JAX package's, on the
CPU.

GPT-2, Llama and Mixtral fixture repos land over ``["cpu"] * 8`` (and
``* 4``) slot meshes through the streamed and the stream-off direct
landings of ``pull_model(mesh=...)``, the disk staging of a resumed pull,
``load_checkpoint`` and ``stage_snapshot_to_hbm``, in float32 and with
``land_dtype="bf16"``; the JAX package lands the same bytes under
``ZEST_TPU_MESH`` on its 8-device virtual mesh. Every slot's shard of
every tensor equals the reference's ``addressable_shards`` entry on the
device of the same index, ``params_digest`` equals the reference's and
the unsharded landing's, and the ``hbm`` keys are the reference's. A
sharded commit that raises fails the pull, the serving pool refuses a
mesh, and the loader takes a hot-swap over one.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests.fixtures import (
    FixtureHub,
    FixtureRepo,
    gpt2_checkpoint_files,
    llama_checkpoint_files,
    mixtral_checkpoint_files,
)
from zest_tpu.config import Config as JConfig, MeshConfig as JMesh
from zest_tpu.models import loader as j_loader, registry as j_registry
from zest_tpu.parallel import mesh as j_mesh
from zest_tpu.transfer import pull as j_pull
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import hbm_pool, loader, registry
from zest_tpu_torch.parallel.mesh import model_mesh
from zest_tpu_torch.parallel.sharding import MeshUnsupported, ShardedTensor
from zest_tpu_torch.transfer.pull import pull_model

GPT2, LLAMA, MIXTRAL = "acme/mesh-gpt2", "acme/mesh-llama", "acme/mesh-moe"
FILES = {GPT2: gpt2_checkpoint_files(seed=11),
         LLAMA: llama_checkpoint_files(seed=12),
         MIXTRAL: mixtral_checkpoint_files(seed=13)}
FAMILY = {GPT2: "gpt2", LLAMA: "llama", MIXTRAL: "mixtral"}
DM = {"data": 2, "model": 4}


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(*[FixtureRepo(r, f, chunks_per_xorb=2)
                      for r, f in FILES.items()]) as h:
        yield h


def _cfg(hub, root, **kw) -> Config:
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _jcfg(hub, root, axes, **kw) -> JConfig:
    return JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                   hf_token="hf_test", endpoint=hub.url,
                   mesh=JMesh(mesh_axes=axes), **kw)


def _mesh(axes):
    return model_mesh(axes, ["cpu"] * int(np.prod(list(axes.values()))))


def _assert_shards_equal(params, jparams):
    """Every slot's shard equals the reference's shard on the device of
    the same index, byte for byte (NaN payloads included)."""
    assert set(params) == set(jparams)
    devices = jax.devices()
    for name, st in params.items():
        assert isinstance(st, ShardedTensor), name
        ref = {devices.index(s.device): np.asarray(s.data)
               for s in jparams[name].addressable_shards}
        assert set(ref) == set(st.shards), name
        assert tuple(st.spec) == tuple(jparams[name].sharding.spec), name
        for slot, want in ref.items():
            got = st.shard(slot)
            assert got.is_contiguous()
            assert tuple(got.shape) == want.shape, (name, slot)
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            assert np.array_equal(got.view(torch.uint8).numpy().reshape(-1),
                                  want.view(np.uint8).reshape(-1)), (name,
                                                                     slot)


@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("stream", [True, False], ids=["streamed",
                                                       "stream_off"])
@pytest.mark.parametrize("repo", list(FILES))
def test_direct_landing_shards_match_reference(hub, tmp_path, repo, stream,
                                               dtype):
    res = pull_model(_cfg(hub, tmp_path / "p", land_stream=stream,
                          land_dtype=dtype), repo, device="cpu",
                     mesh=_mesh(DM), no_p2p=True, log=_quiet)
    jres = j_pull.pull_model(_jcfg(hub, tmp_path / "j", DM,
                                   land_stream=stream, land_dtype=dtype),
                             repo, device="tpu", pod=False, no_p2p=True,
                             log=_quiet)
    hbm, jhbm = res.stats["hbm"], jres.stats["hbm"]
    assert hbm["direct"] is jhbm["direct"] is True
    assert hbm["sharded"] is jhbm["sharded"] is True
    assert hbm.get("streamed") == jhbm.get("streamed")
    assert set(hbm) == set(jhbm)
    assert (hbm["tensors"], hbm["bytes"]) == (jhbm["tensors"], jhbm["bytes"])
    assert res.stats["mesh"] == DM
    _assert_shards_equal(res.params, jres.params)
    digest = loader.params_digest(res.params)
    assert digest == j_loader.params_digest(jres.params)
    flat = pull_model(_cfg(hub, tmp_path / "u", land_stream=stream,
                           land_dtype=dtype), repo, device="cpu",
                      no_p2p=True, log=_quiet)
    assert flat.stats["hbm"]["sharded"] is False
    assert loader.params_digest(flat.params) == digest
    for name, data in FILES[repo].items():
        assert (res.snapshot_dir / name).read_bytes() == data


@pytest.mark.parametrize("repo", list(FILES))
def test_model_axis_alone_and_resumed_disk_staging(hub, tmp_path, repo):
    """``{"model": 4}`` over four slots; then the same node pulls again:
    every file is complete, so the tree stages from disk, still sharded,
    equal to the reference's disk staging of the snapshot."""
    axes = {"model": 4}
    cfg = _cfg(hub, tmp_path / "p")
    first = pull_model(cfg, repo, device="cpu", mesh=_mesh(axes),
                       no_p2p=True, log=_quiet)
    again = pull_model(cfg, repo, device="cpu", mesh=_mesh(axes),
                       no_p2p=True, log=_quiet)
    assert first.stats["hbm"]["direct"] is True
    assert again.stats["hbm"]["direct"] is False
    assert again.stats["hbm"]["sharded"] is True
    jm = j_mesh.model_mesh(axes, jax.devices()[:4])
    rules = j_registry.shard_rules_for_model_type(FAMILY[repo])
    jparams, jst = j_loader.stage_snapshot_to_hbm(again.snapshot_dir, jm,
                                                  rules)
    _assert_shards_equal(first.params, jparams)
    _assert_shards_equal(again.params, jparams)
    assert set(again.stats["hbm"]) == set(jst)
    assert loader.params_digest(again.params) == j_loader.params_digest(
        jparams)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("repo", list(FILES))
def test_load_checkpoint_and_stage_snapshot(hub, tmp_path, repo, dtype):
    res = pull_model(_cfg(hub, tmp_path), repo, device="cpu", land=False,
                     no_p2p=True, log=_quiet)
    snap = res.snapshot_dir
    rules = registry.shard_rules_for_snapshot(snap)
    jm = j_mesh.model_mesh(DM)
    jrules = j_registry.shard_rules_for_snapshot(snap)
    jdtype = None if dtype is None else j_loader.resolve_dtype("bf16")
    want = j_loader.load_checkpoint(snap, jm, jrules, dtype=jdtype)
    got = loader.load_checkpoint(snap, dtype=dtype, mesh=_mesh(DM),
                                 rules=rules)
    _assert_shards_equal(got, want)
    params, st = loader.stage_snapshot_to_hbm(snap, dtype=dtype,
                                              mesh=_mesh(DM), rules=rules)
    jparams, jst = j_loader.stage_snapshot_to_hbm(snap, jm, jrules,
                                                  dtype=jdtype)
    _assert_shards_equal(params, jparams)
    assert set(st) == set(jst) and st["sharded"] is jst["sharded"] is True
    assert st["bytes"] == jst["bytes"]
    unsharded, ust = loader.stage_snapshot_to_hbm(snap, "cpu", dtype)
    assert ust["sharded"] is False
    assert loader.params_digest(params) == loader.params_digest(unsharded)


def test_rules_that_do_not_fit_degrade_to_infer_spec(hub, tmp_path):
    """Mixtral's rules name the ``expert`` axis: on a ``{data, model}``
    mesh every tensor they match takes ``infer_spec`` (the router's
    ``P()`` fits any mesh), as the reference's do."""
    res = pull_model(_cfg(hub, tmp_path), MIXTRAL, device="cpu", land=False,
                     no_p2p=True, log=_quiet)
    got = loader.load_checkpoint(res.snapshot_dir, mesh=_mesh(DM),
                                 rules=registry.shard_rules_for_model_type(
                                     "mixtral"))
    for name, t in got.items():
        assert "expert" not in str(t.spec), name
        want = (() if name.endswith("block_sparse_moe.gate.weight") else
                tuple(loader.infer_spec(tuple(t.shape), t.mesh, "model")))
        assert tuple(t.spec) == want, name


@pytest.mark.parametrize("stream", [True, False])
def test_raising_sharded_commit_fails_the_pull(hub, tmp_path, monkeypatch,
                                               stream):
    def boom(*a, **k):
        raise RuntimeError("sharded commit failed")

    monkeypatch.setattr(loader._ShardedCommit, "commit", boom)
    monkeypatch.setattr(loader, "_commit_sharded", boom)
    with pytest.raises(RuntimeError, match="sharded commit failed"):
        pull_model(_cfg(hub, tmp_path, land_stream=stream), LLAMA,
                   device="cpu", mesh=_mesh(DM), no_p2p=True, log=_quiet)


def test_sharded_tree_refuses_hot_swap_and_the_pool(hub, tmp_path):
    """The pool lands on one device and refuses a mesh; the hot-swap over
    a mesh is no longer refused (tests/test_torch_mesh_swap.py holds it to
    the reference): the loader takes sharded ``preloaded`` tensors as the
    same objects and counts them by their global bytes."""
    with pytest.raises(MeshUnsupported, match="one device"):
        hbm_pool.HbmPool(_cfg(hub, tmp_path), device="cpu",
                         mesh=_mesh(DM))
    with pytest.raises(TypeError, match="SlotMesh"):
        pull_model(_cfg(hub, tmp_path), LLAMA, device="cpu",
                   mesh=["cpu"] * 8, no_p2p=True, log=_quiet)
    mesh = _mesh(DM)
    base = loader.land_tensor(torch.arange(32.0).reshape(8, 4), mesh,
                              loader.spec_for("x", (8, 4), mesh))
    swap_from = {"x": base, "gone": base}
    params, stats = loader.stage_cached_to_hbm(
        None, [], mesh=mesh, preloaded={"x": base}, swap_from=swap_from,
        stream=False)
    assert params["x"] is base
    assert stats["swap"] == {"reused_tensors": 1, "reused_bytes": 128,
                             "landed_tensors": 0, "landed_bytes": 0}
