"""The named slot mesh, partition specs and shard rules against the JAX
package's, on the CPU.

- ``MeshConfig`` parses ``ZEST_TPU_MESH`` and the process topology as the
  reference does, bad strings raising the same errors;
- ``model_mesh`` keeps the axis order and raises the reference's
  ``ValueError``, a device may stand in several slots, and the 1-D
  ``pod_mesh`` is unchanged;
- ``shard_index`` is the reference sharding's index map, and a slot's
  shard is its own allocation;
- ``infer_spec``, ``_spec_fits`` and ``spec_for`` agree with the
  reference's over hypothesis-drawn shapes and every family's rules, and
  the registry, ``param_specs`` and ``checkpoint_shard_rules`` are the
  reference's pattern for pattern.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from zest_tpu import config as j_config
from zest_tpu.models import gpt2 as j_gpt2, llama as j_llama, moe as j_moe
from zest_tpu.models import loader as j_loader, registry as j_registry
from zest_tpu.parallel import mesh as j_mesh
from zest_tpu_torch import config
from zest_tpu_torch.models import gpt2, llama, loader, moe, registry
from zest_tpu_torch.parallel import mesh
from zest_tpu_torch.parallel.sharding import (
    P,
    ShardedTensor,
    shard_index,
    shard_tensor,
)

AXES = [{"data": 2, "model": 4}, {"model": 4}, {"expert": 4},
        {"data": 2, "expert": 4}, {"model": 8}, {"data": 8},
        {"a": 2, "b": 2, "c": 2}]
FAMILIES = ["gpt2", "llama", "mistral", "qwen2", "mixtral", "bert", None]
MESH_ENVS = [
    {}, {"ZEST_TPU_MESH": "data=2,model=4"},
    {"ZEST_TPU_MESH": "model=8,data=1"},
    {"ZEST_TPU_MESH": " data = 2 , model=4"},
    {"ZEST_TPU_MESH": "data=2", "ZEST_TPU_COORDINATOR": "10.0.0.1:8476",
     "ZEST_TPU_PROCESS_ID": "3", "ZEST_TPU_NUM_PROCESSES": "8"},
    {"ZEST_TPU_COORDINATOR": ""},
    {"ZEST_TPU_MESH": "data=x"}, {"ZEST_TPU_MESH": "data"},
    {"ZEST_TPU_MESH": "data=2,"}, {"ZEST_TPU_MESH": "=4"},
    {"ZEST_TPU_MESH": "data=2.5"}, {"ZEST_TPU_PROCESS_ID": "one"},
    {"ZEST_TPU_NUM_PROCESSES": ""},
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 - compared with the reference
        return ("raise", type(exc).__name__, str(exc))


@pytest.mark.parametrize("env", MESH_ENVS, ids=range(len(MESH_ENVS)))
def test_mesh_config_parses_as_reference(env):
    def mine():
        m = config.MeshConfig.from_env(env)
        return (m.coordinator, m.process_id, m.num_processes,
                list(m.mesh_axes.items()), m.is_distributed)

    def ref():
        m = j_config.MeshConfig.from_env(env)
        return (m.coordinator, m.process_id, m.num_processes,
                list(m.mesh_axes.items()), m.is_distributed)

    assert _outcome(mine) == _outcome(ref)


def test_config_load_carries_the_mesh(tmp_path):
    env = {"HF_HOME": str(tmp_path / "hf"), "ZEST_CACHE_DIR": str(tmp_path),
           "ZEST_TPU_MESH": "data=2,model=4", "ZEST_TPU_PROCESS_ID": "1",
           "ZEST_TPU_NUM_PROCESSES": "2"}
    mine, ref = config.Config.load(env).mesh, j_config.Config.load(env).mesh
    assert (mine.mesh_axes, mine.process_id, mine.num_processes) == (
        ref.mesh_axes, ref.process_id, ref.num_processes)
    assert config.Config(hf_home=tmp_path, cache_dir=tmp_path).mesh == \
        config.MeshConfig()


@pytest.mark.parametrize("axes", AXES[:5], ids=str)
def test_model_mesh_shape_and_order(axes):
    m = mesh.model_mesh(axes, ["cpu"] * 8 if np.prod(list(axes.values()))
                        == 8 else ["cpu"] * 4)
    ref = j_mesh.model_mesh(axes, jax.devices()[:m.size])
    assert m.axis_names == ref.axis_names == tuple(axes)
    assert m.shape == dict(ref.shape) == axes
    assert list(m.shape) == list(axes)
    assert m.devices.shape == ref.devices.shape
    assert m.local_slots() == list(range(m.size))
    assert all(d == torch.device("cpu") for d in m.local_devices())
    assert m.distinct_devices() == [torch.device("cpu")]
    for slot in range(m.size):
        coords = m.coords(slot)
        assert tuple(coords.values()) == tuple(
            int(i) for i in np.argwhere(
                ref.devices == jax.devices()[slot])[0])


@pytest.mark.parametrize("axes,n", [({"data": 2, "model": 4}, 4),
                                    ({"model": 4}, 8), ({"x": 3}, 2)])
def test_model_mesh_mismatch_raises_as_reference(axes, n):
    with pytest.raises(ValueError) as mine:
        mesh.model_mesh(axes, ["cpu"] * n)
    with pytest.raises(ValueError) as ref:
        j_mesh.model_mesh(axes, jax.devices()[:n])
    assert str(mine.value) == str(ref.value)


def test_no_axes_is_the_pod_mesh_and_config_roundtrip():
    assert mesh.model_mesh(None, ["cpu"] * 3) == mesh.pod_mesh(["cpu"] * 3)
    assert mesh.model_mesh({}, ["cpu"]) == [torch.device("cpu")]
    cfg = config.MeshConfig(mesh_axes={"data": 2, "model": 4})
    m = mesh.mesh_from_config(cfg, ["cpu"] * 8)
    assert m.shape == {"data": 2, "model": 4}
    assert mesh.mesh_from_config(config.MeshConfig(), ["cpu"] * 2) == \
        mesh.pod_mesh(["cpu"] * 2)
    assert mesh.replicated(m) == P() and mesh.row_sharded(m) == P("pod")
    assert mesh.row_sharded(m, "model") == P("model")
    assert tuple(j_mesh.row_sharded(j_mesh.model_mesh(
        {"pod": 8}), "pod").spec) == tuple(mesh.row_sharded(m))


def test_mesh_from_config_process_topology_raises():
    """Several processes need a coordinator and an id in range; a process
    already in a group must be the rank the config names. (The join
    itself runs in tests/test_torch_tp_decode.py's two-process case.)"""
    import socket

    import torch.distributed as dist

    two = dict(num_processes=2, mesh_axes={"model": 2})
    with pytest.raises(ValueError, match="ZEST_TPU_COORDINATOR"):
        mesh.mesh_from_config(config.MeshConfig(**two), ["cpu"])
    with pytest.raises(ValueError, match="not in 0..1"):
        mesh.mesh_from_config(config.MeshConfig(
            coordinator="127.0.0.1:1", process_id=2, **two), ["cpu"])
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="rank 0 of 1"):
            mesh.mesh_from_config(config.MeshConfig(
                coordinator="127.0.0.1:1", process_id=1, **two), ["cpu"])
        one = config.MeshConfig(coordinator="127.0.0.1:1", num_processes=1,
                                mesh_axes={"model": 2})
        assert mesh.mesh_from_config(one, ["cpu"] * 2).shape == {"model": 2}
    finally:
        dist.destroy_process_group()


def test_mixed_devices_in_one_mesh():
    m = mesh.model_mesh({"model": 2}, ["cpu", "meta"])
    assert m.local_devices() == [torch.device("cpu"), torch.device("meta")]
    assert m.distinct_devices() == m.local_devices()
    assert "model" in repr(m)


def test_spec_semantics_match_partition_spec():
    assert P() != P(None) and JP() != JP(None)
    assert tuple(P("model", None)) == tuple(JP("model", None))
    assert P(("data", "model")) == P(("data", "model"))
    assert repr(P("model")) == "P('model')"


SPECS = [P(), P(None), P("model"), P(None, "model"), P("data", "model"),
         P(("data", "model")), P("model", "data"), P(None, ("model", "data"))]


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_shard_index_matches_reference_sharding(spec):
    shape = (16, 8)
    m = mesh.model_mesh({"data": 2, "model": 4}, ["cpu"] * 8)
    ref = NamedSharding(j_mesh.model_mesh({"data": 2, "model": 4}),
                        JP(*spec))
    want = ref.devices_indices_map(shape)
    for slot in range(8):
        got = shard_index(shape, m, spec, slot)
        ref_idx = want[jax.devices()[slot]]
        assert [(s.start, s.stop) for s in got] == [
            (s.start or 0, shape[d] if s.stop is None else s.stop)
            for d, s in enumerate(ref_idx)]


def test_shards_are_own_allocations_on_a_shared_device():
    """Four slots on one device: writing one slot's shard leaves every
    other slot's, and the source, unchanged; ``full`` aliases none."""
    m = mesh.model_mesh({"model": 4}, ["cpu"] * 4)
    src = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    for spec in (P(), P("model"), P(None, "model")):
        st_ = shard_tensor(src, m, spec)
        assert isinstance(st_, ShardedTensor)
        assert st_.nbytes == src.nbytes and st_.shape == src.shape
        ptrs = {st_.shard(s).data_ptr() for s in range(4)}
        assert len(ptrs) == 4 and src.data_ptr() not in ptrs
        before = [st_.shard(s).clone() for s in range(4)]
        st_.shard(0).fill_(-1)
        for s in range(1, 4):
            assert torch.equal(st_.shard(s), before[s])
        assert torch.equal(src, torch.arange(32.).reshape(8, 4))
        st_.shard(0).copy_(before[0])
        full = st_.full()
        assert torch.equal(full, src)
        assert full.data_ptr() not in ptrs
        full.fill_(7)
        assert torch.equal(st_.shard(1), before[1])
        assert torch.equal(loader.land_tensor(src, m, spec).full(), src)


@settings(max_examples=60, deadline=None)
@given(dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 50257]),
                     min_size=0, max_size=3),
       axes_i=st.integers(0, len(AXES) - 1),
       family=st.sampled_from(FAMILIES),
       name=st.sampled_from([
           "h.0.attn.c_attn.weight", "h.1.attn.c_attn.bias",
           "h.0.mlp.c_proj.weight", "wte.weight", "ln_f.bias",
           "model.layers.0.self_attn.q_proj.weight",
           "model.layers.3.self_attn.o_proj.weight",
           "model.layers.1.self_attn.k_proj.bias",
           "model.layers.1.self_attn.o_proj.bias",
           "model.layers.0.mlp.down_proj.weight",
           "model.layers.0.mlp.gate_proj.weight", "lm_head.weight",
           "model.layers.0.block_sparse_moe.experts.3.w1.weight",
           "model.layers.0.block_sparse_moe.experts.7.w2.weight",
           "model.layers.0.block_sparse_moe.gate.weight",
           "model.embed_tokens.weight", "model.norm.weight"]))
def test_spec_for_matches_reference(dims, axes_i, family, name):
    axes = AXES[axes_i]
    n = int(np.prod(list(axes.values())))
    m = mesh.model_mesh(axes, ["cpu"] * n)
    jm = Mesh(np.asarray(jax.devices()[:n]).reshape(list(axes.values())),
              tuple(axes))
    shape = tuple(dims)
    rules = registry.shard_rules_for_model_type(family)
    jrules = j_registry.shard_rules_for_model_type(family)
    for axis in axes:
        assert tuple(loader.infer_spec(shape, m, axis)) == tuple(
            j_loader.infer_spec(shape, jm, axis))
    for (_pat, spec), (_jpat, jspec) in zip(rules or [], jrules or []):
        assert loader._spec_fits(shape, m, spec) == j_loader._spec_fits(
            shape, jm, jspec)
    assert tuple(loader.spec_for(name, shape, m, rules)) == tuple(
        j_loader.spec_for(name, shape, jm, jrules))


@pytest.mark.parametrize("family", FAMILIES)
def test_registry_rules_match_reference(family, tmp_path):
    mine = registry.shard_rules_for_model_type(family)
    ref = j_registry.shard_rules_for_model_type(family)
    if ref is None:
        assert mine is None
    else:
        assert [(p, tuple(s)) for p, s in mine] == [
            (p, tuple(s)) for p, s in ref]
    assert registry.is_expert_sharded(family) == \
        j_registry.is_expert_sharded(family)
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": family}))
    snap = registry.shard_rules_for_snapshot(tmp_path)
    assert snap == mine or [(p, tuple(s)) for p, s in snap] == [
        (p, tuple(s)) for p, s in mine]
    assert set(registry._FAMILIES) == set(j_registry._FAMILIES)
    assert set(registry._EXPERT_SHARDED) == set(j_registry._EXPERT_SHARDED)


def test_shard_rules_for_snapshot_without_config(tmp_path):
    assert registry.shard_rules_for_snapshot(tmp_path) is None
    (tmp_path / "config.json").write_text("[1, 2]")
    assert registry.shard_rules_for_snapshot(tmp_path) is None


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("case", ["gpt2", "llama", "llama_bias",
                                  "llama_tied", "mixtral"])
def test_param_specs_and_axis_names_match_reference(case):
    if case == "gpt2":
        mine = gpt2.param_specs(gpt2.GPT2Config())
        ref = j_gpt2.param_specs(j_gpt2.GPT2Config())
    elif case == "mixtral":
        mine = moe.param_specs(moe.MoEConfig.tiny())
        ref = j_moe.param_specs(j_moe.MoEConfig.tiny())
    else:
        over = {"llama_bias": dict(attn_bias=True, o_bias=True),
                "llama_tied": dict(tie_embeddings=True)}.get(case, {})
        mine = llama.param_specs(llama.LlamaConfig.tiny(**over))
        ref = j_llama.param_specs(j_llama.LlamaConfig.tiny(**over))
    assert _spec_tree(mine) == _spec_tree(ref)
    assert (gpt2.DATA_AXIS, gpt2.MODEL_AXIS) == (j_gpt2.DATA_AXIS,
                                                 j_gpt2.MODEL_AXIS)
    assert (llama.DATA_AXIS, llama.MODEL_AXIS) == (j_llama.DATA_AXIS,
                                                   j_llama.MODEL_AXIS)
    assert (moe.DATA_AXIS, moe.EXPERT_AXIS) == (j_moe.DATA_AXIS,
                                                j_moe.EXPERT_AXIS)
