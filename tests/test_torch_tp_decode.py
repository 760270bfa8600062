"""Tensor- and expert-parallel decoding from a sharded tree against the
JAX package's forward over its sharded tree, on the CPU.

- Llama (untied, tied, with attention biases) landed over ``{"model":
  4}``, ``{"data": 2, "model": 4}`` and ``{"model": 2}`` CPU slot meshes:
  prefill logits within 1e-5 of ``zest_tpu.models.llama.forward`` over
  the reference's ``NamedSharding`` tree, greedy tokens equal to its
  ``generate_cached``, sampled tokens under injected noise equal to the
  port's unsharded decode;
- Mixtral over ``{"expert": 4}``, both from the raw landing (its
  ``params_from_hf`` gathers each expert onto the slot that holds it
  whole) and from the stacked expert-parallel tree: prefill logits within
  1e-5 of the reference's ``decode_window`` over its ``param_specs``
  tree, greedy tokens equal;
- GPT-2's sharded tree gathers to the plain tree, and decodes
  tensor-parallel with its q|k|v columns regrouped into whole heads a
  slot: logits within 1e-5 of the reference's, the same tokens;
- a tree whose heads do not divide the axis raises ``MeshUnsupported``;
- two processes (gloo), one slot each: the prefill logits and tokens of
  the one-process decode.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from zest_tpu.models import gpt2 as j_gpt2, llama as j_llama, moe as j_moe
from zest_tpu.models import loader as j_loader
from zest_tpu.parallel.mesh import model_mesh as j_model_mesh
from zest_tpu_torch.models import gpt2, llama, loader, moe
from zest_tpu_torch.models import tensor_parallel as tp
from zest_tpu_torch.models.generate import load_generator
from zest_tpu_torch.models.safetensors_io import write_safetensors
from zest_tpu_torch.models.training import tree_paths
from zest_tpu_torch.parallel.mesh import model_mesh
from zest_tpu_torch.parallel.sharding import MeshUnsupported, shard_tensor

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5


def tree_paths_spec(specs, path):
    for k in path:
        specs = specs[k]
    return specs
E, L, V, H, KV, F, X = 64, 2, 256, 8, 4, 128, 8
D = E // H


def _w(rng, *shape, one=False):
    v = rng.normal(0, 0.02, shape).astype(np.float32)
    return v + np.float32(1) if one else v


def _llama_tensors(seed=0, tied=False, bias=False, kv=KV):
    rng = np.random.default_rng(seed)
    t = {"model.embed_tokens.weight": _w(rng, V, E),
         "model.norm.weight": _w(rng, E, one=True)}
    if not tied:
        t["lm_head.weight"] = _w(rng, V, E)
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = _w(rng, E, one=True)
        t[p + "post_attention_layernorm.weight"] = _w(rng, E, one=True)
        for proj, rows in (("q", H), ("k", kv), ("v", kv)):
            t[p + f"self_attn.{proj}_proj.weight"] = _w(rng, rows * D, E)
            if bias:
                t[p + f"self_attn.{proj}_proj.bias"] = _w(rng, rows * D)
        t[p + "self_attn.o_proj.weight"] = _w(rng, E, H * D)
        if bias:
            t[p + "self_attn.o_proj.bias"] = _w(rng, E)
        t[p + "mlp.gate_proj.weight"] = _w(rng, F, E)
        t[p + "mlp.up_proj.weight"] = _w(rng, F, E)
        t[p + "mlp.down_proj.weight"] = _w(rng, E, F)
    return t


def _mixtral_tensors(seed=1):
    rng = np.random.default_rng(seed)
    t = {"model.embed_tokens.weight": _w(rng, V, E),
         "model.norm.weight": _w(rng, E, one=True),
         "lm_head.weight": _w(rng, V, E)}
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = _w(rng, E, one=True)
        t[p + "post_attention_layernorm.weight"] = _w(rng, E, one=True)
        for proj, rows in (("q", H), ("k", KV), ("v", KV)):
            t[p + f"self_attn.{proj}_proj.weight"] = _w(rng, rows * D, E)
        t[p + "self_attn.o_proj.weight"] = _w(rng, E, H * D)
        t[p + "block_sparse_moe.gate.weight"] = _w(rng, X, E)
        for x in range(X):
            ep = f"{p}block_sparse_moe.experts.{x}."
            t[ep + "w1.weight"] = _w(rng, F, E)
            t[ep + "w2.weight"] = _w(rng, E, F)
            t[ep + "w3.weight"] = _w(rng, F, E)
    return t


LLAMA_CASES = {"untied": {}, "tied": {"tie_embeddings": True},
               "bias": {"attn_bias": True, "o_bias": True}}
MESHES = [{"model": 4}, {"data": 2, "model": 4}, {"model": 2}]


def _meshes(axes):
    n = int(np.prod(list(axes.values())))
    return (model_mesh(axes, ["cpu"] * n),
            j_model_mesh(axes, jax.devices()[:n]))


def _host(t):
    return {k: torch.from_numpy(v) for k, v in t.items()}


def _ids(seed=3, batch=2, n=8):
    return np.random.default_rng(seed).integers(0, V, (batch, n))


@pytest.mark.parametrize("axes", MESHES, ids=str)
@pytest.mark.parametrize("case", list(LLAMA_CASES))
def test_llama_tensor_parallel_matches_reference(case, axes):
    over = dict(n_head=H, n_kv_head=KV, d_ff=F, **LLAMA_CASES[case])
    cfg, jcfg = llama.LlamaConfig.tiny(**over), \
        j_llama.LlamaConfig.tiny(**over)
    t = _llama_tensors(tied=cfg.tie_embeddings, bias=cfg.attn_bias)
    mesh, jmesh = _meshes(axes)
    tree = loader.commit_tensors(_host(t), mesh=mesh,
                                 rules=llama.checkpoint_shard_rules())
    train = llama.params_from_hf(tree, cfg)
    params = tp.decode_params(train, cfg)
    assert isinstance(params, tp.TPParams)
    assert params.group.size == axes["model"]
    assert len(params.local) == axes["model"]
    # Only a vocabulary-parallel head is gathered.
    assert params.gather_bytes == (0 if cfg.tie_embeddings
                                   else train["lm_head"].nbytes)
    # The Megatron tensors stay in place: the training tree's shard itself.
    q_w = train["blocks"]["attn"]["q_w"]
    for j, s in enumerate(params.group.slots):
        assert params.local[j]["attn"]["q_w"].data_ptr() == \
            q_w.shard(s).data_ptr()
    jparams = j_llama.params_from_hf(
        j_loader.commit_tensors(t, jmesh, j_llama.checkpoint_shard_rules()),
        jcfg)
    ids = _ids()
    want = np.asarray(j_llama.forward(jparams, jnp.asarray(ids), jcfg))
    cache = params.init_kv_cache(2, 12, torch.float32)
    got, cache = tp.decode_window(params, cache, torch.from_numpy(ids), 0,
                                  cfg)
    assert np.abs(got.numpy() - want).max() <= TOL
    assert len(cache["k"]) == axes["model"]
    assert cache["k"][0].shape == (L, 2, 12, KV // axes["model"], D)
    assert np.abs(tp.forward(params, torch.from_numpy(ids), cfg).numpy()
                  - want).max() <= TOL
    jout = np.asarray(j_llama.generate_cached(jparams, jcfg,
                                              jnp.asarray(ids), 6))
    out = llama.generate_cached(params, cfg, ids.tolist(), 6).numpy()
    assert np.array_equal(out, jout)
    plain = llama.params_from_hf(_host(t), cfg)
    noise = torch.from_numpy(np.random.default_rng(4).gumbel(
        size=(13, 2, V)).astype(np.float32))
    kw = dict(temperature=0.8, top_k=50, top_p=0.9, noise=noise)
    assert np.array_equal(
        llama.generate_cached(params, cfg, ids.tolist(), 6, **kw).numpy(),
        llama.generate_cached(plain, cfg, ids.tolist(), 6, **kw).numpy())


def _j_moe_sharded(t, jcfg, jmesh):
    jp = j_moe.params_from_hf({k: jnp.asarray(v) for k, v in t.items()},
                              jcfg)
    return jax.device_put(jp, jax.tree.map(
        lambda s: NamedSharding(jmesh, s), j_moe.param_specs(jcfg),
        is_leaf=lambda v: isinstance(v, JP)))


@pytest.mark.parametrize("source", ["raw_landing", "stacked"])
def test_mixtral_expert_parallel_matches_reference(source):
    over = dict(n_head=H, n_kv_head=KV, d_ff=F, n_experts=X)
    cfg, jcfg = moe.MoEConfig.tiny(**over), j_moe.MoEConfig.tiny(**over)
    t = _mixtral_tensors()
    mesh, jmesh = _meshes({"expert": 4})
    if source == "raw_landing":
        tree = loader.commit_tensors(_host(t), mesh=mesh,
                                     rules=moe.checkpoint_shard_rules())
        params = tp.decode_params(moe.params_from_hf(tree, cfg), cfg)
        # The raw landing cut each expert's features; the tree holds whole
        # experts a slot, each gathered once onto it.
        for j, s in enumerate(params.group.slots):
            for x in params.experts[j]:
                name = f"model.layers.0.block_sparse_moe.experts.{x}"
                k = x - params.experts[j].start
                assert torch.equal(params.local[j]["moe"]["w1"][0][k],
                                   tree[f"{name}.w1.weight"].full().T)
                assert torch.equal(params.local[j]["moe"]["w2"][0][k],
                                   tree[f"{name}.w2.weight"].full().T)
    else:
        stacked = moe.params_from_hf(_host(t), cfg)

        def place(tr, sp):
            if isinstance(tr, dict):
                return {k: place(tr[k], sp[k]) for k in tr}
            return shard_tensor(tr, mesh, sp)

        tree = place(stacked, moe.param_specs(cfg))
        params = tp.moe_params(tree, cfg)
        w1 = tree["blocks"]["moe"]["w1"]
        for j, s in enumerate(params.group.slots):
            assert params.local[j]["moe"]["w1"].data_ptr() == \
                w1.shard(s).data_ptr()
    assert params.experts == [range(0, 2), range(2, 4), range(4, 6),
                              range(6, 8)]
    jparams = _j_moe_sharded(t, jcfg, jmesh)
    ids = _ids()
    want, _ = j_moe.decode_window(jparams, j_moe.init_kv_cache(jcfg, 2, 12),
                                  jnp.asarray(ids), 0, jcfg)
    cache = params.init_kv_cache(2, 12, torch.float32)
    got, _ = tp.decode_window(params, cache, torch.from_numpy(ids), 0, cfg)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    jout = np.asarray(j_moe.generate_cached(jparams, jcfg, jnp.asarray(ids),
                                            6))
    assert np.array_equal(
        moe.generate_cached(params, cfg, ids.tolist(), 6).numpy(), jout)
    # The sharded forward is a window over a fresh cache (every token its
    # own dispatch group), not moe.forward's one batch group.
    assert torch.equal(tp.forward(params, torch.from_numpy(ids), cfg), got)


def test_gpt2_sharded_tree_is_gathered(tmp_path):
    cfg_json = dict(model_type="gpt2", vocab_size=V, n_positions=64,
                    n_ctx=64, n_embd=E, n_layer=L, n_head=4,
                    layer_norm_epsilon=1e-5)
    rng = np.random.default_rng(7)
    t = {"wte.weight": _w(rng, V, E), "wpe.weight": _w(rng, 64, E),
         "ln_f.weight": _w(rng, E, one=True), "ln_f.bias": _w(rng, E)}
    for i in range(L):
        for leaf, shape in {"ln_1.weight": (E,), "ln_1.bias": (E,),
                            "ln_2.weight": (E,), "ln_2.bias": (E,),
                            "attn.c_attn.weight": (E, 3 * E),
                            "attn.c_attn.bias": (3 * E,),
                            "attn.c_proj.weight": (E, E),
                            "attn.c_proj.bias": (E,),
                            "mlp.c_fc.weight": (E, 4 * E),
                            "mlp.c_fc.bias": (4 * E,),
                            "mlp.c_proj.weight": (4 * E, E),
                            "mlp.c_proj.bias": (E,)}.items():
            t[f"h.{i}.{leaf}"] = _w(rng, *shape)
    cfg = gpt2.GPT2Config.from_hf(cfg_json)
    mesh, jmesh = _meshes({"data": 2, "model": 4})
    tree = loader.commit_tensors(_host(t), mesh=mesh,
                                 rules=gpt2.checkpoint_shard_rules())
    assert tuple(tree["h.0.attn.c_attn.weight"].spec) == (None, "model")
    sharded, plain = gpt2.params_from_hf(tree, cfg), \
        gpt2.params_from_hf(_host(t), cfg)
    flat = dict(tree_paths(plain))
    for path, v in tree_paths(sharded):
        assert v.spec == tree_paths_spec(gpt2.param_specs(cfg), path), path
        assert torch.equal(v.full(), flat[path]), path
    # The fused columns the landing cut stay in place on each slot.
    qkv = sharded["blocks"]["attn"]["qkv_w"]
    assert torch.equal(qkv.shard(1)[0], tree["h.0.attn.c_attn.weight"]
                       .shard(1))
    ids = _ids()
    jcfg = j_gpt2.GPT2Config.from_hf(cfg_json)
    jparams = j_gpt2.params_from_hf(j_loader.commit_tensors(
        t, jmesh, j_gpt2.checkpoint_shard_rules()), jcfg)
    want = np.asarray(j_gpt2.forward(jparams, jnp.asarray(ids), jcfg))
    params = tp.decode_params(sharded, cfg)
    assert params.group.size == 4 and params.cfg_local.n_head == 1
    got = tp.forward(params, torch.from_numpy(ids), cfg).numpy()
    assert np.abs(got - want).max() <= TOL
    np.testing.assert_allclose(
        got, gpt2.forward(plain, torch.from_numpy(ids), cfg).numpy(),
        atol=TOL, rtol=0)
    (tmp_path / "config.json").write_text(json.dumps(cfg_json))
    write_safetensors(tmp_path / "model.safetensors", _host(t))
    _, gen = load_generator(tmp_path, device="cpu", tensors=tree)
    _, gen_plain = load_generator(tmp_path, device="cpu")
    assert np.array_equal(gen(ids.tolist(), 5, stop_at_eos=False),
                          gen_plain(ids.tolist(), 5, stop_at_eos=False))


def test_load_generator_decodes_a_sharded_llama_tree(tmp_path):
    cfg_json = dict(model_type="llama", vocab_size=V, hidden_size=E,
                    intermediate_size=F, num_hidden_layers=L,
                    num_attention_heads=H, num_key_value_heads=KV,
                    max_position_embeddings=64, rms_norm_eps=1e-5,
                    rope_theta=1e4, tie_word_embeddings=False)
    t = _host(_llama_tensors(seed=5))
    (tmp_path / "config.json").write_text(json.dumps(cfg_json))
    write_safetensors(tmp_path / "model.safetensors", t)
    mesh = model_mesh({"model": 4}, ["cpu"] * 4)
    tree = loader.load_checkpoint(tmp_path, mesh=mesh,
                                  rules=llama.checkpoint_shard_rules())
    _, gen = load_generator(tmp_path, device="cpu", tensors=tree)
    _, gen_plain = load_generator(tmp_path, device="cpu")
    ids = _ids(seed=6).tolist()
    assert np.array_equal(gen(ids, 6, stop_at_eos=False),
                          gen_plain(ids, 6, stop_at_eos=False))


def test_heads_that_do_not_divide_raise():
    t = _llama_tensors(kv=2)
    mesh = model_mesh({"model": 4}, ["cpu"] * 4)
    tree = loader.commit_tensors(_host(t), mesh=mesh,
                                 rules=llama.checkpoint_shard_rules())
    cfg = llama.LlamaConfig.tiny(n_head=H, n_kv_head=2, d_ff=F)
    with pytest.raises(MeshUnsupported, match="kv heads"):
        tp.decode_params(llama.params_from_hf(tree, cfg), cfg)
    wrong_axis = loader.commit_tensors(
        _host(t), mesh=model_mesh({"expert": 4}, ["cpu"] * 4))
    with pytest.raises(MeshUnsupported, match="no 'model' axis"):
        llama.params_from_hf(wrong_axis, cfg)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_tensor_parallel_prefill(tmp_path):
    """Two gloo processes, one CPU slot each, ``{"model": 2}``: each holds
    only its own shards, and the prefill logits and greedy tokens equal
    the one-process decode over ``["cpu"] * 2`` (and the reference's)."""
    spec = dict(n_head=H, n_kv_head=KV, d_ff=F)
    cfg = llama.LlamaConfig.tiny(**spec)
    t = _llama_tensors(seed=9)
    ids = _ids(seed=10)
    np.savez(tmp_path / "ckpt.npz", **t)
    np.save(tmp_path / "ids.npy", ids)
    (tmp_path / "cfg.json").write_text(json.dumps(spec))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_mp_worker.py"),
         str(rank), "2", str(port), str(tmp_path), "tp"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    mesh = model_mesh({"model": 2}, ["cpu"] * 2)
    one = llama.params_from_hf(loader.commit_tensors(
        _host(t), mesh=mesh, rules=llama.checkpoint_shard_rules()), cfg)
    want = tp.forward(one, torch.from_numpy(ids), cfg).numpy()
    jcfg = j_llama.LlamaConfig.tiny(**spec)
    jparams = j_llama.params_from_hf(j_loader.commit_tensors(
        t, j_model_mesh({"model": 2}, jax.devices()[:2]),
        j_llama.checkpoint_shard_rules()), jcfg)
    ref = np.asarray(j_llama.forward(jparams, jnp.asarray(ids), jcfg))
    tokens = llama.generate_cached(one, cfg, ids.tolist(), 4).numpy()
    for rank in range(2):
        got = np.load(tmp_path / f"logits_{rank}.npy")
        assert np.abs(got - want).max() <= TOL
        assert np.abs(got - ref).max() <= TOL
        assert np.array_equal(np.load(tmp_path / f"greedy_{rank}.npy"),
                              tokens)
