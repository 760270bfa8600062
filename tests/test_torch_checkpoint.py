"""The port's train-state checkpoint, HF export and the fine-tune
lifecycle, on the CPU.

- ``save_train_state`` / ``restore_train_state`` round-trip every array
  bit for bit, and the steps continued from the restored state equal the
  steps continued from the saved one (an unmarked mirror of
  tests/test_checkpoint.py's slow round trip); a second save to the same
  path raises; a state of another structure does not restore;
- ``export_hf_safetensors`` writes the JAX package's bytes for the same
  tree: untied, tied, ``attention_bias`` and Qwen2's q/k/v biases, and
  its file reads back through ``params_from_hf`` bit for bit;
- the lifecycle on a loopback publisher with a tiny Llama: pull → three
  AdamW steps (losses within 1e-5 of the reference's optax run on the
  same tree) → export → push → a delta pull over the pulled tree, whose
  digest is the export's and whose greedy tokens are the trainer's.

The train-state format is the port's own (safetensors and a JSON of the
scalars), not orbax's: the two packages do not read each other's.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.models import llama as j_llama
from zest_tpu.models import training as j_training
from zest_tpu.models.checkpoint import \
    export_hf_safetensors as j_export_hf_safetensors
from zest_tpu_torch.api.http_api import PublisherServer
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import gpt2, llama, training
from zest_tpu_torch.models.checkpoint import (export_hf_safetensors,
                                              restore_train_state,
                                              save_train_state)
from zest_tpu_torch.models.loader import load_checkpoint, params_digest
from zest_tpu_torch.models.safetensors_io import (SafetensorsFile,
                                                  write_safetensors)
from zest_tpu_torch.models.training import tree_leaves, tree_map, tree_paths
from zest_tpu_torch.transfer.pull import pull_model
from zest_tpu_torch.transfer.push import push_checkpoint

REPO = "acme/finetune"


def _quiet(*a, **k):
    pass


def _batch(vocab, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape))


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for s in (a, b):
        assert s.opt_state.count == s.step
    for x, y in zip(*(tree_leaves({"p": s.params, "m": s.opt_state.mu,
                                   "n": s.opt_state.nu}) for s in (a, b))):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_save_restore_round_trip_continues_equal(tmp_path, family):
    mod, cfg = {"gpt2": (gpt2, gpt2.GPT2Config.tiny()),
                "llama": (llama, llama.LlamaConfig.tiny())}[family]
    tx = training.adamw(warmup_steps=1, total_steps=10)
    step = training.make_train_step(tx, functools.partial(mod.loss_fn,
                                                          cfg=cfg))
    batch = _batch(cfg.vocab_size, (2, 9), 0)
    state = training.create_state(
        mod.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"), tx)
    for _ in range(2):
        state, _ = step(state, batch)
    save_train_state(tmp_path / "step_2", state)
    assert sorted(p.name for p in (tmp_path / "step_2").iterdir()) == [
        "arrays.safetensors", "train_state.json"]
    like = training.create_state(
        mod.init_params(torch.Generator().manual_seed(9), cfg, device="cpu"), tx)
    restored = restore_train_state(tmp_path / "step_2", like)
    _assert_states_equal(restored, state)
    assert restored.step == 2
    # Fresh allocations: the restored state shares nothing with the
    # saved one or with the template.
    ptrs = {t.data_ptr() for t in tree_leaves(
        {"p": state.params, "m": state.opt_state.mu, "l": like.params})}
    assert not ptrs & {t.data_ptr() for t in tree_leaves(restored.params)}
    for _ in range(2):
        state, loss = step(state, batch)
        restored, rloss = step(restored, batch)
        assert torch.equal(loss, rloss)
    _assert_states_equal(restored, state)
    assert restored.step == 4


def test_second_save_and_wrong_structure_raise(tmp_path):
    cfg = llama.LlamaConfig.tiny()
    tx = training.adamw()
    state = training.create_state(
        llama.init_params(torch.Generator().manual_seed(1), cfg, device="cpu"), tx)
    save_train_state(tmp_path / "s", state)
    with pytest.raises(FileExistsError):
        save_train_state(tmp_path / "s", state)
    other = training.create_state(llama.init_params(
        torch.Generator().manual_seed(1),
        dataclasses.replace(cfg, tie_embeddings=True), device="cpu"), tx)
    with pytest.raises(ValueError, match="lm_head"):
        restore_train_state(tmp_path / "s", other)
    wider = training.create_state(llama.init_params(
        torch.Generator().manual_seed(1),
        dataclasses.replace(cfg, d_ff=256), device="cpu"), tx)
    with pytest.raises(ValueError, match="gate_w"):
        restore_train_state(tmp_path / "s", wider)


EXPORTS = {
    "untied": {},
    "tied": {"tie_embeddings": True},
    "attention_bias": {"attn_bias": True, "o_bias": True},
    "qwen2": {"attn_bias": True},
}


@pytest.mark.parametrize("case", list(EXPORTS))
def test_export_bytes_equal_reference(tmp_path, case):
    jcfg = j_llama.LlamaConfig.tiny(**EXPORTS[case])
    jparams = j_llama.init_params(jax.random.key(5), jcfg)
    # Nonzero biases, so a swapped or dropped bias shows.
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.5 if str(path[-1].key).endswith("_b") else x,
        jparams)
    j_export_hf_safetensors(tmp_path / "ref.safetensors", jparams, jcfg)
    cfg = llama.LlamaConfig(**dataclasses.asdict(jcfg))
    params = llama.params_from_jax(jax.tree.map(np.asarray, jparams))
    export_hf_safetensors(tmp_path / "port.safetensors", params, cfg)
    want = (tmp_path / "ref.safetensors").read_bytes()
    assert (tmp_path / "port.safetensors").read_bytes() == want
    with SafetensorsFile(tmp_path / "port.safetensors") as sf:
        names = sf.names()
        back = dict(tree_paths(llama.params_from_hf(
            {n: sf.tensor(n) for n in names}, cfg)))
        for path, t in tree_paths(params):
            assert torch.equal(t, back[path]), path
    assert ("model.layers.0.self_attn.q_proj.bias" in names) == \
        jcfg.attn_bias
    assert ("model.layers.0.self_attn.o_proj.bias" in names) == jcfg.o_bias
    assert ("lm_head.weight" in names) != jcfg.tie_embeddings


def _llama_checkpoint(root, hf_cfg: dict, seed: int):
    cfg = llama.LlamaConfig.from_hf(hf_cfg)
    rng = np.random.default_rng(seed)
    E, F, V = cfg.n_embd, cfg.d_ff, cfg.vocab_size
    kvE = cfg.n_kv_head * cfg.head_dim

    def w(*shape):
        return rng.normal(0, 0.02, shape).astype(np.float32)

    t = {"model.embed_tokens.weight": w(V, E), "lm_head.weight": w(V, E),
         "model.norm.weight": 1 + w(E)}
    for i in range(cfg.n_layer):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": 1 + w(E),
                  p + "post_attention_layernorm.weight": 1 + w(E),
                  p + "self_attn.q_proj.weight": w(E, E),
                  p + "self_attn.k_proj.weight": w(kvE, E),
                  p + "self_attn.v_proj.weight": w(kvE, E),
                  p + "self_attn.o_proj.weight": w(E, E),
                  p + "mlp.gate_proj.weight": w(F, E),
                  p + "mlp.up_proj.weight": w(F, E),
                  p + "mlp.down_proj.weight": w(E, F)})
    root.mkdir(parents=True)
    (root / "config.json").write_text(json.dumps(hf_cfg))
    write_safetensors(root / "model.safetensors", t)
    return t


def test_lifecycle_pull_finetune_export_push_delta_pull(tmp_path):
    hf_cfg = dict(model_type="llama", vocab_size=256, hidden_size=64,
                  intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=64, rms_norm_eps=1e-5,
                  rope_theta=10000.0, tie_word_embeddings=False)
    tensors = _llama_checkpoint(tmp_path / "ck_a", hf_cfg, 7)
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest")
    sha_a = push_checkpoint(cfg_a, REPO, tmp_path / "ck_a", device="cpu",
                            log=_quiet).revision
    batch = _batch(256, (2, 17), 8)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    with PublisherServer(cfg_a) as server:
        cfg_s = Config(hf_home=tmp_path / "s" / "hf",
                       cache_dir=tmp_path / "s" / "zest",
                       endpoint=server.url)
        base = pull_model(cfg_s, REPO, device="cpu", log=_quiet).params
        cfg = llama.LlamaConfig.from_hf(hf_cfg)
        # The step updates in place (the reference donates), and a
        # float32 tree from params_from_hf aliases the pulled tensors:
        # the trainer takes its own copy, the pulled tree stays A's.
        params = tree_map(torch.clone, llama.params_from_hf(base, cfg))
        tx = training.adamw(**kw)
        step = training.make_train_step(
            tx, functools.partial(llama.loss_fn, cfg=cfg))
        state = training.create_state(params, tx)
        losses = []
        for _ in range(3):
            state, loss = step(state, batch)
            losses.append(float(loss))

        # The reference's optax run from the same tree and batch.
        jcfg = j_llama.LlamaConfig.from_hf(hf_cfg)
        jtx = j_training.adamw(**kw)
        jstep = j_training.make_train_step(
            jtx, functools.partial(j_llama.loss_fn, cfg=jcfg))
        jstate = j_training.create_state(
            j_llama.params_from_hf(tensors, jcfg), jtx)
        jlosses = []
        for _ in range(3):
            jstate, jloss = jstep(jstate, jnp.asarray(batch.numpy(),
                                                      jnp.int32))
            jlosses.append(float(jloss))
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        assert losses[2] < losses[0]

        ck_b = tmp_path / "ck_b"
        ck_b.mkdir()
        (ck_b / "config.json").write_text(json.dumps(hf_cfg))
        export_hf_safetensors(ck_b / "model.safetensors", state.params,
                              cfg)
        sha_b = push_checkpoint(cfg_a, REPO, ck_b, base_revision=sha_a,
                                device="cpu", notify=False,
                                log=_quiet).revision
        assert sha_b != sha_a
        n = len(base)
        res = pull_model(cfg_s, REPO, revision=sha_b, device="cpu",
                         base_params=base, base_revision=sha_a, log=_quiet)
    swapped = res.params
    assert params_digest(swapped) == params_digest(
        load_checkpoint(ck_b, "cpu"))
    delta = res.stats["delta"]
    assert delta["base_revision"] == sha_a
    # AdamW moved every leaf: nothing of A is reused.
    assert res.stats["hbm"]["swap"]["reused_tensors"] == 0
    assert res.stats["hbm"]["swap"]["landed_tensors"] == len(swapped) == n
    prompt = batch[0, :5].tolist()
    got = llama.generate_cached(llama.params_from_hf(swapped, cfg), cfg,
                                [prompt], 8)
    want = llama.generate_cached(state.params, cfg, [prompt], 8)
    assert torch.equal(got, want)
