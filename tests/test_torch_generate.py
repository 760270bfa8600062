"""The port's ``generate`` against the JAX package's, on the CPU.

Mirrors tests/test_generate.py but for its HTTP cases (they wait for the
serving slice): ``load_generator`` for llama and gpt2 snapshots, the
sampler's semantics token for token against
``zest_tpu.models.sampling.sample_token`` (both draws given the same
``jax.random.gumbel`` noise: the port draws its own from a
``torch.Generator``, so one seed gives other tokens than the JAX
package's), ``top_k=1`` as greedy, the ``top_p`` range check, EOS stop,
trim and row freezing with several stop ids, ``on_token`` on both decode
paths, the prefill equal to the sequential replay, the unsupported and
missing-weight errors, ``try_tokenizer``, and the CLI end to end on a
fixture hub with its flag errors. Greedy and injected-noise tokens are
compared exactly.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import (
    FixtureHub,
    FixtureRepo,
    gpt2_checkpoint_files,
    llama_checkpoint_files,
)
from zest_tpu.models import generate as j_generate
from zest_tpu.models import llama as j_llama
from zest_tpu.models.sampling import sample_token as j_sample_token
from zest_tpu_torch.models import generate, llama, sampling
from zest_tpu_torch.models.generate import (
    UnsupportedModelError,
    load_generator,
    try_tokenizer,
)


def _write(root, files: dict, **cfg_over):
    root.mkdir(parents=True, exist_ok=True)
    for name, blob in files.items():
        if name == "config.json" and cfg_over:
            blob = json.dumps(dict(json.loads(blob), **cfg_over)).encode()
        (root / name).write_bytes(blob)
    return root


@pytest.fixture(scope="module")
def llama_snap(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("llama"),
                  llama_checkpoint_files(seed=2))


@pytest.fixture(scope="module")
def gpt2_snap(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("gpt2"),
                  gpt2_checkpoint_files(n_embd=64, n_layer=2))


@pytest.fixture(scope="module")
def tiny():
    """A tiny Llama (the JAX package's ``init_params``) on both sides."""
    cfg = j_llama.LlamaConfig.tiny()
    jparams = j_llama.init_params(jax.random.key(0), cfg)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, jparams, llama.LlamaConfig.tiny(), params


def _jax_gumbel(key, positions: int, batch: int, vocab: int) -> torch.Tensor:
    """The Gumbel noise the JAX package's decode loop draws with ``key``:
    one (vocab,) draw per (position, row) of its key grid."""
    keys = jax.random.split(key, positions * batch).reshape(positions, batch)
    return torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.gumbel(k, (vocab,), jnp.float32)))(keys)))


# ── load_generator ──


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_load_generator_matches_reference(family, llama_snap, gpt2_snap):
    snap = llama_snap if family == "llama" else gpt2_snap
    model_type, gen = load_generator(snap, device="cpu")
    j_type, j_gen = j_generate.load_generator(snap)
    assert model_type == j_type == family
    assert gen.eos_ids == j_gen.eos_ids
    for prompt in ([5, 6, 7], [[5, 6, 7], [9, 1, 4]]):
        assert np.array_equal(gen(prompt, 6), j_gen(prompt, 6))
    # Sampled, with the noise the reference draws from seed 3.
    kw = dict(temperature=0.9, top_k=20, top_p=0.95)
    want = j_gen([[5, 6, 7], [9, 1, 4]], 6, seed=3, **kw)
    noise = _jax_gumbel(jax.random.key(3), 8, 2, 256 if family == "llama"
                        else json.loads((snap / "config.json").read_text())[
                            "vocab_size"])
    assert np.array_equal(gen([[5, 6, 7], [9, 1, 4]], 6, noise=noise, **kw),
                          want)


def test_generator_takes_a_landed_tree(llama_snap):
    """``tensors=`` (a pull's landed tree) builds the same generator as
    landing the snapshot, and the dict handed over is left as it was."""
    from zest_tpu_torch.models.loader import load_checkpoint

    landed = load_checkpoint(llama_snap, "cpu")
    before = dict(landed)
    _, gen = load_generator(llama_snap, device="cpu", tensors=landed)
    _, again = load_generator(llama_snap, device="cpu")
    assert np.array_equal(gen([1, 2, 3], 5), again([1, 2, 3], 5))
    assert landed.keys() == before.keys()


# ── The sampler ──


_LOGITS = [
    [0.0, 5.0, 4.0, -1.0],
    [4.0, -2.0, 3.0, 5.0, 2.0],
    [0.0] * 16,
    list(np.random.default_rng(0).normal(0, 2, 64)),
]
_SETTINGS = [
    dict(temperature=1.0), dict(temperature=5.0, top_k=2),
    dict(temperature=1.0, top_k=100000), dict(temperature=1.0, top_p=0.7),
    dict(temperature=3.0, top_p=1e-6), dict(temperature=1.0, top_k=3,
                                            top_p=0.7),
    dict(temperature=50.0, top_p=1.0), dict(temperature=0.0),
    dict(temperature=0.7, top_k=5, top_p=0.9),
]


@pytest.mark.parametrize("settings", _SETTINGS, ids=lambda s: "-".join(
    f"{k}={v}" for k, v in s.items()))
def test_sample_token_matches_reference_under_injected_noise(settings):
    """Temperature, top-k (k past the vocabulary: no restriction),
    nucleus with HF's boundary rule (ties at the boundary keep the
    earliest index), their composition and greedy: the reference's token
    for each of 12 draws of its own noise."""
    for row in _LOGITS:
        logits = np.asarray(row, np.float32)
        for s in range(12):
            key = jax.random.key(s)
            want = int(j_sample_token(jnp.asarray(logits), key, **settings))
            g = torch.from_numpy(np.array(jax.random.gumbel(
                key, logits.shape, jnp.float32)))
            got = sampling.sample_token(torch.from_numpy(logits), noise=g,
                                        **settings)
            assert int(got) == want, (row, s)


def test_sampling_semantics():
    """top_k masks everything outside the k best; a tiny nucleus is
    greedy and with all logits equal keeps index 0; top_p >= 1 is
    unrestricted; one seed gives one draw, seeds differ."""
    logits = torch.tensor([0.0, 5.0, 4.0, -1.0])
    gen = torch.Generator().manual_seed(0)
    draws = [int(sampling.sample_token(logits, 5.0, top_k=2, generator=gen))
             for _ in range(32)]
    assert set(draws) == {1, 2}
    assert all(int(sampling.sample_token(torch.zeros(16), 5.0, top_p=1e-6,
                                         generator=gen)) == 0
               for _ in range(8))
    wide = {int(sampling.sample_token(torch.tensor([4.0, -2, 3, 5, 2]),
                                      50.0, top_p=1.0, generator=gen))
            for _ in range(64)}
    assert len(wide) >= 4
    batch = torch.tensor([[0.0, 5.0, 4.0, -1.0]] * 3)
    assert sampling.sample_token(batch, 1.0, top_k=1,
                                 generator=gen).tolist() == [1, 1, 1]

    def seeded(seed):
        return sampling.sample_token(
            torch.zeros(4, 64), 1.0,
            generator=torch.Generator().manual_seed(seed)).tolist()

    assert seeded(7) == seeded(7) and seeded(7) != seeded(8)


@pytest.mark.parametrize("bad", [0.0, -0.5, 1.5])
def test_top_p_out_of_range_raises(bad, tiny):
    _, _, cfg, params = tiny
    with pytest.raises(ValueError, match="top_p"):
        sampling.sample_token(torch.zeros(4), 1.0, top_p=bad)
    with pytest.raises(ValueError, match="top_p"):
        llama.generate_cached(params, cfg, [1, 2], 3, temperature=1.0,
                              top_p=bad)
    with pytest.raises(ValueError, match="top_p"):
        j_sample_token(jnp.zeros(4), jax.random.key(0), 1.0, None, bad)


def test_top_k_1_is_greedy_and_seeds_repeat(llama_snap, gpt2_snap):
    for snap in (llama_snap, gpt2_snap):
        _, gen = load_generator(snap, device="cpu")
        greedy = gen([1, 2], 8)
        assert np.array_equal(gen([1, 2], 8, temperature=0.7, top_k=1),
                              greedy)
        assert np.array_equal(gen([1, 2], 8, temperature=2.0, top_p=1e-6),
                              greedy)
        s = gen([1, 2], 8, temperature=1.5, seed=3)
        assert s.shape == (10,)
        assert np.array_equal(s, gen([1, 2], 8, temperature=1.5, seed=3))
        assert any(not np.array_equal(
            gen([1, 2], 8, temperature=2.0, seed=k), greedy)
            for k in range(4))


# ── Decode-loop semantics against the reference ──


def test_eos_stop_trim_and_row_freezing(tiny, llama_snap):
    """A row that generates a stop id pads the rest with the first stop
    id; a tuple stops on any of its ids; the other row is untouched; the
    generator trims just past the first generated stop and prompt
    occurrences do not count. Tokens equal the reference's."""
    jcfg, jparams, cfg, params = tiny
    prompts = np.asarray([[3, 7, 1], [5, 2, 9]], np.int32)
    base = llama.generate_cached(params, cfg, prompts, 8).numpy()
    assert np.array_equal(base, np.asarray(
        j_llama.generate_cached(jparams, jcfg, prompts, 8)))
    eos = int(base[0, 4])
    if eos == int(base[1, 4]):
        eos = int(base[0, 5])
    # A first stop id that is never generated: only ``eos`` can fire.
    other = next(t for t in range(cfg.vocab_size) if t not in base)
    for stop in (eos, (other, eos)):
        out = llama.generate_cached(params, cfg, prompts, 8,
                                    eos_id=stop).numpy()
        assert np.array_equal(out, np.asarray(j_llama.generate_cached(
            jparams, jcfg, prompts, 8, eos_id=stop)))
        row0 = list(base[0]).index(eos, 3)
        assert np.array_equal(out[0, :row0 + 1], base[0, :row0 + 1])
        pad = stop if isinstance(stop, int) else stop[0]
        assert set(out[0, row0 + 1:].tolist()) <= {pad}
    # The generator: trim, full buffer, a stop id in the prompt.
    _, gen = load_generator(llama_snap, device="cpu")
    full = gen([1, 2], 8)
    stop = int(full[4])
    first = 2 + list(full[2:]).index(stop)
    other = next(t for t in range(cfg.vocab_size) if t not in full)
    cfg_json = json.loads((llama_snap / "config.json").read_text())
    snap = _write(llama_snap.parent / "llama-eos", {
        "config.json": json.dumps(dict(cfg_json, eos_token_id=[other, stop])
                                  ).encode(),
        "model.safetensors": (llama_snap / "model.safetensors").read_bytes()})
    _, gen = load_generator(snap, device="cpu")
    _, j_gen = j_generate.load_generator(snap)
    assert gen.eos_ids == (other, stop)
    assert np.array_equal(gen([1, 2], 8), full[:first + 1])
    assert np.array_equal(gen([1, 2], 8, stop_at_eos=False),
                          j_gen([1, 2], 8, stop_at_eos=False))
    assert np.array_equal(gen([1, stop, 2], 8), j_gen([1, stop, 2], 8))


def test_ids_outside_the_vocabulary_raise(tiny):
    """The JAX package's gather clamps such an id; an embedding lookup
    here would fault (on a card, the whole context), so it is refused."""
    _, _, cfg, params = tiny
    for prompt, eos in (([1, 256], None), ([-1, 2], None), ([1, 2], 999),
                        ([1, 2], (3, 256))):
        with pytest.raises(ValueError, match="must be in"):
            llama.generate_cached(params, cfg, prompt, 3, eos_id=eos)


def test_on_token_positions_on_both_paths(tiny):
    """The prefill path reports each generated position once, in order;
    the sequential path the prompt replay positions too; the streamed
    tokens are the returned ones; a raising callback is dropped."""
    _, _, cfg, params = tiny
    seen = []
    out = llama.generate_cached(
        params, cfg, [3, 7, 1], 6,
        on_token=lambda pos, toks: seen.append((pos, int(toks[0])))).numpy()
    assert [p for p, _ in seen] == list(range(3, 9))
    assert all(out[p] == t for p, t in seen)
    seen_seq = []
    out_seq = sampling.cached_decode_loop(
        llama.init_kv_cache, llama.decode_step, params, cfg, [3, 7, 1], 6,
        on_token=lambda pos, toks: seen_seq.append((pos, int(toks[0])))
    ).numpy()
    assert [p for p, _ in seen_seq] == list(range(1, 9))
    assert all(out_seq[p] == t for p, t in seen_seq)

    def boom(pos, toks):
        raise RuntimeError("callback failed")

    assert np.array_equal(llama.generate_cached(params, cfg, [3, 7, 1], 6,
                                                on_token=boom).numpy(), out)


@pytest.mark.parametrize("prompt", [[3, 7, 1, 4, 2], [[3, 7, 1], [5, 2, 9]]],
                         ids=["single", "batched"])
def test_prefill_matches_sequential_decode(tiny, prompt):
    """The batched prefill gives the sequential replay's tokens for both
    families, greedy, sampled (the noise of each sampled position is
    drawn in the same order on both paths) and under EOS."""
    from zest_tpu.models import gpt2 as j_gpt2
    from zest_tpu_torch.models import gpt2

    _, _, cfg, params = tiny
    g_cfg = j_gpt2.GPT2Config.tiny()
    g_params = gpt2.params_from_jax(jax.tree.map(
        np.asarray, j_gpt2.init_params(jax.random.key(1), g_cfg)))
    g_cfg = gpt2.GPT2Config(**{f: getattr(g_cfg, f) for f in (
        "vocab_size", "n_ctx", "n_embd", "n_layer", "n_head")})
    for fam, c, p in ((llama, cfg, params), (gpt2, g_cfg, g_params)):
        base = fam.generate_cached(p, c, prompt, 6)
        first = int(base.reshape(-1, base.shape[-1])[0, -6])
        for kw in ({}, dict(temperature=1.3, top_p=0.9, seed=5),
                   dict(eos_id=first)):
            seq = sampling.cached_decode_loop(
                fam.init_kv_cache, fam.decode_step, p, c, prompt, 6, **kw)
            pre = fam.generate_cached(p, c, prompt, 6, **kw)
            assert torch.equal(pre, seq), (fam.__name__, kw)


def test_prefill_respects_eos_like_reference(tiny):
    jcfg, jparams, cfg, params = tiny
    base = llama.generate_cached(params, cfg, [3, 7, 1], 8).numpy()
    first = int(base[3])
    out = llama.generate_cached(params, cfg, [3, 7, 1], 8,
                                eos_id=first).numpy()
    assert set(out[3:].tolist()) == {first}
    assert np.array_equal(out, np.asarray(j_llama.generate_cached(
        jparams, jcfg, [3, 7, 1], 8, eos_id=first)))


def test_sampled_decode_matches_reference_under_injected_noise(tiny):
    """The whole sampled decode, prefill path, batched: the reference's
    tokens for the noise its key grid draws."""
    jcfg, jparams, cfg, params = tiny
    prompts = np.asarray([[3, 7, 1], [5, 2, 9]], np.int32)
    kw = dict(temperature=1.1, top_k=50, top_p=0.9)
    key = jax.random.key(4)
    want = np.asarray(j_llama.generate_cached(jparams, jcfg, prompts, 10,
                                              rng=key, **kw))
    got = llama.generate_cached(params, cfg, prompts, 10,
                                noise=_jax_gumbel(key, 12, 2, 256), **kw)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="noise"):
        llama.generate_cached(params, cfg, prompts, 10,
                              noise=_jax_gumbel(key, 12, 1, 256), **kw)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.8, top_k=50, top_p=0.9),
    dict(temperature=1.3, top_k=20, top_p=0.5),
    dict(temperature=0.5, top_k=None, top_p=0.95),
])
def test_chip_smoke_margin_gate_reproduces_sampled_choices(tiny, kw):
    """``chip_smoke.sampled_margin``, the gate that forgives a bf16 token
    only where the float32 decision is near a flip, reproduces every
    float32 choice of a sampled decode from the cached path's logits and
    the noise (it fails on a choice it does not reproduce), and refuses
    a token that is not the pick."""
    import chip_smoke

    _, _, cfg, params = tiny
    prompts = [[3, 7, 1, 4, 2, 8, 6, 5], [5, 2, 9, 1, 1, 3, 0, 7]]
    n0, steps = 8, 16
    noise = sampling.gumbel_noise((n0 + steps - 1, 2, cfg.vocab_size),
                                  torch.Generator().manual_seed(0))
    got = llama.generate_cached(params, cfg, prompts, steps, noise=noise,
                                **kw)
    logits = chip_smoke.cached_logits(llama, params, cfg, got, n0)
    for r in range(2):
        for pos in range(n0, n0 + steps):
            assert chip_smoke.sampled_margin(
                logits[r, pos - 1], noise[pos - 1, r], int(got[r, pos]),
                **kw) > 0
    least = int(logits[0, n0 - 1].argmin())
    with pytest.raises(RuntimeError, match="not the gate's pick"):
        chip_smoke.sampled_margin(logits[0, n0 - 1], noise[n0 - 1, 0],
                                  least, **kw)


# ── Errors, the tokenizer, the CLI ──


def test_load_generator_unsupported_and_missing_weights(tmp_path):
    for family in ("rwkv", "gpt_neox"):
        (tmp_path / "config.json").write_text(json.dumps(
            {"model_type": family}))
        with pytest.raises(UnsupportedModelError, match=family):
            load_generator(tmp_path, device="cpu")
    for family in ("gpt2", "llama", "mixtral"):
        (tmp_path / "config.json").write_text(json.dumps(
            {"model_type": family}))
        with pytest.raises(FileNotFoundError, match="safetensors"):
            load_generator(tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError, match="safetensors"):
        generate.snapshot_tensors(tmp_path)


def test_try_tokenizer_absent(tmp_path):
    assert try_tokenizer(tmp_path) is None
    assert j_generate.try_tokenizer(tmp_path) is None


def _hub_env(monkeypatch, tmp_path, hub):
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("ZEST_CACHE_DIR", str(tmp_path / "zest"))
    monkeypatch.setenv("HF_TOKEN", "hf_test")
    monkeypatch.setenv("HF_ENDPOINT", hub.url)


def test_cli_generate_end_to_end(tmp_path, monkeypatch, capsys):
    """Fixture hub → pull → sampled Llama decode → ids out; the same
    flags greedy give the reference CLI's ids."""
    from zest_tpu import cli as j_cli
    from zest_tpu_torch import cli

    repo = FixtureRepo("acme/gen-llama", llama_checkpoint_files(seed=4),
                       chunks_per_xorb=4)
    with FixtureHub(repo) as hub:
        _hub_env(monkeypatch, tmp_path, hub)
        argv = ["generate", "acme/gen-llama", "--ids", "1,2,3", "--steps",
                "5"]
        samp = ["--temperature", "0.8", "--top-k", "50", "--top-p", "0.9",
                "--seed", "1"]
        assert cli.main(argv + samp + ["--device", "cpu"]) == 0
        sampled = capsys.readouterr().out.strip().splitlines()
        assert cli.main(argv + samp + ["--device", "cpu"]) == 0
        assert capsys.readouterr().out.strip().splitlines() == sampled
        assert cli.main(argv + ["--device", "cpu"]) == 0
        greedy = capsys.readouterr().out.strip().splitlines()
        assert j_cli.main(argv + ["--no-p2p"]) == 0
        j_greedy = capsys.readouterr().out.strip().splitlines()
    assert sampled[0] == "[llama] 3 prompt + 5 new tokens"
    ids = [int(t) for t in sampled[-1].split(",")]
    assert len(ids) == 8 and ids[:3] == [1, 2, 3]
    assert greedy[-2:] == j_greedy[-2:]


def test_cli_generate_flag_errors(tmp_path, monkeypatch, capsys):
    """The reference's validation and exit codes: 2 before the pull
    (no prompt, malformed ids, steps < 1) and for a prompt with no
    tokenizer; 1 for a context overflow and a top_p out of range."""
    from zest_tpu_torch import cli

    repo = FixtureRepo("acme/gen2", gpt2_checkpoint_files(n_embd=64,
                                                          n_layer=2),
                       chunks_per_xorb=4)
    with FixtureHub(repo) as hub:
        _hub_env(monkeypatch, tmp_path, hub)
        base = ["generate", "acme/gen2", "--device", "cpu"]
        assert cli.main(base) == 2
        assert cli.main(base + ["--ids", "1,x"]) == 2
        assert cli.main(base + ["--ids", "1", "--steps", "0"]) == 2
        assert not (tmp_path / "zest").exists()  # nothing was pulled
        assert cli.main(base + ["--prompt", "hello"]) == 2
        assert cli.main(base + ["--ids", "1,2", "--steps", "100"]) == 1
        assert cli.main(base + ["--ids", "1,2", "--temperature", "1",
                                "--top-p", "0"]) == 1
    err = capsys.readouterr().err
    assert "required" in err and "tokenizer" in err and "positive" in err
    assert "exceeds" in err and "top_p" in err
