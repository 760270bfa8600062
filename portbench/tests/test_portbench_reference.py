"""The reference against the port at a tiny size on the CPU: it agrees
with a landing, a hot-swap and a forward of the program, and its
controls and the faults a cell can have read as not correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import checkpoints, reference
from portbench.hub import FixtureHub, FixtureRepo

from portbench.tests.conftest import TINY_GPT2, TINY_LLAMA


def _files(cfg, seed=5):
    data = checkpoints.draw(cfg, seed, "cpu")
    return data, checkpoints.repo_files(cfg, data)


def _config(tmp_path, url):
    from zest_tpu_torch.config import Config

    return Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                  hf_token="hf_t", endpoint=url)


@pytest.mark.parametrize("cfg", [TINY_LLAMA, TINY_GPT2],
                         ids=["llama-bf16", "gpt2-f32"])
def test_reference_agrees_with_a_cpu_landing(tmp_path, cfg):
    from zest_tpu_torch.transfer.pull import pull_model

    _, files = _files(cfg)
    blob = files["model.safetensors"]
    repo = FixtureRepo("t/m", files)
    with FixtureHub(repo) as hub:
        res = pull_model(_config(tmp_path, hub.url), "t/m", device="cpu",
                         no_p2p=True, log=lambda *a, **k: None)
    got = reference.judge_tree(res.params, blob)
    assert got == {"bad_bytes": 0, "missing": 0, "extra": 0,
                   "tensors": len(checkpoints.layout(cfg))}
    # The landed tree's dtype is the published one.
    _, entries = reference.read_safetensors(blob)
    assert {e[0] for e in entries.values()} == (
        {"BF16"} if cfg is TINY_LLAMA else {"F32"})


def test_reference_agrees_with_a_cpu_swap(tmp_path):
    from zest_tpu_torch.transfer.pull import pull_model

    # Wide enough that the file spans many chunks and a 1% delta leaves
    # most tensors' chunks as they were.
    cfg = dict(TINY_LLAMA, hidden_size=256, intermediate_size=512,
               num_hidden_layers=4, vocab_size=2048)
    data, files_a = _files(cfg)
    files_b = checkpoints.repo_files(
        cfg, checkpoints.mutate(cfg, data, 0.01, 11))
    repo = FixtureRepo("t/m", files_a)
    sha_a = repo.commit_sha
    sha_b = repo.add_revision(files_b)
    ref_b = reference.apply_delta(files_a["model.safetensors"], 0.01, 11)
    assert ref_b == files_b["model.safetensors"]
    quiet = dict(device="cpu", no_p2p=True, log=lambda *a, **k: None)
    with FixtureHub(repo) as hub:
        zc = _config(tmp_path, hub.url)
        a = pull_model(zc, "t/m", revision=sha_a, **quiet)
        b = pull_model(zc, "t/m", revision=sha_b, base_params=a.params,
                       base_revision=sha_a, **quiet)
    assert "time_to_swap_s" in b.stats
    assert b.stats["hbm"]["swap"]["reused_tensors"] > 0
    assert reference.judge_tree(b.params, ref_b)["bad_bytes"] == 0
    # A swap that returned its state unchanged reads wrong.
    a_again = reference.tensors(files_a["model.safetensors"], "cpu")
    assert reference.judge_tree(a_again, ref_b)["bad_bytes"] > 0


def test_delta_touches_about_the_fraction_in_few_tensors():
    cfg = dict(TINY_LLAMA, num_hidden_layers=8, hidden_size=128,
               intermediate_size=256)
    data, files = _files(cfg)
    blob = files["model.safetensors"]
    b = reference.apply_delta(blob, 0.01, 3)
    diff = np.frombuffer(blob, np.uint8) != np.frombuffer(b, np.uint8)
    assert diff.sum() == max(1, int(data.nbytes * 0.01))
    _, entries = reference.read_safetensors(blob)
    touched = [n for n, (_, _, lo, hi) in entries.items() if diff[lo:hi].any()]
    assert 1 <= len(touched) <= 8


@pytest.mark.parametrize("cfg", [TINY_LLAMA, TINY_GPT2],
                         ids=["bf16-to-fp8", "f32-to-bf16"])
def test_control_and_faults_read_as_wrong(cfg):
    _, files = _files(cfg)
    blob = files["model.safetensors"]
    good = reference.tensors(blob, "cpu")
    assert reference.judge_tree(good, blob)["bad_bytes"] == 0
    assert reference.judge_tree(reference.control_tree(blob, "cpu"),
                                blob)["bad_bytes"] > 0
    names = list(good)
    half = {n: good[n] for n in names[: len(names) // 2]}
    assert reference.judge_tree(half, blob)["missing"] == len(names) - len(
        half)
    altered = dict(good)
    t = altered[names[3]].clone()
    t.view(-1).view(torch.uint8)[7] ^= 1
    altered[names[3]] = t
    assert reference.judge_tree(altered, blob)["bad_bytes"] == 1


def test_reference_forward_matches_the_ports_float32_forward():
    from zest_tpu_torch.models import llama

    cfg = TINY_LLAMA
    _, files = _files(cfg)
    blob = files["model.safetensors"]
    toks = np.random.default_rng(0).integers(0, cfg["vocab_size"], 40)
    ref = reference.llama_logits(blob, cfg, toks, "cpu")
    lc = llama.LlamaConfig.from_hf(cfg)
    ts = {n: t.float() for n, t in reference.tensors(blob, "cpu").items()}
    params = llama.params_from_hf(ts, lc)
    with torch.no_grad():
        port = llama.forward(params, torch.as_tensor(toks)[None], lc)[0]
    assert torch.allclose(ref, port, atol=1e-5, rtol=1e-4)
    # The served gap of the reference's own argmax is 0; of the fp8
    # control's argmax it is not.
    # The reference's own argmax lies 0 below its best; the fp8 control's
    # logits move by more than float32 rounding.
    seq = np.concatenate([toks[:1], ref.argmax(-1).numpy()])
    assert reference.widest_gap(ref, seq, 1) == 0.0
    low = reference.llama_logits(blob, cfg, toks, "cpu", quant="fp8")
    assert float((low - ref).abs().max()) > 1e-3
    assert reference.widest_gap(ref, seq, 1, chosen=low.argmax(-1)) >= 0.0
