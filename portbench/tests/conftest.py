"""Tiny CPU copies of the benchmark's cells: a root with its own
``BENCHMARK.json`` and a copy of ``portbench/`` whose configurations are
cut to a few kilobytes, so that a whole run takes seconds here. The
root's ``BENCHMARK.json`` also holds the cells that ``open_cells.json``
keeps for a later benchmark (the swap and the pool), so that their
runners stay tested."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent

TINY_LLAMA = {
    "model_type": "llama", "architectures": ["LlamaForCausalLM"],
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 256,
    "max_position_embeddings": 1024, "rms_norm_eps": 1e-5,
    "rope_theta": 100000, "tie_word_embeddings": True,
    "torch_dtype": "bfloat16", "eos_token_id": 0}
TINY_GPT2 = {
    "model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
    "n_embd": 64, "n_layer": 2, "n_head": 4, "vocab_size": 256,
    "n_positions": 64, "n_ctx": 64, "layer_norm_epsilon": 1e-5,
    "torch_dtype": "float32"}
TINY_SERVE = {"kind": "serve", "clients": 2, "prompt_min": 8,
              "prompt_max": 32, "lengths": 4, "new_tokens": 8,
              "judge_requests": 3, "trace_seconds": 1,
              "rounds": 8, "write_cap_gib": 3}


def with_open_cells() -> dict:
    """``BENCHMARK.json`` with the entries of ``open_cells.json`` added,
    as a later benchmark that takes those cells would add them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    extra = json.loads((PKG / "open_cells.json").read_text())
    for key, entries in extra.items():
        bench[key] = bench[key] + entries
    return bench


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout-like root whose cells run the tiny configurations."""
    pkg = tmp_path / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    (pkg / "configs" / "smollm2-135m.json").write_text(json.dumps(TINY_LLAMA))
    (pkg / "configs" / "gpt2.json").write_text(json.dumps(TINY_GPT2))
    (pkg / "traffic" / "serve1.json").write_text(json.dumps(TINY_SERVE))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(with_open_cells()))
    return tmp_path


@pytest.fixture
def tiny_spec(tiny_root):
    from portbench.run import Spec

    return Spec(tiny_root, tiny_root / "portbench")


def run_tiny(spec, workload, seed=2**31 + 77, seconds=1.5, trace=False,
             control=False):
    import time

    from portbench.run import run_cell

    return run_cell(spec, workload, seed, seconds, trace, "cpu",
                    control=control, log=lambda *a: None,
                    t_start=time.monotonic())
