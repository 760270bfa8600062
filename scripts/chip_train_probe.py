#!/usr/bin/env python3
"""Phases 12 and 13 of ``chip_smoke.py`` (the training plane and the
sharded tree's life cycle) alone, on one card.

    python3 scripts/chip_train_probe.py [--seed N] [--steps N]

Builds what those phases need and nothing else: phase 3's GPT-2
checkpoint and phase 5b's revision B pushed, B delta-pulled over A on one
device (what 13a holds its sharded swap to), and phase 7's Llama-3.2-1B
push and direct pull (random bf16 weights from ``--seed + 7``), then runs
``gpt2_finetune_phase``, ``llama_finetune_phase`` and
``parallel_train_phase``, then ``mesh_swap_phase``,
``sharded_train_phase``, ``tp_cp_phase`` and ``expert_train_phase``,
with their gates. About 6 minutes on an H100 against ``chip_smoke.py``'s
12; for iterating on these phases. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=32)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_train_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    wall0 = time.monotonic()
    work = Path(tempfile.mkdtemp(prefix=".smoke-", dir=ROOT))
    try:
        cfg_a = Config(hf_home=work / "a" / "hf",
                       cache_dir=work / "a" / "zest")
        ckpt = work / "checkpoint"
        ckpt.mkdir()
        (ckpt / "config.json").write_text(json.dumps(cs.GPT2_CONFIG))
        tensors = cs.gpt2_checkpoint(args.seed, cs.GPT2_CONFIG)
        write_safetensors(ckpt / "model.safetensors", tensors)
        ckpt_b = work / "checkpoint-b"
        ckpt_b.mkdir()
        (ckpt_b / "config.json").write_text(json.dumps(cs.GPT2_CONFIG))
        write_safetensors(ckpt_b / "model.safetensors",
                          cs.revision_b(tensors, args.seed + 1))
        del tensors
        sha_a = push_checkpoint(cfg_a, cs.REPO, ckpt, device=dev,
                                notify=False).revision
        sha_b = push_checkpoint(cfg_a, cs.REPO, ckpt_b, base_revision=sha_a,
                                device=dev, notify=False).revision
        llama_ckpt = work / "llama"
        llama_ckpt.mkdir()
        (llama_ckpt / "config.json").write_text(json.dumps(cs.LLAMA_CONFIG))
        write_safetensors(llama_ckpt / "model.safetensors",
                          cs.llama_checkpoint(args.seed + 7, cs.LLAMA_CONFIG,
                                              dev))
        pushed = push_checkpoint(cfg_a, cs.LLAMA_REPO, llama_ckpt,
                                 device=dev, notify=False)
        with PublisherServer(cfg_a) as publisher:
            cfg_l = Config(hf_home=work / "l" / "hf",
                           cache_dir=work / "l" / "zest",
                           endpoint=publisher.url)
            res = pull_model(cfg_l, cs.LLAMA_REPO, device=dev)
            ref = {"snapshot": res.snapshot_dir,
                   "revision": pushed.revision,
                   "prompts": np.random.default_rng(args.seed + 8).integers(
                       0, cs.LLAMA_CONFIG["vocab_size"], (4, 8)).tolist()}
            res = None
            torch.cuda.empty_cache()
            # Phase 5b's swap on one device: what 13a is held to.
            cfg_b = Config(hf_home=work / "b" / "hf",
                           cache_dir=work / "b" / "zest",
                           endpoint=publisher.url)
            base = pull_model(cfg_b, cs.REPO, revision=sha_a,
                              device=dev).params
            res = pull_model(cfg_b, cs.REPO, revision=sha_b, device=dev,
                             base_params=base, base_revision=sha_a)
            _, gen = load_generator(res.snapshot_dir, device=dev,
                                    tensors=res.params)
            prompts = np.random.default_rng(args.seed).integers(
                0, cs.GPT2_CONFIG["vocab_size"], (4, 8)).tolist()
            swap_ref = {
                "revision": sha_b, "prompts": prompts,
                "steps": args.steps,
                "digest": params_digest(load_checkpoint(ckpt_b, "cpu")),
                "time_to_swap_s": res.stats["time_to_swap_s"],
                "tokens": {len(b): gen(b, args.steps, stop_at_eos=False)
                           for b in ([prompts[0]], prompts)}}
            del gen, res, base
            shutil.rmtree(work / "b")
            torch.cuda.empty_cache()
            cs.gpt2_finetune_phase(ckpt, work, args.seed, dev)
            ft_ref = cs.llama_finetune_phase(
                work, publisher.url, cfg_a, ref, args.seed, args.steps, dev)
            launches = ft_ref["launches"]
            cs.parallel_train_phase(args.seed, dev)
            torch.cuda.empty_cache()
            cs.mesh_swap_phase(work, publisher.url, sha_a, swap_ref, dev)
            cs.sharded_train_phase(work, publisher.url, ref, ft_ref, dev)
            cs.tp_cp_phase(args.seed, dev)
            cs.expert_train_phase(args.seed, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"push_finetune kernel launches {launches}; wall "
          f"{time.monotonic() - wall0:.1f} s")
    print(cs.card_label())
    return 0


if __name__ == "__main__":
    sys.exit(main())
