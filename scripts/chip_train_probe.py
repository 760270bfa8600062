#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` (the training plane) alone, on one card.

    python3 scripts/chip_train_probe.py [--seed N] [--steps N]

Builds what phase 12 needs and nothing else: phase 3's GPT-2 checkpoint
and phase 7's Llama-3.2-1B push and direct pull (random bf16 weights from
``--seed + 7``), then runs ``gpt2_finetune_phase``,
``llama_finetune_phase`` and ``parallel_train_phase`` with their gates.
About 4 minutes on an H100 against ``chip_smoke.py``'s 12; for
iterating on the training plane. Exits non-zero without a card.
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
        write_safetensors(ckpt / "model.safetensors",
                          cs.gpt2_checkpoint(args.seed, cs.GPT2_CONFIG))
        llama_ckpt = work / "llama"
        llama_ckpt.mkdir()
        (llama_ckpt / "config.json").write_text(json.dumps(cs.LLAMA_CONFIG))
        write_safetensors(llama_ckpt / "model.safetensors",
                          cs.llama_checkpoint(args.seed + 7, cs.LLAMA_CONFIG))
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
            cs.gpt2_finetune_phase(ckpt, work, args.seed, dev)
            launches = cs.llama_finetune_phase(
                work, publisher.url, cfg_a, ref, args.seed, args.steps, dev)
            cs.parallel_train_phase(args.seed, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"push_finetune kernel launches {launches}; wall "
          f"{time.monotonic() - wall0:.1f} s")
    print(cs.card_label())
    return 0


if __name__ == "__main__":
    sys.exit(main())
