#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` (GPT-2's sharded step) alone, on one
card, with phase 13c (TP×CP on the ``ShardedTensor`` tree).

    python3 scripts/chip_sharded_probe.py [--seed N] [--steps N]

Builds what the phase needs and nothing else: phase 3's GPT-2 checkpoint
pushed to a loopback publisher, phase 12a's unsharded AdamW run (its
reference) and four 8-token prompts from ``--seed``; then runs
``sharded_gpt2_phase`` and ``tp_cp_phase`` with their gates, and prints
the kernels' launches in the phase's mesh pull. About 50 s of command
time on an H100; for iterating on these phases without the whole
command. Exits non-zero without a card.
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
        print("chip_sharded_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.safetensors_io import write_safetensors
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
        sha_a = push_checkpoint(cfg_a, cs.REPO, ckpt, device=dev,
                                notify=False).revision
        prompts = np.random.default_rng(args.seed).integers(
            0, cs.GPT2_CONFIG["vocab_size"], (4, 8)).tolist()
        with PublisherServer(cfg_a) as publisher:
            ref = cs.gpt2_finetune_phase(ckpt, work, args.seed, dev)
            launches = cs.sharded_gpt2_phase(work, publisher.url, sha_a, ref,
                                             prompts, args.steps, dev)
            del ref
            cs.tp_cp_phase(args.seed, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"mesh_train kernel launches {launches}; wall "
          f"{time.monotonic() - wall0:.1f} s")
    print(cs.card_label())
    return 0


if __name__ == "__main__":
    sys.exit(main())
