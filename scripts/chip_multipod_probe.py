#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` (the multi-pod pull) alone, on one card.

    python3 scripts/chip_multipod_probe.py [--seed N]

Builds what phase 14 needs and nothing else: phase 3's GPT-2 checkpoint
(random weights from ``--seed``) pushed through the BLAKE3 kernel, its
CPU landing's digest and the CPU float32 run's 32 greedy tokens at batch
1 and 4 (prompts drawn from ``--seed``), then runs ``federated_phase``
(14a), ``hierarchy_phase`` (14b) and ``lossy_phase`` (14c) once with
their gates, printing each phase's line and the kernels' launches by
path. For iterating on phase 14. Exits non-zero without a card.
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
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_multipod_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
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
        pushed = push_checkpoint(cfg_a, cs.REPO, ckpt, device=dev,
                                 notify=False)
        digest = params_digest(load_checkpoint(ckpt, "cpu"))
        prompts = np.random.default_rng(args.seed).integers(
            0, cs.GPT2_CONFIG["vocab_size"], (4, 8)).tolist()
        _, gen_cpu = load_generator(ckpt, device="cpu")
        steps = 32  # chip_smoke.py's default --steps
        ref = {"steps": steps,
               "tokens": [(b, gen_cpu(b, steps, stop_at_eos=False))
                          for b in ([prompts[0]], prompts)]}
        del gen_cpu
        with PublisherServer(cfg_a) as publisher:
            t14 = time.monotonic()
            by_path = {
                "federated": cs.federated_phase(
                    work, publisher.url, cfg_a, ckpt, pushed, digest, ref,
                    dev),
                "hier": cs.hierarchy_phase(work, publisher.url, cfg_a,
                                           pushed, dev),
                "lossy": cs.lossy_phase(work, publisher.url, ckpt, pushed,
                                        dev)}
            print(f"phase 14 wall {time.monotonic() - t14:.2f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"kernel launches by path {by_path}; wall "
          f"{time.monotonic() - wall0:.1f} s")
    print(cs.card_label())
    return 0


if __name__ == "__main__":
    sys.exit(main())
