#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` (peer discovery and the parallel file
rung) alone, on one card.

    python3 scripts/chip_discovery_probe.py [--seed N]

Builds what phase 15 needs and nothing else: phase 3's GPT-2 checkpoint
(random weights from ``--seed``) pushed through the BLAKE3 kernel into
node A, phase 4's pull of it onto ``cuda:0`` into node B (its gates, and
the CPU landing's digest), B's HF directory removed as phase 8 finds it,
then runs ``discovery_phase`` (15a tracker, 15b DHT, 15c gossip, 15d the
files-only pull through the ``ParallelDownloader``) once with its gates,
printing each sub-phase's line and the kernels' launches by path. For
iterating on phase 15. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_discovery_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.transfer.push import push_checkpoint

    dev = torch.device("cuda", 0)
    wall0 = time.monotonic()
    work = Path(tempfile.mkdtemp(prefix=".smoke-", dir=ROOT))
    try:
        cfg_a = Config(hf_home=work / "a" / "hf",
                       cache_dir=work / "a" / "zest")
        ckpt = work / "checkpoint"
        ckpt.mkdir()
        (ckpt / "config.json").write_text(json.dumps(cs.GPT2_CONFIG,
                                                     indent=2))
        write_safetensors(ckpt / "model.safetensors",
                          cs.gpt2_checkpoint(args.seed, cs.GPT2_CONFIG))
        pushed = push_checkpoint(cfg_a, cs.REPO, ckpt, device=dev,
                                 notify=False)
        with PublisherServer(cfg_a) as publisher:
            pulled, cfg_b, digest = cs.pull_phase(
                work, publisher.url, cfg_a, ckpt, pushed, dev)
            del pulled
            shutil.rmtree(work / "b" / "hf")  # phase 8 seeds B's cache
            torch.cuda.empty_cache()
            by_path = cs.discovery_phase(work, publisher.url, cfg_b, ckpt,
                                         pushed, digest, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"kernel launches by path {by_path}; wall "
          f"{time.monotonic() - wall0:.1f} s")
    print(cs.card_label())
    return 0


if __name__ == "__main__":
    sys.exit(main())
