#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` (the self-healing control plane) alone,
on one card.

    python3 scripts/chip_heal_probe.py [--seed N]

Builds what phase 17 needs and nothing else: phase 3's GPT-2 checkpoint
(random weights from ``--seed``) pushed through the BLAKE3 kernel into
node A as revision A, phase 4's pull of A onto the card into node B
(whose xorb cache phase 17 seeds from and lands from), and the CPU
landing's digest; then runs ``heal_phase`` (17a the stalled seeder
hedged, 17b the straggling collective aborted through kernel #3, 17c
the ring tuner and the pool rules, 17d the timeline and remediation
surfaces and the notified push through kernel #1) once with its gates,
printing each sub-phase's line and the kernels' launches by path. For
iterating on phase 17. Exits non-zero without a card.
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
        print("chip_heal_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.transfer.pull import pull_model
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
        digest = params_digest(load_checkpoint(ckpt, "cpu"))
        with PublisherServer(cfg_a) as publisher:
            cfg_b = Config(hf_home=work / "b" / "hf",
                           cache_dir=work / "b" / "zest",
                           endpoint=publisher.url)
            res = pull_model(cfg_b, cs.REPO, revision=pushed.revision,
                             device=dev)
            cs.check_tree("node B", res, digest, dev)
            del res
            shutil.rmtree(work / "b" / "hf")
            print(f"pushed A {pushed.revision[:12]} ({pushed.new_xorbs} "
                  f"xorbs), landed it into node B in "
                  f"{time.monotonic() - wall0:.1f} s", flush=True)
            by_path = cs.heal_phase(work, publisher.url, publisher, cfg_a,
                                    cfg_b, ckpt, pushed, digest, args.seed,
                                    dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"kernel launches by path {by_path}; wall "
          f"{time.monotonic() - wall0:.1f} s")
    print(cs.card_label())
    return 0


if __name__ == "__main__":
    sys.exit(main())
