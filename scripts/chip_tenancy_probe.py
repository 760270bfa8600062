#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` (the multi-tenant pull service) alone, on
one card.

    python3 scripts/chip_tenancy_probe.py [--seed N]

Builds what phase 16 needs and nothing else: phase 3's GPT-2 checkpoint
(random weights from ``--seed``) pushed through the BLAKE3 kernel into
node A as revision A, and phase 5b's revision B (the last block's MLP and
the final norm redrawn from ``--seed + 1``) pushed over A, with the CPU
landings' digests of A and B; then runs ``tenancy_phase`` (16a tenants
and the cancel mid-landing, 16b the daemon's queue, 16c revision C's
swap and the eviction under pins) once with its gates, printing each
sub-phase's line and the kernels' launches by path. For iterating on
phase 16. Exits non-zero without a card.
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
        print("chip_tenancy_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.transfer.push import push_checkpoint

    dev = torch.device("cuda", 0)
    wall0 = time.monotonic()
    work = Path(tempfile.mkdtemp(prefix=".smoke-", dir=ROOT))
    try:
        cfg_a = Config(hf_home=work / "a" / "hf",
                       cache_dir=work / "a" / "zest")
        tensors = cs.gpt2_checkpoint(args.seed, cs.GPT2_CONFIG)
        ckpts = {}
        for name, tree in (("checkpoint", tensors),
                           ("checkpoint-b", cs.revision_b(tensors,
                                                          args.seed + 1))):
            ckpt = ckpts[name] = work / name
            ckpt.mkdir()
            (ckpt / "config.json").write_text(json.dumps(cs.GPT2_CONFIG,
                                                         indent=2))
            write_safetensors(ckpt / "model.safetensors", tree)
        pushed = push_checkpoint(cfg_a, cs.REPO, ckpts["checkpoint"],
                                 device=dev, notify=False)
        pushed_b = push_checkpoint(cfg_a, cs.REPO, ckpts["checkpoint-b"],
                                   base_revision=pushed.revision,
                                   device=dev, notify=False)
        del tensors
        digest = params_digest(load_checkpoint(ckpts["checkpoint"], "cpu"))
        swap_ref = {"revision": pushed_b.revision,
                    "digest": params_digest(load_checkpoint(
                        ckpts["checkpoint-b"], "cpu"))}
        print(f"pushed A {pushed.revision[:12]} ({pushed.new_xorbs} "
              f"xorbs), B {pushed_b.revision[:12]} "
              f"({pushed_b.new_xorbs} new xorbs) in "
              f"{time.monotonic() - wall0:.1f} s", flush=True)
        with PublisherServer(cfg_a) as publisher:
            by_path = cs.tenancy_phase(work, publisher.url, cfg_a,
                                       ckpts["checkpoint"], pushed, digest,
                                       swap_ref, args.seed, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"kernel launches by path {by_path}; wall "
          f"{time.monotonic() - wall0:.1f} s")
    print(cs.card_label())
    return 0


if __name__ == "__main__":
    sys.exit(main())
