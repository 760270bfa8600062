#!/usr/bin/env python3
"""Phase 20 of ``chip_smoke.py`` (the collective over a pod map through
WAN-shaped servers) alone, on one card.

    python3 scripts/chip_wan_probe.py [--seed N]

Builds what phase 20 needs and nothing else: phase 3's GPT-2 checkpoint
(random weights from ``--seed``) pushed through the BLAKE3 kernel into
node A and the CPU landing's digest; then four cooperative hosts pull it
onto the card over ``coop_topology=WAN_SLICES`` and
``coop_pods=WAN_PODS``, each host's ``DcnServer`` shaped by
``WAN_SHAPING`` (``coop_phase(..., shaping=...)`` with phase 6's gates
and :func:`chip_smoke.link_gates`), printing the phase's lines and the
kernels' launches. For iterating on phase 20. Exits non-zero without a
card.
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
        print("chip_wan_probe: no CUDA device", file=sys.stderr)
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
        cs.build_all(work)
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
        print(f"pushed A {pushed.revision[:12]} ({pushed.new_xorbs} xorbs) "
              f"in {time.monotonic() - wall0:.1f} s", flush=True)
        with PublisherServer(cfg_a) as publisher:
            launches = cs.coop_phase(
                work, publisher.url, ckpt, pushed, cfg_a, digest, dev,
                pushed.revision, label="phase 20", schedule="federated",
                shaping=cs.WAN_SHAPING, coop_topology=cs.WAN_SLICES,
                coop_pods=cs.WAN_PODS)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"kernel launches (coop_wan) {launches}; wall "
          f"{time.monotonic() - wall0:.1f} s")
    print(cs.card_label())
    return 0


if __name__ == "__main__":
    sys.exit(main())
