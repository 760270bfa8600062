#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (``zest bench`` and the scale benches)
and the fuller bench runs that the smoke does not make, on one card.

    python3 scripts/chip_bench_probe.py [--skip NAME,...] [--out FILE]

First phase 19 with its gates (19a ``zest bench --json`` in a child and
``bench_blake3_device`` held to the plain version, 19b the GB pull at full
Llama-8B width, 19c the shaped cooperative bench with its kernel and
``DcnServerStats`` gates, 19d the fleet model); then the suite in-process
and each scale bench at a small size on ``cuda:0``: ``bench_gb_pull``
(2 GB, three timed runs), ``bench_delta_pull``, ``bench_coop_pull``,
``bench_collective_transports``, ``bench_swarm``, ``bench_tenants``,
``bench_serve_pool``, ``bench_mttr`` and ``bench_fleet``. One summary line
a bench is printed; with ``--out FILE`` every bench's artifact goes to
that JSON file with the card's name and power limit. A
bench that raises is recorded and the probe exits non-zero at the end.
``--skip`` names benches (``phase19``, ``suite``, ``gb``, ``delta``,
``coop``, ``collective``, ``swarm``, ``tenants``, ``serve``, ``mttr``,
``fleet``) to leave out. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--skip", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_bench_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    work = Path(tempfile.mkdtemp(prefix=".smoke-", dir=ROOT))
    # Every bench's temporary dirs go under work, as in chip_smoke.py.
    tempfile.tempdir = str(work)
    try:
        return run(args, cs, dev, work)
    finally:
        tempfile.tempdir = None
        shutil.rmtree(work, ignore_errors=True)


def run(args, cs, dev, work: Path) -> int:
    import torch

    from zest_tpu_torch import bench_scale, bench_suite

    skip = {s for s in args.skip.split(",") if s}
    out = {"card": cs.card_label(), "benches": {}, "errors": {}}
    benches = [
        ("phase19", lambda: cs.bench_phase(work, dev)),
        ("suite", lambda: [r.as_dict() for r in
                           bench_suite.run_synthetic(device=True)]),
        ("gb", lambda: bench_scale.bench_gb_pull(runs=3)),
        ("delta", lambda: bench_scale.bench_delta_pull(gb=0.5, runs=2)),
        ("coop", lambda: bench_scale.bench_coop_pull(
            n_hosts=4, dcn_bps=50_000_000, dcn_rtt_s=0.005)),
        ("collective", lambda: bench_scale.bench_collective_transports()),
        ("swarm", lambda: bench_scale.bench_swarm(
            fault_spec="upload_corrupt:0.02,seeder_choke_flap:0.1")),
        ("tenants", lambda: bench_scale.bench_tenants()),
        ("serve", lambda: bench_scale.bench_serve_pool()),
        ("mttr", lambda: bench_scale.bench_mttr()),
        ("fleet", lambda: bench_scale.bench_fleet()),
    ]
    wall0 = time.monotonic()
    for name, fn in benches:
        if name in skip:
            continue
        t0 = time.monotonic()
        try:
            res = fn()
        except Exception as exc:  # noqa: BLE001 - recorded, fails the run
            traceback.print_exc()
            out["errors"][name] = f"{type(exc).__name__}: {exc}"
            print(f"{name}: FAILED after {time.monotonic() - t0:.1f} s: "
                  f"{exc}", flush=True)
            continue
        torch.cuda.empty_cache()
        out["benches"][name] = {"wall_s": round(time.monotonic() - t0, 3),
                                "result": res}
        gates = res.get("gates") if isinstance(res, dict) else None
        print(f"{name}: {time.monotonic() - t0:.1f} s; "
              + (f"gates {json.dumps(gates)}" if gates is not None
                 else json.dumps(res, default=str)[:1500]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=2, default=str)
                                  + "\n")
    print(f"chip_bench_probe ({out['card']}): {len(out['benches'])} benches "
          f"in {time.monotonic() - wall0:.1f} s, errors "
          f"{sorted(out['errors'])}; artifacts in {args.out}")
    return 1 if out["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
