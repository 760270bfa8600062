"""One process of tests/test_torch_parallel.py's two-process gloo round.

    python tests/_torch_mp_worker.py RANK WORLD PORT DIR

Joins a gloo process group on 127.0.0.1:PORT, announces a made-up DCN
endpoint through ``CoordinatorRegistry`` and reads the other's back, then
runs one ``PodDistributor`` round over two CPU slots per process (a fetch
that serves only this process's owned units from DIR/blobs.json) and
writes its gathered rows and discovered peers into DIR.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from zest_tpu_torch.cas import reconstruction as recon  # noqa: E402
from zest_tpu_torch.parallel import (  # noqa: E402
    CoordinatorRegistry,
    DistributionPlan,
    PodDistributor,
    num_slots,
    pod_mesh,
)


def main(rank: int, world: int, port: int, root: Path) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        reg = CoordinatorRegistry(f"10.0.0.{rank}")
        ih = b"\x05" * 20
        reg.announce(ih, 7000 + rank)
        reg.barrier("announced")
        (root / f"peers_{rank}.json").write_text(
            json.dumps(reg.find_peers(ih)))

        blobs = {hh: bytes.fromhex(b) for hh, b in json.loads(
            (root / "blobs.json").read_text()).items()}
        recs = [recon.from_json(fh, doc) for fh, doc in json.loads(
            (root / "recs.json").read_text()).items()]
        mesh = pod_mesh(["cpu"] * 2)
        dist_ = PodDistributor(mesh)
        plan = DistributionPlan.build(recs, num_slots(mesh))
        mine = set(dist_.local_slots())

        def fetch(a):
            assert a.owner in mine, "fetched a unit another process owns"
            return blobs[a.hash_hex]

        pool = dist_.distribute(plan, fetch)
        for replica in pool.replicas[1:]:
            assert np.array_equal(replica.numpy(), pool.replicas[0].numpy())
        np.save(root / f"rows_{rank}.npy", pool.replicas[0].numpy())
        reg.barrier("done")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         Path(sys.argv[4]))
