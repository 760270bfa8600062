"""One process of a two-process gloo test.

    python tests/_torch_mp_worker.py RANK WORLD PORT DIR [tp]

Joins a gloo process group on 127.0.0.1:PORT. By default (for
tests/test_torch_parallel.py) it announces a made-up DCN endpoint through
``CoordinatorRegistry`` and reads the other's back, then runs one
``PodDistributor`` round over two CPU slots per process (a fetch that
serves only this process's owned units from DIR/blobs.json) and writes
its gathered rows and discovered peers into DIR.

With ``tp`` (for tests/test_torch_tp_decode.py) it joins the group
through ``mesh_from_config`` from ``ZEST_TPU_*`` mesh settings, lands
DIR/ckpt.npz's Llama tensors over that ``{"model": WORLD}`` mesh of one
CPU slot per process, keeps only its own shards, builds the tensor-parallel tree
(the replicated tensors gathered over the group, the row-parallel sums
all-reduced) and writes the prefill logits of DIR/ids.npy and a greedy
decode into DIR.

With ``hier`` (for tests/test_torch_hierarchy.py) it runs one
``HierarchicalDistributor`` round over a ``(pods=2, hosts=2)`` mesh of two
CPU slots per process, each fetching only the units its slots own from
DIR/blobs.json, and writes every local slot's gathered rows into DIR.

With ``ring``, ``pipe`` or ``train`` (for tests/test_torch_multiprocess.py)
it runs ring attention over ``{"seq": 4}`` (two CPU slots a process), the
GPipe pipeline over ``{"pipe": 2}`` (one stage a process) or the sharded
train step over ``{"data": 2, "model": 4}`` (four CPU slots a process, a
data row each) on DIR's inputs, runs the backward, and writes the
outputs and gradients (the train step: the gathered gradients, then two
AdamW steps' losses and gathered params) into DIR.
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


def tp_main(rank: int, world: int, port: int, root: Path) -> None:
    import torch

    from zest_tpu_torch.config import MeshConfig
    from zest_tpu_torch.models import llama, loader
    from zest_tpu_torch.models import tensor_parallel as tp
    from zest_tpu_torch.parallel.mesh import mesh_from_config

    # The process group comes from the mesh settings, as a pull's does.
    mesh = mesh_from_config(MeshConfig.from_env({
        "ZEST_TPU_MESH": f"model={world}",
        "ZEST_TPU_COORDINATOR": f"127.0.0.1:{port}",
        "ZEST_TPU_PROCESS_ID": str(rank),
        "ZEST_TPU_NUM_PROCESSES": str(world)}), ["cpu"])
    try:
        assert dist.get_backend() == "gloo" and dist.get_rank() == rank
        assert mesh.local_slots() == [rank]
        spec = json.loads((root / "cfg.json").read_text())
        cfg = llama.LlamaConfig.tiny(**spec)
        host = {n: torch.from_numpy(a) for n, a in
                np.load(root / "ckpt.npz").items()}
        tree = loader.commit_tensors(host, mesh=mesh,
                                     rules=llama.checkpoint_shard_rules())
        assert all(set(t.shards) == {rank} for t in tree.values())
        params = llama.params_from_hf(tree, cfg)
        ids = torch.from_numpy(np.load(root / "ids.npy"))
        np.save(root / f"logits_{rank}.npy",
                tp.forward(params, ids, cfg).numpy())
        np.save(root / f"greedy_{rank}.npy", llama.generate_cached(
            params, cfg, ids.tolist(), 4).numpy())
    finally:
        dist.destroy_process_group()


def hier_main(rank: int, world: int, port: int, root: Path) -> None:
    from zest_tpu_torch.parallel import (
        HierarchicalDistributor,
        HierarchicalPlan,
        hier_mesh,
    )

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        blobs = {hh: bytes.fromhex(b) for hh, b in json.loads(
            (root / "blobs.json").read_text()).items()}
        recs = [recon.from_json(fh, doc) for fh, doc in json.loads(
            (root / "recs.json").read_text()).items()]
        mesh = hier_mesh(2, 2, ["cpu"] * 2)
        mine = set(mesh.local_slots())

        def fetch(a):
            assert a.owner in mine, "fetched a unit another process owns"
            f = a.fetch_info
            return blobs[a.hash_hex][f.url_range_start:f.url_range_end]

        hd = HierarchicalDistributor(mesh)
        pool = hd.distribute(HierarchicalPlan.build(recs, 2, 2), fetch)
        for j, replica in enumerate(pool.replicas):
            np.save(root / f"hier_{rank}_{j}.npy", replica.numpy())
        (root / f"stats_{rank}.json").write_text(json.dumps(
            sorted(hd.stage_stats())))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _join(rank: int, world: int, port: int) -> None:
    import datetime

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))


def _nested(flat: dict) -> dict:
    """A tree from ``"a/b/c"``-keyed arrays."""
    import torch

    out: dict = {}
    for key, a in flat.items():
        *head, leaf = key.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = torch.from_numpy(np.array(a))
    return out


def _flat(tree) -> dict:
    from zest_tpu_torch.models.training import tree_paths

    return {"/".join(path): (t.full() if hasattr(t, "full") else t)
            .detach().numpy() for path, t in tree_paths(tree)}


def ring_main(rank: int, world: int, port: int, root: Path) -> None:
    import torch

    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.parallel.ring import ring_attention

    _join(rank, world, port)
    try:
        mesh = model_mesh({"seq": 4}, ["cpu"] * 2)
        a = np.load(root / "ring.npz")
        q, k, v = (torch.from_numpy(a[n]).requires_grad_() for n in "qkv")
        out = ring_attention(q, k, v, mesh)
        (out * torch.from_numpy(a["w"])).sum().backward()
        np.savez(root / f"ring_{rank}.npz", out=out.detach().numpy(),
                 dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy())
    finally:
        dist.destroy_process_group()


def pipe_main(rank: int, world: int, port: int, root: Path) -> None:
    import torch

    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.parallel.pipeline import pipeline_blocks

    def block(x, p):
        return torch.tanh(x @ p["w"] + p["b"]), None

    _join(rank, world, port)
    try:
        mesh = model_mesh({"pipe": 2}, ["cpu"])
        a = np.load(root / "pipe.npz")
        stack = {n: torch.from_numpy(a[n]).requires_grad_() for n in "wb"}
        x = torch.from_numpy(a["x"]).requires_grad_()
        out = pipeline_blocks(block, stack, x, mesh, int(a["m"]))
        (out * torch.from_numpy(a["g"])).sum().backward()
        np.savez(root / f"pipe_{rank}.npz", out=out.detach().numpy(),
                 dx=(x.grad if x.grad is not None
                     else torch.zeros_like(x)).numpy(),
                 dw=stack["w"].grad.numpy(), db=stack["b"].grad.numpy())
    finally:
        dist.destroy_process_group()


def train_main(rank: int, world: int, port: int, root: Path) -> None:
    import functools

    import torch

    from zest_tpu_torch.models import gpt2, llama, training
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.parallel.sharding import MeshUnsupported, shard_tree

    _join(rank, world, port)
    try:
        spec = json.loads((root / "cfg.json").read_text())
        mod = {"gpt2": gpt2, "llama": llama}[spec.pop("family")]
        cfg = (mod.GPT2Config if mod is gpt2 else mod.LlamaConfig)(**spec)
        params = _nested(dict(np.load(root / "params.npz")))
        batch = torch.from_numpy(np.load(root / "batch.npy")).long()
        mesh = model_mesh({"data": 2, "model": 4}, ["cpu"] * 4)
        assert mesh.local_slots() == list(range(4 * rank, 4 * rank + 4))
        sharded = shard_tree(params, mod.param_specs(cfg), mesh)
        loss, grads = training.value_and_grad(mod.loss_fn, sharded, batch,
                                              cfg)
        np.savez(root / f"grads_{rank}.npz", **_flat(grads))
        tx = training.adamw(lr=1e-3, warmup_steps=1, total_steps=10)
        step = training.make_train_step(
            tx, functools.partial(mod.loss_fn, cfg=cfg))
        state = training.create_state(sharded, tx)
        losses = [float(loss)]
        for _ in range(2):
            state, step_loss = step(state, batch)
            losses.append(float(step_loss))
        for path, t in training.tree_paths(state.params):
            for group in t.replica_groups():
                for slot in group[1:]:
                    assert torch.equal(t.shards[group[0]], t.shards[slot])
        np.savez(root / f"params_{rank}.npz", **_flat(state.params))
        split = model_mesh({"data": 1, "model": 8}, ["cpu"] * 4)
        try:
            mod.loss_fn(shard_tree(params, mod.param_specs(cfg), split),
                        batch, cfg)
            refused = ""
        except MeshUnsupported as exc:
            refused = str(exc)
        (root / f"train_{rank}.json").write_text(json.dumps(
            {"losses": losses, "refused": refused}))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run = {"tp": tp_main, "hier": hier_main, "ring": ring_main,
           "pipe": pipe_main, "train": train_main}.get(
        (sys.argv[5:] or [""])[0], main)
    run(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
        Path(sys.argv[4]))
