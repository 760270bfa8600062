"""Training-state checkpointing and HF-format export.

The counterpart of ``zest_tpu/models/checkpoint.py``. The JAX package
writes its ``TrainState`` with orbax, which needs jax; the port's format
is its own: a directory holding ``arrays.safetensors`` (every parameter
and both AdamW moments, named by tree path: ``params/blocks/attn/q_w``,
``mu/...``, ``nu/...``) and ``train_state.json`` (the step and the
optimizer count). Both are read back through the port's own safetensors
reader, so nothing is unpickled.

A sharded state (``ShardedTensor`` leaves, ``models/training.py``) saves
each leaf gathered once (``ShardedTensor.full``), so its files equal
those of the same state unsharded; a restore lays every array out again
under its counterpart's mesh and spec in ``state_like``. An export of a
sharded tree equals the export of the gathered tree, byte for byte.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from zest_tpu_torch.models.safetensors_io import (SafetensorsFile,
                                                  write_safetensors)
from zest_tpu_torch.models.training import (AdamWState, TrainState,
                                            tree_map, tree_paths)
from zest_tpu_torch.parallel.sharding import ShardedTensor, shard_tensor

FORMAT = "zest-train-state/1"
ARRAYS = "arrays.safetensors"
SCALARS = "train_state.json"


def _named(state: TrainState) -> list[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of every array of the state, by tree path."""
    out = []
    for root, tree in (("params", state.params), ("mu", state.opt_state.mu),
                       ("nu", state.opt_state.nu)):
        out += [("/".join((root, *path)), t) for path, t in tree_paths(tree)]
    return out


def save_train_state(path: str | Path, state: TrainState) -> None:
    """Write ``state`` into the directory ``path``, which must not exist
    yet (as orbax, this refuses to overwrite: version the step dirs,
    ``ckpt/step_000100``). The files are written beside it and renamed
    into place, so a crash leaves no half checkpoint under ``path``."""
    path = Path(path)
    if path.exists():
        raise FileExistsError(f"{path} already exists: a checkpoint is "
                              "never overwritten")
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    tmp.mkdir(parents=True)
    write_safetensors(tmp / ARRAYS, {
        name: t.full("cpu") if isinstance(t, ShardedTensor) else t
        for name, t in _named(state)})
    (tmp / SCALARS).write_text(json.dumps(
        {"format": FORMAT, "step": int(state.step),
         "count": int(state.opt_state.count)}))
    tmp.rename(path)


def restore_train_state(path: str | Path, state_like: TrainState
                        ) -> TrainState:
    """Read a state written by :func:`save_train_state`. ``state_like``
    (``create_state(params, tx)``) gives the structure; each tensor lands
    in a fresh allocation on its counterpart's device and dtype (a sharded
    counterpart's mesh and spec, every local slot its shard). A missing,
    extra or misshapen array raises."""
    path = Path(path)
    meta = json.loads((path / SCALARS).read_text())
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    like = dict(_named(state_like))
    with SafetensorsFile(path / ARRAYS) as sf:
        names = set(sf.names())
        if names != set(like):
            raise ValueError(f"{path}: arrays differ from the state's: "
                             f"missing {sorted(set(like) - names)}, extra "
                             f"{sorted(names - set(like))}")
        got = {}
        for name, t in like.items():
            src = sf.tensor(name)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{path}: {name} is {tuple(src.shape)}, "
                                 f"the state's {tuple(t.shape)}")
            if isinstance(t, ShardedTensor):
                got[name] = shard_tensor(src.to(t.dtype), t.mesh, t.spec)
            else:
                got[name] = torch.empty_like(t).copy_(src)

    def rebuild(root, tree):
        pairs = iter(tree_paths(tree))
        return tree_map(lambda _: got["/".join((root, *next(pairs)[0]))],
                        tree)

    return TrainState(
        meta["step"], rebuild("params", state_like.params),
        AdamWState(meta["count"], rebuild("mu", state_like.opt_state.mu),
                   rebuild("nu", state_like.opt_state.nu)))


def export_hf_safetensors(path: str | Path, params: dict, cfg) -> None:
    """Trained Llama-family params → one HF-format safetensors file
    (``llama.params_to_hf``: HF names, ``[out, in]`` Linears), byte for
    byte the JAX package's export of the same tree; a GPT-2 tree through
    ``gpt2.params_to_hf`` (the hub's names, which ``gpt2.params_from_hf``
    reads back), which the JAX package does not export. A sharded tree is
    gathered leaf by leaf first."""
    from zest_tpu_torch.models import gpt2, llama

    params = tree_map(
        lambda t: t.full() if isinstance(t, ShardedTensor) else t, params)
    fam = gpt2 if isinstance(cfg, gpt2.GPT2Config) else llama
    write_safetensors(path, fam.params_to_hf(params, cfg))
