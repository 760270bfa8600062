"""Tensor- and expert-parallel decoding from a tree sharded over a mesh.

The counterpart of the JAX package's jitted forward over a
``NamedSharding`` tree, where GSPMD inserts the collectives: here the
collectives are written out. A landing over a named slot mesh
(``models/loader.py``) gives ``ShardedTensor``s laid out by the family's
shard rules; :func:`llama_params` and :func:`moe_params_from_hf` (reached
through the families' ``params_from_hf``) and :func:`moe_params` (the
stacked tree of ``direct.land_moe_expert_sharded``) turn it into a
:class:`TPParams` tree:

- tensors the rules lay out Megatron-style stay in place on their slots:
  q/k/v (and gate/up, and each expert's w1/w3) are column-parallel, o
  (and down, and each expert's w2) row-parallel, so each slot runs
  attention on its local heads and the FFN on its local columns, and the
  row-parallel partial sums are reduced over the group
  (:meth:`TPGroup.reduce`: a sum on one device when the slots share it,
  ``dist.all_reduce`` across processes);
- Mixtral's attention is the same tensor-parallel code over the
  ``expert`` axis. In the stacked tree each expert runs on the slot that
  holds it (slot ``s`` holds the contiguous block ``ExpertPlacement``
  routes to it); in a raw landing every slot holds its columns of every
  expert. Either way the slots' routed outputs are summed where the
  residual lives;
- every other tensor (embeddings, norms, the router, the head) is gathered
  once, when the tree is built, onto the group's lead device, where the
  residual stream lives; ``TPParams.gather_bytes`` counts those bytes, and
  a Megatron tensor landed under another spec (a rule that did not fit)
  is gathered and cut too.

A :class:`TPParams` tree decodes through the families' ``generate_cached``
(``sampling.cached_decode_loop`` takes this module's loop from
:func:`decode_fns`), or directly through :func:`forward` and
:func:`decode_window`. The KV cache is per slot, each holding its local kv
heads. Row-parallel sums change the float32 summation order, so logits
agree with the unsharded forward to a tolerance, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from zest_tpu_torch.parallel.mesh import world_size
from zest_tpu_torch.parallel.sharding import MeshUnsupported, ShardedTensor


class TPGroup:
    """The slots one decode runs over: those along ``axis`` that share this
    process's first local slot's index on every other axis (a ``data``
    replica). With several processes the group spans them all and the
    other axes must have size 1."""

    def __init__(self, mesh, axis: str):
        if axis not in mesh.shape:
            raise MeshUnsupported(
                f"the tree's mesh {mesh.shape} has no {axis!r} axis")
        self.mesh = mesh
        self.axis = axis
        self.size = int(mesh.shape[axis])
        first = mesh.coords(mesh.local_slots()[0])
        group = [s for s in range(mesh.size)
                 if all(mesh.coords(s)[a] == first[a]
                        for a in mesh.axis_names if a != axis)]
        self.slots = [s for s in group if mesh.devices.flat[s] is not None]
        self.remote = len(self.slots) < self.size
        if self.remote and any(n > 1 for a, n in mesh.shape.items()
                               if a != axis):
            raise MeshUnsupported(
                f"a decode over several processes needs every axis but "
                f"{axis!r} of size 1, not {mesh.shape}")
        self.rank = {s: int(mesh.coords(s)[axis]) for s in self.slots}
        self.devices = [mesh.device_of(s) for s in self.slots]
        self.lead = self.devices[0]

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The sum of the local slots' partial results on the lead device,
        then over the processes."""
        out = parts[0].to(self.lead)
        for p in parts[1:]:
            out = out + p.to(self.lead)
        if self.remote and world_size() > 1:
            dist.all_reduce(out)
        return out


class TPParams(dict):
    """A tensor-parallel tree. The dict holds the replicated leaves on the
    lead device in the family tree's layout (``wte``, ``ln_f``, optional
    ``lm_head``, ``blocks`` norms, Mixtral's ``router_w``, Llama's
    ``o_b``), so ``params["wte"]`` gives the decode loop its device and
    dtype; ``local[j]`` is group slot ``j``'s leaves (per-layer lists or
    stacked tensors, indexed by layer), ``cfg_local`` the config of one
    slot's share of the heads."""

    family: str
    group: TPGroup
    local: list[dict]
    cfg_local: object
    experts: list[range]
    gather_bytes: int

    def init_kv_cache(self, batch: int, max_len: int,
                      dtype: torch.dtype) -> dict:
        """One (L, B, max_len, local KV, D) cache a slot, on its device."""
        c = self.cfg_local
        shape = (c.n_layer, batch, max_len, c.n_kv_head, c.head_dim)
        return {"k": [torch.zeros(shape, dtype=dtype, device=d)
                      for d in self.group.devices],
                "v": [torch.zeros(shape, dtype=dtype, device=d)
                      for d in self.group.devices]}


def decode_fns(params, init_kv_cache, decode_step, prefill_step):
    """The ``(init_kv_cache, decode_step, prefill_step)`` a decode loop
    over ``params`` takes: the family's own for a single-device tree, this
    module's for a :class:`TPParams` tree."""
    if not isinstance(params, TPParams):
        return init_kv_cache, decode_step, prefill_step
    return (lambda _cfg, batch, max_len, dtype=None, device=None:
            params.init_kv_cache(batch, max_len, dtype)), \
        _decode_step, decode_window


class _Leaves:
    """Takes leaves out of a sharded tree for one :class:`TPGroup`."""

    def __init__(self, group: TPGroup, dtype: torch.dtype):
        self.group = group
        self.dtype = dtype
        self.gather_bytes = 0

    def replicated(self, t) -> torch.Tensor:
        """``t`` whole on the lead device: a replicated shard in place, a
        sharded tensor gathered."""
        if not isinstance(t, ShardedTensor):
            return t.to(self.group.lead).to(self.dtype)
        if all(a is None for a in t.spec):
            return t.shard(self.group.slots[0]).to(self.dtype)
        self.gather_bytes += t.nbytes
        return t.full(self.group.lead).to(self.dtype)

    def split(self, t, dim: int) -> list[torch.Tensor]:
        """Each group slot's block of ``t`` cut on ``dim`` over the group's
        axis: the landed shard itself where the landing laid it out so,
        else the gathered tensor's block."""
        g = self.group
        if isinstance(t, ShardedTensor):
            want = [None] * len(t.shape)
            want[dim] = g.axis
            spec = list(t.spec) + [None] * (len(t.shape) - len(t.spec))
            if spec == want:
                return [t.shard(s).to(self.dtype) for s in g.slots]
            self.gather_bytes += t.nbytes
            t = t.full(g.lead)
        n = t.shape[dim] // g.size
        return [t.narrow(dim, g.rank[s] * n, n).to(d).to(self.dtype)
                for s, d in zip(g.slots, g.devices)]


def _check_heads(cfg, n: int, axis: str, d_ff: int | None) -> None:
    for what, v in (("attention heads", cfg.n_head),
                    ("kv heads", cfg.n_kv_head)) + (
                        (("FFN columns", d_ff),) if d_ff else ()):
        if v % n:
            raise MeshUnsupported(
                f"{v} {what} do not divide over the {n} slots of the "
                f"{axis!r} axis: gather the tree (ShardedTensor.full)")


def _tree_mesh(tensors: dict):
    for t in tensors.values():
        if isinstance(t, ShardedTensor):
            return t.mesh
    raise ValueError("no ShardedTensor in the tree")


def _new(family, group, cfg_local, local, experts=()) -> TPParams:
    out = TPParams()
    out.family = family
    out.group = group
    out.local = local
    out.cfg_local = cfg_local
    out.experts = list(experts)
    return out


def _split_leaves(b: _Leaves, take, local: list[dict], group: str,
                  leaves, n_layer: int, transpose: bool = True) -> None:
    """Each slot's per-layer blocks of HF tensors ``(leaf, name, dim)``
    into ``local[j][group][leaf]``, transposed to the ``x @ W`` layout."""
    for leaf, name, dim in leaves:
        per = [[] for _ in local]
        for layer in range(n_layer):
            for j, part in enumerate(b.split(take(layer, name), dim)):
                per[j].append(part.T if transpose else part)
        for j, parts in enumerate(per):
            local[j].setdefault(group, {})[leaf] = parts


def _attn_local(take, b: _Leaves, n_layer: int, biases: bool) -> list[dict]:
    """Each slot's attention leaves: q/k/v column-parallel (HF dim 0), o
    row-parallel (HF dim 1)."""
    local = [{} for _ in b.group.slots]
    _split_leaves(b, take, local, "attn", [
        (f"{p}_w", f"self_attn.{p}_proj.weight", 0 if p != "o" else 1)
        for p in "qkvo"], n_layer)
    if biases:
        _split_leaves(b, take, local, "attn", [
            (f"{p}_b", f"self_attn.{p}_proj.bias", 0) for p in "qkv"],
            n_layer, transpose=False)
    return local


def _taker(tensors: dict):
    def take(layer, leaf):
        name = f"model.layers.{layer}.{leaf}" if layer is not None else leaf
        t = tensors.get(name)
        if t is None:
            raise ValueError(f"checkpoint missing {name}")
        return t
    return take


def llama_params(tensors: dict, cfg, dtype: torch.dtype) -> TPParams:
    """The tensor-parallel Llama tree (over the ``model`` axis) from a
    flat HF-named tree of ``ShardedTensor``s."""
    group = TPGroup(_tree_mesh(tensors), "model")
    _check_heads(cfg, group.size, group.axis, cfg.d_ff)
    b = _Leaves(group, dtype)
    take = _taker(tensors)
    L = cfg.n_layer
    local = _attn_local(take, b, L, cfg.attn_bias)
    _split_leaves(b, take, local, "mlp", [
        ("gate_w", "mlp.gate_proj.weight", 0),
        ("up_w", "mlp.up_proj.weight", 0),
        ("down_w", "mlp.down_proj.weight", 1)], L)
    blocks = {"ln_attn": {"g": [b.replicated(take(i, "input_layernorm.weight"))
                                for i in range(L)]},
              "ln_mlp": {"g": [b.replicated(take(
                  i, "post_attention_layernorm.weight")) for i in range(L)]},
              "attn": {}}
    if cfg.o_bias:
        blocks["attn"]["o_b"] = [b.replicated(take(
            i, "self_attn.o_proj.bias")) for i in range(L)]
    cfg_local = dataclasses.replace(
        cfg, n_head=cfg.n_head // group.size,
        n_kv_head=cfg.n_kv_head // group.size,
        d_ff=cfg.d_ff // group.size, head_dim_override=cfg.head_dim)
    out = _new("llama", group, cfg_local, local)
    out["wte"] = b.replicated(take(None, "model.embed_tokens.weight"))
    out["ln_f"] = {"g": b.replicated(take(None, "model.norm.weight"))}
    if not cfg.tie_embeddings:
        out["lm_head"] = b.replicated(take(None, "lm_head.weight")).T
    out["blocks"] = blocks
    out.gather_bytes = b.gather_bytes
    return out


@dataclasses.dataclass(frozen=True)
class _SlotAttention:
    """What Mixtral's cached attention reads of its config, for one
    slot's share of the heads (the head width stays the full tree's)."""

    n_layer: int
    n_head: int
    n_kv_head: int
    head_dim: int
    rope_theta: float


def _moe_local_cfg(cfg, n: int) -> _SlotAttention:
    return _SlotAttention(cfg.n_layer, cfg.n_head // n, cfg.n_kv_head // n,
                          cfg.head_dim, cfg.rope_theta)


def _expert_blocks(cfg, group: TPGroup) -> list[range]:
    """The experts of each group slot: the contiguous blocks
    ``ExpertPlacement`` routes bytes to (``e * n // n_experts``)."""
    if cfg.n_experts % group.size:
        raise MeshUnsupported(
            f"{cfg.n_experts} experts do not divide over the "
            f"{group.size} slots of the {group.axis!r} axis")
    per = cfg.n_experts // group.size
    return [range(group.rank[s] * per, (group.rank[s] + 1) * per)
            for s in group.slots]


def moe_params_from_hf(tensors: dict, cfg, dtype: torch.dtype) -> TPParams:
    """The Mixtral tree over the ``expert`` axis from a flat HF-named tree
    of ``ShardedTensor``s (``checkpoint_shard_rules``): attention stays in
    place, and so does every expert's FFN, tensor-parallel as the rules
    land it (w1/w3 on HF dim 0, w2 on dim 1), so every slot runs its
    columns of every chosen expert. Nothing of an expert is gathered."""
    group = TPGroup(_tree_mesh(tensors), "expert")
    _check_heads(cfg, group.size, group.axis, cfg.d_ff)
    b = _Leaves(group, dtype)
    take = _taker(tensors)
    L = cfg.n_layer
    local = _attn_local(take, b, L, False)
    for j in range(len(local)):
        local[j]["moe"] = {"w1": [], "w3": [], "w2": []}
    for layer in range(L):
        for leaf, dim in (("w1", 0), ("w3", 0), ("w2", 1)):
            # (X, ...) of each slot's blocks, in the ``x @ W`` layout.
            per = zip(*(b.split(take(
                layer, f"block_sparse_moe.experts.{x}.{leaf}.weight"), dim)
                for x in range(cfg.n_experts)))
            for j, parts in enumerate(per):
                local[j]["moe"][leaf].append(
                    torch.stack([p.T for p in parts]))
    out = _new("mixtral", group, _moe_local_cfg(cfg, group.size), local,
               [range(cfg.n_experts)] * len(local))
    out["wte"] = b.replicated(take(None, "model.embed_tokens.weight"))
    out["ln_f"] = {"g": b.replicated(take(None, "model.norm.weight"))}
    out["lm_head"] = b.replicated(take(None, "lm_head.weight")).T
    out["blocks"] = {
        "ln_attn": {"g": [b.replicated(take(i, "input_layernorm.weight"))
                          for i in range(L)]},
        "ln_moe": {"g": [b.replicated(take(
            i, "post_attention_layernorm.weight")) for i in range(L)]},
        "moe": {"router_w": [b.replicated(take(
            i, "block_sparse_moe.gate.weight")).T for i in range(L)]},
    }
    out.gather_bytes = b.gather_bytes
    return out


def moe_params(tree: dict, cfg, dtype: torch.dtype | None = None
               ) -> TPParams:
    """The expert-parallel Mixtral tree from the stacked tree
    ``direct.land_moe_expert_sharded`` lands (``moe.param_specs``): every
    slot's experts and attention heads in place, the rest gathered."""
    attn, moe_b = tree["blocks"]["attn"], tree["blocks"]["moe"]
    group = TPGroup(attn["q_w"].mesh, "expert")
    _check_heads(cfg, group.size, group.axis, None)
    experts = _expert_blocks(cfg, group)
    b = _Leaves(group, dtype or tree["wte"].dtype)
    local = [{"attn": {}, "moe": {}} for _ in group.slots]
    for leaf, dim in (("q_w", 2), ("k_w", 2), ("v_w", 2), ("o_w", 1)):
        for j, part in enumerate(b.split(attn[leaf], dim)):
            local[j]["attn"][leaf] = part
    for leaf in ("w1", "w3", "w2"):
        for j, part in enumerate(b.split(moe_b[leaf], 1)):
            local[j]["moe"][leaf] = part
    out = _new("mixtral", group, _moe_local_cfg(cfg, group.size), local,
               experts)
    out["wte"] = b.replicated(tree["wte"])
    out["ln_f"] = {"g": b.replicated(tree["ln_f"]["g"])}
    out["lm_head"] = b.replicated(tree["lm_head"])
    out["blocks"] = {
        "ln_attn": {"g": b.replicated(tree["blocks"]["ln_attn"]["g"])},
        "ln_moe": {"g": b.replicated(tree["blocks"]["ln_moe"]["g"])},
        "moe": {"router_w": b.replicated(moe_b["router_w"])},
    }
    out.gather_bytes = b.gather_bytes
    return out


def _leaves(local: dict, grp: str, i: int) -> dict:
    return {k: v[i] for k, v in local[grp].items()}


def _moe_ep(params: TPParams, h, i: int, cfg) -> torch.Tensor:
    """Layer ``i``'s routed experts over (B, S, E), every token its own
    dispatch group: routing on the lead device, each slot's experts (or
    its columns of every expert) on their slot, the partial outputs
    summed on the lead."""
    from zest_tpu_torch.models import moe

    B, S, E = h.shape
    flat = h.reshape(B * S, 1, E)
    combine, _ = moe._combine(flat, params["blocks"]["moe"]["router_w"][i],
                              cfg)
    parts = []
    for local, rng, dev in zip(params.local, params.experts,
                               params.group.devices):
        w = _leaves(local, "moe", i)
        parts.append(moe._experts(combine[:, :, rng.start:rng.stop].to(dev),
                                  flat.to(dev), w["w1"], w["w3"], w["w2"]))
    return params.group.reduce(parts).reshape(B, S, E)


@torch.inference_mode()
def decode_window(params: TPParams, cache: dict, tokens: torch.Tensor,
                  pos: int, cfg, last_only: bool = False):
    """The families' ``decode_window`` over a :class:`TPParams` tree and a
    per-slot cache (:meth:`TPParams.init_kv_cache`)."""
    from zest_tpu_torch.models import llama, moe

    g = params.group
    blocks = params["blocks"]
    mixtral = params.family == "mixtral"
    attn = moe._attention_cached if mixtral else llama._attention_cached
    ln2 = blocks["ln_moe" if mixtral else "ln_mlp"]["g"]
    x = params["wte"][tokens.to(g.lead)]
    for i in range(cfg.n_layer):
        h = llama._rms_norm(x, blocks["ln_attn"]["g"][i], cfg.rms_eps)
        a = g.reduce([attn(h.to(d), _leaves(loc, "attn", i),
                           params.cfg_local, ck[i], cv[i], pos)
                      for loc, d, ck, cv in zip(params.local, g.devices,
                                                cache["k"], cache["v"])])
        if "o_b" in blocks.get("attn", {}):
            a = a + blocks["attn"]["o_b"][i]
        x = x + a
        h = llama._rms_norm(x, ln2[i], cfg.rms_eps)
        if mixtral:
            x = x + _moe_ep(params, h, i, cfg)
        else:
            x = x + g.reduce([llama._mlp(h.to(d), _leaves(loc, "mlp", i))
                              for loc, d in zip(params.local, g.devices)])
    x = llama._rms_norm(x, params["ln_f"]["g"], cfg.rms_eps)
    if last_only:
        x = x[:, -1:, :]
    head = params.get("lm_head")
    return x @ (head if head is not None else params["wte"].T), cache


def _decode_step(params: TPParams, cache: dict, token: torch.Tensor,
                 pos: int, cfg):
    """One incremental step: (B,) ids at ``pos`` → ((B, vocab), cache)."""
    logits, cache = decode_window(params, cache, token[:, None], pos, cfg)
    return logits[:, 0, :], cache


def forward(params: TPParams, input_ids: torch.Tensor, cfg) -> torch.Tensor:
    """(B, T) ids → (B, T, vocab) logits: one window over a fresh cache
    (Llama's prefill equals its forward; Mixtral's dispatches every token
    as its own group, as ``moe.decode_window`` does, where ``moe.forward``
    makes the batch one group)."""
    B, T = input_ids.shape
    cache = params.init_kv_cache(B, T, params["wte"].dtype)
    return decode_window(params, cache, input_ids, 0, cfg)[0]
