"""Tensor- and expert-parallel decoding and training over a tree sharded
over a mesh.

The counterpart of the JAX package's jitted forward and step over a
``NamedSharding`` tree, where GSPMD inserts the collectives: here the
collectives are written out. There is one sharded tree: the family's
stacked tree with a ``ShardedTensor`` at every leaf, laid out by its
``param_specs`` (``sharding.shard_tree`` of a plain tree, or the
family's ``params_from_hf`` of a mesh landing). :func:`decode_params`
turns it into a :class:`TPParams` decode tree (:func:`llama_params`,
:func:`gpt2_params`, :func:`moe_params`):

- the leaves ``param_specs`` lays out Megatron-style stay in place on
  their slots: q/k/v (and gate/up, fc) are column-parallel, o (and down,
  GPT-2's projections) row-parallel, so each slot runs attention on its
  local heads and the FFN on its local columns, and the row-parallel
  partial sums are reduced over the group (:meth:`TPGroup.reduce`: a sum
  on one device when the slots share it, ``dist.all_reduce`` across
  processes). GPT-2's fused q|k|v columns give no slot whole heads, so
  they are gathered once and regrouped: slot ``j`` takes its ``j``-th
  block of q, k and v;
- Mixtral's attention is the same tensor-parallel code over the
  ``expert`` axis, and each expert runs on the slot that holds it (slot
  ``s`` holds the contiguous block ``ExpertPlacement`` routes to it); the
  slots' routed outputs are summed where the residual lives;
- the replicated leaves (embeddings, norms, the router, biases) are read
  from the lead slot's replica, where the residual stream lives; a cut
  leaf the decode reads whole (a vocabulary-parallel head) is gathered
  once, and ``TPParams.gather_bytes`` counts those bytes.

A :class:`TPParams` tree decodes through the families' ``generate_cached``
(``sampling.cached_decode_loop`` takes this module's loop from
:func:`decode_fns`, and builds the tree from a sharded one itself), or
directly through :func:`forward` and :func:`decode_window`. The KV cache
is per slot, each holding its local kv heads. Row-parallel sums change
the float32 summation order, so logits agree with the unsharded forward
to a tolerance, not bit for bit.

**Training** (:func:`llama_loss`, :func:`gpt2_loss`, :func:`moe_loss`,
reached through the families' ``loss_fn``) runs over the sharded tree
itself. The batch is cut into rows over the ``data`` axis; each row runs
on its slots along the tensor-parallel axis (``model`` for Llama and
GPT-2, ``expert`` for Mixtral) with each slot's shards in place: q/k/v
and gate/up column-parallel, o and down row-parallel, their partial sums
reduced on the row's lead slot, where the residual stream and the
replicated leaves (embeddings, norms) are read; an untied head is
column-parallel over the vocabulary. Llama's layer body,
:func:`llama_layer`, is also ``llama.cp_forward``'s under TP×CP, where
each seq slot's columns run the K/V ring. Heads that do not divide the
axis run whole on the lead in both, and so does GPT-2's attention (its
fused q|k|v blocks joined there). Every hop is a ``.to`` of an autograd
graph outside inference mode, so the backward gives each shard its own
gradient across the slot devices (``training.value_and_grad`` then sums
the replicas). Where the mesh spans processes each process runs the rows
it holds whole; the loss's value is summed over the processes and the
replicas' gradients all-reduced (``sharding.sum_replicas``). Mixtral
routes the whole batch as one dispatch group on the first row's lead
slot, as the reference's global einsums do, and each row's tokens go to
the slots that own their experts and come back combined (the counterpart
of the all-to-alls GSPMD puts around the dispatch einsums); it needs
every row in one process.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from zest_tpu_torch.parallel.mesh import world_size
from zest_tpu_torch.parallel.ring import ring_self_attention
from zest_tpu_torch.parallel.sharding import (MeshUnsupported, P,
                                              ShardedTensor)


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
    module's for a :class:`TPParams` tree (:func:`decode_params` of a
    sharded training tree)."""
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


def _new(family, group, cfg_local, local, experts=()) -> TPParams:
    out = TPParams()
    out.family = family
    out.group = group
    out.local = local
    out.cfg_local = cfg_local
    out.experts = list(experts)
    return out


def _split_group(b: _Leaves, local: list[dict], group: str, leaves: dict,
                 dims: dict) -> None:
    """Each slot's block of the stacked leaves ``dims`` names (leaf →
    the dim cut over the group's axis) into ``local[j][group]``."""
    for leaf, dim in dims.items():
        if leaf in leaves:
            for j, part in enumerate(b.split(leaves[leaf], dim)):
                local[j].setdefault(group, {})[leaf] = part


def llama_params(tree: dict, cfg, dtype: torch.dtype | None = None
                 ) -> TPParams:
    """The tensor-parallel Llama decode tree (over the ``model`` axis)
    from the training tree laid out by ``llama.param_specs``: every cut
    leaf stays in place on its slot, the replicated ones are read from
    the lead's replica, and a vocabulary-parallel head is gathered."""
    blocks, attn = tree["blocks"], tree["blocks"]["attn"]
    group = TPGroup(attn["q_w"].mesh, "model")
    _check_heads(cfg, group.size, group.axis, cfg.d_ff)
    b = _Leaves(group, dtype or tree["wte"].dtype)
    local = [{} for _ in group.slots]
    _split_group(b, local, "attn", attn, _LLAMA_ATTN)
    _split_group(b, local, "mlp", blocks["mlp"], _LLAMA_MLP)
    cfg_local = dataclasses.replace(
        cfg, n_head=cfg.n_head // group.size,
        n_kv_head=cfg.n_kv_head // group.size,
        d_ff=cfg.d_ff // group.size, head_dim_override=cfg.head_dim)
    out = _new("llama", group, cfg_local, local)
    out["wte"] = b.replicated(tree["wte"])
    out["ln_f"] = {"g": b.replicated(tree["ln_f"]["g"])}
    if "lm_head" in tree:
        out["lm_head"] = b.replicated(tree["lm_head"])
    out["blocks"] = {
        "ln_attn": {"g": b.replicated(blocks["ln_attn"]["g"])},
        "ln_mlp": {"g": b.replicated(blocks["ln_mlp"]["g"])},
        "attn": ({"o_b": b.replicated(attn["o_b"])} if "o_b" in attn
                 else {})}
    out.gather_bytes = b.gather_bytes
    return out


def gpt2_params(tree: dict, cfg, dtype: torch.dtype | None = None
                ) -> TPParams:
    """The tensor-parallel GPT-2 decode tree (over the ``model`` axis)
    from the training tree laid out by ``gpt2.param_specs``. The fused
    q|k|v columns are cut across the q/k/v borders, so they are gathered
    once and regrouped: slot ``j`` takes its ``j``-th block of the q, k
    and v columns (whole heads). The projections and the MLP stay in
    place."""
    blocks, attn = tree["blocks"], tree["blocks"]["attn"]
    group = TPGroup(attn["qkv_w"].mesh, "model")
    n, E = group.size, cfg.n_embd
    if cfg.n_head % n:
        raise MeshUnsupported(
            f"{cfg.n_head} attention heads do not divide over the {n} slots "
            f"of the {group.axis!r} axis: gather the tree "
            "(ShardedTensor.full)")
    b = _Leaves(group, dtype or tree["wte"].dtype)
    qkv_w, qkv_b = b.replicated(attn["qkv_w"]), b.replicated(attn["qkv_b"])
    w = E // n
    local = []
    for s, d in zip(group.slots, group.devices):
        r = group.rank[s]
        cols = torch.cat([torch.arange(k * E + r * w, k * E + (r + 1) * w)
                          for k in range(3)]).to(qkv_w.device)
        local.append({"attn": {"qkv_w": qkv_w[..., cols].to(d),
                               "qkv_b": qkv_b[..., cols].to(d)}})
    _split_group(b, local, "attn", attn, {"proj_w": 1})
    _split_group(b, local, "mlp", blocks["mlp"], _GPT2_MLP)
    cfg_local = _SlotAttention(cfg.n_layer, cfg.n_head // n,
                               cfg.n_head // n, E // cfg.n_head, 0.0)
    out = _new("gpt2", group, cfg_local, local)
    out["wte"] = b.replicated(tree["wte"])
    out["wpe"] = b.replicated(tree["wpe"])
    out["ln_f"] = {k: b.replicated(v) for k, v in tree["ln_f"].items()}
    out["blocks"] = {
        g: {k: b.replicated(blocks[g][k]) for k in keys}
        for g, keys in (("ln_1", ("g", "b")), ("ln_2", ("g", "b")),
                        ("attn", ("proj_b",)), ("mlp", ("proj_b",)))}
    out.gather_bytes = b.gather_bytes
    return out


def decode_params(tree: dict, cfg, dtype: torch.dtype | None = None
                  ) -> TPParams:
    """The :class:`TPParams` decode tree of a family's training tree of
    ``ShardedTensor``s (``params_from_hf`` of a mesh landing, or
    ``sharding.shard_tree`` under the family's ``param_specs``): GPT-2
    and Llama over ``model``, Mixtral expert-parallel over ``expert``."""
    if "wpe" in tree:
        return gpt2_params(tree, cfg, dtype)
    if "moe" in tree["blocks"]:
        return moe_params(tree, cfg, dtype)
    return llama_params(tree, cfg, dtype)


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

    if params.family == "gpt2":
        return _gpt2_window(params, cache, tokens, pos, cfg, last_only)
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


def _gpt2_attention_cached(h, p, c: _SlotAttention, cache_k, cache_v,
                           pos: int):
    """One slot's share of GPT-2's cached attention: its heads' q, k and
    v, the cache window written, and the output through its rows of the
    projection (a partial sum)."""
    B, S, _ = h.shape
    H, D = c.n_head, c.head_dim
    qkv = h @ p["qkv_w"] + p["qkv_b"]
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, -1))
    cache_k[:, pos:pos + S] = k
    cache_v[:, pos:pos + S] = v
    max_len = cache_k.shape[1]
    valid = (torch.arange(max_len, device=h.device)[None, :]
             <= pos + torch.arange(S, device=h.device)[:, None])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, cache_k) / math.sqrt(D)
    scores = scores.masked_fill(~valid[None, None],
                                torch.finfo(scores.dtype).min)
    att = torch.softmax(scores.float(), dim=-1).to(h.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", att, cache_v).reshape(B, S, H * D)
    return out @ p["proj_w"]


def _gpt2_window(params: TPParams, cache: dict, tokens: torch.Tensor,
                 pos: int, cfg, last_only: bool):
    """``gpt2.decode_window`` over a GPT-2 :class:`TPParams` tree: each
    slot runs its heads and MLP columns, the partial sums meet on the
    lead, where the residual stream, the norms and the biases live."""
    from zest_tpu_torch.models import gpt2

    g, blocks, eps = params.group, params["blocks"], cfg.layer_norm_eps
    S = tokens.shape[1]
    x = params["wte"][tokens.to(g.lead)] + params["wpe"][pos:pos + S][None]
    for i in range(cfg.n_layer):
        h = gpt2._layer_norm(x, blocks["ln_1"]["g"][i],
                             blocks["ln_1"]["b"][i], eps)
        x = x + g.reduce([_gpt2_attention_cached(
            h.to(d), _leaves(loc, "attn", i), params.cfg_local, ck[i], cv[i],
            pos) for loc, d, ck, cv in zip(params.local, g.devices,
                                           cache["k"], cache["v"])]
        ) + blocks["attn"]["proj_b"][i]
        h = gpt2._layer_norm(x, blocks["ln_2"]["g"][i],
                             blocks["ln_2"]["b"][i], eps)
        x = x + g.reduce([torch.nn.functional.gelu(
            h.to(d) @ p["fc_w"] + p["fc_b"], approximate="tanh")
            @ p["proj_w"] for p, d in ((_leaves(loc, "mlp", i), d)
                                       for loc, d in zip(params.local,
                                                         g.devices))]
        ) + blocks["mlp"]["proj_b"][i]
    x = gpt2._layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"], eps)
    if last_only:
        x = x[:, -1:, :]
    return x @ params["wte"].T, cache


def _decode_step(params: TPParams, cache: dict, token: torch.Tensor,
                 pos: int, cfg):
    """One incremental step: (B,) ids at ``pos`` → ((B, vocab), cache)."""
    logits, cache = decode_window(params, cache, token[:, None], pos, cfg)
    return logits[:, 0, :], cache


def forward(params: TPParams, input_ids: torch.Tensor, cfg) -> torch.Tensor:
    """(B, T) ids → (B, T, vocab) logits: one window over a fresh cache
    (Llama's prefill equals its forward; Mixtral's dispatches every token
    as its own group, as ``moe.decode_window`` does, where ``moe.forward``
    makes the batch one group). A sharded training tree decodes through
    its :func:`decode_params`."""
    if is_sharded_train_tree(params):
        params = decode_params(params, cfg)
    B, T = input_ids.shape
    cache = params.init_kv_cache(B, T, params["wte"].dtype)
    return decode_window(params, cache, input_ids, 0, cfg)[0]


# ── Training over the nested sharded tree ──


def _first_sharded(tree) -> ShardedTensor | None:
    if isinstance(tree, dict):
        for v in tree.values():
            found = _first_sharded(v)
            if found is not None:
                return found
        return None
    return tree if isinstance(tree, ShardedTensor) else None


def is_sharded_train_tree(tree) -> bool:
    """A nested family tree with ``ShardedTensor`` leaves (a
    :class:`TPParams` decode tree is not one)."""
    return (isinstance(tree, dict) and not isinstance(tree, TPParams)
            and _first_sharded(tree) is not None)


def _train_rows(mesh, axis: str, data_axis: str = "data") -> list[list[int]]:
    """The mesh's slots as rows of ``data_axis``, each row the slots along
    ``axis`` in axis order (one slot when the mesh has no ``axis``). Every
    other axis must have size 1. Where the mesh spans processes each row
    must lie in one process (:func:`_local_rows` picks this process's)."""
    extra = [a for a, n in mesh.shape.items()
             if a not in (axis, data_axis) and n > 1]
    if extra:
        raise MeshUnsupported(
            f"a sharded train step runs over {data_axis!r} and {axis!r}; "
            f"the mesh {mesh.shape} has {extra} too")
    rows: dict[int, list] = {}
    for s in range(mesh.size):
        c = mesh.coords(s)
        rows.setdefault(int(c.get(data_axis, 0)), []).append(
            (int(c.get(axis, 0)), s))
    out = [[s for _, s in sorted(r)] for _, r in sorted(rows.items())]
    for row in out:
        held = {mesh.devices.flat[s] is not None for s in row}
        if len(held) > 1:
            raise MeshUnsupported(
                f"a row of the {axis!r} axis ({row}) is split across "
                "processes: the sharded train step runs each row in one "
                f"process (the mesh {mesh.shape} over {world_size()})")
    return out


def _local_rows(mesh, rows: list[list[int]]) -> list[int]:
    """The indices of the rows this process holds."""
    return [r for r, row in enumerate(rows)
            if mesh.devices.flat[row[0]] is not None]


def _global_loss(local: torch.Tensor, mesh) -> torch.Tensor:
    """A loss over this process's rows, valued as the sum over every
    process's (the others' parts come over the default group, outside
    autograd): its gradient stays this process's share, which
    ``sum_replicas`` then sums over the processes."""
    if world_size() == 1 or len(mesh.local_slots()) == mesh.size:
        return local
    total = local.detach().clone()
    dist.all_reduce(total)
    return local + (total - local.detach())


def _cut(t: ShardedTensor, dim: int, axis: str) -> bool:
    """True when ``t`` is cut on ``dim`` over ``axis`` alone, False when
    every slot holds it whole; another layout raises."""
    spec = list(t.spec) + [None] * (len(t.shape) - len(t.spec))
    if all(a is None for a in spec):
        return False
    if spec[dim] == axis and all(a is None for i, a in enumerate(spec)
                                 if i != dim):
        return True
    raise MeshUnsupported(
        f"a {tuple(t.shape)} leaf under {t.spec!r}: the sharded train step "
        f"takes it whole (P()) or cut on dim {dim} over {axis!r}")


def _whole(t, slot: int) -> torch.Tensor:
    """Slot ``slot``'s replica of a leaf every slot holds whole."""
    if not isinstance(t, ShardedTensor):
        raise MeshUnsupported("a sharded train tree holds a ShardedTensor "
                              "at every leaf")
    if any(a is not None for a in t.spec):
        raise MeshUnsupported(
            f"a {tuple(t.shape)} leaf under {t.spec!r} where the sharded "
            "train step reads it whole: lay it out under P()")
    return t.shard(slot)


def _columns(leaves: dict, dims: dict, row: list[int], axis: str, mesh,
             split: bool = True):
    """``(cols, devices)``: each column's leaves of one parallel group
    (attention, MLP, experts), a column a slot of ``row`` when the group's
    leaves are cut over ``axis`` on ``dims``, else the row's lead slot
    alone with them whole. A cut group that may not run split (``split``
    false: its heads do not divide over the slots) runs on the lead with
    the slots' blocks joined there, so each block still gets its own
    gradient."""
    cut = {_cut(leaves[k], dims[k], axis) for k in dims}
    if len(cut) > 1:
        raise MeshUnsupported(f"the leaves {sorted(dims)} mix whole and cut "
                              f"layouts over {axis!r}")
    lead = mesh.device_of(row[0])
    if not cut.pop():
        return [{k: leaves[k].shard(row[0]) for k in dims}], [lead]
    if not split:
        return [{k: torch.cat([leaves[k].shard(s).to(lead) for s in row],
                              dim=dims[k]) for k in dims}], [lead]
    return ([{k: leaves[k].shard(s) for k in dims} for s in row],
            [mesh.device_of(s) for s in row])


def heads_divide(cfg, n: int) -> bool:
    """Whether attention may run split over ``n`` slots (whole heads and
    kv heads on each); else it runs whole on the lead."""
    return cfg.n_head % n == 0 and cfg.n_kv_head % n == 0


def _sum_on(parts: list[torch.Tensor], dev) -> torch.Tensor:
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def _at(col: dict, i: int) -> dict:
    return {k: v[i] for k, v in col.items()}


def _head_logits(params: dict, x: torch.Tensor, row: list[int], axis: str,
                 mesh, lead) -> torch.Tensor:
    """The unembedding of the row's final hidden states on its lead: an
    untied head column-parallel over the vocabulary (each slot its
    columns, joined on the lead), a tied one ``wte.T``."""
    head = params.get("lm_head")
    if head is None:
        return x @ _whole(params["wte"], row[0]).T
    cols, devs = _columns({"w": head}, {"w": 1}, row, axis, mesh)
    return torch.cat([(x.to(d) @ c["w"]).to(lead)
                      for c, d in zip(cols, devs)], dim=-1)


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.to(logits.device)[..., None]).sum()


def _split_batch(batch: torch.Tensor, rows: list) -> int:
    if batch.shape[0] % len(rows):
        raise ValueError(f"batch of {batch.shape[0]} rows does not divide "
                         f"over the {len(rows)} rows of the data axis")
    return batch.shape[0] // len(rows)


def _local_cfg(cfg, n: int):
    """The config of one column's share of the heads (the head width
    stays the tree's)."""
    if hasattr(cfg, "head_dim_override"):
        return dataclasses.replace(cfg, n_head=cfg.n_head // n,
                                   n_kv_head=cfg.n_kv_head // n,
                                   head_dim_override=cfg.head_dim)
    return _moe_local_cfg(cfg, n)


_LLAMA_ATTN = {"q_w": 2, "k_w": 2, "v_w": 2, "o_w": 1,
               "q_b": 1, "k_b": 1, "v_b": 1}
_LLAMA_MLP = {"gate_w": 2, "up_w": 2, "down_w": 1}


def llama_layer(xs: list, cells: list, cfg, t: int = 0) -> list:
    """One Llama layer over one data row's seq slots: ``xs[s]`` (b, t, E)
    the residual stream of seq slot ``s`` on its lead; ``cells[s]`` its
    leaves for the layer: ``ln_attn``, ``ln_mlp`` and ``o_b`` (or None)
    on the lead, and ``attn`` and ``mlp`` lists of ``(leaves, device)``
    columns along the tensor-parallel axis (one column for a group that
    runs whole on the lead). Each attention column's local heads attend
    causally over the row: in place for one seq slot, else by the K/V
    ring, slot ``s``'s RoPE phases from ``s * t``. The o and down partial
    sums meet on each lead. The body of the sharded train step (one seq
    slot) and of ``llama.cp_forward`` (TP×CP)."""
    from zest_tpu_torch.models import llama

    a_cfg = _local_cfg(cfg, len(cells[0]["attn"]))
    hs = [llama._rms_norm(x, c["ln_attn"], cfg.rms_eps)
          for x, c in zip(xs, cells)]
    parts: list[list] = [[] for _ in xs]
    for m in range(len(cells[0]["attn"])):
        cols = [c["attn"][m] for c in cells]
        qkv = [llama._qkv(h.to(d), p, a_cfg, pos0=s * t)
               for s, (h, (p, d)) in enumerate(zip(hs, cols))]
        outs = ([llama._causal(*qkv[0], a_cfg)] if len(xs) == 1
                else ring_self_attention(*zip(*qkv), causal=True))
        for part, o, (p, _) in zip(parts, outs, cols):
            part.append(o.reshape(*o.shape[:2], -1) @ p["o_w"])
    out = []
    for x, part, c in zip(xs, parts, cells):
        a = _sum_on(part, x.device)
        x = x + (a if c["o_b"] is None else a + c["o_b"])
        h = llama._rms_norm(x, c["ln_mlp"], cfg.rms_eps)
        out.append(x + _sum_on([llama._mlp(h.to(d), p)
                                for p, d in c["mlp"]], x.device))
    return out


def _llama_row(params: dict, ids: torch.Tensor, cfg, row: list[int],
               mesh, remat: bool) -> torch.Tensor:
    """One data row's (b, T, vocab) logits on its lead slot."""
    from zest_tpu_torch.models import llama

    lead_slot = row[0]
    lead = mesh.device_of(lead_slot)
    blocks = params["blocks"]
    attn = blocks["attn"]
    a_cols, a_devs = _columns(attn, {k: d for k, d in _LLAMA_ATTN.items()
                                     if k in attn}, row, "model", mesh,
                              heads_divide(cfg, len(row)))
    m_cols, m_devs = _columns(blocks["mlp"], _LLAMA_MLP, row, "model", mesh)
    o_b = _whole(attn["o_b"], lead_slot) if "o_b" in attn else None
    ln_attn = _whole(blocks["ln_attn"]["g"], lead_slot)
    ln_mlp = _whole(blocks["ln_mlp"]["g"], lead_slot)

    def layer(x, i):
        cell = {"ln_attn": ln_attn[i], "ln_mlp": ln_mlp[i],
                "o_b": None if o_b is None else o_b[i],
                "attn": [(_at(c, i), d) for c, d in zip(a_cols, a_devs)],
                "mlp": [(_at(c, i), d) for c, d in zip(m_cols, m_devs)]}
        return llama_layer([x], [cell], cfg)[0]

    x = _whole(params["wte"], lead_slot)[ids.to(lead)]
    for i in range(cfg.n_layer):
        x = (checkpoint(layer, x, i, use_reentrant=False) if remat
             else layer(x, i))
    x = llama._rms_norm(x, _whole(params["ln_f"]["g"], lead_slot),
                        cfg.rms_eps)
    return _head_logits(params, x, row, "model", mesh, lead)


def _sharded_loss(params: dict, batch: torch.Tensor, cfg, remat: bool,
                  row_logits) -> torch.Tensor:
    """Next-token cross entropy over ``batch`` (B, T+1) ids on a nested
    tree of ``ShardedTensor``s: B cut over the ``data`` axis, each of this
    process's rows run by ``row_logits`` tensor-parallel over ``model``;
    the rows' NLL sums meet on this process's first row's lead slot."""
    mesh = _first_sharded(params).mesh
    rows = _train_rows(mesh, "model")
    b = _split_batch(batch, rows)
    inputs, targets = batch[:, :-1], batch[:, 1:]
    mine = _local_rows(mesh, rows)
    lead = mesh.device_of(rows[mine[0]][0])
    total = 0.0
    for r in mine:
        logits = row_logits(params, inputs[r * b:(r + 1) * b], cfg, rows[r],
                            mesh, remat)
        total = total + _nll_sum(logits, targets[r * b:(r + 1) * b]).to(lead)
    return _global_loss(total / targets.numel(), mesh)


def llama_loss(params: dict, batch: torch.Tensor, cfg,
               remat: bool = False) -> torch.Tensor:
    """Llama's loss on a tree laid out by ``llama.param_specs``."""
    return _sharded_loss(params, batch, cfg, remat, _llama_row)


_GPT2_ATTN = {"qkv_w": 2, "qkv_b": 1, "proj_w": 1}
_GPT2_MLP = {"fc_w": 2, "fc_b": 1, "proj_w": 1}


def _gpt2_row(params: dict, ids: torch.Tensor, cfg, row: list[int], mesh,
              remat: bool) -> torch.Tensor:
    """One data row's (b, T, vocab) GPT-2 logits on its lead slot. The
    fused q|k|v columns give no slot whole heads, so the row's attention
    blocks are joined on the lead and attention runs whole there; the MLP
    runs split (fc column-parallel, its projection row-parallel, the
    partial sums on the lead)."""
    from zest_tpu_torch.models import gpt2

    lead_slot = row[0]
    lead = mesh.device_of(lead_slot)
    blocks = params["blocks"]
    (attn,), _ = _columns(blocks["attn"], _GPT2_ATTN, row, "model", mesh,
                          split=False)
    m_cols, m_devs = _columns(blocks["mlp"], _GPT2_MLP, row, "model", mesh)
    whole = {(g, k): _whole(blocks[g][k], lead_slot)
             for g, k in (("ln_1", "g"), ("ln_1", "b"), ("ln_2", "g"),
                          ("ln_2", "b"), ("attn", "proj_b"),
                          ("mlp", "proj_b"))}

    def layer(x, i):
        p = {"ln_1": {"g": whole["ln_1", "g"][i], "b": whole["ln_1", "b"][i]},
             "attn": {**_at(attn, i), "proj_b": whole["attn", "proj_b"][i]}}
        x = gpt2._attn(x, p, cfg)
        h = gpt2._layer_norm(x, whole["ln_2", "g"][i], whole["ln_2", "b"][i],
                             cfg.layer_norm_eps)
        parts = [torch.nn.functional.gelu(
            h.to(d) @ c["fc_w"][i] + c["fc_b"][i], approximate="tanh")
            @ c["proj_w"][i] for c, d in zip(m_cols, m_devs)]
        return x + _sum_on(parts, lead) + whole["mlp", "proj_b"][i]

    T = ids.shape[1]
    x = (_whole(params["wte"], lead_slot)[ids.to(lead)]
         + _whole(params["wpe"], lead_slot)[:T])
    for i in range(cfg.n_layer):
        x = (checkpoint(layer, x, i, use_reentrant=False) if remat
             else layer(x, i))
    f = params["ln_f"]
    x = gpt2._layer_norm(x, _whole(f["g"], lead_slot),
                         _whole(f["b"], lead_slot), cfg.layer_norm_eps)
    return _head_logits(params, x, row, "model", mesh, lead)


def gpt2_loss(params: dict, batch: torch.Tensor, cfg,
              remat: bool = False) -> torch.Tensor:
    """GPT-2's loss on a tree laid out by ``gpt2.param_specs``."""
    return _sharded_loss(params, batch, cfg, remat, _gpt2_row)


_MOE_ATTN = {"q_w": 2, "k_w": 2, "v_w": 2, "o_w": 1}
_MOE_EXPERTS = {"w1": 1, "w3": 1, "w2": 1}


def moe_loss(params: dict, batch: torch.Tensor, cfg,
             remat: bool = False) -> torch.Tensor:
    """Mixtral's loss (cross entropy + ``aux_loss_weight`` × the aux
    loss) over ``batch`` (B, T+1) ids on a nested tree of
    ``ShardedTensor``s (``moe.param_specs``): B cut over ``data``,
    attention tensor-parallel over ``expert`` within each row, and the
    whole batch routed as one dispatch group on the first row's lead slot
    (capacity and aux loss as the unsharded step counts them); each row's
    tokens run on the row's slots that own their experts. ``remat`` is
    accepted for the family signature; the sharded step saves its
    activations."""
    from zest_tpu_torch.models import llama, moe

    mesh = _first_sharded(params).mesh
    rows = _train_rows(mesh, "expert")
    if len(_local_rows(mesh, rows)) < len(rows):
        raise MeshUnsupported(
            "Mixtral's sharded step routes the whole batch as one dispatch "
            "group: every row of the mesh must be in this process")
    b = _split_batch(batch, rows)
    inputs, targets = batch[:, :-1], batch[:, 1:]
    T = inputs.shape[1]
    leads = [r[0] for r in rows]
    ldevs = [mesh.device_of(s) for s in leads]
    glead = ldevs[0]
    blocks = params["blocks"]
    per_row = []
    for row in rows:
        a_cols, a_devs = _columns(blocks["attn"], _MOE_ATTN, row, "expert",
                                  mesh, heads_divide(cfg, len(row)))
        e_cols, e_devs = _columns(blocks["moe"], _MOE_EXPERTS, row,
                                  "expert", mesh)
        per = cfg.n_experts // len(e_cols)
        if cfg.n_experts % len(e_cols):
            raise MeshUnsupported(f"{cfg.n_experts} experts do not divide "
                                  f"over {len(e_cols)} slots")
        per_row.append((a_cols, a_devs, _local_cfg(cfg, len(a_cols)),
                        e_cols, e_devs,
                        [range(j * per, (j + 1) * per)
                         for j in range(len(e_cols))]))
    router = _whole(blocks["moe"]["router_w"], leads[0])
    xs = [_whole(params["wte"], s)[inputs[r * b:(r + 1) * b].to(d)]
          for r, (s, d) in enumerate(zip(leads, ldevs))]
    aux = torch.zeros((), dtype=torch.float32, device=glead)
    for i in range(cfg.n_layer):
        hs = []
        for r, (s, d) in enumerate(zip(leads, ldevs)):
            a_cols, a_devs, a_cfg = per_row[r][:3]
            h = llama._rms_norm(xs[r], _whole(blocks["ln_attn"]["g"], s)[i],
                                cfg.rms_eps)
            xs[r] = xs[r] + _sum_on([moe._attention(h.to(ad), _at(c, i),
                                                    a_cfg)
                                     for c, ad in zip(a_cols, a_devs)], d)
            hs.append(llama._rms_norm(
                xs[r], _whole(blocks["ln_moe"]["g"], s)[i], cfg.rms_eps))
        E = hs[0].shape[-1]
        flat = torch.cat([h.to(glead).reshape(-1, E) for h in hs])[None]
        combine, layer_aux = moe._combine(flat, router[i], cfg)
        aux = aux + layer_aux[0]
        n = b * T
        for r, d in enumerate(ldevs):
            e_cols, e_devs, ranges = per_row[r][3:]
            comb = combine[:, r * n:(r + 1) * n]
            tokens = hs[r].reshape(1, n, E)
            out = _sum_on([moe._experts(
                comb[:, :, rng.start:rng.stop].to(ed), tokens.to(ed),
                c["w1"][i], c["w3"][i], c["w2"][i])
                for c, ed, rng in zip(e_cols, e_devs, ranges)], d)
            xs[r] = xs[r] + out.reshape(b, T, E)
    total = 0.0
    for r, (row, s, d) in enumerate(zip(rows, leads, ldevs)):
        x = llama._rms_norm(xs[r], _whole(params["ln_f"]["g"], s),
                            cfg.rms_eps)
        logits = _head_logits(params, x, row, "expert", mesh, d)
        total = total + _nll_sum(logits,
                                 targets[r * b:(r + 1) * b]).to(glead)
    return total / targets.numel() + cfg.aux_loss_weight * (
        aux / cfg.n_layer)


def _padded(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def stack_sharded(pieces: list, spec, dtype: torch.dtype,
                  transpose: bool = False, stacked: bool = True
                  ) -> ShardedTensor:
    """A training-tree leaf from landed HF tensors (``ShardedTensor``s of
    one mesh): the pieces, each transposed to the ``x @ W`` layout when
    ``transpose``, stacked on a new leading layer axis when ``stacked``
    (else the one piece), laid out under ``spec`` in ``dtype``. A slot's
    block comes from its own landed shard where the landing cut the piece
    as ``spec`` wants it, else from the piece gathered once
    (``ShardedTensor.full``) onto the slot's device."""
    from zest_tpu_torch.parallel.sharding import shard_index

    mesh = pieces[0].mesh
    hf_shape = tuple(pieces[0].shape)
    leaf = hf_shape[::-1] if transpose else hf_shape
    shape = (len(pieces), *leaf) if stacked else leaf
    per = _padded(spec, len(shape))[1 if stacked else 0:]
    want = P(*(per[::-1] if transpose else per))
    gathered: dict = {}
    shards = {}
    for slot in mesh.local_slots():
        dev = mesh.device_of(slot)
        out = torch.empty([i.stop - i.start for i in shard_index(
            shape, mesh, spec, slot)], dtype=dtype, device=dev)
        for k, t in enumerate(pieces):
            if _padded(t.spec, len(hf_shape)) == tuple(want):
                blk = t.shard(slot)
            else:
                if (k, dev) not in gathered:
                    gathered[(k, dev)] = t.full(dev)
                blk = gathered[(k, dev)][shard_index(hf_shape, mesh, want,
                                                     slot)]
            (out[k] if stacked else out).copy_(blk.T if transpose else blk)
        shards[slot] = out
    return ShardedTensor(shards, shape, dtype, spec, mesh)
