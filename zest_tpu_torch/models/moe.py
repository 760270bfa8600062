"""Sparse mixture of experts (Mixtral) in plain PyTorch: the serving half.

The counterpart of ``zest_tpu/models/moe.py``'s config, HF mapping,
forward and cached decode, kept in its layout so the tests compare like
with like: RMSNorm, rotary embeddings (rotate-half, float32 frequencies
``theta ** (-i / half)``), grouped-query attention, and a top-k routed
SwiGLU expert FFN. Params are a dict tree; every MoE leaf is stacked
``[layer, expert, ...]`` and every HF ``[out, in]`` Linear is transposed
to the ``x @ W`` layout.

Token → expert dispatch is the GShard formulation the JAX package uses:
a dense one-hot dispatch tensor of shape ``[tokens, experts, capacity]``
and einsums around the expert FFN, with capacity ``C`` per expert
(:func:`_capacity`). A token routed past an expert's capacity drops to
the residual path, as the JAX package's does. :func:`forward` dispatches
the whole batch as one group; :func:`decode_window` dispatches every
token as its own group, so no token ever drops while decoding.

The KV cache is updated in place. :func:`checkpoint_shard_rules` and
:func:`param_specs` are the JAX package's; a tree sharded over the
``expert`` axis decodes through :func:`generate_cached` with each slot's
experts and attention heads (``models/tensor_parallel.py``, whose
``forward`` and ``decode_window`` take the tree directly).

The training half (:func:`init_params`, :func:`loss_fn` with its
``aux_loss_weight`` × aux term, :func:`train_step`, ``remat``) runs the
same body as :func:`forward` through ``_forward``, outside inference
mode; ``forward`` and the decode keep it. A tree of ``ShardedTensor``s
laid out by :func:`param_specs` trains expert-parallel over a
``{data, expert}`` mesh through :func:`loss_fn` and :func:`train_step`.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from zest_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from zest_tpu_torch.models import tensor_parallel as tp
# The JAX package's trees (as numpy arrays) carry over as GPT-2's do.
from zest_tpu_torch.models.gpt2 import normal, params_from_jax  # noqa: F401
from zest_tpu_torch.models.llama import _rms_norm  # noqa: F401 - same math
from zest_tpu_torch.models.training import (cross_entropy, sgd,
                                            value_and_grad)
from zest_tpu_torch.parallel.sharding import (MeshUnsupported, P,
                                              is_sharded_tree, shard_tensor)

DATA_AXIS = "data"
EXPERT_AXIS = "expert"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    # Defaults are Mixtral-8x7B's config.json.
    vocab_size: int = 32000
    n_ctx: int = 4096
    n_embd: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 8
    d_ff: int = 14336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    rms_eps: float = 1e-5
    rope_theta: float = 1e6
    aux_loss_weight: float = 1e-2

    @staticmethod
    def tiny(**over) -> "MoEConfig":
        """Test-sized config."""
        base = dict(vocab_size=256, n_ctx=64, n_embd=64, n_layer=2,
                    n_head=4, n_kv_head=2, d_ff=128, n_experts=8, top_k=2)
        base.update(over)
        return MoEConfig(**base)

    @staticmethod
    def mixtral_8x7b() -> "MoEConfig":
        return MoEConfig()  # defaults

    @staticmethod
    def from_hf(cfg_json: dict) -> "MoEConfig":
        return MoEConfig(
            vocab_size=cfg_json["vocab_size"],
            n_ctx=cfg_json.get("max_position_embeddings", 4096),
            n_embd=cfg_json["hidden_size"],
            n_layer=cfg_json["num_hidden_layers"],
            n_head=cfg_json["num_attention_heads"],
            n_kv_head=cfg_json.get("num_key_value_heads",
                                   cfg_json["num_attention_heads"]),
            d_ff=cfg_json["intermediate_size"],
            n_experts=cfg_json.get("num_local_experts", 8),
            top_k=cfg_json.get("num_experts_per_tok", 2),
            rms_eps=cfg_json.get("rms_norm_eps", 1e-5),
            rope_theta=cfg_json.get("rope_theta", 1e6),
        )

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


# ── Parameters ──


def init_params(gen: torch.Generator, cfg: MoEConfig,
                dtype: torch.dtype = torch.float32,
                device=DEFAULT_DEVICE) -> dict:
    """Random-init tree; MoE leaves are stacked [layer, expert, ...]:
    weights N(0, 0.02), the output projections N(0, 0.02/sqrt(2L)), norm
    gains 1; drawn from ``gen`` (``gpt2.normal``) onto ``device``
    (``cuda`` by default, which raises without a card)."""
    device = resolve_device(device)
    E, L, X, F_ = cfg.n_embd, cfg.n_layer, cfg.n_experts, cfg.d_ff
    kvE = cfg.n_kv_head * cfg.head_dim
    out_scale = 0.02 / math.sqrt(2 * L)

    def dense(shape, scale=0.02):
        return normal(gen, shape, scale, dtype, device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "wte": dense((cfg.vocab_size, E)),
        "ln_f": {"g": ones((E,))},
        "lm_head": dense((E, cfg.vocab_size)),
        "blocks": {
            "ln_attn": {"g": ones((L, E))},
            "ln_moe": {"g": ones((L, E))},
            "attn": {
                "q_w": dense((L, E, E)),
                "k_w": dense((L, E, kvE)),
                "v_w": dense((L, E, kvE)),
                "o_w": dense((L, E, E), out_scale),
            },
            "moe": {
                "router_w": dense((L, E, X)),
                # SwiGLU expert FFN: w1 gate, w3 up, w2 down (HF names)
                "w1": dense((L, X, E, F_)),
                "w3": dense((L, X, E, F_)),
                "w2": dense((L, X, F_, E), out_scale),
            },
        },
    }


# ── HF checkpoint mapping (Mixtral tensor names) ──

_HF_ATTN = {
    "self_attn.q_proj": ("attn", "q_w"),
    "self_attn.k_proj": ("attn", "k_w"),
    "self_attn.v_proj": ("attn", "v_w"),
    "self_attn.o_proj": ("attn", "o_w"),
}
_HF_NORM = {
    "input_layernorm": ("ln_attn", "g"),
    "post_attention_layernorm": ("ln_moe", "g"),
}
_EXPERT_RE = re.compile(r"\bexperts\.(\d+)\b")


def expert_of_tensor(name: str) -> int | None:
    """Expert index owning a checkpoint tensor (the HF Mixtral layout,
    ``…block_sparse_moe.experts.N.w1…``), or None for a dense one."""
    m = _EXPERT_RE.search(name)
    return int(m.group(1)) if m else None


def _stacked(items: list, dtype: torch.dtype) -> torch.Tensor:
    """Tensors (or lists of tensors, one level deep) stacked along new
    leading axes in ``dtype``: one allocation, each piece cast and copied
    into its slot."""
    inner = items[0]
    shape = ((len(items), len(inner), *inner[0].shape)
             if isinstance(inner, list) else (len(items), *inner.shape))
    device = inner[0].device if isinstance(inner, list) else inner.device
    out = torch.empty(shape, dtype=dtype, device=device)
    for i, item in enumerate(items):
        if isinstance(item, list):
            for j, t in enumerate(item):
                out[i, j].copy_(t)
        else:
            out[i].copy_(item)
    return out


def params_from_hf(tensors: dict[str, torch.Tensor], cfg: MoEConfig,
                   dtype: torch.dtype = torch.float32) -> dict:
    """Map a Mixtral-family HF checkpoint (flat name→tensor) onto the
    stacked tree, on the tensors' device. Every Linear is transposed to
    ``x @ W``; per-(layer, expert) tensors stack into ``[L, X, ...]``
    leaves. A missing tensor raises with its name. A tree of
    ``ShardedTensor``s (a landing over a mesh) gives the tree of
    ``ShardedTensor``s under :func:`param_specs` on the landing's mesh:
    attention and the head from each slot's own shard where the landing
    cut them so, each expert gathered once onto the slot that holds it
    whole. It trains (:func:`loss_fn`) and decodes expert-parallel
    (``tensor_parallel.decode_params``)."""
    if is_sharded_tree(tensors):
        return _sharded_tree(tensors, cfg, dtype)

    def take(name):
        t = tensors.get(name)
        if t is None:
            raise ValueError(f"checkpoint missing {name}")
        return t

    out = {
        "wte": take("model.embed_tokens.weight").to(dtype),
        "ln_f": {"g": take("model.norm.weight").to(dtype)},
        "lm_head": take("lm_head.weight").to(dtype).T,
    }
    blocks: dict = {
        "ln_attn": {"g": []}, "ln_moe": {"g": []},
        "attn": {leaf: [] for _, leaf in _HF_ATTN.values()},
        "moe": {"router_w": [], "w1": [], "w3": [], "w2": []},
    }
    for layer in range(cfg.n_layer):
        pre = f"model.layers.{layer}."
        for hf, (grp, leaf) in _HF_NORM.items():
            blocks[grp][leaf].append(take(f"{pre}{hf}.weight"))
        for hf, (grp, leaf) in _HF_ATTN.items():
            blocks[grp][leaf].append(take(f"{pre}{hf}.weight").T)
        blocks["moe"]["router_w"].append(
            take(f"{pre}block_sparse_moe.gate.weight").T)
        for leaf in ("w1", "w3", "w2"):
            blocks["moe"][leaf].append([
                take(f"{pre}block_sparse_moe.experts.{x}.{leaf}.weight").T
                for x in range(cfg.n_experts)])
    out["blocks"] = {grp: {leaf: _stacked(items, dtype)
                           for leaf, items in leaves.items()}
                     for grp, leaves in blocks.items()}
    return out


def _sharded_tree(tensors: dict, cfg: MoEConfig, dtype) -> dict:
    """The stacked tree of a landing over a mesh, leaf by leaf under
    :func:`param_specs`."""
    mesh = next(t.mesh for t in tensors.values()
                            if hasattr(t, "mesh"))
    if EXPERT_AXIS not in mesh.axis_names:
        raise MeshUnsupported(f"the tree's mesh {mesh.shape} has no "
                              f"{EXPERT_AXIS!r} axis")
    specs = param_specs(cfg)
    b = specs["blocks"]

    def take(name):
        t = tensors.get(name)
        if t is None:
            raise ValueError(f"checkpoint missing {name}")
        return t

    def per_layer(hf, spec, transpose):
        return tp.stack_sharded(
            [take(f"model.layers.{i}.{hf}") for i in range(cfg.n_layer)],
            spec, dtype, transpose=transpose)

    wte = take("model.embed_tokens.weight")
    blocks: dict = {
        grp: {leaf: per_layer(f"{hf}.weight", b[grp][leaf], False)}
        for hf, (grp, leaf) in _HF_NORM.items()}
    blocks["attn"] = {leaf: per_layer(f"{hf}.weight", b[grp][leaf], True)
                      for hf, (grp, leaf) in _HF_ATTN.items()}
    blocks["moe"] = {"router_w": per_layer("block_sparse_moe.gate.weight",
                                           b["moe"]["router_w"], True)}
    for leaf in ("w1", "w3", "w2"):
        # A raw landing cuts each expert's features, the tree holds whole
        # experts a slot: each expert is gathered once.
        whole = _stacked([[take(
            f"model.layers.{i}.block_sparse_moe.experts.{x}.{leaf}.weight"
        ).full().T for x in range(cfg.n_experts)]
            for i in range(cfg.n_layer)], dtype)
        blocks["moe"][leaf] = shard_tensor(whole, mesh, b["moe"][leaf])
        del whole
    return {
        "wte": tp.stack_sharded([wte], specs["wte"], dtype, stacked=False),
        "ln_f": {"g": tp.stack_sharded([take("model.norm.weight")],
                                       specs["ln_f"]["g"], dtype,
                                       stacked=False)},
        "lm_head": tp.stack_sharded([take("lm_head.weight")],
                                    specs["lm_head"], dtype, transpose=True,
                                    stacked=False),
        "blocks": blocks,
    }


# ── Sharding (data + expert parallel; the expert axis doubles as TP) ──


def param_specs(cfg: MoEConfig) -> dict:
    """The spec tree matching the stacked tree, as the JAX package's:
    experts shard over ``EXPERT_AXIS`` on their stacked axis (slot ``s``
    holds ``n_experts / axis size`` of them, the blocks
    ``parallel/expert.ExpertPlacement`` routes bytes to), attention rides
    the same axis Megatron-style."""
    return {
        "wte": P(),
        "ln_f": {"g": P()},
        "lm_head": P(None, EXPERT_AXIS),
        "blocks": {
            "ln_attn": {"g": P()},
            "ln_moe": {"g": P()},
            "attn": {
                "q_w": P(None, None, EXPERT_AXIS),
                "k_w": P(None, None, EXPERT_AXIS),
                "v_w": P(None, None, EXPERT_AXIS),
                "o_w": P(None, EXPERT_AXIS, None),
            },
            "moe": {
                "router_w": P(),
                "w1": P(None, EXPERT_AXIS, None, None),
                "w3": P(None, EXPERT_AXIS, None, None),
                "w2": P(None, EXPERT_AXIS, None, None),
            },
        },
    }


def checkpoint_shard_rules() -> list[tuple[str, P]]:
    """Name-pattern rules for landing a raw HF Mixtral checkpoint
    (``models.loader``, HF ``[out, in]``): a raw landing balances bytes,
    each expert's feature dims sharded TP-style; the expert-parallel
    layout comes from :func:`param_specs`
    (``direct.land_moe_expert_sharded``)."""
    return [
        (r"self_attn\.[qkv]_proj\.weight$", P(EXPERT_AXIS, None)),
        (r"self_attn\.o_proj\.weight$", P(None, EXPERT_AXIS)),
        (r"experts\.\d+\.w[13]\.weight$", P(EXPERT_AXIS, None)),
        (r"experts\.\d+\.w2\.weight$", P(None, EXPERT_AXIS)),
        (r"block_sparse_moe\.gate\.weight$", P()),
        (r"^lm_head\.weight$", P(EXPERT_AXIS, None)),
    ]


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked block tree."""
    return {g: {k: v[i] for k, v in leaves.items()}
            for g, leaves in params["blocks"].items()}


# ── Forward ──


def _rope(x, theta: float, pos0: int = 0):
    """Rotary embedding over (B, T, H, D), rotate-half, at positions
    ``pos0``..``pos0+T-1``: float32 frequencies ``theta ** (-i / half)``
    and angles, cast to ``x``'s dtype, as the JAX package forms them."""
    T, D = x.shape[1], x.shape[3]
    half = D // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    pos = pos0 + torch.arange(T, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(x, p, cfg: MoEConfig):
    """Dense causal GQA over the whole sequence (over a slot's share of
    the heads when ``cfg`` counts only those)."""
    B, T, _ = x.shape
    H, KV, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    q = (x @ p["q_w"]).reshape(B, T, H, D)
    k = (x @ p["k_w"]).reshape(B, T, KV, D)
    v = (x @ p["v_w"]).reshape(B, T, KV, D)
    q, k = _rope(q, cfg.rope_theta), _rope(k, cfg.rope_theta)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    att = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = (att @ v).transpose(1, 2).reshape(B, T, H * D)
    return out @ p["o_w"]


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    cap = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(cap, cfg.top_k)


def _route(flat, router_w, cfg: MoEConfig):
    """Router over (..., E) activations: float32 logits → softmax →
    top-k → gates renormalized over the selected mass (Mixtral). Returns
    ``(probs, gate_vals, gate_idx)``."""
    probs = torch.softmax((flat @ router_w).float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, gate_idx


def _combine(flat, router_w, cfg: MoEConfig):
    """The GShard combine weights over (G, N, E): G independent groups of
    N tokens, each with capacity ``_capacity(N)`` per expert. Returns the
    (G, N, X, C) weights and the (G,) load-balance aux loss."""
    G, N, E = flat.shape
    X, k = cfg.n_experts, cfg.top_k
    C = _capacity(N, cfg)
    probs, gate_vals, gate_idx = _route(flat, router_w, cfg)
    # Load-balance aux loss (Switch §2.2): X * Σ_e fraction_e * prob_e.
    sel = F.one_hot(gate_idx[..., 0], X).float()
    aux = X * (sel.mean(dim=1) * probs.mean(dim=1)).sum(dim=-1)
    # Position of each (token, slot) in its expert's capacity buffer.
    onehot = F.one_hot(gate_idx, X)                          # (G, N, k, X)
    flat_sel = onehot.reshape(G, N * k, X)
    pos = (torch.cumsum(flat_sel, dim=1) * flat_sel - 1).reshape(G, N, k, X)
    in_cap = (pos >= 0) & (pos < C)
    # combine[g, n, x, c] = gate weight of token n in slot c of expert x.
    pos_oh = F.one_hot(pos.clamp(0, C - 1), C)              # (G, N, k, X, C)
    combine = torch.einsum(
        "gnk,gnkxc->gnxc", gate_vals.to(flat.dtype),
        (pos_oh * in_cap[..., None]).to(flat.dtype))
    return combine, aux


def _experts(combine, flat, w1, w3, w2):
    """The expert FFN of the experts ``combine``'s X axis names (the
    stacked ``w1``, ``w3``, ``w2`` hold the same experts): (G, N, E)."""
    dispatch = (combine > 0).to(flat.dtype)
    expert_in = torch.einsum("gnxc,gne->gxce", dispatch, flat)
    h = torch.einsum("gxce,xef->gxcf", expert_in, w1)
    up = torch.einsum("gxce,xef->gxcf", expert_in, w3)
    h = F.silu(h) * up                                      # SwiGLU
    expert_out = torch.einsum("gxcf,xfe->gxce", h, w2)
    return torch.einsum("gnxc,gxce->gne", combine, expert_out)


def _dispatch(flat, p, cfg: MoEConfig):
    """The GShard dispatch over (G, N, E) (:func:`_combine`). Returns the
    (G, N, E) expert output and the (G,) load-balance aux loss."""
    combine, aux = _combine(flat, p["router_w"], cfg)
    return _experts(combine, flat, p["w1"], p["w3"], p["w2"]), aux


def _moe_block(x, p, cfg: MoEConfig):
    """Top-k expert FFN over (B, T, E), the whole batch one dispatch
    group with capacity ``_capacity(B*T)``: overflow tokens drop to the
    residual path. Returns ``(out, aux_loss)``."""
    B, T, E = x.shape
    out, aux = _dispatch(x.reshape(1, B * T, E), p, cfg)
    return out.reshape(B, T, E), aux[0]


def _block(x, lp, cfg: MoEConfig):
    """One layer over (B, T, E): ``(x, the layer's aux loss)``."""
    h = _rms_norm(x, lp["ln_attn"]["g"], cfg.rms_eps)
    x = x + _attention(h, lp["attn"], cfg)
    h = _rms_norm(x, lp["ln_moe"]["g"], cfg.rms_eps)
    moe_out, layer_aux = _moe_block(h, lp["moe"], cfg)
    return x + moe_out, layer_aux


def _forward(params: dict, input_ids: torch.Tensor, cfg: MoEConfig,
             remat: bool = False):
    """:func:`forward` outside inference mode: the training core.
    ``remat=True`` recomputes each layer's activations (the dispatch
    tensors dominate them) in the backward instead of saving them."""
    x = params["wte"][input_ids]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layer):
        if remat:
            x, layer_aux = checkpoint(_block, x, _layer(params, i), cfg,
                                      use_reentrant=False)
        else:
            x, layer_aux = _block(x, _layer(params, i), cfg)
        aux = aux + layer_aux
    x = _rms_norm(x, params["ln_f"]["g"], cfg.rms_eps)
    return x @ params["lm_head"], aux / cfg.n_layer


@torch.inference_mode()
def forward(params: dict, input_ids: torch.Tensor, cfg: MoEConfig):
    """(B, T) ids → ((B, T, vocab) logits, scalar aux loss)."""
    return _forward(params, input_ids, cfg)


def loss_fn(params: dict, batch: torch.Tensor, cfg: MoEConfig,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross entropy over ``batch`` (B, T+1) ids plus
    ``aux_loss_weight`` × the load-balance aux loss. A tree of
    ``ShardedTensor``s (:func:`param_specs`) runs expert-parallel over
    its mesh's ``expert`` axis with the batch cut over ``data``
    (``tensor_parallel.moe_loss``): one dispatch group over the whole
    batch, as here."""
    if tp.is_sharded_train_tree(params):
        return tp.moe_loss(params, batch, cfg, remat)
    logits, aux = _forward(params, batch[:, :-1], cfg, remat)
    return cross_entropy(logits, batch[:, 1:]) + cfg.aux_loss_weight * aux


def train_step(params: dict, batch: torch.Tensor, cfg: MoEConfig,
               lr: float = 1e-3, remat: bool = False):
    """One SGD step: ``(new params, loss)``; ``params`` is not changed."""
    loss, grads = value_and_grad(loss_fn, params, batch, cfg, remat)
    return sgd(params, grads, lr), loss


# ── Incremental decode (serving) ──


def init_kv_cache(cfg: MoEConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.float32, device="cpu") -> dict:
    """Static-shape per-layer K/V cache: (L, B, max_len, KV, head_dim)."""
    shape = (cfg.n_layer, batch, max_len, cfg.n_kv_head, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attention_cached(h, p, cfg: MoEConfig, cache_k, cache_v, pos: int):
    """Window attention of (B, S, E) at positions ``pos``..``pos+S-1``
    against one layer's (B, max_len, KV, D) cache, written in place."""
    B, S, _ = h.shape
    H, KV, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    q = _rope((h @ p["q_w"]).reshape(B, S, H, D), cfg.rope_theta, pos)
    k = _rope((h @ p["k_w"]).reshape(B, S, KV, D), cfg.rope_theta, pos)
    v = (h @ p["v_w"]).reshape(B, S, KV, D)
    cache_k[:, pos:pos + S] = k
    cache_v[:, pos:pos + S] = v
    kk, vv = cache_k, cache_v
    if KV != H:
        kk = kk.repeat_interleave(H // KV, dim=2)
        vv = vv.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(D)
    max_len = cache_k.shape[1]
    valid = (torch.arange(max_len, device=h.device)[None, :]
             <= pos + torch.arange(S, device=h.device)[:, None])
    scores = scores.masked_fill(~valid[None, None],
                                torch.finfo(scores.dtype).min)
    att = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att.to(h.dtype), vv)
    return out.reshape(B, S, H * D) @ p["o_w"]


@torch.inference_mode()
def decode_window(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                  cfg: MoEConfig, last_only: bool = False):
    """Cached step over a token window: (B, S) ids at positions
    ``pos``..``pos+S-1`` → ((B, S, vocab) logits, cache). S=1 is one
    decode step; S=len(prompt) is the batched prefill. Every token
    dispatches as its own group (capacity ≥ top_k), so none drops and
    any window size gives the same logits."""
    B, S = tokens.shape
    x = params["wte"][tokens]
    for i in range(cfg.n_layer):
        lp = _layer(params, i)
        h = _rms_norm(x, lp["ln_attn"]["g"], cfg.rms_eps)
        x = x + _attention_cached(h, lp["attn"], cfg, cache["k"][i],
                                  cache["v"][i], pos)
        h = _rms_norm(x, lp["ln_moe"]["g"], cfg.rms_eps)
        moe_out, _ = _dispatch(h.reshape(B * S, 1, cfg.n_embd), lp["moe"],
                               cfg)
        x = x + moe_out.reshape(B, S, cfg.n_embd)
    x = _rms_norm(x, params["ln_f"]["g"], cfg.rms_eps)
    if last_only:
        x = x[:, -1:, :]
    return x @ params["lm_head"], cache


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos: int,
                cfg: MoEConfig):
    """One incremental step: (B,) ids at ``pos`` → ((B, vocab), cache)."""
    logits, cache = decode_window(params, cache, token[:, None], pos, cfg)
    return logits[:, 0, :], cache


def generate_cached(params: dict, cfg: MoEConfig, prompt_ids, steps: int,
                    temperature: float = 0.0, top_k: int | None = None,
                    top_p: float | None = None, seed: int = 0,
                    noise: torch.Tensor | None = None,
                    eos_id: int | tuple[int, ...] | None = None,
                    on_token=None) -> torch.Tensor:
    """KV-cached decode (``sampling.cached_decode_loop``, the prompt in
    one prefill window); greedy by default."""
    from zest_tpu_torch.models.sampling import cached_decode_loop

    return cached_decode_loop(
        init_kv_cache, decode_step, params, cfg,
        prompt_ids, steps,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        noise=noise, eos_id=eos_id, on_token=on_token,
        prefill_step=decode_window)
