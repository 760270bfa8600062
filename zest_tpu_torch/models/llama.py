"""The Llama family (Llama 2/3.x, Mistral, Qwen2-dense) in plain PyTorch.

The counterpart of ``zest_tpu/models/llama.py``'s serving half, kept in
its layout so the tests compare like with like: RMSNorm, rotary
embeddings (HF rotate-half, with the Llama-3.1 "llama3" frequency
scaling), grouped-query attention, SwiGLU MLP; params are a dict tree
with per-layer leaves stacked along a leading layer axis, every HF
``[out, in]`` Linear transposed to the ``x @ W`` layout. Matrix products
are ``torch.matmul``; attention is the same einsum, causal mask (filled
with ``finfo.min``) and float32 softmax as the JAX package, not a fused
kernel (the JAX package computes none of this in a Pallas kernel).

The KV cache, ``(L, B, max_len, KV, head_dim)``, is updated in place
(the JAX version returns a new cache); :func:`decode_window` still
returns it so the two read alike.

:func:`checkpoint_shard_rules` lays a raw checkpoint out Megatron-style
over a named mesh, as the JAX package's. :func:`params_from_hf` of such a
landing (``ShardedTensor`` values) gives the one sharded tree: the family
tree with a ``ShardedTensor`` at every leaf, laid out by
:func:`param_specs` (as ``sharding.shard_tree`` of a plain tree). It
trains tensor- and data-parallel through :func:`loss_fn` and
:func:`train_step` (and ``training.make_train_step``;
``models/tensor_parallel.llama_loss``), runs TP×CP through
:func:`cp_forward`, and decodes through :func:`generate_cached` with each
slot's local heads and FFN columns (the ``TPParams`` tree
``tensor_parallel.decode_params`` builds from it).

The training half (:func:`init_params`, :func:`loss_fn`,
:func:`train_step`, ``remat``) runs the same body as :func:`forward`
through ``_forward``, outside inference mode; ``forward`` and the decode
keep it. Context parallelism (:func:`cp_forward`, :func:`cp_loss_fn`,
:func:`cp_train_step`) shards the sequence over the ``seq`` axis of a
slot mesh and the batch over its ``data`` axis: every slot runs the layer
body on its block with its RoPE offset, and attention is the K/V ring of
``parallel/ring.py``. It runs on the sharded tree: a ``model`` axis
beside ``seq`` (the JAX package's TP×CP) gives each slot its share of
the tree Megatron-style, the ring carries the slot's local heads, and
the o/down partial sums meet on the lead slot of the ``model`` row. A
plain tree is laid out as that tree first, each slot's shard a view of
it (:func:`cp_specs`), so every slot's gradient flows into the one tree.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from zest_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from zest_tpu_torch.models import tensor_parallel as tp
# The JAX package's trees (as numpy arrays) carry over as GPT-2's do.
from zest_tpu_torch.models.gpt2 import normal, params_from_jax  # noqa: F401
from zest_tpu_torch.models.training import (cross_entropy, sgd, tree_map,
                                            value_and_grad)
from zest_tpu_torch.parallel.ring import SEQ_AXIS
from zest_tpu_torch.parallel.sharding import (MeshUnsupported, P,
                                              ShardedTensor, is_sharded_tree,
                                              shard_index)

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    # Defaults are Llama-3.1-8B's config.json.
    vocab_size: int = 128256
    n_ctx: int = 131072
    n_embd: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 8
    d_ff: int = 14336
    rms_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    # Llama-3.1 "llama3" RoPE frequency scaling (config.json rope_scaling).
    # factor None = unscaled (Llama 2 / 3.0 / Mistral).
    rope_scaling_factor: float | None = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_ctx: int = 8192
    # Some family members decouple head_dim from n_embd/n_head
    # (e.g. Mistral-Nemo: 5120/32 but head_dim=128). None = derived.
    head_dim_override: int | None = None
    # Qwen2-style q/k/v projection biases (Qwen2 hardcodes them on
    # without an attention_bias config key).
    attn_bias: bool = False
    # HF attention_bias=True additionally puts a bias on o_proj
    # (Qwen2 does not), so the two are tracked separately.
    o_bias: bool = False

    @staticmethod
    def tiny(**over) -> "LlamaConfig":
        """Test-sized config."""
        base = dict(vocab_size=256, n_ctx=64, n_embd=64, n_layer=2,
                    n_head=4, n_kv_head=2, d_ff=128,
                    rope_scaling_factor=None)
        base.update(over)
        return LlamaConfig(**base)

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()  # defaults

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(n_embd=8192, n_layer=80, n_head=64,
                           n_kv_head=8, d_ff=28672)

    @staticmethod
    def from_hf(cfg_json: dict) -> "LlamaConfig":
        rs = cfg_json.get("rope_scaling") or None
        scaling: dict = {"rope_scaling_factor": None}
        if rs:
            rtype = rs.get("rope_type", rs.get("type", "default"))
            if rtype == "llama3":
                scaling = dict(
                    rope_scaling_factor=float(rs["factor"]),
                    rope_low_freq_factor=float(
                        rs.get("low_freq_factor", 1.0)),
                    rope_high_freq_factor=float(
                        rs.get("high_freq_factor", 4.0)),
                    rope_original_ctx=int(
                        rs.get("original_max_position_embeddings", 8192)),
                )
            elif rtype != "default":
                # Silently dropping a scaling rule would yield wrong
                # positional phases on every token: refuse instead.
                raise ValueError(
                    f"unsupported rope_scaling type {rtype!r} "
                    "(supported: llama3, default)")
        if cfg_json.get("mlp_bias"):
            # The tree has no MLP-bias leaves; loading such a checkpoint
            # would silently drop tensors and compute wrong logits.
            raise ValueError(
                "mlp_bias checkpoints are not supported by this tree")
        # Qwen2 hardcodes q/k/v biases without setting attention_bias;
        # an explicit attention_bias=True (HF LlamaAttention) biases
        # o_proj as well.
        explicit = bool(cfg_json.get("attention_bias", False))
        attn_bias = explicit or cfg_json.get("model_type") == "qwen2"
        # Fallbacks for omitted keys are transformers.LlamaConfig's
        # defaults (a Llama-2-era config.json omits rope_theta and must
        # get 10000.0, not a 3.1 value).
        return LlamaConfig(
            **scaling,
            vocab_size=cfg_json["vocab_size"],
            n_ctx=cfg_json.get("max_position_embeddings", 2048),
            n_embd=cfg_json["hidden_size"],
            n_layer=cfg_json["num_hidden_layers"],
            n_head=cfg_json["num_attention_heads"],
            n_kv_head=cfg_json.get("num_key_value_heads",
                                   cfg_json["num_attention_heads"]),
            d_ff=cfg_json["intermediate_size"],
            rms_eps=cfg_json.get("rms_norm_eps", 1e-6),
            rope_theta=cfg_json.get("rope_theta", 10000.0),
            tie_embeddings=cfg_json.get("tie_word_embeddings", False),
            head_dim_override=cfg_json.get("head_dim"),
            attn_bias=attn_bias,
            o_bias=explicit,
        )

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.n_embd // self.n_head


# ── Parameters ──


def init_params(gen: torch.Generator, cfg: LlamaConfig,
                dtype: torch.dtype = torch.float32,
                device=DEFAULT_DEVICE) -> dict:
    """Random-init tree with stacked per-layer leaves (L leading): weights
    N(0, 0.02), the output projections N(0, 0.02/sqrt(2L)), norm gains 1,
    biases 0; drawn from ``gen`` (``gpt2.normal``) onto ``device``
    (``cuda`` by default, which raises without a card)."""
    device = resolve_device(device)
    E, L, F_ = cfg.n_embd, cfg.n_layer, cfg.d_ff
    qE = cfg.n_head * cfg.head_dim  # == E unless head_dim_override
    kvE = cfg.n_kv_head * cfg.head_dim
    out_scale = 0.02 / math.sqrt(2 * L)

    def dense(shape, scale=0.02):
        return normal(gen, shape, scale, dtype, device)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    attn = {
        "q_w": dense((L, E, qE)),
        "k_w": dense((L, E, kvE)),
        "v_w": dense((L, E, kvE)),
        "o_w": dense((L, qE, E), out_scale),
    }
    if cfg.attn_bias:
        attn.update(q_b=const((L, qE), 0.0), k_b=const((L, kvE), 0.0),
                    v_b=const((L, kvE), 0.0))
    if cfg.o_bias:
        attn["o_b"] = const((L, E), 0.0)
    out = {
        "wte": dense((cfg.vocab_size, E)),
        "ln_f": {"g": const((E,), 1.0)},
        "blocks": {
            "ln_attn": {"g": const((L, E), 1.0)},
            "ln_mlp": {"g": const((L, E), 1.0)},
            "attn": attn,
            "mlp": {
                "gate_w": dense((L, E, F_)),
                "up_w": dense((L, E, F_)),
                "down_w": dense((L, F_, E), out_scale),
            },
        },
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = dense((E, cfg.vocab_size))
    return out


_HF_ATTN = {
    "self_attn.q_proj": ("attn", "q_w"),
    "self_attn.k_proj": ("attn", "k_w"),
    "self_attn.v_proj": ("attn", "v_w"),
    "self_attn.o_proj": ("attn", "o_w"),
}
_HF_MLP = {
    "mlp.gate_proj": ("mlp", "gate_w"),
    "mlp.up_proj": ("mlp", "up_w"),
    "mlp.down_proj": ("mlp", "down_w"),
}
_HF_NORM = {
    "input_layernorm": ("ln_attn", "g"),
    "post_attention_layernorm": ("ln_mlp", "g"),
}


def _stack(layers: list[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """Per-layer tensors stacked along a new leading axis in ``dtype``:
    one allocation, each layer cast and copied into its slot (no stacked
    intermediate in the source dtype)."""
    out = torch.empty((len(layers), *layers[0].shape), dtype=dtype,
                      device=layers[0].device)
    for i, t in enumerate(layers):
        out[i].copy_(t)
    return out


def params_from_hf(tensors: dict[str, torch.Tensor], cfg: LlamaConfig,
                   dtype: torch.dtype = torch.float32) -> dict:
    """Map an HF Llama-family checkpoint (flat name→tensor) onto the tree,
    on the tensors' device.

    HF ``nn.Linear`` weights are stored ``[out, in]``; all are transposed
    into the ``x @ W`` layout. A tied config maps onto a tree without the
    ``lm_head`` leaf (the logits reuse ``wte``, as a view); an untied one
    without ``lm_head.weight`` raises, as any missing tensor does, with
    its name.

    A tree of ``ShardedTensor``s (a landing over a mesh) gives the one
    sharded tree: every leaf a ``ShardedTensor`` under :func:`param_specs`
    on the landing's mesh (``tensor_parallel.stack_sharded``). It trains
    (:func:`loss_fn`), runs TP×CP (:func:`cp_forward`) and decodes
    tensor-parallel (``tensor_parallel.decode_params``)."""
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
    }
    # A tied checkpoint may still carry lm_head.weight: the tree follows
    # the config, not the file.
    if not cfg.tie_embeddings:
        out["lm_head"] = take("lm_head.weight").to(dtype).T
    blocks: dict = {
        "ln_attn": {"g": []}, "ln_mlp": {"g": []},
        "attn": {leaf: [] for _, leaf in _HF_ATTN.values()},
        "mlp": {leaf: [] for _, leaf in _HF_MLP.values()},
    }
    if cfg.attn_bias:
        for leaf in ("q_b", "k_b", "v_b"):
            blocks["attn"][leaf] = []
    if cfg.o_bias:
        blocks["attn"]["o_b"] = []
    for layer in range(cfg.n_layer):
        pre = f"model.layers.{layer}."
        for hf, (grp, leaf) in _HF_NORM.items():
            blocks[grp][leaf].append(take(f"{pre}{hf}.weight"))
        for hf, (grp, leaf) in {**_HF_ATTN, **_HF_MLP}.items():
            blocks[grp][leaf].append(take(f"{pre}{hf}.weight").T)
        if cfg.attn_bias:
            for proj, leaf in (("q", "q_b"), ("k", "k_b"), ("v", "v_b")):
                blocks["attn"][leaf].append(
                    take(f"{pre}self_attn.{proj}_proj.bias"))
        if cfg.o_bias:
            blocks["attn"]["o_b"].append(take(f"{pre}self_attn.o_proj.bias"))
    out["blocks"] = {grp: {leaf: _stack(layers, dtype)
                           for leaf, layers in leaves.items()}
                     for grp, leaves in blocks.items()}
    return out


def _sharded_tree(tensors: dict, cfg: LlamaConfig, dtype) -> dict:
    """The training tree of a landing over a mesh, leaf by leaf under
    :func:`param_specs`."""
    mesh = next(t.mesh for t in tensors.values()
                if isinstance(t, ShardedTensor))
    if MODEL_AXIS not in mesh.axis_names:
        raise MeshUnsupported(f"the tree's mesh {mesh.shape} has no "
                              f"{MODEL_AXIS!r} axis")
    specs = param_specs(cfg)

    def take(name):
        t = tensors.get(name)
        if t is None:
            raise ValueError(f"checkpoint missing {name}")
        return t

    def per_layer(hf, spec, transpose):
        return tp.stack_sharded(
            [take(f"model.layers.{i}.{hf}") for i in range(cfg.n_layer)],
            spec, dtype, transpose=transpose)

    b = specs["blocks"]
    out = {
        "wte": tp.stack_sharded([take("model.embed_tokens.weight")],
                                specs["wte"], dtype, stacked=False),
        "ln_f": {"g": tp.stack_sharded([take("model.norm.weight")],
                                       specs["ln_f"]["g"], dtype,
                                       stacked=False)},
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = tp.stack_sharded([take("lm_head.weight")],
                                          specs["lm_head"], dtype,
                                          transpose=True, stacked=False)
    blocks: dict = {grp: {leaf: per_layer(f"{hf}.weight", b[grp][leaf],
                                          False)}
                    for hf, (grp, leaf) in _HF_NORM.items()}
    for hf, (grp, leaf) in {**_HF_ATTN, **_HF_MLP}.items():
        blocks.setdefault(grp, {})[leaf] = per_layer(
            f"{hf}.weight", b[grp][leaf], True)
    if cfg.attn_bias:
        for proj, leaf in (("q", "q_b"), ("k", "k_b"), ("v", "v_b")):
            blocks["attn"][leaf] = per_layer(f"self_attn.{proj}_proj.bias",
                                             b["attn"][leaf], False)
    if cfg.o_bias:
        blocks["attn"]["o_b"] = per_layer("self_attn.o_proj.bias",
                                          b["attn"]["o_b"], False)
    out["blocks"] = blocks
    return out


# ── Sharding rules (data + tensor parallel) ──


def param_specs(cfg: LlamaConfig) -> dict:
    """The spec tree matching the param tree (Megatron-style TP), as the
    JAX package's."""
    out = {
        "wte": P(),
        "ln_f": {"g": P()},
        "blocks": {
            "ln_attn": {"g": P()},
            "ln_mlp": {"g": P()},
            "attn": {
                "q_w": P(None, None, MODEL_AXIS),
                "k_w": P(None, None, MODEL_AXIS),
                "v_w": P(None, None, MODEL_AXIS),
                "o_w": P(None, MODEL_AXIS, None),
                **({"q_b": P(None, MODEL_AXIS),
                    "k_b": P(None, MODEL_AXIS),
                    "v_b": P(None, MODEL_AXIS)} if cfg.attn_bias else {}),
                # o_b adds after the row-parallel o_w reduce: replicated.
                **({"o_b": P()} if cfg.o_bias else {}),
            },
            "mlp": {
                "gate_w": P(None, None, MODEL_AXIS),
                "up_w": P(None, None, MODEL_AXIS),
                "down_w": P(None, MODEL_AXIS, None),
            },
        },
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = P(None, MODEL_AXIS)
    return out


def checkpoint_shard_rules() -> list[tuple[str, P]]:
    """Name-pattern rules for landing a raw HF Llama checkpoint
    (``models.loader``). HF stores ``[out, in]``: column-parallel tensors
    shard dim 0, row-parallel ones dim 1."""
    return [
        (r"self_attn\.[qkv]_proj\.weight$", P(MODEL_AXIS, None)),
        (r"self_attn\.[qkv]_proj\.bias$", P(MODEL_AXIS)),
        (r"self_attn\.o_proj\.bias$", P(None)),
        (r"self_attn\.o_proj\.weight$", P(None, MODEL_AXIS)),
        (r"mlp\.(gate|up)_proj\.weight$", P(MODEL_AXIS, None)),
        (r"mlp\.down_proj\.weight$", P(None, MODEL_AXIS)),
        (r"^lm_head\.weight$", P(MODEL_AXIS, None)),
    ]


def params_to_hf(params: dict, cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_hf`: the stacked tree back to HF
    tensor names and orientations (``[out, in]`` Linears, per layer)."""
    out = {
        "model.embed_tokens.weight": params["wte"],
        "model.norm.weight": params["ln_f"]["g"],
    }
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = params["lm_head"].T.contiguous()
    b = params["blocks"]
    for layer in range(cfg.n_layer):
        pre = f"model.layers.{layer}."
        for hf, (grp, leaf) in _HF_NORM.items():
            out[f"{pre}{hf}.weight"] = b[grp][leaf][layer]
        for hf, (grp, leaf) in {**_HF_ATTN, **_HF_MLP}.items():
            out[f"{pre}{hf}.weight"] = b[grp][leaf][layer].T.contiguous()
        if cfg.attn_bias:
            for proj, leaf in (("q", "q_b"), ("k", "k_b"), ("v", "v_b")):
                out[f"{pre}self_attn.{proj}_proj.bias"] = \
                    b["attn"][leaf][layer]
        if cfg.o_bias:
            out[f"{pre}self_attn.o_proj.bias"] = b["attn"]["o_b"][layer]
    return out


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked block tree."""
    return {g: {k: v[i] for k, v in leaves.items()}
            for g, leaves in params["blocks"].items()}


# ── Forward ──


def _rms_norm(x, g, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * g


@functools.lru_cache(maxsize=None)
def _inv_freq(cfg: LlamaConfig) -> np.ndarray:
    """Per-dimension rotary frequencies, with the Llama-3.1 "llama3"
    scaling rule applied when configured: long-wavelength dims slow by
    ``factor``, short wavelengths stay, the band between interpolates
    (HF ROPE_INIT_FUNCTIONS['llama3']). Computed in float64 and cast to
    float32, as the JAX package does; config-static, so cached."""
    half = cfg.head_dim // 2
    inv = cfg.rope_theta ** (-np.arange(half, dtype=np.float64) / half)
    if cfg.rope_scaling_factor:
        wavelen = 2.0 * math.pi / inv
        smooth = ((cfg.rope_original_ctx / wavelen - cfg.rope_low_freq_factor)
                  / (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor))
        smooth = np.clip(smooth, 0.0, 1.0)
        # smooth=0 (wavelen > orig/low): fully scaled; smooth=1
        # (wavelen < orig/high): unscaled; between: linear blend.
        inv = (1.0 - smooth) * inv / cfg.rope_scaling_factor + smooth * inv
    return inv.astype(np.float32)


def _rope(x, cfg: LlamaConfig, pos0: int = 0):
    """Rotary embedding over (B, T, H, D), HF rotate-half convention, at
    positions ``pos0``..``pos0+T-1``. The angles are float32 products of
    the positions and the float32 frequencies, as the JAX package forms
    them."""
    T, D = x.shape[1], x.shape[3]
    freqs = torch.from_numpy(_inv_freq(cfg)).to(x.device)
    half = D // 2
    pos = pos0 + torch.arange(T, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _qkv(x, p, cfg: LlamaConfig, pos0: int = 0):
    """Projections and RoPE: (B, T, E) → q (B, T, H, D), k and v
    (B, T, KV, D)."""
    B, T, _ = x.shape
    D = cfg.head_dim

    def proj(w, b):
        h = x @ p[w]
        if b in p:  # Qwen2-style q/k/v biases
            h = h + p[b]
        return h.reshape(B, T, -1, D)

    q, k, v = proj("q_w", "q_b"), proj("k_w", "k_b"), proj("v_w", "v_b")
    return _rope(q, cfg, pos0), _rope(k, cfg, pos0), v


def _out_proj(out, p):
    out = out @ p["o_w"]
    return out + p["o_b"] if "o_b" in p else out


def _causal(q, k, v, cfg: LlamaConfig):
    """Dense causal GQA: q (B, T, H, D), k and v (B, T, KV, D) →
    (B, T, H·D), before the o projection."""
    B, T, H, D = q.shape
    KV = cfg.n_kv_head
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    att = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return (att @ v).transpose(1, 2).reshape(B, T, H * D)


def _attention(x, p, cfg: LlamaConfig):
    """Dense causal GQA over the whole sequence."""
    return _out_proj(_causal(*_qkv(x, p, cfg), cfg), p)


def _mlp(x, p):
    return (F.silu(x @ p["gate_w"]) * (x @ p["up_w"])) @ p["down_w"]


def _unembed(params, x):
    head = params.get("lm_head")
    return x @ (head if head is not None else params["wte"].T)


def _block(x, lp, cfg: LlamaConfig, attn_fn):
    """One layer over (B, T, E); ``lp`` holds this layer's slice."""
    h = _rms_norm(x, lp["ln_attn"]["g"], cfg.rms_eps)
    x = x + attn_fn(h, lp["attn"])
    h = _rms_norm(x, lp["ln_mlp"]["g"], cfg.rms_eps)
    return x + _mlp(h, lp["mlp"])


def _body(params, x, cfg: LlamaConfig, attn_fn, remat: bool = False):
    for i in range(cfg.n_layer):
        if remat:
            # Per-layer rematerialization: a block's activations are
            # recomputed in the backward instead of saved.
            x = checkpoint(_block, x, _layer(params, i), cfg, attn_fn,
                           use_reentrant=False)
        else:
            x = _block(x, _layer(params, i), cfg, attn_fn)
    x = _rms_norm(x, params["ln_f"]["g"], cfg.rms_eps)
    return _unembed(params, x)


def _forward(params: dict, input_ids: torch.Tensor, cfg: LlamaConfig,
             remat: bool = False) -> torch.Tensor:
    """:func:`forward` outside inference mode: the training core."""
    x = params["wte"][input_ids]
    return _body(params, x, cfg, lambda h, p: _attention(h, p, cfg), remat)


@torch.inference_mode()
def forward(params: dict, input_ids: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """(B, T) token ids → (B, T, vocab) logits."""
    return _forward(params, input_ids, cfg)


def loss_fn(params: dict, batch: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross entropy over ``batch`` (B, T+1) ids. A tree of
    ``ShardedTensor``s runs tensor-parallel over its mesh's ``model`` axis
    with the batch cut over ``data`` (``tensor_parallel.llama_loss``)."""
    if tp.is_sharded_train_tree(params):
        return tp.llama_loss(params, batch, cfg, remat)
    return cross_entropy(_forward(params, batch[:, :-1], cfg, remat),
                         batch[:, 1:])


def train_step(params: dict, batch: torch.Tensor, cfg: LlamaConfig,
               lr: float = 1e-3, remat: bool = False):
    """One SGD step: ``(new params, loss)``; ``params`` is not changed.
    ``remat=True`` recomputes each layer's activations in the backward. A
    sharded tree steps in its layout (its replicas equal after it)."""
    loss, grads = value_and_grad(loss_fn, params, batch, cfg, remat)
    return sgd(params, grads, lr), loss


# ── Context parallelism (sequence sharded, ring attention) ──


def _cp_grid(mesh, seq_axis: str, data_axis: str) -> list[list[list]]:
    """The mesh's slots as a data × seq grid of ``model`` rows: cell
    ``[r][s]`` lists the slots along the ``model`` axis (one slot without
    one) at data index ``r`` and seq index ``s``."""
    if len(mesh.local_slots()) < mesh.size:
        raise MeshUnsupported("context parallelism needs every slot of the "
                              "mesh in this process")
    n_data = mesh.shape.get(data_axis, 1)
    n_seq = mesh.shape[seq_axis]
    if MODEL_AXIS not in mesh.axis_names:
        return [[[s] for s in mesh.axis_slots(seq_axis, {data_axis: r})]
                for r in range(n_data)]
    return [[mesh.axis_slots(MODEL_AXIS, {data_axis: r, seq_axis: s})
             for s in range(n_seq)] for r in range(n_data)]


def cp_specs(cfg: LlamaConfig, mesh) -> dict:
    """:func:`param_specs` over ``mesh``: without a ``model`` axis every
    leaf is whole on every slot."""
    specs = param_specs(cfg)
    if MODEL_AXIS in mesh.axis_names:
        return specs
    return tree_map(lambda _s: P(), specs)


def _laid_out(params: dict, cfg: LlamaConfig, mesh) -> dict:
    """A plain tree as the sharded tree :func:`cp_specs` gives, each
    slot's shard a view of it moved to the slot's device (on the tree's
    own device no copy), so every slot's gradient flows back into the
    one tree."""
    def lay(t, spec):
        return ShardedTensor(
            {s: t[shard_index(tuple(t.shape), mesh, spec, s)].to(
                mesh.device_of(s)) for s in mesh.local_slots()},
            t.shape, t.dtype, spec, mesh)

    return tree_map(lay, params, cp_specs(cfg, mesh))


def _cp_cells(params: dict, cfg: LlamaConfig, grid, mesh) -> dict:
    """Each grid cell's leaves (by its lead slot), the stacked form of
    what ``tensor_parallel.llama_layer`` takes a layer: the norms and
    ``o_b`` whole on the lead, attention and MLP as columns over the
    cell's ``model`` slots. Attention runs whole on the lead when the
    heads do not divide over the cell, as the sharded train step's
    does."""
    blocks = params["blocks"]
    attn = blocks["attn"]
    out = {}
    for row in grid:
        for cell in row:
            lead = cell[0]
            out[lead] = {
                "ln_attn": tp._whole(blocks["ln_attn"]["g"], lead),
                "ln_mlp": tp._whole(blocks["ln_mlp"]["g"], lead),
                "o_b": (tp._whole(attn["o_b"], lead) if "o_b" in attn
                        else None),
                "attn": list(zip(*tp._columns(
                    attn, {k: d for k, d in tp._LLAMA_ATTN.items()
                           if k in attn}, cell, MODEL_AXIS, mesh,
                    tp.heads_divide(cfg, len(cell))))),
                "mlp": list(zip(*tp._columns(blocks["mlp"], tp._LLAMA_MLP,
                                             cell, MODEL_AXIS, mesh)))}
    return out


def _cp_cell(stacked: dict, i: int) -> dict:
    """Layer ``i`` of one cell's stacked leaves."""
    return {"ln_attn": stacked["ln_attn"][i],
            "ln_mlp": stacked["ln_mlp"][i],
            "o_b": None if stacked["o_b"] is None else stacked["o_b"][i],
            "attn": [(tp._at(c, i), d) for c, d in stacked["attn"]],
            "mlp": [(tp._at(c, i), d) for c, d in stacked["mlp"]]}


def _cp_layer(xs: list, cells: list, cfg: LlamaConfig, t: int) -> list:
    """One layer over every slot's block, rows of the data axis in turn
    (``xs[r][s]`` on the lead of cell ``[r][s]``, ``cells[r][s]`` its
    leaves from :func:`_cp_cell`)."""
    return [tp.llama_layer(row, crow, cfg, t) for row, crow in zip(xs, cells)]


def _cp_logits(params: dict, input_ids: torch.Tensor, cfg: LlamaConfig,
               mesh, seq_axis: str, data_axis: str,
               remat: bool) -> list[list[torch.Tensor]]:
    """Every cell's (B/D, T/S, vocab) logits on its lead, as a data × seq
    grid, from the sharded tree (a plain tree laid out by
    :func:`_laid_out`)."""
    grid = _cp_grid(mesh, seq_axis, data_axis)
    n_data, n_seq, n_model = len(grid), len(grid[0]), len(grid[0][0])
    B, T = input_ids.shape
    if B % n_data or T % n_seq:
        raise ValueError(f"batch ({B}, {T}) does not divide over "
                         f"{data_axis}={n_data}, {seq_axis}={n_seq}")
    if cfg.d_ff % n_model:
        raise MeshUnsupported(f"{cfg.d_ff} FFN columns do not divide over "
                              f"the {n_model} slots of the {MODEL_AXIS!r} "
                              "axis")
    if not tp.is_sharded_train_tree(params):
        params = _laid_out(params, cfg, mesh)
    b, t = B // n_data, T // n_seq
    stacked = _cp_cells(params, cfg, grid, mesh)
    xs = [[tp._whole(params["wte"], cell[0])[
        input_ids[r * b:(r + 1) * b, s * t:(s + 1) * t].to(
            mesh.device_of(cell[0]))]
        for s, cell in enumerate(row)] for r, row in enumerate(grid)]
    for i in range(cfg.n_layer):
        cells = [[_cp_cell(stacked[cell[0]], i) for cell in row]
                 for row in grid]
        if remat:
            xs = checkpoint(_cp_layer, xs, cells, cfg, t,
                            use_reentrant=False)
        else:
            xs = _cp_layer(xs, cells, cfg, t)
    out = []
    for xrow, row in zip(xs, grid):
        cells = []
        for x, cell in zip(xrow, row):
            x = _rms_norm(x, tp._whole(params["ln_f"]["g"], cell[0]),
                          cfg.rms_eps)
            cells.append(tp._head_logits(params, x, cell, MODEL_AXIS, mesh,
                                         mesh.device_of(cell[0])))
        out.append(cells)
    return out


def cp_forward(params: dict, input_ids: torch.Tensor, cfg: LlamaConfig,
               mesh, seq_axis: str = SEQ_AXIS, data_axis: str = DATA_AXIS,
               remat: bool = False) -> torch.Tensor:
    """(B, T) ids → (B, T, vocab) logits with T cut over ``mesh``'s
    ``seq_axis`` and B over its ``data_axis`` (a ``SlotMesh``; both must
    divide). Token and RoPE work is local to each slot (phases offset by
    the slot's global start), attention is the K/V ring; the logits are
    joined on the first slot's device. With a ``model`` axis too (a
    ``{data, seq, model}`` mesh) each slot computes its local heads and
    FFN columns (an untied head its vocabulary columns), and the partial
    sums meet on the lead of each ``model`` row: TP×CP."""
    grid = _cp_logits(params, input_ids, cfg, mesh, seq_axis, data_axis,
                      remat)
    lead = grid[0][0].device
    return torch.cat([torch.cat([x.to(lead) for x in row], dim=1)
                      for row in grid], dim=0)


def cp_loss_fn(params: dict, inputs: torch.Tensor, targets: torch.Tensor,
               cfg: LlamaConfig, mesh, seq_axis: str = SEQ_AXIS,
               data_axis: str = DATA_AXIS, remat: bool = False):
    """Cross entropy with ``inputs``/``targets`` (B, T) aligned: the
    next-token shift crosses slot boundaries, so the caller shifts
    globally (:func:`cp_train_step`). Each slot sums its tokens' NLL; the
    sums meet on the first slot's device."""
    grid = _cp_logits(params, inputs, cfg, mesh, seq_axis, data_axis, remat)
    n_data, n_seq = len(grid), len(grid[0])
    B, T = targets.shape
    b, t = B // n_data, T // n_seq
    lead = grid[0][0].device
    total = 0.0
    for r, row in enumerate(grid):
        for s, logits in enumerate(row):
            tgt = targets[r * b:(r + 1) * b, s * t:(s + 1) * t]
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = -logp.gather(-1, tgt.to(logits.device)[..., None]).sum()
            total = total + nll.to(lead)
    return total / (B * T)


def cp_train_step(params: dict, batch: torch.Tensor, cfg: LlamaConfig,
                  mesh, lr: float = 1e-3, seq_axis: str = SEQ_AXIS,
                  data_axis: str = DATA_AXIS, remat: bool = False):
    """Context-parallel SGD step on ``batch`` (B, T+1) ids: the shift on
    the global array, then forward and backward through the ring (its
    backward is the reverse ring). Every slot's gradient, of every data
    replica, is summed into the one tree: the result is the single-device
    mean's. Returns ``(new params, loss)``."""
    loss, grads = value_and_grad(cp_loss_fn, params, batch[:, :-1],
                                 batch[:, 1:], cfg, mesh, seq_axis,
                                 data_axis, remat)
    return sgd(params, grads, lr), loss


# ── Decoding ──


def _attention_cached(x, p, cfg: LlamaConfig, cache_k, cache_v, pos: int):
    """Window attention against one layer's (B, max_len, KV, D) cache.

    ``x``: (B, S, E) activations for the tokens at positions
    ``pos``..``pos+S-1`` (S=1 is one decode step, S=n0 the batched
    prefill). Writes their K/V into the cache in place; row s attends to
    the entries ``<= pos+s``."""
    B, S, _ = x.shape
    H, KV, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    q, k, v = _qkv(x, p, cfg, pos0=pos)
    cache_k[:, pos:pos + S] = k
    cache_v[:, pos:pos + S] = v
    kk, vv = cache_k, cache_v
    if KV != H:
        kk = kk.repeat_interleave(H // KV, dim=2)
        vv = vv.repeat_interleave(H // KV, dim=2)
    # (B, H, S, max_len) scores over the whole cache, the future masked.
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(D)
    max_len = cache_k.shape[1]
    valid = (torch.arange(max_len, device=x.device)[None, :]
             <= pos + torch.arange(S, device=x.device)[:, None])
    scores = scores.masked_fill(~valid[None, None],
                                torch.finfo(scores.dtype).min)
    att = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att.to(x.dtype), vv)
    return _out_proj(out.reshape(B, S, H * D), p)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.float32, device="cpu") -> dict:
    """Static-shape per-layer K/V cache: (L, B, max_len, KV, D)."""
    shape = (cfg.n_layer, batch, max_len, cfg.n_kv_head, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.inference_mode()
def decode_window(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                  cfg: LlamaConfig, last_only: bool = False):
    """Cached step over a token window: (B, S) ids at positions
    ``pos``..``pos+S-1`` → ((B, S, vocab) logits, cache). S=1 is one
    decode step; S=len(prompt) is the batched prefill. ``last_only``
    unembeds only the final position."""
    x = params["wte"][tokens]
    for i in range(cfg.n_layer):
        lp = _layer(params, i)
        h = _rms_norm(x, lp["ln_attn"]["g"], cfg.rms_eps)
        x = x + _attention_cached(h, lp["attn"], cfg, cache["k"][i],
                                  cache["v"][i], pos)
        h = _rms_norm(x, lp["ln_mlp"]["g"], cfg.rms_eps)
        x = x + _mlp(h, lp["mlp"])
    x = _rms_norm(x, params["ln_f"]["g"], cfg.rms_eps)
    if last_only:
        # Prefill wants one next-token distribution: unembed only the
        # final hidden state, not (B, S, vocab).
        x = x[:, -1:, :]
    return _unembed(params, x), cache


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos: int,
                cfg: LlamaConfig):
    """One incremental step: (B,) ids at ``pos`` → ((B, vocab), cache)."""
    logits, cache = decode_window(params, cache, token[:, None], pos, cfg)
    return logits[:, 0, :], cache


def generate_cached(params: dict, cfg: LlamaConfig, prompt_ids, steps: int,
                    temperature: float = 0.0, top_k: int | None = None,
                    top_p: float | None = None, seed: int = 0,
                    noise: torch.Tensor | None = None,
                    eos_id: int | tuple[int, ...] | None = None,
                    on_token=None) -> torch.Tensor:
    """KV-cached decode (``sampling.cached_decode_loop``, the prompt in
    one prefill window). Greedy by default, token-identical to
    :func:`generate_greedy`."""
    from zest_tpu_torch.models.sampling import cached_decode_loop

    return cached_decode_loop(
        init_kv_cache, decode_step, params, cfg,
        prompt_ids, steps,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        noise=noise, eos_id=eos_id, on_token=on_token,
        prefill_step=decode_window)


@torch.inference_mode()
def generate_greedy(params: dict, cfg: LlamaConfig, prompt_ids,
                    steps: int) -> torch.Tensor:
    """Greedy decode by full recompute over a fixed buffer: (T0,) ids →
    (T0+steps,). The uncached reference of :func:`generate_cached`."""
    device = params["wte"].device
    prompt = torch.as_tensor(prompt_ids, dtype=torch.long, device=device)
    n0 = prompt.shape[0]
    total = n0 + steps
    if total > cfg.n_ctx:
        raise ValueError(f"prompt ({n0}) + steps ({steps}) = {total} "
                         f"exceeds n_ctx {cfg.n_ctx}")
    buf = torch.zeros(total, dtype=torch.long, device=device)
    buf[:n0] = prompt
    for pos in range(n0, total):
        logits = forward(params, buf[None, :], cfg)[0]
        buf[pos] = logits[pos - 1].argmax()
    return buf
