"""GPT-2 in plain PyTorch, consuming pulled HF checkpoints.

The counterpart of ``zest_tpu/models/gpt2.py``, kept in its layout so the
tests compare like with like: params are a dict tree with per-layer
leaves stacked along a leading layer axis (``blocks.attn.qkv_w`` is
``(L, E, 3E)``, GPT-2's Conv1D ``x @ W`` layout). Matrix products are
``torch.matmul``; attention is the same matmul, causal mask (filled with
``finfo.min``) and softmax as the JAX package, not a fused kernel; the
MLP uses the tanh GELU.

The KV cache is updated in place (the JAX version returns a new cache);
:func:`decode_window` still returns it so the two read alike.

:func:`checkpoint_shard_rules` lays a raw checkpoint out over a named mesh
as the JAX package's do. GPT-2 does not decode tensor-parallel from that
layout as it is: ``attn.c_attn.weight`` shards the fused q|k|v columns,
so no slot holds the q, k and v of the same heads (at ``model=4``, 576 of
2304 columns a slot, across the q/k/v borders). :func:`params_from_hf`
keeps a sharded tree sharded (under :func:`param_specs`, as the JAX
package's GSPMD step takes it): the sharded step
(``tensor_parallel.gpt2_loss``) joins each row's q|k|v blocks on the
row's lead and runs the MLP split; decode regroups the columns into whole
heads a slot (``tensor_parallel.decode_params``).

The training half (:func:`init_params`, :func:`loss_fn`,
:func:`train_step`, ``remat``) runs the same body as :func:`forward`
through ``_forward``, outside inference mode; ``forward`` and the decode
keep it. ``init_params`` draws from a ``torch.Generator``: the JAX
package's ``jax.random`` draws cannot be matched bit for bit, so only
the shapes, dtypes and scales are.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from zest_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from zest_tpu_torch.models import tensor_parallel as tp
from zest_tpu_torch.models.training import (cross_entropy, sgd,
                                            value_and_grad)
from zest_tpu_torch.parallel.sharding import (MeshUnsupported, P,
                                              is_sharded_tree)

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_ctx: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny(**over) -> "GPT2Config":
        """Test-sized config."""
        base = dict(vocab_size=256, n_ctx=64, n_embd=64, n_layer=2,
                    n_head=4)
        base.update(over)
        return GPT2Config(**base)

    @staticmethod
    def from_hf(cfg_json: dict) -> "GPT2Config":
        return GPT2Config(
            vocab_size=cfg_json["vocab_size"],
            n_ctx=cfg_json.get("n_ctx", cfg_json.get("n_positions", 1024)),
            n_embd=cfg_json["n_embd"],
            n_layer=cfg_json["n_layer"],
            n_head=cfg_json["n_head"],
            layer_norm_eps=cfg_json.get("layer_norm_epsilon", 1e-5),
        )


# ── Parameters ──


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
           device) -> torch.Tensor:
    """N(0, scale²) drawn on the CPU from ``gen``, then cast and moved:
    the families' random init (``jax.random`` draws cannot be matched bit
    for bit; the shapes, dtypes and scales are the JAX package's)."""
    return (torch.randn(shape, generator=gen) * scale).to(device, dtype)


def init_params(gen: torch.Generator, cfg: GPT2Config,
                dtype: torch.dtype = torch.float32,
                device=DEFAULT_DEVICE) -> dict:
    """Random-init param tree with stacked per-layer leaves (L leading):
    weights N(0, 0.02), ``wpe`` N(0, 0.01), the output projections
    N(0, 0.02/sqrt(2L)), norm gains 1, biases 0; on ``device`` (``cuda``
    by default, which raises without a card)."""
    device = resolve_device(device)
    E, L = cfg.n_embd, cfg.n_layer
    out_scale = 0.02 / math.sqrt(2 * L)

    def dense(shape, scale=0.02):
        return normal(gen, shape, scale, dtype, device)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "wte": dense((cfg.vocab_size, E)),
        "wpe": dense((cfg.n_ctx, E), 0.01),
        "ln_f": {"g": const((E,), 1.0), "b": const((E,), 0.0)},
        "blocks": {
            "ln_1": {"g": const((L, E), 1.0), "b": const((L, E), 0.0)},
            "ln_2": {"g": const((L, E), 1.0), "b": const((L, E), 0.0)},
            "attn": {
                "qkv_w": dense((L, E, 3 * E)),
                "qkv_b": const((L, 3 * E), 0.0),
                "proj_w": dense((L, E, E), out_scale),
                "proj_b": const((L, E), 0.0),
            },
            "mlp": {
                "fc_w": dense((L, E, 4 * E)),
                "fc_b": const((L, 4 * E), 0.0),
                "proj_w": dense((L, 4 * E, E), out_scale),
                "proj_b": const((L, E), 0.0),
            },
        },
    }


_HF_BLOCK = re.compile(r"^h\.(\d+)\.(.+)$")

# HF tensor name (within a block) -> (group, leaf).
_HF_LEAF = {
    "ln_1.weight": ("ln_1", "g"), "ln_1.bias": ("ln_1", "b"),
    "ln_2.weight": ("ln_2", "g"), "ln_2.bias": ("ln_2", "b"),
    "attn.c_attn.weight": ("attn", "qkv_w"),
    "attn.c_attn.bias": ("attn", "qkv_b"),
    "attn.c_proj.weight": ("attn", "proj_w"),
    "attn.c_proj.bias": ("attn", "proj_b"),
    "mlp.c_fc.weight": ("mlp", "fc_w"), "mlp.c_fc.bias": ("mlp", "fc_b"),
    "mlp.c_proj.weight": ("mlp", "proj_w"),
    "mlp.c_proj.bias": ("mlp", "proj_b"),
}


def params_from_hf(tensors: dict[str, torch.Tensor], cfg: GPT2Config,
                   dtype: torch.dtype = torch.float32) -> dict:
    """Map an HF gpt2 checkpoint (flat name→tensor) onto the param tree,
    on the tensors' device. Accepts bare or ``transformer.``-prefixed
    names; skips ``lm_head.weight`` (tied) and the ``attn.bias`` buffers.
    A tree of ``ShardedTensor``s (a landing over a mesh) gives the tree of
    ``ShardedTensor``s under :func:`param_specs` on the landing's mesh
    (``tensor_parallel.stack_sharded``: a slot's block from its own shard
    where the landing cut it so)."""
    flat = {(n[len("transformer."):] if n.startswith("transformer.")
             else n): t for n, t in tensors.items()}
    stacks: dict[tuple[str, str], list] = {
        key: [None] * cfg.n_layer for key in set(_HF_LEAF.values())}
    for name, t in flat.items():
        m = _HF_BLOCK.match(name)
        if m and m.group(2) in _HF_LEAF:
            stacks[_HF_LEAF[m.group(2)]][int(m.group(1))] = t
    for (group, leaf), layers in stacks.items():
        missing = [i for i, t in enumerate(layers) if t is None]
        if missing:
            raise ValueError(f"checkpoint missing {group}.{leaf} "
                             f"for layers {missing}")
    sharded = is_sharded_tree(tensors)
    if sharded:
        mesh = next(t.mesh for t in tensors.values() if hasattr(t, "mesh"))
        if MODEL_AXIS not in mesh.axis_names:
            raise MeshUnsupported(f"the tree's mesh {mesh.shape} has no "
                                  f"{MODEL_AXIS!r} axis")
        specs = param_specs(cfg)

    def leaf(pieces, path, stacked=True):
        if not sharded:
            return (torch.stack(pieces) if stacked else pieces[0]).to(dtype)
        spec = specs
        for k in path:
            spec = spec[k]
        return tp.stack_sharded(pieces, spec, dtype, stacked=stacked)

    out = {
        "wte": leaf([flat["wte.weight"]], ("wte",), False),
        "wpe": leaf([flat["wpe.weight"]], ("wpe",), False),
        "ln_f": {"g": leaf([flat["ln_f.weight"]], ("ln_f", "g"), False),
                 "b": leaf([flat["ln_f.bias"]], ("ln_f", "b"), False)},
        "blocks": {},
    }
    for (group, name), layers in sorted(stacks.items()):
        out["blocks"].setdefault(group, {})[name] = leaf(
            layers, ("blocks", group, name))
    return out


def params_to_hf(params: dict, cfg: GPT2Config) -> dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_hf`: the stacked tree back to the
    hub's bare GPT-2 names, per layer (Conv1D weights stay ``[in, out]``).
    The JAX package exports Llama-family trees only."""
    out = {"wte.weight": params["wte"], "wpe.weight": params["wpe"],
           "ln_f.weight": params["ln_f"]["g"],
           "ln_f.bias": params["ln_f"]["b"]}
    for layer in range(cfg.n_layer):
        for hf, (group, leaf) in _HF_LEAF.items():
            out[f"h.{layer}.{hf}"] = params["blocks"][group][leaf][layer]
    return out


# ── Sharding rules (data + tensor parallel) ──


def param_specs(cfg: GPT2Config) -> dict:
    """The spec tree matching the param tree (Megatron-style TP), as the
    JAX package's."""
    rep1 = {"g": P(), "b": P()}
    return {
        # wte stays replicated: GPT-2's vocab (50257) divides no mesh axis.
        "wte": P(),
        "wpe": P(),
        "ln_f": dict(rep1),
        "blocks": {
            "ln_1": dict(rep1),
            "ln_2": dict(rep1),
            "attn": {
                "qkv_w": P(None, None, MODEL_AXIS),
                "qkv_b": P(None, MODEL_AXIS),
                "proj_w": P(None, MODEL_AXIS, None),
                "proj_b": P(),
            },
            "mlp": {
                "fc_w": P(None, None, MODEL_AXIS),
                "fc_b": P(None, MODEL_AXIS),
                "proj_w": P(None, MODEL_AXIS, None),
                "proj_b": P(),
            },
        },
    }


def checkpoint_shard_rules() -> list[tuple[str, P]]:
    """Name-pattern rules for landing a raw HF gpt2 checkpoint
    (``models.loader``); wte, wpe and the norms take the loader's
    fallback."""
    return [
        (r"attn\.c_attn\.weight$", P(None, MODEL_AXIS)),
        (r"attn\.c_attn\.bias$", P(MODEL_AXIS)),
        (r"attn\.c_proj\.weight$", P(MODEL_AXIS, None)),
        (r"mlp\.c_fc\.weight$", P(None, MODEL_AXIS)),
        (r"mlp\.c_fc\.bias$", P(MODEL_AXIS)),
        (r"mlp\.c_proj\.weight$", P(MODEL_AXIS, None)),
    ]


def params_from_jax(tree: dict, device="cpu",
                    dtype: torch.dtype = torch.float32) -> dict:
    """A JAX package param tree (``zest_tpu.models.gpt2`` or ``llama``
    ``params_from_hf`` or ``init_params`` output, converted to numpy
    arrays) → the same tree of tensors. Numpy only, so the port never
    imports jax."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked block tree."""
    return {g: {k: v[i] for k, v in leaves.items()}
            for g, leaves in params["blocks"].items()}


# ── Forward ──


def _layer_norm(x, g, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _mlp(x, p, cfg: GPT2Config):
    h = _layer_norm(x, p["ln_2"]["g"], p["ln_2"]["b"], cfg.layer_norm_eps)
    h = F.gelu(h @ p["mlp"]["fc_w"] + p["mlp"]["fc_b"], approximate="tanh")
    return x + h @ p["mlp"]["proj_w"] + p["mlp"]["proj_b"]


def _block(x, p, cfg: GPT2Config):
    return _mlp(_attn(x, p, cfg), p, cfg)


def _attn(x, p, cfg: GPT2Config):
    """The block's attention half: ``x`` plus causal self-attention of
    its layer norm."""
    B, T, E = x.shape
    H = cfg.n_head
    h = _layer_norm(x, p["ln_1"]["g"], p["ln_1"]["b"], cfg.layer_norm_eps)
    qkv = h @ p["attn"]["qkv_w"] + p["attn"]["qkv_b"]
    q, k, v = (t.reshape(B, T, H, E // H).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(E // H)
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    att = torch.softmax(scores, dim=-1)
    out = (att @ v).transpose(1, 2).reshape(B, T, E)
    return x + out @ p["attn"]["proj_w"] + p["attn"]["proj_b"]


def _forward(params: dict, input_ids: torch.Tensor, cfg: GPT2Config,
             remat: bool = False) -> torch.Tensor:
    """:func:`forward` outside inference mode: the training core.
    ``remat=True`` recomputes each block's activations in the backward
    instead of saving them."""
    T = input_ids.shape[1]
    x = params["wte"][input_ids] + params["wpe"][:T]
    for i in range(cfg.n_layer):
        if remat:
            x = checkpoint(_block, x, _layer(params, i), cfg,
                           use_reentrant=False)
        else:
            x = _block(x, _layer(params, i), cfg)
    x = _layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"],
                    cfg.layer_norm_eps)
    return x @ params["wte"].T


@torch.inference_mode()
def forward(params: dict, input_ids: torch.Tensor,
            cfg: GPT2Config) -> torch.Tensor:
    """(B, T) token ids → (B, T, vocab) logits."""
    return _forward(params, input_ids, cfg)


def loss_fn(params: dict, batch: torch.Tensor, cfg: GPT2Config,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross entropy over ``batch`` (B, T+1) ids, float32. A
    tree of ``ShardedTensor``s runs over its mesh's ``model`` axis with the
    batch cut over ``data`` (``tensor_parallel.gpt2_loss``)."""
    if tp.is_sharded_train_tree(params):
        return tp.gpt2_loss(params, batch, cfg, remat)
    return cross_entropy(_forward(params, batch[:, :-1], cfg, remat),
                         batch[:, 1:])


def train_step(params: dict, batch: torch.Tensor, cfg: GPT2Config,
               lr: float = 1e-3, remat: bool = False):
    """One SGD step: ``(new params, loss)``; ``params`` is not changed."""
    loss, grads = value_and_grad(loss_fn, params, batch, cfg, remat)
    return sgd(params, grads, lr), loss


def init_kv_cache(cfg: GPT2Config, batch: int, max_len: int,
                  dtype: torch.dtype = torch.float32,
                  device="cpu") -> dict:
    """Static-shape per-layer K/V cache: (L, B, max_len, H, head_dim)."""
    H = cfg.n_head
    shape = (cfg.n_layer, batch, max_len, H, cfg.n_embd // H)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.inference_mode()
def decode_window(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                  cfg: GPT2Config, last_only: bool = False):
    """Cached step over a token window: (B, S) ids at positions
    ``pos``..``pos+S-1`` → ((B, S, vocab) logits, cache). S=1 is one
    decode step; S=len(prompt) is the batched prefill. ``last_only``
    unembeds only the final position."""
    B, S = tokens.shape
    H, D = cfg.n_head, cfg.n_embd // cfg.n_head
    x = params["wte"][tokens] + params["wpe"][pos:pos + S][None]
    max_len = cache["k"].shape[2]
    valid = (torch.arange(max_len, device=x.device)[None, :]
             <= pos + torch.arange(S, device=x.device)[:, None])
    for i in range(cfg.n_layer):
        lp = _layer(params, i)
        h = _layer_norm(x, lp["ln_1"]["g"], lp["ln_1"]["b"],
                        cfg.layer_norm_eps)
        qkv = h @ lp["attn"]["qkv_w"] + lp["attn"]["qkv_b"]
        q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(cfg.n_embd, -1))
        cache["k"][i, :, pos:pos + S] = k
        cache["v"][i, :, pos:pos + S] = v
        ck, cv = cache["k"][i], cache["v"][i]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, ck) / math.sqrt(D)
        scores = scores.masked_fill(~valid[None, None],
                                    torch.finfo(scores.dtype).min)
        att = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", att, cv).reshape(
            B, S, cfg.n_embd)
        x = x + out @ lp["attn"]["proj_w"] + lp["attn"]["proj_b"]
        x = _mlp(x, lp, cfg)
    x = _layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"],
                    cfg.layer_norm_eps)
    if last_only:
        x = x[:, -1:, :]
    return x @ params["wte"].T, cache


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos: int,
                cfg: GPT2Config):
    """One incremental step: (B,) ids at ``pos`` → ((B, vocab), cache)."""
    logits, cache = decode_window(params, cache, token[:, None], pos, cfg)
    return logits[:, 0, :], cache


def generate_cached(params: dict, cfg: GPT2Config, prompt_ids, steps: int,
                    temperature: float = 0.0, top_k: int | None = None,
                    top_p: float | None = None, seed: int = 0,
                    noise: torch.Tensor | None = None,
                    eos_id: int | tuple[int, ...] | None = None,
                    on_token=None) -> torch.Tensor:
    """KV-cached decode (``sampling.cached_decode_loop``, the prompt in
    one prefill window); greedy by default."""
    from zest_tpu_torch.models.sampling import cached_decode_loop

    return cached_decode_loop(
        init_kv_cache, decode_step, params, cfg, prompt_ids, steps,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        noise=noise, eos_id=eos_id, on_token=on_token,
        prefill_step=decode_window)
