"""The plain reference that decides ``correct``.

Plain NumPy and PyTorch. It imports nothing of the program under test
(``zest_tpu_torch``) and nothing of the JAX package, and it works from
the bytes the benchmark generated and published, never from what the
program made of them:

- :func:`read_safetensors` reads a published ``model.safetensors``;
  :func:`apply_delta` derives revision B from A's bytes by re-applying
  the seeded XOR runs itself.
- :func:`judge_tree` holds a landed tree (name → tensor on any device)
  to those bytes, tensor by tensor: every byte has to match, so the
  number it gives (``bad_bytes``) is compared with the limit 0.
- :func:`llama_logits` is a float32 Llama forward (HF
  ``LlamaForCausalLM``: RMSNorm, rotate-half RoPE, grouped-query causal
  attention, SwiGLU, tied or untied head) with TF32 off;
  :func:`widest_gap` reads how far below the reference's best logit a
  served token's logit lies.
- :func:`control_tree` and ``llama_logits(..., quant="fp8")`` are the
  controls: the reference put in the program's place in the next
  precision below the configuration's (float8 e4m3 for bfloat16,
  bfloat16 for float32).
"""

from __future__ import annotations

import json
import math
import struct

import numpy as np
import torch

_TORCH_CODE = {torch.float32: "F32", torch.bfloat16: "BF16"}


def read_safetensors(blob: bytes) -> tuple[int, dict]:
    """``(data_start, {name: (code, shape, lo, hi)})`` of a safetensors
    file; offsets are absolute in ``blob``."""
    (n,) = struct.unpack("<Q", blob[:8])
    doc = json.loads(blob[8:8 + n].decode())
    base = 8 + n
    out = {}
    for name, d in doc.items():
        if name == "__metadata__":
            continue
        lo, hi = d["data_offsets"]
        out[name] = (d["dtype"], tuple(d["shape"]), base + lo, base + hi)
    return base, out


def apply_delta(blob: bytes, fraction: float, seed: int) -> bytes:
    """Revision B's file: ``blob`` with ~``fraction`` of its tensor bytes
    XORed by seeded runs (about four tensors; every touched byte
    changes), tensors taken in file order."""
    _, entries = read_safetensors(blob)
    buf = np.frombuffer(blob, dtype=np.uint8).copy()
    spans = sorted((lo, hi) for _, _, lo, hi in entries.values())
    total = sum(hi - lo for lo, hi in spans)
    budget = max(1, int(total * fraction))
    rng = np.random.default_rng([int(seed), 0xDE17A])
    per = max(1, budget // 4)
    order = rng.permutation(len(spans))
    for k in order:
        if budget <= 0:
            break
        lo, hi = spans[k]
        size = hi - lo
        take = min(size, per, budget) or 1
        start = int(rng.integers(0, size - take + 1))
        flips = rng.integers(1, 256, take, dtype=np.uint8)
        buf[lo + start:lo + start + take] ^= flips
        budget -= take
    return buf.tobytes()


def _host_bytes(t: torch.Tensor, staging: torch.Tensor | None) -> np.ndarray:
    """A tensor's bytes on the host (through ``staging``, a pinned uint8
    buffer at least as large, when given)."""
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if flat.device.type == "cpu":
        return flat.numpy()
    if staging is not None and staging.numel() >= flat.numel():
        dst = staging[:flat.numel()]
        dst.copy_(flat)
        return dst.numpy()
    return flat.cpu().numpy()


def judge_tree(tree: dict, blob: bytes,
               staging: torch.Tensor | None = None) -> dict:
    """Hold a landed tree to the published bytes. ``bad_bytes`` counts
    every byte that differs, plus the whole of a tensor that is missing,
    extra, or of another dtype or shape."""
    _, entries = read_safetensors(blob)
    src = np.frombuffer(blob, dtype=np.uint8)
    bad = missing = 0
    for name, (code, shape, lo, hi) in entries.items():
        t = tree.get(name)
        if t is None:
            bad += hi - lo
            missing += 1
            continue
        if _TORCH_CODE.get(t.dtype) != code or tuple(t.shape) != shape:
            bad += hi - lo
            continue
        got = _host_bytes(t, staging)
        want = src[lo:hi]
        if not np.array_equal(got, want):
            bad += int(np.count_nonzero(got != want))
    extra = [n for n in tree if n not in entries]
    for n in extra:
        bad += int(tree[n].numel() * tree[n].element_size())
    return {"bad_bytes": bad, "missing": missing, "extra": len(extra),
            "tensors": len(entries)}


def tensors(blob: bytes, device, names=None) -> dict:
    """The published tensors as torch tensors on ``device`` (their own
    dtype), read from the bytes."""
    _, entries = read_safetensors(blob)
    out = {}
    for name, (code, shape, lo, hi) in entries.items():
        if names is not None and name not in names:
            continue
        raw = torch.frombuffer(bytearray(blob[lo:hi]), dtype=torch.uint8)
        dt = torch.float32 if code == "F32" else torch.bfloat16
        out[name] = raw.view(dt).reshape(shape).to(device)
    return out


def _fp8_round(w: torch.Tensor) -> torch.Tensor:
    """``w`` through float8 e4m3 with one scale a tensor, back in its
    own dtype."""
    x = w.float()
    scale = x.abs().max().clamp_min(1e-12) / 448.0
    q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(w.dtype)


def lower(w: torch.Tensor) -> torch.Tensor:
    """The next precision below ``w``'s, back in ``w``'s dtype: bfloat16
    for float32, float8 e4m3 for bfloat16."""
    if w.dtype == torch.float32:
        return w.to(torch.bfloat16).to(torch.float32)
    return _fp8_round(w)


def control_tree(blob: bytes, device) -> dict:
    """The control of a landing: the reference's tree in the next
    precision below the published one."""
    return {n: lower(t) for n, t in tensors(blob, device).items()}


# ── The float32 Llama forward ──


def _rms(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def _rope(x, theta: float, pos: torch.Tensor):
    """Rotate-half RoPE over (T, H, D) at positions ``pos``."""
    D = x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                  device=x.device) / D)
    ang = (pos.double()[:, None] * inv[None, :]).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def llama_logits(blob: bytes, cfg: dict, tokens, device,
                 quant: str | None = None) -> torch.Tensor:
    """(T, vocab) float32 logits of a token row, every position, from the
    published bytes; ``quant="fp8"`` rounds every weight through float8
    e4m3 first, and every matrix product's input (the control: a forward
    computed in float8). Layer by layer, so it fits beside little."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _llama_logits(blob, cfg, tokens, device, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@torch.no_grad()
def _llama_logits(blob, cfg, tokens, device, quant):
    E = cfg["hidden_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim") or E // H
    eps = cfg.get("rms_norm_eps", 1e-6)
    theta = float(cfg.get("rope_theta", 10000.0))

    def load(names):
        ts = tensors(blob, device, names)
        if quant == "fp8":
            ts = {n: _fp8_round(t) for n, t in ts.items()}
        return {n: t.float() for n, t in ts.items()}

    def act(x):
        """A matrix product's input: float8 e4m3 too in the control."""
        return _fp8_round(x) if quant == "fp8" else x

    tok = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                          device=device)
    T = tok.shape[0]
    pos = torch.arange(T, device=device)
    emb = load({"model.embed_tokens.weight"})["model.embed_tokens.weight"]
    x = emb[tok]
    mask = torch.ones(T, T, dtype=torch.bool, device=device).tril()
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        w = load({p + s for s in (
            "input_layernorm.weight", "self_attn.q_proj.weight",
            "self_attn.k_proj.weight", "self_attn.v_proj.weight",
            "self_attn.o_proj.weight", "post_attention_layernorm.weight",
            "mlp.gate_proj.weight", "mlp.up_proj.weight",
            "mlp.down_proj.weight")})
        h = act(_rms(x, w[p + "input_layernorm.weight"], eps))
        q = (h @ w[p + "self_attn.q_proj.weight"].T).reshape(T, H, D)
        k = (h @ w[p + "self_attn.k_proj.weight"].T).reshape(T, KV, D)
        v = (h @ w[p + "self_attn.v_proj.weight"].T).reshape(T, KV, D)
        q, k = _rope(q, theta, pos), _rope(k, theta, pos)
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
        s = s.masked_fill(~mask, float("-inf")).softmax(-1)
        a = act(torch.einsum("hqk,khd->qhd", s, v).reshape(T, H * D))
        x = x + a @ w[p + "self_attn.o_proj.weight"].T
        h = act(_rms(x, w[p + "post_attention_layernorm.weight"], eps))
        g = h @ w[p + "mlp.gate_proj.weight"].T
        u = h @ w[p + "mlp.up_proj.weight"].T
        x = x + act(torch.nn.functional.silu(g) * u) @ w[
            p + "mlp.down_proj.weight"].T
    norm = load({"model.norm.weight"})["model.norm.weight"]
    x = act(_rms(x, norm, eps))
    if cfg.get("tie_word_embeddings", False):
        head = emb
    else:
        head = load({"lm_head.weight"})["lm_head.weight"]
    return x @ head.T


def gaps(logits: torch.Tensor, tokens, n0: int,
         chosen=None) -> torch.Tensor:
    """For each position that produced tokens ``n0``..``T-1``, how far
    the logit of the token there (``chosen``'s instead, when given: one
    per position) lies below the reference's best at that position."""
    tok = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                          device=logits.device)
    rows = logits[n0 - 1:tok.shape[0] - 1]
    pick = tok[n0:] if chosen is None else chosen[n0 - 1:tok.shape[0] - 1]
    return rows.max(-1).values - rows.gather(-1, pick[:, None])[:, 0]


def widest_gap(logits: torch.Tensor, tokens, n0: int,
               chosen=None) -> float:
    """The widest of :func:`gaps`."""
    g = gaps(logits, tokens, n0, chosen)
    return float(g.max()) if g.numel() else 0.0
