"""Seeded checkpoints: the bytes a trainer would publish.

A configuration file (``configs/<name>.json``) names the family
(``model_type``: ``gpt2`` or ``llama``) and its published sizes;
:func:`layout` lists the HF tensors it holds, in the order the file
stores them. :func:`draw` fills them from ``--seed`` on the card with one
``torch.Generator`` in one call (every matrix N(0, 0.02), every norm gain
1 + N(0, 0.02), every bias N(0, 0.02)), in the published dtype, and
:func:`safetensors_blob` frames the bytes as a ``model.safetensors``.

:func:`mutate` is revision B of a checkpoint: the seeded XOR runs of
``zest_tpu_torch/bench_scale.py``'s ``mutate_tensors``, copied here so
that the yardstick does not move with the program.
"""

from __future__ import annotations

import json
import struct

import numpy as np

DTYPES = {"float32": ("F32", 4), "bfloat16": ("BF16", 2)}
# Keys of a configuration file that describe the harness's use of it and
# are not part of the published config.json.
HARNESS_KEYS = ("assumed", "deployment")


def published_config(cfg: dict) -> dict:
    """The config.json a repo of this configuration serves."""
    return {k: v for k, v in cfg.items() if k not in HARNESS_KEYS}


def dtype_of(cfg: dict) -> str:
    return cfg.get("torch_dtype") or "float32"


def layout(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """``(name, shape, kind)`` of every tensor, in file order; ``kind`` is
    ``w`` (matrix), ``g`` (norm gain) or ``b`` (bias)."""
    if cfg["model_type"] == "gpt2":
        E, V, P = cfg["n_embd"], cfg["vocab_size"], cfg["n_positions"]
        out = [("wte.weight", (V, E), "w"), ("wpe.weight", (P, E), "w")]
        for i in range(cfg["n_layer"]):
            p = f"h.{i}."
            out += [(p + "ln_1.weight", (E,), "g"), (p + "ln_1.bias", (E,), "b"),
                    (p + "attn.c_attn.weight", (E, 3 * E), "w"),
                    (p + "attn.c_attn.bias", (3 * E,), "b"),
                    (p + "attn.c_proj.weight", (E, E), "w"),
                    (p + "attn.c_proj.bias", (E,), "b"),
                    (p + "ln_2.weight", (E,), "g"), (p + "ln_2.bias", (E,), "b"),
                    (p + "mlp.c_fc.weight", (E, 4 * E), "w"),
                    (p + "mlp.c_fc.bias", (4 * E,), "b"),
                    (p + "mlp.c_proj.weight", (4 * E, E), "w"),
                    (p + "mlp.c_proj.bias", (E,), "b")]
        return out + [("ln_f.weight", (E,), "g"), ("ln_f.bias", (E,), "b")]
    if cfg["model_type"] == "llama":
        E, F, V = (cfg["hidden_size"], cfg["intermediate_size"],
                   cfg["vocab_size"])
        D = cfg.get("head_dim") or E // cfg["num_attention_heads"]
        qE = cfg["num_attention_heads"] * D
        kvE = cfg["num_key_value_heads"] * D
        out = [("model.embed_tokens.weight", (V, E), "w")]
        for i in range(cfg["num_hidden_layers"]):
            p = f"model.layers.{i}."
            out += [(p + "input_layernorm.weight", (E,), "g"),
                    (p + "self_attn.q_proj.weight", (qE, E), "w"),
                    (p + "self_attn.k_proj.weight", (kvE, E), "w"),
                    (p + "self_attn.v_proj.weight", (kvE, E), "w"),
                    (p + "self_attn.o_proj.weight", (E, qE), "w"),
                    (p + "post_attention_layernorm.weight", (E,), "g"),
                    (p + "mlp.gate_proj.weight", (F, E), "w"),
                    (p + "mlp.up_proj.weight", (F, E), "w"),
                    (p + "mlp.down_proj.weight", (E, F), "w")]
        out.append(("model.norm.weight", (E,), "g"))
        if not cfg.get("tie_word_embeddings", False):
            out.append(("lm_head.weight", (V, E), "w"))
        return out
    raise ValueError(f"no layout for model_type {cfg['model_type']!r}")


def n_params(cfg: dict) -> int:
    return sum(int(np.prod(s)) for _, s, _ in layout(cfg))


def draw(cfg: dict, seed: int, device) -> np.ndarray:
    """The checkpoint's data section (every tensor's bytes in file order)
    as a uint8 array, drawn on ``device`` from ``seed``."""
    import torch

    lay = layout(cfg)
    total = sum(int(np.prod(s)) for _, s, _ in lay)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(0.0, 0.02, generator=gen)
    off = 0
    for _, shape, kind in lay:
        n = int(np.prod(shape))
        if kind == "g":
            flat[off:off + n] += 1.0
        off += n
    dt = getattr(torch, dtype_of(cfg))
    data = flat.to(dt).view(torch.uint8).cpu().numpy()
    del flat
    return data


def header(cfg: dict) -> dict:
    """The safetensors header of the data section :func:`draw` gives."""
    code, size = DTYPES[dtype_of(cfg)]
    doc, off = {}, 0
    for name, shape, _ in layout(cfg):
        nb = int(np.prod(shape)) * size
        doc[name] = {"dtype": code, "shape": list(shape),
                     "data_offsets": [off, off + nb]}
        off += nb
    return doc


def safetensors_blob(cfg: dict, data: np.ndarray) -> bytes:
    """``model.safetensors`` bytes: the little-endian header length, the
    header padded with spaces to 8 bytes, then ``data``."""
    head = json.dumps(header(cfg), separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    return struct.pack("<Q", len(head)) + head + data.tobytes()


def repo_files(cfg: dict, data: np.ndarray) -> dict[str, bytes]:
    """The files of a repo of this checkpoint."""
    return {"config.json": json.dumps(published_config(cfg)).encode(),
            "model.safetensors": safetensors_blob(cfg, data)}


def mutate(cfg: dict, data: np.ndarray, fraction: float,
           seed: int) -> np.ndarray:
    """Revision B: a copy of ``data`` with ~``fraction`` of its bytes
    flipped. Seeded contiguous runs of a seeded subset of tensors (about
    four when the budget allows) are XORed with bytes in [1, 255], so
    every touched byte changes and the CDC damage stays proportional to
    the fraction (``bench_scale.mutate_tensors``' arithmetic)."""
    out = data.copy()
    spans = [(d["data_offsets"][0], d["data_offsets"][1])
             for d in header(cfg).values()]
    total = int(data.nbytes)
    budget = max(1, int(total * fraction))
    rng = np.random.default_rng([int(seed), 0xDE17A])
    per = max(1, budget // 4)
    for k in rng.permutation(len(spans)):
        if budget <= 0:
            break
        lo, hi = spans[k]
        flat = out[lo:hi]
        take = min(flat.size, per, budget) or 1
        start = int(rng.integers(0, flat.size - take + 1))
        flat[start:start + take] ^= rng.integers(1, 256, take,
                                                 dtype=np.uint8)
        budget -= take
    return out
