"""Operations, bytes and the card's published peaks.

The counts are what the inputs need: the matrix products of a Llama
token at its context length (causal attention over the positions before
it, not over the padded cache), and the bytes a landing puts on the card.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "tf32": 495e12}
# PCIe Gen5 x16, one direction (the host link of an H100 SXM board).
H2D_PEAK_BYTES_S = 64e9


def llama_dims(cfg: dict) -> tuple[int, int, int, int, int, int, int]:
    """(E, F, V, layers, heads, kv heads, head dim) of a Llama config."""
    E = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    D = cfg.get("head_dim") or E // H
    return (E, cfg["intermediate_size"], cfg["vocab_size"],
            cfg["num_hidden_layers"], H, cfg["num_key_value_heads"], D)


def llama_layer_matmul_params(cfg: dict) -> int:
    """Weights a token multiplies by in one layer (q, k, v, o, gate, up,
    down)."""
    E, F, _, _, H, KV, D = llama_dims(cfg)
    return 2 * E * H * D + 2 * E * KV * D + 3 * E * F


def llama_forward_flops(cfg: dict, pos0: int, n: int,
                        head_rows: int) -> int:
    """FLOPs of a forward over ``n`` tokens at positions ``pos0``..
    ``pos0+n-1``, unembedding ``head_rows`` of them: 2 per weight a token
    meets, plus q·k and the weighted sum of v over the positions each
    token attends to (itself and those before it)."""
    E, _, V, L, H, _, D = llama_dims(cfg)
    mm = 2 * n * L * llama_layer_matmul_params(cfg)
    attended = n * pos0 + n * (n + 1) // 2
    attn = 4 * L * H * D * attended
    return mm + attn + 2 * head_rows * V * E
