"""Greedy token choice and the shared cached-decode loop.

The greedy path of ``zest_tpu/models/sampling.py``. Sampled decoding
(temperature, top-k, top-p) draws from ``jax.random`` there and waits for
a later slice here; asking for it raises.
"""

from __future__ import annotations

from typing import Callable

import torch


def normalize_eos(eos) -> tuple[int, ...] | None:
    """HF's ``eos_token_id`` (one int, a list, or None) → tuple or None."""
    if eos is None:
        return None
    if isinstance(eos, (tuple, list)):
        return tuple(int(e) for e in eos) or None
    return (int(eos),)


@torch.inference_mode()
def cached_decode_loop(init_kv_cache: Callable, decode_step: Callable,
                       params, cfg, prompt_ids, steps: int,
                       temperature: float = 0.0,
                       eos_id: int | tuple[int, ...] | list[int] | None = None,
                       prefill_step: Callable | None = None) -> torch.Tensor:
    """Prefill the prompt through a static-shape KV cache, then produce
    ``steps`` greedy tokens one cached step at a time.

    ``prompt_ids`` is (T0,) → returns (T0+steps,), or (B, T0) equal-length
    prompts → (B, T0+steps). With ``prefill_step`` (the family's
    ``decode_window``) the whole prompt is one batched call. ``eos_id``
    gives HF stop semantics at a fixed length: once a row *generates* any
    stop id, its later tokens are the first stop id. Same token layout as
    the JAX package's loop at temperature 0."""
    if temperature > 0.0:
        raise NotImplementedError(
            "sampled decoding is not ported yet; use temperature=0")
    device = params["wte"].device
    prompt = torch.as_tensor(prompt_ids, dtype=torch.long, device=device)
    batched = prompt.dim() == 2
    if not batched:
        prompt = prompt[None, :]
    B, n0 = prompt.shape
    total = n0 + steps
    if total > cfg.n_ctx:
        raise ValueError(f"prompt ({n0}) + steps ({steps}) = {total} "
                         f"exceeds n_ctx {cfg.n_ctx}")
    eos = normalize_eos(eos_id)
    eos_t = (torch.tensor(eos, dtype=torch.long, device=device)
             if eos is not None else None)
    cache = init_kv_cache(cfg, B, total, dtype=params["wte"].dtype,
                          device=device)
    buf = torch.zeros(B, total, dtype=torch.long, device=device)
    buf[:, :n0] = prompt
    done = torch.zeros(B, dtype=torch.bool, device=device)
    start = 0
    if prefill_step is not None and n0 > 1 and steps > 0:
        logits, cache = prefill_step(params, cache, prompt, 0, cfg,
                                     last_only=True)
        nxt = logits[:, -1, :].argmax(dim=-1)
        if eos_t is not None:
            done = torch.isin(nxt, eos_t)
        buf[:, n0] = nxt
        start = n0
    for pos in range(start, total - 1):
        logits, cache = decode_step(params, cache, buf[:, pos], pos, cfg)
        nxt = logits.argmax(dim=-1)
        if eos_t is not None:
            nxt = torch.where(done, eos_t[0], nxt)
            if pos + 1 >= n0:
                done = done | torch.isin(nxt, eos_t)
        if pos + 1 >= n0:  # prompt positions keep their token
            buf[:, pos + 1] = nxt
    return buf if batched else buf[0]
