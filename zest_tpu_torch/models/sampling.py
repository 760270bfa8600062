"""Token sampling and the shared cached-decode loop for every family.

The counterpart of ``zest_tpu/models/sampling.py``. The draw is
Gumbel-max, as ``jax.random.categorical`` draws: the token is
``argmax(logits + g)`` with ``g = -log(-log(U))``. The JAX package takes
``U`` from ``jax.random``; here it comes from a ``torch.Generator``
seeded by the caller, so one seed gives other tokens than the JAX
package's. Callers (and the tests) may pass the noise ``g`` itself: with
the JAX package's ``jax.random.gumbel`` noise injected, the two pick the
same tokens.

The JAX package streams tokens through a relay of ordered host callbacks
out of its jitted loop; the loop here is plain Python, so ``on_token`` is
called after each step.
"""

from __future__ import annotations

import traceback
from typing import Callable

import torch

from zest_tpu_torch.models import tensor_parallel as tp

def normalize_eos(eos) -> tuple[int, ...] | None:
    """HF's ``eos_token_id`` (one int, a list, or None) → tuple or None."""
    if eos is None:
        return None
    if isinstance(eos, (tuple, list)):
        return tuple(int(e) for e in eos) or None
    return (int(eos),)


def gumbel_noise(shape, generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """Float32 Gumbel noise ``-log(-log(U))``, ``U`` uniform on
    ``[tiny, 1)`` (as ``jax.random.gumbel`` bounds it), drawn from
    ``generator``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))


def check_top_p(top_p: float | None) -> None:
    if top_p is not None and not 0.0 < top_p <= 1.0:
        # A silently ignored top_p=0 would turn the most restrictive
        # request into unrestricted sampling (HF raises here too).
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def sample_scores(logits: torch.Tensor, temperature: float,
                  top_k: int | None = None,
                  top_p: float | None = None) -> torch.Tensor:
    """(..., vocab) logits → the float32 scores the draw perturbs:
    ``logits / temperature``, with every token outside the ``top_k`` most
    likely and outside the nucleus of mass ``top_p`` at ``-inf``.
    ``temperature`` must be positive."""
    check_top_p(top_p)
    scores = logits.float() / temperature
    if top_k is not None and top_k > 0:
        # k > vocab means "no restriction", not a top_k error.
        k = min(int(top_k), scores.shape[-1])
        kth = torch.topk(scores, k, dim=-1).values[..., -1:]
        scores = scores.masked_fill(scores < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        # Nucleus: keep the smallest prefix of the sorted distribution
        # whose mass reaches top_p. ``cum - probs < top_p`` keeps every
        # token whose mass *before* it is under the budget, so the most
        # likely token always survives and the token that crosses the
        # budget is included (HF semantics). The mask goes back by sorted
        # *position*, not by value, so ties at the boundary do not widen
        # the nucleus (the sort is stable: the earliest index of equal
        # scores wins, as in HF).
        order = torch.argsort(-scores, dim=-1, stable=True)
        probs = torch.softmax(scores.gather(-1, order), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        scores = scores.masked_fill(~keep, float("-inf"))
    return scores


def sample_token(logits: torch.Tensor, temperature: float = 0.0,
                 top_k: int | None = None, top_p: float | None = None,
                 noise: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """One token per row of (..., vocab) logits: greedy at
    ``temperature <= 0``, otherwise a softmax draw at that temperature,
    optionally restricted to the ``top_k`` most likely tokens and/or the
    nucleus of cumulative probability ``top_p``. The draw is
    ``argmax(scores + noise)``; ``noise`` (Gumbel, the logits' shape)
    defaults to a draw from ``generator``. Raises ``ValueError`` for a
    ``top_p`` outside (0, 1]."""
    check_top_p(top_p)
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    scores = sample_scores(logits, temperature, top_k, top_p)
    if noise is None:
        noise = gumbel_noise(scores.shape, generator, scores.device)
    return (scores + noise.to(scores.device)).argmax(dim=-1)


@torch.inference_mode()
def cached_decode_loop(init_kv_cache: Callable, decode_step: Callable,
                       params, cfg, prompt_ids, steps: int,
                       temperature: float = 0.0, top_k: int | None = None,
                       top_p: float | None = None, seed: int = 0,
                       noise: torch.Tensor | None = None,
                       eos_id: int | tuple[int, ...] | list[int] | None = None,
                       on_token: Callable | None = None,
                       prefill_step: Callable | None = None) -> torch.Tensor:
    """Prefill the prompt through a static-shape KV cache, then produce
    ``steps`` tokens one cached step at a time.

    ``prompt_ids`` is (T0,) → returns (T0+steps,), or (B, T0) equal-length
    prompts → (B, T0+steps), each row decoded independently. With
    ``prefill_step`` (the family's ``decode_window``) the whole prompt is
    one batched call; without it the prompt replays through
    ``decode_step``. Both paths give the same tokens.

    Greedy at ``temperature`` 0; otherwise sampled (see
    :func:`sample_token`). The token written at position ``p + 1`` is
    drawn with the noise of position ``p``: ``noise`` is a
    (T0+steps-1, B, vocab) float32 tensor laid out as the JAX package
    splits its keys (row ``p`` of its ``split(key, (T0+steps-1)*B)``
    grid), or, without it, each sampled position's (B, vocab) noise is
    drawn in turn from a generator on the params' device seeded with
    ``seed``.

    ``eos_id`` gives HF stop semantics at a fixed length: once a row
    *generates* any stop id, its later tokens are the first stop id.
    Prompt and stop ids outside the vocabulary raise ``ValueError``.

    ``on_token(pos, tokens)`` is called after each step with the position
    just written and its (B,) tokens as a numpy array: on the prefill path
    only generated positions, on the sequential path the prompt replay
    positions too (filter on ``pos >= T0`` either way). An exception it
    raises is printed and dropped; the decode goes on.

    A tree sharded over a mesh decodes through ``tensor_parallel``'s
    cache and steps in place of the family's: a ``TPParams`` tree as it
    is, a training tree of ``ShardedTensor``s through the ``TPParams``
    built from it (``tensor_parallel.decode_params``)."""
    check_top_p(top_p)
    if tp.is_sharded_train_tree(params):
        params = tp.decode_params(params, cfg)
    init_kv_cache, decode_step, prefill_step = tp.decode_fns(
        params, init_kv_cache, decode_step, prefill_step)
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
    # An id past the embedding would fault the lookup (on a card, the
    # whole context); the JAX package's gather clamps it instead.
    if n0 and not (0 <= int(prompt.min()) and int(prompt.max())
                   < cfg.vocab_size):
        raise ValueError(f"prompt ids must be in [0, {cfg.vocab_size})")
    if eos is not None and not all(0 <= e < cfg.vocab_size for e in eos):
        raise ValueError(f"stop ids {eos} must be in [0, {cfg.vocab_size})")
    sampled = temperature > 0.0
    generator = None
    if sampled and noise is None:
        generator = torch.Generator(device=device).manual_seed(int(seed))
    if sampled and noise is not None and tuple(noise.shape[:2]) != (
            total - 1, B):
        raise ValueError(f"noise of shape {tuple(noise.shape)} for "
                         f"{total - 1} positions x {B} rows")
    eos_t = (torch.tensor(eos, dtype=torch.long, device=device)
             if eos is not None else None)

    def choose(logits, pos):
        """The token written at ``pos + 1`` from (B, vocab) logits."""
        if not sampled:
            return logits.argmax(dim=-1)
        g = noise[pos] if noise is not None else None
        return sample_token(logits, temperature, top_k, top_p, noise=g,
                            generator=generator)

    def report(pos, tokens):
        if on_token is None:
            return
        try:
            on_token(pos, tokens.cpu().numpy())
        except Exception:  # noqa: BLE001 - a caller's callback
            traceback.print_exc()

    cache = init_kv_cache(cfg, B, total, dtype=params["wte"].dtype,
                          device=device)
    buf = torch.zeros(B, total, dtype=torch.long, device=device)
    buf[:, :n0] = prompt
    done = torch.zeros(B, dtype=torch.bool, device=device)
    start = 0
    if prefill_step is not None and n0 > 1 and steps > 0:
        logits, cache = prefill_step(params, cache, prompt, 0, cfg,
                                     last_only=True)
        nxt = choose(logits[:, -1, :], n0 - 1)
        if eos_t is not None:
            done = torch.isin(nxt, eos_t)
        buf[:, n0] = nxt
        report(n0, nxt)
        start = n0
    for pos in range(start, total - 1):
        logits, cache = decode_step(params, cache, buf[:, pos], pos, cfg)
        if pos + 1 < n0:  # prompt positions keep their token
            report(pos + 1, buf[:, pos + 1])
            continue
        nxt = choose(logits, pos)
        if eos_t is not None:
            nxt = torch.where(done, eos_t[0], nxt)
            done = done | torch.isin(nxt, eos_t)
        buf[:, pos + 1] = nxt
        report(pos + 1, nxt)
    return buf if batched else buf[0]
