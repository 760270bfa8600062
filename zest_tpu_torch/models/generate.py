"""Snapshot → running model: build GPT-2 from a pulled snapshot and decode.

The counterpart of ``zest_tpu/models/generate.py`` for the GPT-2 family
(llama and MoE come with a later slice), on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from zest_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from zest_tpu_torch.models.sampling import normalize_eos


class UnsupportedModelError(ValueError):
    """config.json names a family with no generation support."""


GENERATE_FAMILIES = ("gpt2",)


def load_generator(snapshot_dir: str | Path, device=DEFAULT_DEVICE,
                   tensors: dict[str, torch.Tensor] | None = None):
    """Build ``(model_type, generate_fn)`` from a pulled snapshot.

    ``tensors`` is an already-landed name→tensor tree (a pull's
    ``PullResult.params``); without it the snapshot's safetensors are
    landed on ``device`` here. ``generate_fn(prompt_ids, steps,
    temperature=0.0, stop_at_eos=True) -> np.ndarray`` decodes greedily
    with a KV cache; when config.json names an ``eos_token_id`` and
    ``stop_at_eos`` is true, rows freeze at their first generated stop id
    and the ids are trimmed just past it. Raises
    :class:`UnsupportedModelError` for other families."""
    from zest_tpu_torch.models import gpt2 as fam
    from zest_tpu_torch.models.loader import load_checkpoint

    snapshot_dir = Path(snapshot_dir)
    cfg_json = json.loads((snapshot_dir / "config.json").read_text())
    model_type = cfg_json.get("model_type")
    if model_type not in GENERATE_FAMILIES:
        raise UnsupportedModelError(
            f"model_type {model_type!r} has no generation support "
            f"(supported: {', '.join(GENERATE_FAMILIES)})")
    dev = resolve_device(device)
    if tensors is None:
        tensors = load_checkpoint(snapshot_dir, dev)
        if not tensors:
            raise FileNotFoundError(
                f"no .safetensors files under {snapshot_dir}")
    else:
        tensors = {n: t.to(dev) for n, t in tensors.items()}
    cfg = fam.GPT2Config.from_hf(cfg_json)
    params = fam.params_from_hf(tensors, cfg)
    eos_ids = normalize_eos(cfg_json.get("eos_token_id"))

    def generate(prompt_ids, steps, temperature=0.0, stop_at_eos=True):
        eos = eos_ids if stop_at_eos else None
        out = fam.generate_cached(params, cfg, prompt_ids, steps,
                                  temperature=temperature,
                                  eos_id=eos).cpu().numpy()
        if eos is not None:
            out = trim_at_eos(out, np.shape(prompt_ids)[-1], eos)
        return out

    return model_type, generate


def trim_at_eos(out: np.ndarray, n_prompt: int,
                eos_id: int | tuple[int, ...]) -> np.ndarray:
    """Cut a decoded row just past its first *generated* stop id; a
    batched (B, T) input keeps its rectangular shape (frozen rows already
    pad with the first stop id)."""
    eos_ids = normalize_eos(eos_id)
    if eos_ids is None:
        return out
    if out.ndim == 2:
        keep = max((_row_end(row, n_prompt, eos_ids) for row in out),
                   default=0)
        return out[:, :keep]
    return out[:_row_end(out, n_prompt, eos_ids)]


def _row_end(row: np.ndarray, n_prompt: int,
             eos_ids: tuple[int, ...]) -> int:
    hits = np.nonzero(np.isin(row[n_prompt:], eos_ids))[0]
    return len(row) if hits.size == 0 else n_prompt + int(hits[0]) + 1
