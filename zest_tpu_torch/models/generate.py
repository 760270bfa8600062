"""Snapshot → running model: build a family model from a pulled snapshot
and decode.

The counterpart of ``zest_tpu/models/generate.py`` for GPT-2, the Llama
family (``llama``, ``mistral``, ``qwen2``) and Mixtral, on ``cuda``
unless the caller passes ``device="cpu"``. The JAX
package also arms jax's persistent compile cache here
(``enable_compile_cache``); a torch decode compiles nothing, so there is
no counterpart.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from zest_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from zest_tpu_torch.models.sampling import normalize_eos
from zest_tpu_torch.parallel.sharding import is_sharded_tree


class UnsupportedModelError(ValueError):
    """config.json names a family with no generation support."""


GENERATE_FAMILIES = ("gpt2", "llama", "mistral", "qwen2", "mixtral")


def snapshot_tensors(snapshot_dir: str | Path) -> dict[str, torch.Tensor]:
    """All tensors of a snapshot as a flat name→CPU-tensor dict, read
    from its safetensors files (contrast ``loader.load_checkpoint``,
    which lands them on a device). Raises ``FileNotFoundError`` when
    there is none."""
    from zest_tpu_torch.models.loader import snapshot_files
    from zest_tpu_torch.models.safetensors_io import SafetensorsFile

    tensors: dict[str, torch.Tensor] = {}
    for path in snapshot_files(snapshot_dir):
        with SafetensorsFile(path) as sf:
            for name in sf.names():
                tensors[name] = sf.tensor(name)
    if not tensors:
        raise FileNotFoundError(
            f"no .safetensors files under {snapshot_dir}")
    return tensors


def load_generator(snapshot_dir: str | Path, device=DEFAULT_DEVICE,
                   tensors: dict[str, torch.Tensor] | None = None):
    """Build ``(model_type, generate_fn)`` from a pulled snapshot.

    ``tensors`` is an already-landed name→tensor tree (a pull's
    ``PullResult.params``); without it the snapshot's safetensors are
    landed on ``device`` here. A tree sharded over a mesh stays on its
    slots: Llama-family and Mixtral trees decode tensor- and
    expert-parallel from it, GPT-2 is gathered once. The family's float32 tree is built from
    it on ``device``; the landed dict is not kept (a caller that drops
    its own reference frees it).

    ``generate_fn(prompt_ids, steps, temperature=0.0, top_k=None,
    top_p=None, seed=0, stop_at_eos=True, on_token=None, noise=None) ->
    np.ndarray`` decodes with a KV cache: greedy by default, sampled when
    ``temperature > 0`` (optionally top-k and/or nucleus restricted, the
    draw seeded by ``seed``, or given as Gumbel ``noise``; see
    ``sampling.cached_decode_loop``). When config.json names an
    ``eos_token_id`` and ``stop_at_eos`` is true, rows freeze at their
    first generated stop id and the ids are trimmed just past it.
    ``on_token(pos, tokens)`` sees each generated position. The function
    carries the stop ids as ``generate_fn.eos_ids``.

    Raises :class:`UnsupportedModelError` for other families and
    ``FileNotFoundError`` for missing weights."""
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
    elif not is_sharded_tree(tensors):
        tensors = {n: t.to(dev) for n, t in tensors.items()}
    if model_type == "gpt2":
        from zest_tpu_torch.models import gpt2 as fam

        cfg = fam.GPT2Config.from_hf(cfg_json)
    elif model_type == "mixtral":
        from zest_tpu_torch.models import moe as fam

        cfg = fam.MoEConfig.from_hf(cfg_json)
    else:  # the llama family
        from zest_tpu_torch.models import llama as fam

        cfg = fam.LlamaConfig.from_hf(cfg_json)
    params = fam.params_from_hf(tensors, cfg)
    del tensors
    eos_ids = eos_token_ids(cfg_json)

    def generate(prompt_ids, steps, temperature=0.0, top_k=None, top_p=None,
                 seed=0, stop_at_eos=True, on_token=None, noise=None):
        eos = eos_ids if stop_at_eos else None
        out = fam.generate_cached(
            params, cfg, prompt_ids, steps, temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed, noise=noise, eos_id=eos,
            on_token=on_token).cpu().numpy()
        if eos is not None:
            out = trim_at_eos(out, np.shape(prompt_ids)[-1], eos)
        return out

    generate.eos_ids = eos_ids  # callers filter streamed stop ids on it
    return model_type, generate


def eos_token_ids(cfg_json: dict) -> tuple[int, ...] | None:
    """The stop ids config.json names (``eos_token_id``: one int or a
    list), or None."""
    return normalize_eos(cfg_json.get("eos_token_id"))


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


# Files whose presence means "this snapshot ships a tokenizer". Checked
# before importing transformers: that import is slow, and for a snapshot
# with no tokenizer its only job would be to fail.
_TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "tokenizer.model",
    "spiece.model", "vocab.json", "vocab.txt", "merges.txt",
)


def try_tokenizer(snapshot_dir: str | Path):
    """The snapshot's tokenizer via transformers, or None (fixture repos
    and minimal pulls carry no tokenizer files, and a machine may have no
    transformers; callers then work in raw token ids). Offline only: the
    snapshot is local by construction."""
    snapshot_dir = Path(snapshot_dir)
    if not any((snapshot_dir / n).exists() for n in _TOKENIZER_FILES):
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(str(snapshot_dir),
                                             local_files_only=True)
    except Exception:  # noqa: BLE001 - absence of a tokenizer is normal
        return None
