"""Model-family dispatch: config.json → landing shard rules, and the
landing order of tensor names.

The counterpart of ``zest_tpu/models/registry.py``. A landing over a mesh
must know how a family shards before any file is written: this reads the
snapshot's ``model_type`` and returns the family's
``checkpoint_shard_rules`` (None for an unknown family, which the
loader's ``infer_spec`` fallback still lands balanced). The streaming
landing (``models/loader.py``) commits tensors in "usefulness" order, so a
decoder can start once the embedding and layer 0 are resident while later
layers are still on the wire. The priority is a pure function of the
tensor name, so every host (and the cooperative round's fetch order)
computes the same order with no coordination.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Iterable

if TYPE_CHECKING:
    from zest_tpu_torch.models.loader import ShardRules


def _gpt2_rules() -> ShardRules:
    from zest_tpu_torch.models import gpt2

    return gpt2.checkpoint_shard_rules()


def _llama_rules() -> ShardRules:
    from zest_tpu_torch.models import llama

    return llama.checkpoint_shard_rules()


def _moe_rules() -> ShardRules:
    from zest_tpu_torch.models import moe

    return moe.checkpoint_shard_rules()


# model_type (HF config.json) → rules factory. Mistral and Qwen2 dense
# share the Llama tensor layout; Mixtral is the expert-sharded family.
_FAMILIES: dict[str, Callable[[], ShardRules]] = {
    "gpt2": _gpt2_rules,
    "llama": _llama_rules,
    "mistral": _llama_rules,
    "qwen2": _llama_rules,
    "mixtral": _moe_rules,
}

# Families whose checkpoints carry per-expert weight tensors: a pull over
# several slots routes each expert's private xorbs to the slot that owns
# it (``transfer.pod.expert_pod_round``), and the serving pool lands their
# dense core and pages the experts in on demand.
_EXPERT_SHARDED = frozenset({"mixtral"})


def is_expert_sharded(model_type: str | None) -> bool:
    return (model_type or "") in _EXPERT_SHARDED


def shard_rules_for_model_type(model_type: str | None) -> ShardRules | None:
    factory = _FAMILIES.get(model_type or "")
    return factory() if factory else None


def detect_model_type(snapshot_dir: str | Path) -> str | None:
    """``model_type`` from the snapshot's config.json, or None."""
    try:
        cfg = json.loads((Path(snapshot_dir) / "config.json").read_text())
    except (OSError, ValueError):
        return None
    return cfg.get("model_type") if isinstance(cfg, dict) else None


def shard_rules_for_snapshot(snapshot_dir: str | Path) -> ShardRules | None:
    return shard_rules_for_model_type(detect_model_type(snapshot_dir))


# Per-layer tensors: Llama-style ``model.layers.N.``, GPT-2 ``h.N.``
# (optionally ``transformer.h.N.``), generic ``blocks.N.``.
_LAYER_RE = re.compile(r"(?:^|\.)(?:layers|h|blocks)\.(\d+)\.")
# Embedding tensors: needed before any layer can run.
_EMBED_RE = re.compile(
    r"(?:^|\.)(?:embed_tokens|tok_embeddings|embed_positions|wte|wpe)"
    r"(?:$|\.)")

# (group, layer index): 0 = embeddings, 1 = transformer layers by index,
# 2 = everything else (final norm, lm_head, unclassified).
LayerPriority = tuple[int, int]


def layer_priority(name: str) -> LayerPriority:
    """Sortable landing priority of one tensor name: embeddings, then
    layer 0, 1, ..., then the rest (unknown names all in the tail)."""
    m = _LAYER_RE.search(name)
    if m:
        return (1, int(m.group(1)))
    if _EMBED_RE.search(name):
        return (0, 0)
    return (2, 0)


def order_names(names: Iterable[str]) -> list[str]:
    """Names in landing order: a stable sort by :func:`layer_priority`, so
    equal priorities keep their file order."""
    return sorted(names, key=layer_priority)


def first_layer_names(names: Iterable[str]) -> frozenset[str]:
    """The first-token-capable set: the embeddings plus every tensor of
    the lowest-indexed layer present. A checkpoint with no recognizable
    layer structure returns the whole set."""
    names = list(names)
    by_prio = [(layer_priority(n), n) for n in names]
    layer_idxs = [p[1] for p, _n in by_prio if p[0] == 1]
    if not layer_idxs:
        return frozenset(names)
    first = min(layer_idxs)
    return frozenset(n for p, n in by_prio if p[0] == 0 or p == (1, first))
