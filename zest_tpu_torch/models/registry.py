"""Model-family detection and the landing order of tensor names.

The counterpart of ``zest_tpu/models/registry.py``'s expert-sharded
family set, ``detect_model_type`` and its landing order: the streaming landing (``models/loader.py``)
commits tensors in "usefulness" order, so a decoder can start once the
embedding and layer 0 are resident while later layers are still on the
wire. The priority is a pure function of the tensor name, so every host
(and the cooperative round's fetch order) computes the same order with no
coordination. Shard rules come with the multi-GPU slice.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Iterable


# Families whose checkpoints carry per-expert weight tensors (Mixtral;
# Mistral and Qwen2 dense share the Llama layout): the serving pool lands
# their dense core and pages the experts in on demand.
_EXPERT_SHARDED = frozenset({"mixtral"})


def is_expert_sharded(model_type: str | None) -> bool:
    return (model_type or "") in _EXPERT_SHARDED


def detect_model_type(snapshot_dir: str | Path) -> str | None:
    """``model_type`` from the snapshot's config.json, or None."""
    try:
        cfg = json.loads((Path(snapshot_dir) / "config.json").read_text())
    except (OSError, ValueError):
        return None
    return cfg.get("model_type") if isinstance(cfg, dict) else None


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
