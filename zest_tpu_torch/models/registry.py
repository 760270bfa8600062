"""Model-family detection from a snapshot's config.json.

Only ``detect_model_type`` of ``zest_tpu/models/registry.py`` is part of
this slice; shard rules and landing order come with the multi-GPU and
streaming slices.
"""

from __future__ import annotations

import json
from pathlib import Path


def detect_model_type(snapshot_dir: str | Path) -> str | None:
    """``model_type`` from the snapshot's config.json, or None."""
    try:
        cfg = json.loads((Path(snapshot_dir) / "config.json").read_text())
    except (OSError, ValueError):
        return None
    return cfg.get("model_type") if isinstance(cfg, dict) else None
