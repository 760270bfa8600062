"""Revision manifests: the persisted file → term-list evidence.

The manifest half of ``zest_tpu/transfer/delta.py``, same file layout and
JSON shape (``cache_dir/manifests/models--{org}--{name}@{sha}.json``), so
the push records what the publisher endpoint later serves. The delta
planner itself waits for a later slice.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from zest_tpu_torch import storage
from zest_tpu_torch.cas import reconstruction as recon

MANIFEST_FORMAT = 1


def manifest_dir(cfg) -> Path:
    return cfg.cache_dir / "manifests"


def manifest_path(cfg, repo_id: str, commit_sha: str) -> Path:
    safe = "models--" + repo_id.replace("/", "--")
    return manifest_dir(cfg) / f"{safe}@{commit_sha}.json"


def terms_of(rec: recon.Reconstruction) -> list[list]:
    """Terms in the manifest wire shape:
    ``[hash_hex, chunk_start, chunk_end, unpacked_length]``."""
    return [[t.hash_hex, t.range.start, t.range.end, t.unpacked_length]
            for t in rec.terms]


def save_manifest(cfg, repo_id: str, commit_sha: str, entries,
                  rec_of, parent: str | None = None) -> bool:
    """Persist this revision's file → term-list map (atomic write).

    ``rec_of(entry)`` returns the entry's Reconstruction or None; the
    manifest is written only when every xet file's terms are known
    (complete or nothing). ``parent`` records lineage. Returns whether a
    manifest was written."""
    files: dict[str, dict] = {}
    for entry in entries:
        if not entry.is_xet:
            continue
        rec = rec_of(entry)
        if rec is None:
            return False
        files[entry.path] = {
            "size": int(entry.size),
            "xet_hash": entry.xet_hash,
            "terms": terms_of(rec),
        }
    doc = {
        "format": MANIFEST_FORMAT,
        "repo": repo_id,
        "revision": commit_sha,
        "saved_at": round(time.time(), 3),
        "files": files,
    }
    if parent and parent != commit_sha:
        doc["parent"] = parent
    storage.atomic_write(manifest_path(cfg, repo_id, commit_sha),
                         json.dumps(doc).encode())
    return True


def load_manifest(cfg, repo_id: str, commit_sha: str) -> dict | None:
    try:
        doc = json.loads(
            manifest_path(cfg, repo_id, commit_sha).read_text())
    except (OSError, ValueError):
        return None
    if (not isinstance(doc, dict)
            or doc.get("format") != MANIFEST_FORMAT
            or not isinstance(doc.get("files"), dict)):
        return None
    return doc
