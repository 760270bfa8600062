"""``huggingface_hub`` integration: ``snapshot_download`` through zest.

The counterpart of ``zest_tpu/api/hf_backend.py``: monkey-patches
``huggingface_hub.snapshot_download`` so ``from_pretrained()`` pulls
through the swarm, and falls back to the original download when the zest
pull raises: zest must never make a download fail that would otherwise
succeed. ``huggingface_hub`` is imported only here, when patching; a
missing package raises ``ImportError``.
"""

from __future__ import annotations

_original_snapshot_download = None


def patch_hf_hub(client) -> None:
    global _original_snapshot_download
    import huggingface_hub

    if _original_snapshot_download is not None:
        return  # already patched

    original = huggingface_hub.snapshot_download

    def zest_snapshot_download(repo_id: str, *args, **kwargs):
        revision = kwargs.get("revision") or "main"
        try:
            return str(client.pull(repo_id, revision=revision))
        except Exception:  # noqa: BLE001 - the hub's own download serves
            return original(repo_id, *args, **kwargs)

    _original_snapshot_download = original
    huggingface_hub.snapshot_download = zest_snapshot_download


def unpatch_hf_hub() -> None:
    global _original_snapshot_download
    if _original_snapshot_download is None:
        return
    import huggingface_hub

    huggingface_hub.snapshot_download = _original_snapshot_download
    _original_snapshot_download = None
