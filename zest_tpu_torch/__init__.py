"""zest-tpu-torch: the PyTorch/CUDA port of zest-tpu, for an NVIDIA H100.

A second package beside ``zest_tpu`` (the JAX reference, which it never
imports). It runs push → pull → generate on one card: CDC-dedup
publishing with every minted chunk re-verified by the CUDA BLAKE3 kernel
(``csrc/blake3.cu``), a pull through the cache → peer → CDN waterfall
landing every tensor in device memory, a node seeding its xorb cache to
its peers over the BT wire, a multi-tenant pull service behind the
daemon's ``POST /v1/pull``, and KV-cached decoding from the landed tree.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

Public API (mirrors ``zest_tpu``'s)::

    import zest_tpu_torch as zest
    zest.enable()                  # start the daemon, patch huggingface_hub
    path = zest.pull("openai-community/gpt2")   # files only
    res = zest.pull("openai-community/gpt2", device="cuda")  # and land
    zest.status(); zest.stop(); zest.disable()

``ZEST=1`` in the environment enables at import.
"""

from __future__ import annotations

import os as _os

__version__ = "0.1.0"

_client = None
_server = None


def _get_server():
    global _server
    if _server is None:
        from zest_tpu_torch.api.daemon import ZestServer

        _server = ZestServer()
    return _server


def _get_client():
    global _client
    if _client is None:
        from zest_tpu_torch.api.client import ZestClient

        _client = ZestClient()
    return _client


def enable() -> None:
    """Start the local daemon and patch ``huggingface_hub`` so that
    ``snapshot_download`` pulls through zest."""
    _get_server().ensure_running()
    from zest_tpu_torch.api import hf_backend

    hf_backend.patch_hf_hub(_get_client())


def disable() -> None:
    """Undo :func:`enable`'s patch."""
    from zest_tpu_torch.api import hf_backend

    hf_backend.unpatch_hf_hub()


def pull(repo_id: str, revision: str = "main", device: str | None = None):
    """Pull a model; returns the result, os.PathLike for the snapshot
    directory. ``device=None`` writes the files only; ``"cuda"`` also
    lands the tree on the card (``.params``), ``"cpu"`` on the CPU."""
    return _get_client().pull(repo_id, revision=revision, device=device)


def status() -> dict:
    """The local daemon's ``/v1/status``."""
    return _get_client().status()


def stop() -> None:
    """Stop the local daemon."""
    _get_server().stop()


if _os.environ.get("ZEST") == "1":  # pragma: no cover - import side effect
    try:
        enable()
    except Exception as _exc:  # noqa: BLE001 - reported, import goes on
        import warnings as _warnings

        _warnings.warn(f"ZEST=1: zest_tpu_torch.enable() failed: {_exc}",
                       RuntimeWarning, stacklevel=2)
