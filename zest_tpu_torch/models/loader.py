"""Checkpoint landing: safetensors → tensors in device memory.

The counterpart of ``zest_tpu/models/loader.py`` for the disk-staging
landing (files first, then :func:`stage_snapshot_to_hbm`). Where the JAX
package lays ``jax.Array``s out over a mesh, this lands ``torch.Tensor``s
on one device; multi-GPU placement, the streaming landing and the direct
landing come with later slices.

:func:`commit_tensors` is one pinned, batched host→device copy per call:
every tensor's bytes are packed into one pinned staging buffer (each
tensor 16-byte aligned), copied in one transfer, and split back into
typed views on the device. The copy moves raw bytes, so NaN payloads and
sub-word float bits land unchanged; a landing ``dtype`` casts only
floating tensors, never int or bool ones. The landed tensors are views
of one device buffer per call, which lives while any of them does.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from zest_tpu_torch.cas import hashing
from zest_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from zest_tpu_torch.models.safetensors_io import SafetensorsFile, tensor_bytes

_ALIGN = 16


def snapshot_files(snapshot_dir: str | Path) -> list[Path]:
    return sorted(Path(snapshot_dir).glob("*.safetensors"))


def commit_tensors(host: dict[str, torch.Tensor], device=DEFAULT_DEVICE,
                   dtype: torch.dtype | None = None
                   ) -> dict[str, torch.Tensor]:
    """Land a name→CPU-tensor dict on ``device`` in one batched copy.

    ``dtype`` casts floating tensors on the host first (fewer bytes to
    move); int and bool tensors keep their dtype. Caller order is kept."""
    dev = resolve_device(device)
    if dtype is not None:
        host = {n: t.to(dtype) if t.dtype.is_floating_point else t
                for n, t in host.items()}
    offsets, total = {}, 0
    for name, t in host.items():
        offsets[name] = total
        total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    staging = torch.empty(total, dtype=torch.uint8,
                          pin_memory=dev.type == "cuda")
    packed = staging.numpy()
    for name, t in host.items():
        raw = tensor_bytes(t)
        packed[offsets[name]:offsets[name] + raw.nbytes] = raw
    landed = (staging.to(dev, non_blocking=True) if dev.type == "cuda"
              else staging)
    out = {}
    for name, t in host.items():
        n = t.numel() * t.element_size()
        piece = landed[offsets[name]:offsets[name] + n]
        out[name] = piece.view(t.dtype).reshape(t.shape)
    if dev.type == "cuda":
        # The pinned staging buffer must outlive the async copy.
        torch.cuda.current_stream(dev).synchronize()
    return out


def load_checkpoint(snapshot_dir: str | Path,
                    device=DEFAULT_DEVICE) -> dict[str, torch.Tensor]:
    """All tensors of a snapshot as a flat name→tensor dict on ``device``,
    one batched commit per safetensors file."""
    out: dict[str, torch.Tensor] = {}
    for path in snapshot_files(snapshot_dir):
        with SafetensorsFile(path) as sf:
            host = {name: sf.tensor(name) for name in sf.names()}
            out.update(commit_tensors(host, device))
            del host
    return out


def params_digest(params: dict[str, torch.Tensor]) -> str:
    """Order-independent BLAKE3 digest of a landed tree: name, dtype,
    shape and raw bytes of every tensor, fetched back to the host.

    Hashes dtype and shape in numpy's spelling (``float32``, ``(768,)``),
    so it equals the JAX package's ``params_digest`` of the same tensors."""
    leaves = []
    for name in sorted(params):
        t = params[name]
        dtype_name = str(t.dtype).removeprefix("torch.")
        leaves.append(hashing.blake3_hash(
            name.encode() + b"\x00" + dtype_name.encode()
            + b"\x00" + repr(tuple(t.shape)).encode() + b"\x00"
            + tensor_bytes(t).tobytes()))
    return hashing.blake3_hash(b"".join(leaves)).hex()


def _commit_stats(params: dict, dt: float) -> dict:
    total = sum(t.numel() * t.element_size() for t in params.values())
    return {
        "tensors": len(params),
        "bytes": total,
        "elapsed_s": round(dt, 3),
        "gbps": round(total / dt / 1e9, 3) if dt > 0 else 0.0,
        "sharded": False,
        "direct": False,
    }


def stage_snapshot_to_hbm(snapshot_dir: str | Path, device=DEFAULT_DEVICE
                          ) -> tuple[dict[str, torch.Tensor], dict]:
    """Disk-path commit of a pulled snapshot into device memory.

    Returns ``(params, stats)``; ``stats`` is the block reported under
    the pull's ``stats["hbm"]`` (tensors, bytes, wall time, host→device
    GB/s). The name keeps the JAX package's: "hbm" is the card's memory."""
    dev = resolve_device(device)
    t0 = time.monotonic()
    params = load_checkpoint(snapshot_dir, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return params, _commit_stats(params, time.monotonic() - t0)
