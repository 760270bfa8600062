"""Device ops: the hand-written CUDA kernels and their plain versions.

``ops/blake3.py`` is the plain PyTorch BLAKE3; ``ops/blake3_cuda.py`` the
CUDA kernel that replaces the JAX package's Pallas verifier. Importing
this package builds nothing and needs no card.
"""

from __future__ import annotations

from zest_tpu_torch.config import resolve_device
from zest_tpu_torch.ops.blake3 import DeviceHasher
from zest_tpu_torch.ops.blake3_cuda import CudaHasher

__all__ = ["CudaHasher", "DeviceHasher", "unit_verify_hasher"]


def unit_verify_hasher(key: bytes | None = None, device="cuda"):
    """Hasher for whole-unit trust-boundary verification: the CUDA kernel
    on ``cuda`` (the default; raises where there is no card), the plain
    PyTorch version on ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return CudaHasher(key, dev)
    return DeviceHasher(key, dev)
