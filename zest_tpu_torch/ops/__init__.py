"""Device ops: the hand-written CUDA kernels and their plain versions.

``ops/blake3.py`` is the plain PyTorch BLAKE3 and ``ops/blake3_cuda.py``
the CUDA kernel that replaces the JAX package's Pallas verifier;
``ops/bg4.py`` the plain BG4 regroup and fused regroup → BLAKE3 pass, and
``ops/bg4_cuda.py`` their CUDA kernels. Importing this package builds
nothing and needs no card.
"""

from __future__ import annotations

from zest_tpu_torch.config import resolve_device
from zest_tpu_torch.ops.bg4 import FusedBg4Verifier
from zest_tpu_torch.ops.blake3 import DeviceHasher
from zest_tpu_torch.ops.blake3_cuda import CudaHasher

__all__ = ["CudaHasher", "DeviceHasher", "FusedBg4Verifier",
           "fused_verifier_for_backend", "unit_verify_hasher"]


def unit_verify_hasher(key: bytes | None = None, device="cuda"):
    """Hasher for whole-unit trust-boundary verification: the CUDA kernel
    on ``cuda`` (the default; raises where there is no card), the plain
    PyTorch version on ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return CudaHasher(key, dev)
    return DeviceHasher(key, dev)


def fused_verifier_for_backend(key: bytes | None = None, device="cuda"):
    """The BG4 decode→verify pass for whole-unit verification: the fused
    CUDA regroup → BLAKE3 kernel on ``cuda`` (the default; raises where
    there is no card), the plain PyTorch pass on ``cpu`` — so the CPU
    tests drive the same code path the card runs."""
    return FusedBg4Verifier(key, resolve_device(device))
