"""The CUDA BG4 regroup kernel and the fused regroup → BLAKE3 kernel.

Counterpart of ``zest_tpu/ops/decode_pallas.py`` (``_regroup_pallas`` and
``_fused_regroup_hash``).

- :func:`launch` runs the standalone regroup, ``csrc/bg4.cu``, on a CUDA
  tensor or raises; :data:`COUNTER` counts its launches and rows. The
  main paths no longer run it: ``chip_smoke.py`` still holds it against
  its plain version and times it.
- :func:`launch_fused` runs the fused kernel, ``csrc/blake3.cu``'s
  ``zest_blake3_bg4_chunks``: one launch that regroups the planar words in
  registers as it loads each message block, so the regrouped bytes are
  never written to device memory. :data:`FUSED_COUNTER` counts its
  launches and rows.

``ops/nvcc.py`` compiles each source for ``sm_90a`` into ``csrc/build/``
at first use — nothing is built when this module is imported. The plain
versions are in ``ops/bg4.py``; only a CPU tensor takes them.
"""

from __future__ import annotations

import ctypes

import torch

from zest_tpu_torch.ops import bg4 as plain
from zest_tpu_torch.ops import blake3_cuda, nvcc
from zest_tpu_torch.ops.blake3 import check_batch


def _bind(dll: ctypes.CDLL) -> None:
    dll.zest_bg4_regroup.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    dll.zest_bg4_regroup.restype = ctypes.c_int


LIBRARY = nvcc.KernelLibrary("bg4.cu", "libzest_bg4.so", _bind)
SOURCE = LIBRARY.source
COUNTER = nvcc.LaunchCounter()
FUSED_COUNTER = nvcc.LaunchCounter()


def build() -> str:
    """Compile and load the regroup kernel's library (once per process);
    returns the compiler's ``-Xptxas -v`` report. The fused kernel is in
    ``blake3_cuda``'s library."""
    return LIBRARY.build()


def launch(words: torch.Tensor) -> torch.Tensor:
    """Regroup CUDA ``words`` (B, W) u32, plane ``k`` at word ``k·W/4``;
    returns (B, W) u32 on the same device. Does not synchronise; raises
    if the launch is refused."""
    plain.check_planar(words)
    if words.device.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got "
                         f"{words.device}")
    if not words.is_contiguous():
        raise ValueError("planar words must be contiguous")
    if words.data_ptr() % 16:
        raise ValueError("planar words must be 16-byte aligned")
    B, W = words.shape
    out = torch.empty_like(words)
    if B == 0 or W == 0:
        return out
    lib = LIBRARY.get()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.zest_bg4_regroup(words.data_ptr(), out.data_ptr(), B, W,
                                  stream)
    nvcc.check_launch(rc, "BG4 regroup")
    COUNTER.add(B)
    return out


def launch_fused(words: torch.Tensor, lengths: torch.Tensor,
                 key_words: tuple[int, ...],
                 base_flags: int) -> torch.Tensor:
    """The fused pass on the card, one launch: CUDA ``words`` (B, cap/4)
    u32 planar (plane ``k`` at word ``k·cap/16``) and the original (B,)
    lengths → (B, 8) u32 digests of the regrouped bytes. Does not
    synchronise; raises if the launch is refused."""
    plain.check_planar(words)
    check_batch(words, lengths)
    blake3_cuda.check_device_words(words)
    return blake3_cuda.run(blake3_cuda.PLANAR_ENTRY, words, lengths,
                           key_words, base_flags, FUSED_COUNTER)
