"""The CUDA BG4 regroup kernel and the fused regroup → BLAKE3 pair.

Counterpart of ``zest_tpu/ops/decode_pallas.py`` (``_regroup_pallas`` and
``_fused_regroup_hash``). The kernel is ``csrc/bg4.cu``; its source note
says what it replaces, what bounds it and how it is laid out.
``ops/nvcc.py`` compiles it for ``sm_90a`` into ``csrc/build/`` at first
use with the same flags as the BLAKE3 kernel — nothing is built when this
module is imported.

- :func:`launch` runs the regroup on a CUDA tensor or raises;
  :data:`COUNTER` counts its launches and rows.
- :func:`launch_fused` runs the regroup and then the BLAKE3 kernel
  (``ops/blake3_cuda.py``) on the same stream: the regrouped words never
  leave the card. On the main path the regroup runs only inside this
  pair, so :data:`COUNTER` counts the pairs too.

The plain versions are in ``ops/bg4.py``; only a CPU tensor takes them.
"""

from __future__ import annotations

import ctypes

import torch

from zest_tpu_torch.ops import bg4 as plain
from zest_tpu_torch.ops import blake3_cuda, nvcc


def _bind(dll: ctypes.CDLL) -> None:
    dll.zest_bg4_regroup.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    dll.zest_bg4_regroup.restype = ctypes.c_int


LIBRARY = nvcc.KernelLibrary("bg4.cu", "libzest_bg4.so", _bind)
SOURCE = LIBRARY.source
COUNTER = nvcc.LaunchCounter()


def build() -> str:
    """Compile and load the kernel library (once per process); returns
    the compiler's ``-Xptxas -v`` report."""
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
    """The fused pass on the card: :func:`launch`, then the BLAKE3 kernel
    on its output, both on the current stream with no host copy between.
    Returns (B, 8) u32 digests of the regrouped bytes."""
    return blake3_cuda.launch(launch(words), lengths, key_words, base_flags)
