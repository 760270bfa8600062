"""The CUDA BLAKE3 chunk verifier: build, bind and launch.

Counterpart of ``zest_tpu/ops/blake3_pallas.py`` (``PallasHasher``). The
kernel is ``csrc/blake3.cu``; its source note says what it replaces, what
bounds it and how it is laid out. ``ops/nvcc.py`` compiles it for
``sm_90a`` into ``csrc/build/`` at first use and binds it with ``ctypes``
— nothing is built when this module is imported.

:class:`CudaHasher` keeps the Pallas hasher's surface (``hash_device``,
``hash_batch``). A CUDA tensor launches the kernel on the current stream
or raises; only a CPU tensor takes the plain PyTorch version
(``ops/blake3.py``). :data:`COUNTER` counts kernel launches and the chunks
(rows) they hashed, so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from zest_tpu_torch.ops import blake3 as plain
from zest_tpu_torch.ops import nvcc


def _bind(dll: ctypes.CDLL) -> None:
    dll.zest_blake3_chunks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.c_void_p,
    ]
    dll.zest_blake3_chunks.restype = ctypes.c_int


LIBRARY = nvcc.KernelLibrary("blake3.cu", "libzest_blake3.so", _bind)
SOURCE = LIBRARY.source
COUNTER = nvcc.LaunchCounter()


def build() -> str:
    """Compile and load the kernel library (once per process); returns
    the compiler's ``-Xptxas -v`` report."""
    return LIBRARY.build()


def launch(words: torch.Tensor, lengths: torch.Tensor,
           key_words: tuple[int, ...], base_flags: int) -> torch.Tensor:
    """Run the kernel on CUDA ``words`` (B, cap/4) u32 and ``lengths``
    (B,); returns (B, 8) u32 digests on the same device. Does not
    synchronise; raises if the launch is refused."""
    plain.check_batch(words, lengths)
    if words.device.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got "
                         f"{words.device}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    lengths = lengths.to(torch.int32).contiguous()
    B, W = words.shape
    out = torch.empty((B, 8), dtype=torch.uint32, device=words.device)
    if B == 0:
        return out
    lib = LIBRARY.get()
    key = (ctypes.c_uint32 * 8)(*key_words)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.zest_blake3_chunks(
            words.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, W,
            ctypes.addressof(key), base_flags, stream)
    nvcc.check_launch(rc, "BLAKE3")
    COUNTER.add(B)
    return out


class CudaHasher:
    """Batched BLAKE3 through the CUDA kernel (``device`` defaults to
    ``cuda``); a drop-in sibling of the JAX package's ``PallasHasher``."""

    def __init__(self, key: bytes | None = None,
                 device: torch.device | str = "cuda"):
        self.key_words, self.base_flags = plain.key_params(key)
        self.device = torch.device(device)

    def hash_device(self, words: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
        """(B, cap/4) u32 + (B,) lengths → (B, 8) u32 digests. A CUDA
        tensor launches the kernel; a CPU tensor takes the plain version."""
        if words.device.type == "cuda":
            return launch(words, lengths, self.key_words, self.base_flags)
        if words.device.type == "cpu":
            return plain.hash_words(words, lengths, self.key_words,
                                    self.base_flags)
        raise ValueError(f"unsupported device {words.device}")

    def hash_batch(self, chunks: list[bytes]) -> list[bytes]:
        """Byte strings → 32-byte digests, staged on ``self.device``."""
        if not chunks:
            return []
        return plain.digests_to_bytes(
            self.hash_device(*plain.stage_batch(chunks, self.device)))
