"""The CUDA BLAKE3 chunk verifiers: build, bind and launch.

Counterpart of ``zest_tpu/ops/blake3_pallas.py`` (``PallasHasher``). The
kernels are ``csrc/blake3.cu``: one template with two message loaders, row
words (``zest_blake3_chunks``, launched here) and BG4 planes
(``zest_blake3_bg4_chunks``, launched by ``ops/bg4_cuda.launch_fused``).
Its source note says what they replace, what bounds them and how they are
laid out. ``ops/nvcc.py`` compiles it for ``sm_90a`` into ``csrc/build/``
at first use and binds it with ``ctypes`` — nothing is built when this
module is imported.

:class:`CudaHasher` keeps the Pallas hasher's surface (``hash_device``,
``hash_batch``). A CUDA tensor launches the kernel on the current stream
or raises; only a CPU tensor takes the plain PyTorch version
(``ops/blake3.py``). :data:`COUNTER` counts kernel launches and the chunks
(rows) they hashed, so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from zest_tpu_torch.ops import blake3 as plain
from zest_tpu_torch.ops import nvcc

ROWS_ENTRY = "zest_blake3_chunks"
PLANAR_ENTRY = "zest_blake3_bg4_chunks"
# The kernels' scratch words (csrc/blake3.cu): the work-ticket and
# warps-done counters, then per row the counter that joins a chunk's 32-leaf
# groups and its 128 leaves' chaining values.
CONTROL_WORDS = 2
JOIN_WORDS = 1 + 128 * 8


def _bind(dll: ctypes.CDLL) -> None:
    for name in (ROWS_ENTRY, PLANAR_ENTRY):
        fn = getattr(dll, name)
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int


LIBRARY = nvcc.KernelLibrary("blake3.cu", "libzest_blake3.so", _bind)
SOURCE = LIBRARY.source
COUNTER = nvcc.LaunchCounter()
_scratch: dict[tuple[int, int], torch.Tensor] = {}
_scratch_lock = threading.Lock()


def build() -> str:
    """Compile and load the kernel library (once per process); returns
    the compiler's ``-Xptxas -v`` report."""
    return LIBRARY.build()


def _scratch_for(device: torch.device, stream: int,
                 rows: int) -> torch.Tensor:
    """The kernels' scratch for ``rows`` rows on ``stream``. The kernel
    leaves every counter at 0, and launches on one stream run in order, so
    each stream's buffer is zeroed once, when it is allocated or grown (one
    fill at set-up), never per launch."""
    key = (device.index, stream)
    with _scratch_lock:
        buf = _scratch.get(key)
        if buf is None or buf.numel() < CONTROL_WORDS + rows * JOIN_WORDS:
            have = 0 if buf is None else buf.numel() // JOIN_WORDS
            size = CONTROL_WORDS + max(rows, 2 * have) * JOIN_WORDS
            buf = torch.zeros(size, dtype=torch.int32, device=device)
            _scratch[key] = buf
        return buf


def check_device_words(words: torch.Tensor) -> None:
    """What the kernels' 16-byte ``uint4`` loads need (``ValueError``)."""
    if words.device.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got "
                         f"{words.device}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")


def run(entry: str, words: torch.Tensor, lengths: torch.Tensor,
        key_words: tuple[int, ...], base_flags: int,
        counter: nvcc.LaunchCounter) -> torch.Tensor:
    """Launch ``entry`` of ``csrc/blake3.cu`` on checked CUDA ``words``
    (B, cap/4) u32 and ``lengths`` (B,) and count it on ``counter``;
    returns (B, 8) u32 digests on the same device. Does not synchronise;
    raises if the launch is refused."""
    lengths = lengths.to(torch.int32).contiguous()
    B, W = words.shape
    out = torch.empty((B, 8), dtype=torch.uint32, device=words.device)
    if B == 0:
        return out
    lib = LIBRARY.get()
    key = (ctypes.c_uint32 * 8)(*key_words)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        scratch = _scratch_for(words.device, stream, B)
        rc = getattr(lib, entry)(
            words.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, W,
            ctypes.addressof(key), base_flags, scratch.data_ptr(), stream)
    nvcc.check_launch(rc, "BLAKE3")
    counter.add(B)
    return out


def launch(words: torch.Tensor, lengths: torch.Tensor,
           key_words: tuple[int, ...], base_flags: int) -> torch.Tensor:
    """Run the kernel on CUDA ``words`` (B, cap/4) u32 and ``lengths``
    (B,); returns (B, 8) u32 digests on the same device. Does not
    synchronise; raises if the launch is refused."""
    plain.check_batch(words, lengths)
    check_device_words(words)
    return run(ROWS_ENTRY, words, lengths, key_words, base_flags, COUNTER)


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
