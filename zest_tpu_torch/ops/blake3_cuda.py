"""The CUDA BLAKE3 chunk verifier: build, bind and launch.

Counterpart of ``zest_tpu/ops/blake3_pallas.py`` (``PallasHasher``). The
kernel is ``csrc/blake3.cu``; its source note says what it replaces, what
bounds it and how it is laid out. It is compiled with ``nvcc`` for
``sm_90a`` into ``csrc/build/`` (listed in ``.gitignore``) at first use and
bound with ``ctypes`` — nothing is built when this module is imported.

:class:`CudaHasher` keeps the Pallas hasher's surface (``hash_device``,
``hash_batch``). A CUDA tensor launches the kernel on the current stream
or raises; only a CPU tensor takes the plain PyTorch version
(``ops/blake3.py``). :data:`COUNTER` counts kernel launches and the chunks
they hashed, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from zest_tpu_torch.ops import blake3 as plain

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "blake3.cu"
_BUILD_DIR = _CSRC / "build"
_LIB_NAME = "libzest_blake3.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class LaunchCounter:
    """Kernel launches, and the chunks those launches hashed."""

    launches: int = 0
    chunks: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.chunks = 0


COUNTER = LaunchCounter()

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA BLAKE3 kernel cannot be "
                       "built (put the CUDA toolkit's bin/ on PATH)")


def build() -> str:
    """Compile and load the kernel library (once per process; an up-to-date
    library on disk is reused). Returns the compiler's ``-Xptxas -v``
    report. Raises ``RuntimeError`` when ``nvcc`` is missing or fails."""
    global _lib, _build_log
    with _lock:
        if _lib is not None:
            return _build_log
        _BUILD_DIR.mkdir(exist_ok=True)
        so_path = _BUILD_DIR / _LIB_NAME
        stamp = _BUILD_DIR / (_LIB_NAME + ".stamp")
        st = SOURCE.stat()
        fingerprint = f"{st.st_mtime_ns}:{st.st_size}:{' '.join(NVCC_FLAGS)}"
        if not (so_path.exists() and stamp.exists()
                and stamp.read_text() == fingerprint):
            fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, prefix=".tmp-",
                                       suffix=".so")
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so_path)
            stamp.write_text(fingerprint)
            _build_log = proc.stderr
        lib = ctypes.CDLL(str(so_path))
        lib.zest_blake3_chunks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p,
        ]
        lib.zest_blake3_chunks.restype = ctypes.c_int
        _lib = lib
        return _build_log


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
    build()
    key = (ctypes.c_uint32 * 8)(*key_words)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = _lib.zest_blake3_chunks(
            words.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, W,
            ctypes.addressof(key), base_flags, stream)
    if rc != 0:
        raise RuntimeError(f"BLAKE3 kernel launch failed: cudaError {rc}")
    COUNTER.launches += 1
    COUNTER.chunks += B
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
