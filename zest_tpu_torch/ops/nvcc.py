"""Build, bind and count the hand-written CUDA kernels.

Every kernel of the port is one ``csrc/*.cu`` file with a plain C
interface. :class:`KernelLibrary` compiles it with ``nvcc`` for ``sm_90a``
into ``csrc/build/`` (listed in ``.gitignore``) at first use and loads it
with ``ctypes``; nothing is built when a module is imported. The first-use
build runs under the library's own lock, so host threads that launch at
once never run ``nvcc`` twice into one path, while two libraries can build
side by side. An up-to-date library on disk is reused.

:class:`LaunchCounter` is each kernel's count of launches and the rows
they covered, so a run can show that its main path went through the
kernel. Several host threads launch at once (the cooperative pull's
receivers), so it counts under a lock.
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
from typing import Callable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class LaunchCounter:
    """Kernel launches, and the rows (chunks) those launches covered."""

    launches: int = 0
    rows: int = 0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def add(self, rows: int) -> None:
        with self._lock:
            self.launches += 1
            self.rows += rows

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.rows = 0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH)")


class KernelLibrary:
    """One ``csrc/<source>`` compiled into ``csrc/build/<lib_name>``;
    ``bind(dll)`` declares its functions' ``argtypes``/``restype``."""

    def __init__(self, source: str, lib_name: str,
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self.lib_name = lib_name
        self._bind = bind
        self._lock = threading.Lock()
        self._dll: ctypes.CDLL | None = None
        self._log = ""

    def build(self) -> str:
        """Compile (when stale) and load the library, once per process.
        Returns the compiler's ``-Xptxas -v`` report. Raises
        ``RuntimeError`` when ``nvcc`` is missing or fails."""
        with self._lock:
            if self._dll is not None:
                return self._log
            BUILD_DIR.mkdir(exist_ok=True)
            so_path = BUILD_DIR / self.lib_name
            stamp = BUILD_DIR / (self.lib_name + ".stamp")
            st = self.source.stat()
            fingerprint = f"{st.st_mtime_ns}:{st.st_size}:{' '.join(NVCC_FLAGS)}"
            if not (so_path.exists() and stamp.exists()
                    and stamp.read_text() == fingerprint):
                fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".tmp-",
                                           suffix=".so")
                os.close(fd)
                cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(f"nvcc failed on {self.source.name} "
                                       f"({proc.returncode}):\n{proc.stderr}")
                os.replace(tmp, so_path)
                stamp.write_text(fingerprint)
                self._log = proc.stderr
            dll = ctypes.CDLL(str(so_path))
            self._bind(dll)
            self._dll = dll
            return self._log

    def get(self) -> ctypes.CDLL:
        """The loaded library, built at first use."""
        self.build()
        return self._dll


def check_launch(rc: int, kernel: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
