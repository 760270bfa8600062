"""Parallel term fetcher: the pull's first reconstruction rung.

The port's copy of ``zest_tpu/transfer/parallel.py``. Term output offsets
are known up front from the reconstruction plan, so workers ``pwrite``
their terms straight to the right offset of a temp file — no
barrier-then-serialize, bounded memory (at most one blob per worker in
flight). The first error wins and cancels the remaining work (the
reference's atomic error flag, parallel_download.zig:152-153).

:meth:`ParallelDownloader.reconstruct_to_file` renames the finished temp
file over ``out_path`` itself, as the JAX package's does. The pull's file
pipeline calls :meth:`ParallelDownloader.write_plan_to_temp` instead and
hands the temp file to its commit barrier (fsync + rename at the pull's
end), so a file the rung wrote commits with every other file.
"""

from __future__ import annotations

import os
import tempfile
import threading
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait
from pathlib import Path

from zest_tpu_torch.cas import reconstruction as recon


class ParallelDownloader:
    def __init__(self, bridge, max_concurrent: int | None = None,
                 executor: ThreadPoolExecutor | None = None):
        """``bridge`` is the pull's ``XetBridge``. ``executor``, when
        given, is a SHARED term-fetch pool: the file pipeline writes
        several files at once, and one pool across all of them bounds the
        in-flight fetches at its size instead of files x max_concurrent.
        The caller owns it (it is never shut down here). Term tasks never
        wait on other term tasks, so sharing cannot deadlock."""
        self.bridge = bridge
        self.max_concurrent = (
            max_concurrent or bridge.cfg.max_concurrent_downloads)
        self._executor = executor

    def reconstruct_to_file(self, file_hash_hex: str, out_path) -> int:
        rec = self.bridge.get_reconstruction(file_hash_hex)
        return self.reconstruct_plan_to_file(rec, out_path)

    def reconstruct_plan_to_file(self, rec: recon.Reconstruction,
                                 out_path) -> int:
        tmp = self.write_plan_to_temp(rec, out_path)
        os.replace(tmp, out_path)
        return rec.total_bytes

    def write_plan_to_temp(self, rec: recon.Reconstruction, out_path) -> str:
        """Fetch every term of ``rec`` into a fresh temp file beside
        ``out_path`` and return its name; on any error the temp file is
        gone and the first error raises."""
        offsets = []
        pos = 0
        for term in rec.terms:
            offsets.append(pos)
            pos += term.unpacked_length
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        # Unique per call: two concurrent pulls of one repo must not
        # truncate each other's half-written file.
        fd, tmp = tempfile.mkstemp(dir=out_path.parent,
                                   prefix=f".tmp-{out_path.name}.")
        cancel = threading.Event()
        try:
            os.ftruncate(fd, rec.total_bytes)

            def fetch_one(i: int) -> None:
                if cancel.is_set():
                    return
                data = self.bridge.fetch_term(rec.terms[i], rec)
                if cancel.is_set():
                    return
                os.pwrite(fd, data, offsets[i])

            pool = self._executor or ThreadPoolExecutor(self.max_concurrent)
            try:
                futures = [pool.submit(fetch_one, i)
                           for i in range(len(rec.terms))]
                done, not_done = wait(futures, return_when=FIRST_EXCEPTION)
                first_error = next(
                    (f.exception() for f in done if f.exception()), None)
                if first_error is not None:
                    cancel.set()
                    for f in not_done:
                        f.cancel()
                    wait(not_done)  # cancelled or done before fd closes
                    raise first_error
            finally:
                if pool is not self._executor:
                    pool.shutdown(wait=True)
        except BaseException:
            os.close(fd)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.close(fd)
        return tmp
