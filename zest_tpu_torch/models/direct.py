"""Direct landing: cached xorb units → host tensors, with no file between.

The counterpart of ``zest_tpu/models/direct.py``. A safetensors header
maps tensor names to file byte ranges and a reconstruction maps file
ranges to cached chunk ranges, so a tensor's bytes decode straight out of
the xorb cache into a host buffer (a pinned ring slot on the streaming
landing) and go to the device from there; the only disk artifacts on the
landing path are the content-addressed cache entries.

- :class:`CachedFileReader`: random-access reads of a file that exists
  only as cached units, through three lanes: stored chunks ``preadv``
  straight from the entry file, every other wholly contained cached term
  decodes in one native batch call (GIL released), and whatever is left
  (cache misses, boundary terms shared by two reads, corrupt entries)
  goes term by term through the memo and the bridge's waterfall, which
  heals a corrupt entry from the CDN.
- :func:`land_tensors`: one shard's tensors as CPU tensors over one
  decoded buffer (the shard-level landing).
- :class:`StreamingShardReader`: decode of caller-chosen byte runs into
  caller-owned buffers (the streaming landing's ring slots).
- :func:`tensor_unit_keys`, :func:`unit_layer_priorities`,
  :func:`unit_priority_sort_key`: which fetch units each tensor needs, and
  the layer order in which units are fetched and exchanged.
- :func:`land_moe_expert_sharded`: a Mixtral checkpoint stacked into the
  family tree and laid out expert-parallel over a slot mesh.

A reader built with ``allow_lossy=True`` overlays the host's lossy
staging (``transfer/lossy.py``) where the cache misses: the device
landings ask for it when no file shares their decoded bytes; file
materialization and serving never do.
"""

from __future__ import annotations

import bisect
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from zest_tpu_torch import telemetry
from zest_tpu_torch.cas import compression, reconstruction as recon
from zest_tpu_torch.cas.xorb import (
    XorbFormatError,
    XorbReader,
    _exclusive_cumsum,
)
from zest_tpu_torch.config import DEFAULT_DECODE_CACHE_BYTES
from zest_tpu_torch.models.registry import layer_priority
from zest_tpu_torch.models.safetensors_io import SafetensorsHeader
from zest_tpu_torch.transfer import lossy

_M_READER_EVENTS = telemetry.counter(
    "zest_decode_reader_cache_events_total",
    "Parsed-reader LRU events on the landing decode path", ("event",))

# Typed views of a landed byte buffer keep the file's alignment: the
# buffer starts ``file offset % _ALIGN`` bytes into an aligned allocation.
_ALIGN = 16


class DirectLandingError(RuntimeError):
    pass


_pool_lock = threading.Lock()
_decode_pool: ThreadPoolExecutor | None = None
_decode_pool_width = 0


def resolve_decode_workers(workers: int | None = None) -> int:
    """Term-decode parallelism: explicit value, else
    ``ZEST_DECODE_WORKERS``, else auto. 0 means auto (min(4, cpus)); 1
    means serial. The native decode releases the GIL, so a small pool
    speeds it up without crowding the landing's own threads."""
    if workers is None:
        try:
            workers = int(os.environ.get("ZEST_DECODE_WORKERS", "0"))
        except ValueError:
            workers = 0
    if workers <= 0:
        workers = min(4, os.cpu_count() or 1)
    return max(1, workers)


def _shared_decode_pool(workers: int) -> ThreadPoolExecutor | None:
    """One process-wide decode pool shared by every reader, grown to the
    widest request seen (a replaced pool drains its tasks and its idle
    threads exit)."""
    if workers <= 1:
        return None
    global _decode_pool, _decode_pool_width
    with _pool_lock:
        if _decode_pool is None or _decode_pool_width < workers:
            _decode_pool = ThreadPoolExecutor(
                workers, thread_name_prefix="zest-term-decode")
            _decode_pool_width = workers
        return _decode_pool


# preadv limits: Linux's IOV_MAX is 1024; gaps between adjacent payloads
# are 8-byte frame headers, so a page-sized gap cap keeps runs long
# without reading skipped chunks.
_IOV_MAX = 1024
_PREADV_GAP_MAX = 4096


def _preadv_into(fd, iovecs, offset: int) -> tuple[int, int]:
    """Fill ``iovecs`` (writable memoryviews) from ``fd`` at file
    ``offset``: ``os.preadv`` split at IOV_MAX, resuming short reads.
    Returns ``(bytes_read, syscalls)``; short only when the file is."""
    want = sum(v.nbytes for v in iovecs)
    total = calls = idx = 0
    sub = 0  # bytes already filled of iovecs[idx]
    while total < want:
        batch = [iovecs[idx][sub:] if sub else iovecs[idx]]
        batch.extend(iovecs[idx + 1:idx + _IOV_MAX])
        got = os.preadv(fd, batch, offset + total)
        calls += 1
        if got <= 0:
            break
        total += got
        while got:
            rem = iovecs[idx].nbytes - sub
            if got >= rem:
                got -= rem
                idx += 1
                sub = 0
            else:
                sub += got
                got = 0
    return total, calls


class CachedFileReader:
    """Random-access byte reads over a file that exists only as cached
    xorb units plus its reconstruction.

    Decoded boundary terms are memoized (adjacent reads share them).
    Terms of one read land in disjoint slices of the destination, so they
    decode in parallel over a small shared pool (``workers`` > 1); two
    threads racing one boundary term at worst both decode it. Parsed
    cache entries sit in a byte-bounded LRU (``cfg.decode_cache_bytes``):
    one unit serves many terms. With a ``bridge``, a unit missing from the
    cache or failing to decode is fetched through its waterfall.
    """

    def __init__(self, cache, rec: recon.Reconstruction, bridge=None,
                 workers: int | None = None, allow_lossy: bool = False,
                 use_preadv: bool = True):
        self.cache = cache
        self.allow_lossy = allow_lossy
        self.rec = rec
        self.bridge = bridge
        self.use_preadv = bool(use_preadv) and hasattr(os, "preadv")
        self.preadv_stats = {"terms": 0, "bytes": 0, "syscalls": 0}
        self._spans: list[tuple[int, int, recon.Term]] = []
        off = 0
        for t in rec.terms:
            self._spans.append((off, off + t.unpacked_length, t))
            off += t.unpacked_length
        self.size = off
        self._term_bytes: dict[int, bytes] = {}
        self._memo_lock = threading.Lock()
        self.workers = resolve_decode_workers(workers)
        cap = getattr(getattr(cache, "cfg", None), "decode_cache_bytes",
                      None)
        self._reader_cache_cap = (DEFAULT_DECODE_CACHE_BYTES
                                  if cap is None else int(cap))
        self._readers: OrderedDict[tuple[str, int],
                                   tuple[XorbReader, int, int]] = \
            OrderedDict()
        self._readers_bytes = 0
        self._readers_lock = threading.Lock()
        # Entries whose frame stream does not parse: a miss for the
        # waterfall (which rewrites them), a decode failure in reports.
        self._malformed: dict[tuple[str, int], ValueError] = {}

    def _entry_reader(self, hash_hex: str, range_start: int):
        """``(XorbReader, chunk_offset)`` of a cache entry, LRU-memoized,
        over a read-only map of the entry; None on a miss."""
        key = (hash_hex, range_start)
        with self._readers_lock:
            hit = self._readers.get(key)
            if hit is not None:
                self._readers.move_to_end(key)
        if hit is not None:
            _M_READER_EVENTS.inc(event="hit")
            return hit[0], hit[1]
        _M_READER_EVENTS.inc(event="miss")
        entry = self.cache.get_with_range_mapped(hash_hex, range_start)
        if entry is None:
            got = self._lossy_reader(hash_hex, range_start)
            if got is None:
                return None
            reader, chunk_offset, nbytes = got
        else:
            try:
                reader = XorbReader(entry.data)
            except ValueError as exc:  # XorbFormatError
                # Kept without its traceback: the frames it links to (the
                # caller's read, and its view of the caller's buffer) must
                # not outlive the read.
                self._malformed[key] = exc.with_traceback(None)
                return None
            chunk_offset, nbytes = entry.chunk_offset, len(entry.data)
        if self._reader_cache_cap > 0:
            with self._readers_lock:
                if key not in self._readers:
                    self._readers[key] = (reader, chunk_offset, nbytes)
                    self._readers_bytes += nbytes
                while (self._readers_bytes > self._reader_cache_cap
                       and len(self._readers) > 1):
                    _, (_r, _o, dropped) = self._readers.popitem(last=False)
                    self._readers_bytes -= dropped
        return reader, chunk_offset

    def _lossy_reader(self, hash_hex: str, range_start: int):
        """``(reader, chunk_offset, nbytes)`` over the dequantized frames
        of a staged lossy container, or None. Only a reader built with
        ``allow_lossy`` looks, and only after a cache miss, so byte-exact
        data always wins."""
        if not self.allow_lossy:
            return None
        cache_dir = getattr(getattr(self.cache, "cfg", None), "cache_dir",
                            None)
        if cache_dir is None:
            return None
        staged = lossy.staging_for(cache_dir).get_with_range(hash_hex,
                                                             range_start)
        if staged is None:
            return None
        container, chunk_offset = staged
        try:
            data = lossy.dequantize_blob(container)
        except ValueError:
            return None  # a malformed container reads as a miss
        _M_READER_EVENTS.inc(event="lossy")
        return XorbReader(data), chunk_offset, len(data)

    def _drop_reader(self, hash_hex: str, range_start: int) -> None:
        """Forget a memoized reader whose blob failed to decode, so no
        later term is served the same bad bytes from memory."""
        with self._readers_lock:
            hit = self._readers.pop((hash_hex, range_start), None)
            if hit is not None:
                self._readers_bytes -= hit[2]

    def _fetch_info(self, term):
        fi = self.rec.find_fetch_info(term)
        if fi is None:
            raise DirectLandingError(
                f"no fetch_info covers term {term.hash_hex}")
        return fi

    def _locate(self, term):
        """``(fi, reader, local_start, local_end)`` of a cached term, or
        ``(fi, None, 0, 0)`` on a miss: the one place the fetch-info
        lookup, cache read and chunk rebase live."""
        fi = self._fetch_info(term)
        got = self._entry_reader(term.hash_hex, fi.range.start)
        if got is None:
            return fi, None, 0, 0
        reader, chunk_offset = got
        return (fi, reader, term.range.start - chunk_offset,
                term.range.end - chunk_offset)

    def _decode_term(self, i: int) -> bytes:
        """Term ``i``'s bytes, memoized: from the cache, else (a miss or
        a corrupt entry) through the bridge's waterfall."""
        with self._memo_lock:
            data = self._term_bytes.get(i)
        if data is not None:
            return data
        _lo, _hi, term = self._spans[i]
        data = None
        decode_err: ValueError | None = None
        fi, reader, local_start, local_end = self._locate(term)
        if reader is not None:
            try:
                data = reader.extract_chunk_range(local_start, local_end)
            except ValueError as exc:  # XorbFormatError / CompressionError
                self._drop_reader(term.hash_hex, fi.range.start)
                decode_err = exc
        else:
            decode_err = self._malformed.get((term.hash_hex, fi.range.start))
        if data is None:
            if self.bridge is None:
                if decode_err is not None:
                    raise DirectLandingError(
                        f"cached unit {term.hash_hex}"
                        f"[{fi.range.start},{fi.range.end}) failed to "
                        f"decode: {decode_err}") from decode_err
                raise DirectLandingError(
                    f"unit {term.hash_hex}[{fi.range.start},{fi.range.end})"
                    " not in cache")
            data = self.bridge.fetch_term(term, self.rec)
        if len(data) != term.unpacked_length:
            raise DirectLandingError(
                f"term decoded to {len(data)} bytes, expected "
                f"{term.unpacked_length}")
        with self._memo_lock:
            self._term_bytes[i] = data
        return data

    def _decode_part_into(self, i: int, a: int, b: int, dest,
                          workers: int = 1) -> int:
        """Bytes ``[a, b)`` of term ``i`` (offsets within the term) into
        ``dest``: a read that cuts a term decodes only the chunks it
        touches (:func:`_extract_bytes_into`), so two reads that share a
        term decode at most one chunk twice. A memoized term is copied
        from the memo; a miss or a decode failure takes
        :meth:`_decode_term` (the waterfall heals) and copies."""
        _lo, _hi, term = self._spans[i]
        with self._memo_lock:
            data = self._term_bytes.get(i)
        if data is None:
            fi, reader, local_start, local_end = self._locate(term)
            if reader is not None:
                try:
                    return _extract_bytes_into(reader, local_start,
                                               local_end, a, b, dest,
                                               workers)
                except ValueError:  # XorbFormatError / CompressionError
                    self._drop_reader(term.hash_hex, fi.range.start)
            data = self._decode_term(i)
        dest[:] = memoryview(data)[a:b]
        return b - a

    def _decode_term_into(self, i: int, dest) -> int:
        """Decode term ``i`` straight into ``dest`` (no memo: a term
        wholly inside one read is read once); a miss or a decode failure
        takes :meth:`_decode_term` and copies."""
        _lo, _hi, term = self._spans[i]
        try:
            _fi, reader, local_start, local_end = self._locate(term)
            if reader is not None:
                return reader.extract_range_into(local_start, local_end,
                                                 dest)
        except ValueError:
            pass  # corrupt entry: the memoized path heals
        data = self._decode_term(i)
        dest[:] = data
        return len(data)

    def _stored_columns(self, job, lo: int, hi: int, memoized):
        """``(reader, chunk_offset, fi, columns)`` of a job's term when it
        is wholly inside ``[lo, hi)``, not memoized and cached without
        footer hashes; None when the job must take another lane. A
        malformed entry's reader is dropped (the per-term lane heals)."""
        i, _d_lo, _d_hi = job
        t_lo, t_hi, term = self._spans[i]
        if not (lo <= t_lo and t_hi <= hi) or i in memoized:
            return None
        fi = self._fetch_info(term)
        got = self._entry_reader(term.hash_hex, fi.range.start)
        if got is None:
            return None
        reader, chunk_offset = got
        try:
            cols = reader.decode_columns(term.range.start - chunk_offset,
                                         term.range.end - chunk_offset)
        except ValueError:
            self._drop_reader(term.hash_hex, fi.range.start)
            return None
        if cols is None or int(cols[3].sum(dtype=np.uint64)) \
                != term.unpacked_length:
            return None  # footer-hashed (verify per chunk) or mis-sized
        return reader, chunk_offset, fi, cols

    def _preadv_batch(self, jobs, lo: int, hi: int, view):
        """The stored-chunk lane: a term whose entry is a file without
        footer hashes and whose chunks are all stored reads its payloads
        straight from the entry file into ``view``, one ``preadv`` per
        contiguous run (throwaway gap buffers for the frame headers).
        Returns ``(bytes_written, leftover_jobs)``; any failure hands the
        jobs to the decode lanes, which attribute and heal."""
        with self._memo_lock:
            memoized = set(self._term_bytes)
        per_path: dict[str, tuple[list, list]] = {}
        leftover = []
        for job in jobs:
            got = self._stored_columns(job, lo, hi, memoized)
            term = self._spans[job[0]][2]
            located = (None if got is None else self.cache.locate_with_range(
                term.hash_hex, got[2].range.start))
            if got is None or located is None or located[1] != got[1] \
                    or got[3][2].any():  # any compressed chunk
                leftover.append(job)
                continue
            src_offs, _src_lens, _schemes, dst_lens = got[3]
            triples, pjobs = per_path.setdefault(str(located[0]), ([], []))
            dst = job[1] + _exclusive_cumsum(dst_lens).astype(np.int64)
            triples.extend(zip(src_offs.tolist(), dst.tolist(),
                               dst_lens.tolist()))
            pjobs.append(job)

        written = 0
        gap_buf = bytearray(_PREADV_GAP_MAX)  # contents discarded
        for path, (triples, pjobs) in per_path.items():
            try:
                fd = os.open(path, os.O_RDONLY)
            except OSError:
                leftover.extend(pjobs)  # evicted meanwhile: decode heals
                continue
            ok = True
            try:
                triples.sort()
                k = 0
                while k < len(triples):
                    run_start = pos = triples[k][0]
                    iovecs = []
                    while k < len(triples):
                        src, dst, ln = triples[k]
                        gap = src - pos
                        if gap < 0 or gap > _PREADV_GAP_MAX:
                            break
                        if gap:
                            iovecs.append(memoryview(gap_buf)[:gap])
                        iovecs.append(view[dst:dst + ln])
                        pos = src + ln
                        k += 1
                    got, calls = _preadv_into(fd, iovecs, run_start)
                    self.preadv_stats["syscalls"] += calls
                    if got != sum(v.nbytes for v in iovecs):
                        ok = False  # short entry: decode path heals
                        break
            except OSError:
                ok = False
            finally:
                os.close(fd)
            if not ok:
                leftover.extend(pjobs)
                continue
            payload = sum(t[2] for t in triples)
            written += payload
            self.preadv_stats["terms"] += len(pjobs)
            self.preadv_stats["bytes"] += payload
        return written, leftover

    def _decode_batch(self, jobs, lo: int, hi: int, view):
        """The batch lane: every batchable job's chunk descriptors decode
        in one native call. Returns ``(bytes_written, leftover_jobs)``;
        a failing batch hands every job to the per-term lane, which
        attributes the fault to its entry and heals it."""
        with self._memo_lock:
            memoized = set(self._term_bytes)
        groups, batched, leftover = [], [], []
        for job in jobs:
            got = self._stored_columns(job, lo, hi, memoized)
            if got is None:
                leftover.append(job)
                continue
            reader, _off, _fi, (src_offs, src_lens, schemes, dst_lens) = got
            dst_offs = np.uint64(job[1]) + _exclusive_cumsum(dst_lens)
            groups.append((reader._data, src_offs, src_lens, schemes,
                           dst_offs, dst_lens))
            batched.append(job)
        if not groups:
            return 0, leftover
        try:
            written = compression.decode_columns_into(
                groups, view, workers=self.workers)
        except ValueError:
            return 0, leftover + batched
        return written, leftover

    def _check_range(self, lo: int, hi: int) -> None:
        if not 0 <= lo <= hi <= self.size:
            raise DirectLandingError(
                f"read [{lo},{hi}) outside file of {self.size} bytes")

    def copy_plan(self, lo: int, hi: int):
        """Zero-copy plan for file bytes ``[lo, hi)``: ``(copies,
        leftovers)``. ``copies`` is one ``(entry_path, src_offs, dst_offs,
        lens)`` group (u64 columns, destinations relative to ``lo``) per
        term that is wholly inside, cached in an entry file without footer
        hashes and all stored chunks — its payload bytes are the file's
        bytes. ``leftovers`` are merged ``(d_lo, d_hi)`` ranges the caller
        decodes through :meth:`read_into`. Reads no payload byte."""
        self._check_range(lo, hi)
        copies, leftovers = [], []

        def leftover(d_lo: int, d_hi: int) -> None:
            if leftovers and leftovers[-1][1] == d_lo:
                leftovers[-1] = (leftovers[-1][0], d_hi)
            else:
                leftovers.append((d_lo, d_hi))

        for i, (t_lo, t_hi, term) in enumerate(self._spans):
            if t_hi <= lo:
                continue
            if t_lo >= hi:
                break
            job = (i, max(lo, t_lo) - lo, min(hi, t_hi) - lo)
            got = self._stored_columns(job, lo, hi, ())
            located = (None if got is None else self.cache.locate_with_range(
                term.hash_hex, got[2].range.start))
            if got is None or located is None or located[1] != got[1] \
                    or got[3][2].any():
                leftover(job[1], job[2])
                continue
            src_offs, _sl, _sc, dst_lens = got[3]
            copies.append((located[0], src_offs,
                           np.uint64(job[1]) + _exclusive_cumsum(dst_lens),
                           dst_lens))
        return copies, leftovers

    def read(self, lo: int, hi: int) -> bytes:
        """Bytes ``[lo, hi)`` of the reconstructed file."""
        self._check_range(lo, hi)  # before allocating hi - lo bytes
        out = bytearray(hi - lo)
        self.read_into(lo, hi, memoryview(out))
        return bytes(out)

    def read_into(self, lo: int, hi: int, out) -> int:
        """Decode bytes ``[lo, hi)`` straight into ``out`` (a writable
        buffer of exactly ``hi - lo`` bytes); returns the count. Every
        term a read touches owns a disjoint slice of ``out``."""
        self._check_range(lo, hi)
        view = memoryview(out).cast("B")
        if view.nbytes != hi - lo:
            raise DirectLandingError(
                f"out buffer is {view.nbytes} bytes for a [{lo},{hi}) read")
        jobs = []  # (term index, dest offset in view, dest end)
        for i, (t_lo, t_hi, _term) in enumerate(self._spans):
            if t_hi <= lo:
                continue
            if t_lo >= hi:
                break
            jobs.append((i, max(lo, t_lo) - lo, min(hi, t_hi) - lo))

        written = 0
        if jobs and self.use_preadv:
            w, jobs = self._preadv_batch(jobs, lo, hi, view)
            written += w
        if jobs:
            w, jobs = self._decode_batch(jobs, lo, hi, view)
            written += w
        if not jobs:
            return written
        # A lone job owns the native decode threads; several share the
        # pool below.
        part_workers = self.workers if len(jobs) == 1 else 1

        def decode_into_view(i: int, d_lo: int, d_hi: int) -> int:
            t_lo, t_hi, _term = self._spans[i]
            if lo <= t_lo and t_hi <= hi and i not in self._term_bytes:
                return self._decode_term_into(i, view[d_lo:d_hi])
            return self._decode_part_into(
                i, max(lo, t_lo) - t_lo, min(hi, t_hi) - t_lo,
                view[d_lo:d_hi], part_workers)

        def decode_group(group: list[tuple[int, int, int]]) -> int:
            try:
                return sum(decode_into_view(*j) for j in group)
            except BaseException as exc:
                # Detach the worker frames before the error crosses the
                # future: a pinned frame would hold ``out`` alive.
                raise exc.with_traceback(None) from None

        pool = _shared_decode_pool(self.workers) if len(jobs) > 1 else None
        if pool is None:
            return written + sum(decode_into_view(*j) for j in jobs)
        # One future per contiguous job group, not per term.
        n_groups = min(len(jobs), self.workers)
        per = -(-len(jobs) // n_groups)
        futures = [pool.submit(decode_group, jobs[k:k + per])
                   for k in range(0, len(jobs), per)]
        first_error: BaseException | None = None
        for f in futures:
            # Wait out every job even after a failure: a decode still
            # writing into ``view`` while the caller unwinds would write
            # into freed memory.
            try:
                written += f.result()
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                if first_error is None:
                    first_error = exc
        futures.clear()
        if first_error is not None:
            raise first_error
        return written

    def drop_memo(self) -> None:
        with self._memo_lock:
            self._term_bytes.clear()


def _extract_bytes_into(reader, start: int, end: int, a: int, b: int,
                        dest, workers: int = 1) -> int:
    """Bytes ``[a, b)`` of chunks ``[start, end)`` of ``reader`` (offsets
    from chunk ``start``'s first byte) into ``dest``: runs of whole chunks
    decode in place on ``workers`` native threads, a chunk cut by either
    end decodes alone and its piece is copied."""
    sizes = reader.chunk_sizes[start:end].astype(np.int64)
    ends = np.cumsum(sizes)
    starts = ends - sizes
    k = int(np.searchsorted(ends, a, side="right"))
    k_end = int(np.searchsorted(starts, b, side="left"))
    pos = 0
    while k < k_end:
        c_lo, c_hi = int(starts[k]), int(ends[k])
        if a <= c_lo and c_hi <= b:
            j = k + 1
            while j < k_end and int(ends[j]) <= b:
                j += 1
            n = int(ends[j - 1]) - c_lo
            reader.extract_range_into(start + k, start + j,
                                      dest[pos:pos + n], workers=workers)
        else:
            j = k + 1
            piece = reader.extract_chunk(start + k)[
                max(a, c_lo) - c_lo:min(b, c_hi) - c_lo]
            n = len(piece)
            dest[pos:pos + n] = piece
        pos += n
        k = j
    if pos != b - a:  # a chunk table that disagrees with the term
        raise XorbFormatError(
            f"chunk range decoded {pos} bytes for a {b - a}-byte read")
    return pos


def aligned_bytes(n: int, file_offset: int, pin: bool = False):
    """``(buffer, view)``: a uint8 tensor of ``n`` bytes whose address is
    ``file_offset`` modulo 16 (inside a 16-aligned allocation), so typed
    views of it are aligned as the file's tensors are, and its numpy
    view. ``pin`` page-locks it for an asynchronous device copy."""
    pad = file_offset % _ALIGN
    raw = torch.empty(n + pad, dtype=torch.uint8, pin_memory=pin)
    buf = raw[pad:]
    return buf, buf.numpy()


def typed_view(raw: torch.Tensor, info) -> torch.Tensor:
    """The tensor ``info`` describes, as a view of its raw bytes."""
    return raw.view(info.torch_dtype).reshape(info.shape)


def land_tensors(cache, rec: recon.Reconstruction, header: SafetensorsHeader,
                 predicate=None, bridge=None, workers: int | None = None,
                 allow_lossy: bool = False) -> dict[str, torch.Tensor]:
    """Decode one safetensors file's tensors (those ``predicate(name)``
    keeps) from the cache into CPU tensors. Without a predicate the whole
    data section decodes as one read into one buffer and the tensors are
    views of it. With a ``bridge``, missing units come through its
    waterfall. ``workers`` sizes the decode pool; ``allow_lossy`` reads
    the lossy staging where the cache misses. Runs in a ``land.decode``
    span."""
    with telemetry.span("land.decode", file=rec.file_hash.hex(),
                        tensors=len(header.tensors)) as sp:
        out = _land_tensors(cache, rec, header, predicate, bridge, workers,
                            allow_lossy)
        sp.add_bytes(sum(t.numel() * t.element_size()
                         for t in out.values()))
        return out


def _land_tensors(cache, rec, header, predicate, bridge, workers,
                  allow_lossy) -> dict[str, torch.Tensor]:
    reader = CachedFileReader(cache, rec, bridge=bridge, workers=workers,
                              allow_lossy=allow_lossy)
    out: dict[str, torch.Tensor] = {}
    spans = {name: info.file_range(header.data_start)
             for name, info in header.tensors.items()
             if predicate is None or predicate(name)}
    if predicate is None and spans:
        lo = min(s[0] for s in spans.values())
        hi = max(s[1] for s in spans.values())
        buf, arr = aligned_bytes(hi - lo, lo)
        reader.read_into(lo, hi, memoryview(arr))
        for name, (t_lo, t_hi) in spans.items():
            out[name] = typed_view(buf[t_lo - lo:t_hi - lo],
                                   header.tensors[name])
    else:
        for name, (lo, hi) in spans.items():
            buf, arr = aligned_bytes(hi - lo, lo)
            reader.read_into(lo, hi, memoryview(arr))
            out[name] = typed_view(buf, header.tensors[name])
    reader.drop_memo()
    return out


class StreamingShardReader:
    """The streaming landing's decode front end for one shard: each run
    of file-contiguous tensors decodes as one read straight into a
    caller-owned buffer (a ring slot), so terms between run members stay
    on the batch lane. Boundary terms shared by two runs ride the memo;
    corruption is attributed and healed by :class:`CachedFileReader`.
    ``close()`` drops the memo."""

    def __init__(self, cache, rec: recon.Reconstruction,
                 header: SafetensorsHeader, bridge=None,
                 workers: int | None = None, allow_lossy: bool = False):
        self.header = header
        self.reader = CachedFileReader(cache, rec, bridge=bridge,
                                       workers=workers,
                                       allow_lossy=allow_lossy)

    def decode_range_into(self, lo: int, hi: int, dest,
                          label: str = "") -> None:
        """Decode file bytes ``[lo, hi)`` into ``dest``, in a
        ``land.slice`` span naming the run (``label``)."""
        with telemetry.span("land.slice", tensors=label) as sp:
            self.reader.read_into(lo, hi, dest)
            sp.add_bytes(hi - lo)

    def close(self) -> None:
        self.reader.drop_memo()


def tensor_unit_keys(rec: recon.Reconstruction,
                     header: SafetensorsHeader) -> dict[str, frozenset]:
    """Tensor name → the fetch-unit keys ``(hash_hex, range_start)`` its
    file range touches: the streaming landing decodes a tensor once these
    units are cached. Terms with no covering fetch_info are skipped (the
    per-term waterfall serves them)."""
    starts: list[int] = []
    ends: list[int] = []
    keys: list[tuple[str, int] | None] = []
    off = 0
    for t in rec.terms:
        fi = rec.find_fetch_info(t)
        starts.append(off)
        ends.append(off + t.unpacked_length)
        keys.append((t.hash_hex, fi.range.start) if fi is not None
                    else None)
        off += t.unpacked_length
    out: dict[str, frozenset] = {}
    for name, info in header.tensors.items():
        lo, hi = info.file_range(header.data_start)
        cover = set()
        j = max(0, bisect.bisect_right(starts, lo) - 1)
        while j < len(starts) and starts[j] < hi:
            if ends[j] > lo and keys[j] is not None:
                cover.add(keys[j])
            j += 1
        out[name] = frozenset(cover)
    return out


def unit_layer_priorities(
        recs_with_headers) -> dict[tuple[str, int], tuple[int, int]]:
    """Landing priority per fetch unit: the least
    :func:`~zest_tpu_torch.models.registry.layer_priority` over every
    tensor whose bytes the unit serves, across all ``(rec, header)``
    pairs. Terms inside a file's header rank with the embeddings; units
    serving no tensor rank ``(2, 0)``. A pure function of
    content-addressed metadata, so every host of a cooperative pull
    computes the same order."""
    out: dict[tuple[str, int], tuple[int, int]] = {}
    for rec, header in recs_with_headers:
        tspans = sorted(
            info.file_range(header.data_start) + (layer_priority(name),)
            for name, info in header.tensors.items())
        off = ti = 0
        for t in rec.terms:
            lo, hi = off, off + t.unpacked_length
            off = hi
            fi = rec.find_fetch_info(t)
            if fi is None:
                continue
            key = (t.hash_hex, fi.range.start)
            while ti < len(tspans) and tspans[ti][1] <= lo:
                ti += 1
            prio = None
            j = ti
            while j < len(tspans) and tspans[j][0] < hi:
                if prio is None or tspans[j][2] < prio:
                    prio = tspans[j][2]
                j += 1
            if lo < header.data_start and (prio is None or (0, 0) < prio):
                prio = (0, 0)
            if prio is None:
                prio = (2, 0)
            cur = out.get(key)
            if cur is None or prio < cur:
                out[key] = prio
    return out


def unit_priority_sort_key(priorities):
    """Sort key over ``(hash_hex, FetchInfo)`` units: layer priority
    (unknown units last), then ``(hash_hex, range_start)``. The one key
    both the landing's warm and the cooperative round sort with."""
    def key(u):
        return (priorities.get((u[0], u[1].range.start), (9, 0)),
                u[0], u[1].range.start)
    return key


def land_moe_expert_sharded(cache, recs_with_headers, moe_cfg, mesh,
                            placement, dtype: torch.dtype | None = None
                            ) -> dict:
    """A Mixtral-family checkpoint, decoded from the cache, stacked into
    the ``models.moe`` tree (in ``dtype``, default float32) and laid out
    over ``mesh`` under ``moe.param_specs``: the stacked expert leaves are
    cut over the ``expert`` axis in the blocks ``ExpertPlacement`` routed
    bytes for, so expert ``e`` lands on slot ``placement.host_of_expert(e)``.
    Returns the tree with ``ShardedTensor`` leaves
    (``tensor_parallel.moe_params`` decodes it)."""
    from zest_tpu_torch.models import moe as moe_mod
    from zest_tpu_torch.parallel.sharding import shard_tensor

    if placement.n_experts != moe_cfg.n_experts:
        raise DirectLandingError(
            f"placement has {placement.n_experts} experts, "
            f"config has {moe_cfg.n_experts}")
    tensors: dict = {}
    for rec, header in recs_with_headers:
        tensors.update(land_tensors(cache, rec, header))
    params = moe_mod.params_from_hf(tensors, moe_cfg,
                                    dtype=dtype or torch.float32)
    del tensors

    def place(tree, specs):
        if isinstance(tree, dict):
            return {k: place(tree[k], specs[k]) for k in tree}
        return shard_tensor(tree, mesh, specs)

    return place(params, moe_mod.param_specs(moe_cfg))
