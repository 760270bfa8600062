"""Host-disk storage tier: atomic writes, HF refs and the xorb cache.

The subset of ``zest_tpu/storage.py`` the port runs, with the same
on-disk layout: full xorbs at ``xorbs/{prefix}/{hash}``, partial entries
(a chunk sub-range fetched from the CDN) at ``{hash}.{range_start}``, and
single chunks at ``chunks/{prefix}/{hash}`` (read by the DCN server).
The landing's decode reads entries through read-only maps
(:meth:`XorbCache.get_with_range_mapped`) and, for stored chunks, straight
from the entry file (:meth:`XorbCache.locate_with_range`).
:class:`XorbRegistry` is the seeding node's in-memory index of that cache
(``serve`` scans it at start, ``POST /v1/push`` adds what a push minted).
A cache write that hits ENOSPC raises :class:`CacheFullError` after its
temp file is gone and the disk-full hook (the tenancy evictor) ran; a
read freshens the entry's mtime, so that evictor's pass is LRU.
"""

from __future__ import annotations

import errno
import mmap
import os
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path

from zest_tpu_torch.config import Config


class CacheFullError(OSError):
    """Typed ENOSPC for cache writes: the write's temp file is already
    removed, a ``disk_pressure`` event was recorded and, when a disk-full
    hook is installed (the tenancy layer's eviction pass), eviction
    already ran. The fetch path treats it as "could not cache" and keeps
    serving; a pull that cannot progress at all fails with this error."""

    def __init__(self, msg: str, path: Path | str | None = None):
        super().__init__(errno.ENOSPC, msg)
        self.path = str(path) if path is not None else None


# The tenancy layer's eviction pass (``transfer.tenancy`` installs it;
# None while tenancy is off or unconfigured). Called on ENOSPC; True when
# it freed anything, which earns the write one retry.
_disk_full_hook = None


def set_disk_full_hook(fn) -> None:
    global _disk_full_hook
    _disk_full_hook = fn


def note_disk_full(path) -> bool:
    """Record disk pressure and run the eviction hook; True when the hook
    freed space."""
    from zest_tpu_torch import telemetry

    telemetry.record("disk_pressure", path=str(path))
    hook = _disk_full_hook
    if hook is None:
        return False
    try:
        return bool(hook())
    except Exception:  # noqa: BLE001 - eviction is advisory
        return False


def atomic_write(path: Path, data: bytes) -> None:
    """Write via tmp file + rename so readers never see partial content.
    ENOSPC raises :class:`CacheFullError`; the payload is replayable, so
    the write is retried once when the eviction hook freed space."""
    try:
        atomic_write_stream(path, (data,))
    except CacheFullError:
        # note_disk_full (and the eviction pass) already ran: one retry.
        atomic_write_stream(path, (data,), _retry=True)


def atomic_write_stream(path: Path, chunks, _retry: bool = False) -> int:
    """:func:`atomic_write` fed by an iterator of byte chunks; returns
    the byte count. The warm fetch streams CDN bodies straight to their
    cache file through this, so no whole-unit buffer is built.

    ENOSPC raises :class:`CacheFullError` after the temp file is gone and
    :func:`note_disk_full` ran. There is no retry: the iterator is used
    up. Any error the iterator raises (a body cut short) removes the temp
    file too, so nothing is renamed into place."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-")
    n = 0
    try:
        with os.fdopen(fd, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
                n += len(chunk)
        os.replace(tmp, path)
    except BaseException as exc:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        if isinstance(exc, OSError) and exc.errno == errno.ENOSPC \
                and not isinstance(exc, CacheFullError):
            if not _retry:
                note_disk_full(path)
            raise CacheFullError(
                f"cache write of {path} hit ENOSPC", path) from exc
        raise
    return n


def durable_replace(tmp: str | Path, dest: Path) -> None:
    """fsync ``tmp``, then rename it over ``dest``: the file pipeline's
    commit barrier, so a pull killed mid-write leaves no complete-named
    partial file."""
    fd = os.open(tmp, os.O_RDWR)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, dest)


def write_ref(cfg: Config, repo_id: str, ref: str, commit_sha: str) -> None:
    """Record ``refs/{ref} -> commit_sha`` in the HF cache layout."""
    atomic_write(cfg.model_refs_dir(repo_id) / ref, commit_sha.encode())


def read_ref(cfg: Config, repo_id: str, ref: str) -> str | None:
    try:
        return (cfg.model_refs_dir(repo_id) / ref).read_text().strip()
    except OSError:
        return None


def list_models(cfg: Config) -> list[dict]:
    """Pulled models in the HF hub cache: one row per ``models--*`` dir
    with its newest snapshot revision and file count (``repo_id``,
    ``revision``, ``files``), for the daemon's ``/v1/models`` and the
    ``models`` command."""
    models = []
    hub = cfg.hf_home / "hub"
    if hub.is_dir():
        for d in sorted(hub.iterdir()):
            if not d.name.startswith("models--") or not d.is_dir():
                continue
            repo_id = d.name[len("models--"):].replace("--", "/", 1)
            snapshots = d / "snapshots"
            n_files = 0
            revision = None
            if snapshots.is_dir():
                # Dirs only: a file beside the snapshots is no revision.
                revs = sorted((p for p in snapshots.iterdir() if p.is_dir()),
                              key=lambda p: p.stat().st_mtime)
                if revs:
                    revision = revs[-1].name
                    n_files = sum(1 for f in revs[-1].rglob("*")
                                  if f.is_file())
            models.append({"repo_id": repo_id, "revision": revision,
                           "files": n_files})
    return models


def read_chunk(cfg: Config, chunk_hash: bytes) -> bytes | None:
    """A chunk from the chunk cache, or None."""
    try:
        return cfg.chunk_cache_path(chunk_hash.hex()).read_bytes()
    except OSError:
        return None


def _touch_for_lru(fileno_or_path) -> None:
    """Freshen an entry's mtime on read, so the evictor's
    oldest-mtime-first pass is LRU and not write-time FIFO."""
    try:
        os.utime(fileno_or_path)
    except OSError:
        pass


@dataclass(frozen=True)
class CacheResult:
    """A serialized xorb whose chunk 0 is absolute chunk ``chunk_offset``
    of the full xorb."""

    data: bytes
    chunk_offset: int


class XorbCache:
    """Full (``{hash}``) and partial (``{hash}.{range_start}``) xorbs on
    disk; every fetched entry is kept so this host can serve it."""

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def _path(self, key: str) -> Path:
        return self.cfg.xorb_cache_path(key)

    def has(self, hash_hex: str) -> bool:
        return self._path(hash_hex).exists()

    def get(self, hash_hex: str) -> bytes | None:
        try:
            with open(self._path(hash_hex), "rb") as f:
                _touch_for_lru(f.fileno())
                return f.read()
        except OSError:
            return None

    def get_with_range(self, hash_hex: str, range_start: int,
                       covers=None) -> CacheResult | None:
        """Full xorb first (offset 0), then the exact partial entry.
        ``covers(result) -> bool`` lets a non-covering candidate fall
        through to the next one instead of shadowing it."""
        for key, offset in ((hash_hex, 0),
                            (f"{hash_hex}.{range_start}", range_start)):
            data = self.get(key)
            if data is not None:
                result = CacheResult(data, offset)
                if covers is None or covers(result):
                    return result
        return None

    def _get_mapped(self, key: str) -> memoryview | None:
        """Read-only map of one entry, or None: the decoder reads the page
        cache in place instead of a whole-file copy. The map lives as long
        as the view; an entry overwritten by rename keeps its old inode
        for existing maps."""
        try:
            with open(self._path(key), "rb") as f:
                if os.fstat(f.fileno()).st_size == 0:
                    return memoryview(b"")
                _touch_for_lru(f.fileno())
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            return None
        try:
            mm.madvise(mmap.MADV_WILLNEED)
        except (AttributeError, OSError):
            pass  # advisory only
        return memoryview(mm)

    def get_with_range_mapped(self, hash_hex: str,
                              range_start: int) -> CacheResult | None:
        """:meth:`get_with_range` (no ``covers``) over read-only maps."""
        for key, offset in ((hash_hex, 0),
                            (f"{hash_hex}.{range_start}", range_start)):
            data = self._get_mapped(key)
            if data is not None:
                return CacheResult(data, offset)
        return None

    def locate_with_range(self, hash_hex: str,
                          range_start: int) -> tuple[Path, int] | None:
        """``(path, chunk_offset)`` of the entry file serving this range,
        full xorb first, or None. Writes go through a rename, so a path
        seen here is a complete entry."""
        for key, offset in ((hash_hex, 0),
                            (f"{hash_hex}.{range_start}", range_start)):
            p = self._path(key)
            if p.exists():
                _touch_for_lru(p)
                return p, offset
        return None

    def put(self, hash_hex: str, data: bytes) -> None:
        atomic_write(self._path(hash_hex), data)

    def put_partial(self, hash_hex: str, range_start: int,
                    data: bytes) -> None:
        atomic_write(self._path(f"{hash_hex}.{range_start}"), data)

    def put_stream(self, hash_hex: str, chunks) -> int:
        return atomic_write_stream(self._path(hash_hex), chunks)

    def put_partial_stream(self, hash_hex: str, range_start: int,
                           chunks) -> int:
        return atomic_write_stream(
            self._path(f"{hash_hex}.{range_start}"), chunks)


def list_cached_xorbs(cfg: Config) -> list[str]:
    """Every full-xorb hex key in the cache, sorted. Partial entries
    (``{hex}.{start}``) are left out: a seeder announces whole xorbs."""
    root = cfg.xorb_cache_dir()
    if not root.is_dir():
        return []
    return sorted(f.name for sub in root.iterdir() if sub.is_dir()
                  for f in sub.iterdir()
                  if len(f.name) == 64 and "." not in f.name)


@dataclass
class RegistryEntry:
    hash_hex: str
    size: int
    partial_starts: tuple[int, ...] = ()


class XorbRegistry:
    """In-memory index of locally available xorbs (reference:
    storage.zig:148-196). ``scan()`` rebuilds it from the cache
    directory (full entries and ``{hex}.{start}`` partial ones) when the
    daemon starts; ``POST /v1/push`` adds the xorbs a push minted."""

    def __init__(self) -> None:
        self._entries: dict[str, RegistryEntry] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def add(self, hash_hex: str, size: int,
            partial_starts: tuple[int, ...] = ()) -> None:
        with self._lock:
            prev = self._entries.get(hash_hex)
            if prev is not None:
                partial_starts = tuple(
                    sorted(set(prev.partial_starts) | set(partial_starts))
                )
                size = max(size, prev.size)
            self._entries[hash_hex] = RegistryEntry(hash_hex, size, partial_starts)

    def has(self, hash_hex: str) -> bool:
        with self._lock:
            return hash_hex in self._entries

    def get(self, hash_hex: str) -> RegistryEntry | None:
        with self._lock:
            return self._entries.get(hash_hex)

    def all_hashes(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def scan(self, cfg: Config) -> int:
        """Rebuild from the on-disk cache; returns the number of entries."""
        root = cfg.xorb_cache_dir()
        found: dict[str, RegistryEntry] = {}
        if root.is_dir():
            for sub in root.iterdir():
                if not sub.is_dir():
                    continue
                for f in sub.iterdir():
                    name = f.name
                    if name.startswith(".tmp-"):
                        continue
                    try:
                        size = f.stat().st_size
                    except OSError:
                        continue
                    if len(name) == 64:
                        e = found.setdefault(name, RegistryEntry(name, 0))
                        found[name] = RegistryEntry(
                            name, size, e.partial_starts
                        )
                    elif len(name) > 65 and name[64] == ".":
                        hex_part, _, start = name.partition(".")
                        if len(hex_part) == 64 and start.isdigit():
                            e = found.setdefault(
                                hex_part, RegistryEntry(hex_part, 0)
                            )
                            found[hex_part] = RegistryEntry(
                                hex_part, e.size,
                                tuple(sorted(set(e.partial_starts) | {int(start)})),
                            )
        with self._lock:
            self._entries = found
            return len(self._entries)
