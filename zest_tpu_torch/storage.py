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
"""

from __future__ import annotations

import mmap
import os
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path

from zest_tpu_torch.config import Config


def atomic_write(path: Path, data: bytes) -> None:
    """Write via tmp file + rename so readers never see partial content."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


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
            return self._path(hash_hex).read_bytes()
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
                return p, offset
        return None

    def put(self, hash_hex: str, data: bytes) -> None:
        atomic_write(self._path(hash_hex), data)

    def put_partial(self, hash_hex: str, range_start: int,
                    data: bytes) -> None:
        atomic_write(self._path(f"{hash_hex}.{range_start}"), data)


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
