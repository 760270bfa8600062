"""The HBM staging tier: xorb blobs resident in device memory above the
disk cache.

The counterpart of ``zest_tpu/parallel/hbm.py``. Blobs are uint8 tensors
on the cache's device (``cuda`` unless the caller passes ``cpu``), under
an LRU byte budget (``Config.hbm_staging_bytes``), with the range contract
of ``storage.XorbCache``: ``{hash}`` keys full xorbs, ``{hash}.{start}``
partial ones, and ``get_with_range`` takes the same ``covers`` predicate,
so the waterfall cannot tell the tiers apart. :class:`TieredCache` puts
it above the disk cache: reads try the device first and promote disk
hits, writes go to both.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from zest_tpu_torch import telemetry
from zest_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from zest_tpu_torch.storage import CacheResult

_M_EVENTS = telemetry.counter(
    "zest_hbm_cache_events_total",
    "HBM staging-cache events (hit/miss/eviction)", ("event",))


@dataclass
class HbmEntry:
    tensor: torch.Tensor      # uint8[length] on the cache's device
    chunk_offset: int

    @property
    def nbytes(self) -> int:
        return int(self.tensor.numel())


class HbmStagingCache:
    """LRU cache of xorb blobs in device memory. ``device`` is ``cuda``
    by default; asking for it without a card raises."""

    def __init__(self, budget_bytes: int, device=DEFAULT_DEVICE):
        self.budget_bytes = int(budget_bytes)
        self.device = resolve_device(device)
        self._entries: OrderedDict[str, HbmEntry] = OrderedDict()
        self._used = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _insert(self, key: str, data: bytes, chunk_offset: int) -> None:
        if len(data) > self.budget_bytes:
            return  # larger than the whole tier: the disk tier has it
        host = torch.empty(len(data), dtype=torch.uint8)
        host.numpy()[:] = np.frombuffer(data, dtype=np.uint8)
        t = host.to(self.device)
        with self._lock:
            prev = self._entries.pop(key, None)
            if prev is not None:
                self._used -= prev.nbytes
            while self._used + len(data) > self.budget_bytes \
                    and self._entries:
                _, evicted = self._entries.popitem(last=False)
                self._used -= evicted.nbytes
                self.evictions += 1
                _M_EVENTS.inc(event="eviction")
            self._entries[key] = HbmEntry(t, chunk_offset)
            self._used += len(data)

    def put(self, hash_hex: str, data: bytes) -> None:
        self._insert(hash_hex, data, 0)

    def put_partial(self, hash_hex: str, range_start: int,
                    data: bytes) -> None:
        self._insert(f"{hash_hex}.{range_start}", data, range_start)

    def _lookup(self, hash_hex: str,
                range_start: int | None = None) -> HbmEntry | None:
        """Full key, then (with ``range_start``) the partial key: the probe,
        the LRU touch and the hit/miss count under one lock, so hits +
        misses equals the number of gets."""
        with self._lock:
            key = hash_hex
            entry = self._entries.get(key)
            if entry is None and range_start is not None:
                key = f"{hash_hex}.{range_start}"
                entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        _M_EVENTS.inc(event="hit" if entry is not None else "miss")
        return entry

    def get_device(self, hash_hex: str,
                   range_start: int = 0) -> HbmEntry | None:
        """The resident entry itself (its tensor stays on the device)."""
        return self._lookup(hash_hex, range_start if range_start else None)

    @staticmethod
    def _result(entry: HbmEntry) -> CacheResult:
        return CacheResult(entry.tensor.cpu().numpy().tobytes(),
                           entry.chunk_offset)

    def get_with_range(self, hash_hex: str, range_start: int,
                       covers=None) -> CacheResult | None:
        """Full entry first, then the partial keyed by ``range_start``,
        bytes back on the host. With ``covers``, a full entry that does
        not cover falls through to the partial instead of shadowing it."""
        if covers is None:
            entry = self._lookup(hash_hex, range_start)
            return None if entry is None else self._result(entry)
        for key in (hash_hex, f"{hash_hex}.{range_start}"):
            entry = self._lookup(key)
            if entry is not None:
                result = self._result(entry)
                if covers(result):
                    return result
        return None

    def has(self, hash_hex: str) -> bool:
        with self._lock:
            return hash_hex in self._entries

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def summary(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "used_bytes": self._used,
                "budget_bytes": self.budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }


class TieredCache:
    """The HBM tier above the disk tier with the waterfall's semantics:
    reads hit the device first and promote disk hits; writes go to both
    (the disk stays the durable copy a seeder serves from)."""

    def __init__(self, disk, hbm: HbmStagingCache):
        self.disk = disk
        self.hbm = hbm

    def has(self, hash_hex: str) -> bool:
        return self.hbm.has(hash_hex) or self.disk.has(hash_hex)

    def get_with_range(self, hash_hex: str, range_start: int,
                       covers=None) -> CacheResult | None:
        res = self.hbm.get_with_range(hash_hex, range_start, covers=covers)
        if res is not None:
            return res
        res = self.disk.get_with_range(hash_hex, range_start, covers=covers)
        if res is not None:
            if res.chunk_offset == 0:
                self.hbm.put(hash_hex, res.data)
            else:
                self.hbm.put_partial(hash_hex, res.chunk_offset, res.data)
        return res

    def put(self, hash_hex: str, data: bytes) -> None:
        self.disk.put(hash_hex, data)
        self.hbm.put(hash_hex, data)

    def put_partial(self, hash_hex: str, range_start: int,
                    data: bytes) -> None:
        self.disk.put_partial(hash_hex, range_start, data)
        self.hbm.put_partial(hash_hex, range_start, data)
