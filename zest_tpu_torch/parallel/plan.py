"""Fetch units and the pod round's ownership plan.

The counterpart of ``zest_tpu/parallel/plan.py``. A unit is one
``fetch_info`` chunk range of one xorb, keyed by ``(xorb hash hex, range
start)``; every planner (the cooperative round's byte-balanced plan, the
pod round's :class:`DistributionPlan`) shares this one collection so
policies differ without re-collecting. The pod round's ownership is a
pure function: rendezvous hashing of (xorb hash, range start, host), so
every host computes the same plan without coordination.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.reconstruction import FetchInfo, Reconstruction

UnitKey = tuple[str, int]
Unit = tuple[UnitKey, FetchInfo]


def collect_units(recs: list[Reconstruction]) -> list[Unit]:
    """Deduplicated, sorted fetch units for a set of reconstructions.

    A xorb range shared across files (or repeated terms) is fetched once.
    Keeps the widest entry per start — a narrower duplicate would leave
    later readers short of chunks."""
    units: dict[UnitKey, FetchInfo] = {}
    for rec in recs:
        for hash_hex, entries in rec.fetch_info.items():
            for fi in entries:
                key = (hash_hex, fi.range.start)
                prev = units.get(key)
                if prev is None or fi.range.end > prev.range.end:
                    units[key] = fi
    return sorted(units.items())


def owner_host(xorb_hash: bytes, range_start: int, num_hosts: int) -> int:
    """Rendezvous-hash (highest random weight) owner of one fetch unit
    among ``num_hosts``: every host computes the same owner with no
    coordination, and a host leaving remaps only its own share."""
    if num_hosts <= 0:
        raise ValueError("num_hosts must be positive")
    if num_hosts == 1:
        return 0
    tail = struct.pack("<Q", range_start)
    best_host, best_score = 0, b""
    for h in range(num_hosts):
        score = hashing.blake3_hash(xorb_hash + tail + struct.pack("<Q", h))
        if score > best_score:
            best_host, best_score = h, score
    return best_host


@dataclass(frozen=True)
class FetchAssignment:
    """One fetch unit: a xorb's fetch_info range, owned by ``owner``."""

    hash_hex: str
    fetch_info: FetchInfo
    owner: int

    @property
    def est_bytes(self) -> int:
        """Compressed transfer size: the load-balance weight."""
        return self.fetch_info.url_range_end - self.fetch_info.url_range_start


@dataclass
class DistributionPlan:
    """The pod round's fetch schedule for a set of files, built the same
    on every host from the same reconstructions (units sorted by key
    before assignment), so no plan is exchanged."""

    num_hosts: int
    assignments: list[FetchAssignment] = field(default_factory=list)
    _by_owner: dict[int, list[FetchAssignment]] | None = field(
        default=None, repr=False, compare=False)

    @staticmethod
    def build(recs: list[Reconstruction],
              num_hosts: int) -> "DistributionPlan":
        return DistributionPlan(num_hosts, [
            FetchAssignment(hh, fi, owner_host(hashing.hex_to_hash(hh),
                                               start, num_hosts))
            for (hh, start), fi in collect_units(recs)])

    def by_owner(self) -> dict[int, list[FetchAssignment]]:
        """Assignments grouped by owner, built once."""
        if self._by_owner is None:
            grouped: dict[int, list[FetchAssignment]] = {}
            for a in self.assignments:
                grouped.setdefault(a.owner, []).append(a)
            self._by_owner = grouped
        return self._by_owner

    def for_host(self, host: int) -> list[FetchAssignment]:
        """The units ``host`` sources through the waterfall."""
        return self.by_owner().get(host, [])

    def bytes_per_host(self) -> list[int]:
        out = [0] * self.num_hosts
        for a in self.assignments:
            out[a.owner] += a.est_bytes
        return out

    @property
    def total_bytes(self) -> int:
        return sum(a.est_bytes for a in self.assignments)

    def summary(self) -> dict:
        per_host = self.bytes_per_host()
        peak = max(per_host) if per_host else 0
        mean = self.total_bytes / self.num_hosts if self.num_hosts else 0
        return {
            "units": len(self.assignments),
            "hosts": self.num_hosts,
            "total_bytes": self.total_bytes,
            "bytes_per_host": per_host,
            # 1.0: every host fetches the same share.
            "balance": round(mean / peak, 4) if peak else 1.0,
        }
