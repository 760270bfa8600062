"""Fetch units: the deduplicated xorb ranges a set of files needs.

The part of ``zest_tpu/parallel/plan.py`` the cooperative pull runs. A
unit is one ``fetch_info`` chunk range of one xorb, keyed by ``(xorb hash
hex, range start)``; every planner (the cooperative round's ownership
plan here) shares this one collection so policies differ without
re-collecting.
"""

from __future__ import annotations

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
