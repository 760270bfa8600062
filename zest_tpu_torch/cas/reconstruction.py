"""Reconstruction metadata: how a file is reassembled from xorb chunks.

A file maps to an ordered list of **terms** — (xorb hash, chunk range) —
plus a **fetch_info** map telling the client where each xorb's bytes can
be fetched (URL + byte range) and which chunk range that URL covers.
Three coordinate frames meet here:

  - term.range         — absolute chunk indices within the xorb
  - fetch_info.range   — absolute chunk indices covered by one URL
  - local indices      — term.range rebased into the fetched blob:
                         ``local = term.range - chunk_offset``
"""

from __future__ import annotations

from dataclasses import dataclass, field

from zest_tpu_torch.cas import hashing


@dataclass(frozen=True)
class ChunkRange:
    """Half-open chunk-index range [start, end)."""

    start: int
    end: int

    def __post_init__(self):
        if not (0 <= self.start < self.end):
            raise ValueError(f"invalid chunk range [{self.start},{self.end})")

    def covers(self, other: "ChunkRange") -> bool:
        return self.start <= other.start and self.end >= other.end


@dataclass(frozen=True)
class Term:
    """One segment of a file: chunks [range.start, range.end) of ``xorb_hash``."""

    xorb_hash: bytes
    range: ChunkRange
    unpacked_length: int

    @property
    def hash_hex(self) -> str:
        return hashing.hash_to_hex(self.xorb_hash)


@dataclass(frozen=True)
class FetchInfo:
    """Where to fetch (part of) a xorb: ``url`` serves byte range
    [url_range_start, url_range_end) which decodes to chunks
    [range.start, range.end) of the xorb."""

    url: str
    url_range_start: int
    url_range_end: int
    range: ChunkRange


@dataclass
class Reconstruction:
    """Full reconstruction plan for one file."""

    file_hash: bytes
    terms: list[Term]
    fetch_info: dict[str, list[FetchInfo]] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(t.unpacked_length for t in self.terms)

    def find_fetch_info(self, term: Term) -> FetchInfo | None:
        """The fetch_info entry covering this term's chunk range."""
        for fi in self.fetch_info.get(term.hash_hex, []):
            if fi.range.covers(term.range):
                return fi
        return None


class ReconstructionError(ValueError):
    pass


def from_json(file_hash_hex: str, doc: dict) -> Reconstruction:
    """Parse the CAS reconstruction response.

    Wire shape (our CAS protocol; field names follow HF's Xet API):

        {"terms": [{"hash": hex, "range": {"start": s, "end": e},
                    "unpacked_length": n}, ...],
         "fetch_info": {hex: [{"url": u,
                               "url_range": {"start": b0, "end": b1},
                               "range": {"start": s, "end": e}}, ...]}}
    """
    try:
        terms = [
            Term(
                xorb_hash=hashing.hex_to_hash(t["hash"]),
                range=ChunkRange(t["range"]["start"], t["range"]["end"]),
                unpacked_length=int(t["unpacked_length"]),
            )
            for t in doc["terms"]
        ]
        fetch_info = {
            h: [
                FetchInfo(
                    url=fi["url"],
                    url_range_start=int(fi["url_range"]["start"]),
                    # The wire "url_range.end" is INCLUSIVE (production
                    # semantics: the client requests exactly
                    # ``Range: bytes={start}-{end}``); internally we keep
                    # half-open [start, end).
                    url_range_end=int(fi["url_range"]["end"]) + 1,
                    range=ChunkRange(fi["range"]["start"], fi["range"]["end"]),
                )
                for fi in entries
            ]
            for h, entries in doc.get("fetch_info", {}).items()
        }
    except (KeyError, TypeError, ValueError) as exc:
        raise ReconstructionError(f"malformed reconstruction: {exc}") from exc
    return Reconstruction(
        file_hash=hashing.hex_to_hash(file_hash_hex),
        terms=terms,
        fetch_info=fetch_info,
    )


def to_json(rec: Reconstruction) -> dict:
    """Serialize (what the publisher endpoint answers).

    ``offset_into_first_range`` is part of the production response schema
    (cas_types ``QueryReconstructionResponse``) — nonzero only for ranged
    file queries, which we don't issue; the real client requires the field.
    """
    return {
        "offset_into_first_range": 0,
        "terms": [
            {
                "hash": t.hash_hex,
                "range": {"start": t.range.start, "end": t.range.end},
                "unpacked_length": t.unpacked_length,
            }
            for t in rec.terms
        ],
        "fetch_info": {
            h: [
                {
                    "url": fi.url,
                    # Inclusive end on the wire (see from_json).
                    "url_range": {
                        "start": fi.url_range_start,
                        "end": fi.url_range_end - 1,
                    },
                    "range": {"start": fi.range.start, "end": fi.range.end},
                }
                for fi in entries
            ]
            for h, entries in rec.fetch_info.items()
        },
    }
