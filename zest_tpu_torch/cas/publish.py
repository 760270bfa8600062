"""CDC-dedup publishing — the CAS *write* path.

A file becomes gearhash CDC chunks (:mod:`zest_tpu_torch.cas.chunking`),
every chunk is looked up in a first-occurrence-wins index over the xorb
set the publisher already holds, and the file's reconstruction comes out
as a term list where

- a run of chunks that sit CONTIGUOUSLY in one existing xorb collapses
  into a single *referencing* term (no bytes re-uploaded), and
- new chunks are packed into new :class:`XorbBuilder` frames and
  referenced by *defining* terms.

The publisher is transport-agnostic: it never touches the network or the
disk cache. ``transfer/push.py`` feeds it base-revision xorbs (via
:meth:`Publisher.seed_xorb`), collects the xorbs it mints, and decides
where the bytes go.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from zest_tpu_torch.cas import chunking, hashing
from zest_tpu_torch.cas import reconstruction as recon
from zest_tpu_torch.cas.xorb import XorbBuilder

# File suffixes stored in Xet CAS (everything else is a "regular" file
# carried verbatim), mirroring how HF stores configs vs weights.
XET_SUFFIXES = (".safetensors", ".bin", ".pt", ".h5", ".msgpack")


def is_xet_path(path: str) -> bool:
    return path.endswith(XET_SUFFIXES)


@dataclass
class PublishedXorb:
    """A xorb minted by this publisher (new bytes entering the CAS)."""

    hash_hex: str
    blob: bytes               # frame stream (the in-pipeline blob shape)
    frame_offsets: list[int]  # len = num_chunks + 1
    full: bytes               # frames + XETBLOB footer (the CDN artifact)


@dataclass
class PublishedFile:
    """One file's publish outcome: identity, terms, and dedup split."""

    path: str
    size: int
    xet_hash: str                      # LE-u64 hex of the merkle file hash
    terms: list[recon.Term]
    reconstruction: recon.Reconstruction
    new_bytes: int = 0                 # bytes that entered NEW xorbs
    reused_bytes: int = 0              # bytes served by referencing terms


@dataclass
class ChunkIndex:
    """chunk hash → (xorb_hex, chunk_index, length), first-occurrence-wins.

    Any occurrence serves identical bytes (content addressing), so the
    first registered location is as good as any and keeps term runs
    stable across re-registration.
    """

    _by_hash: dict[bytes, tuple[str, int, int]] = field(default_factory=dict)

    def add_xorb(self, xorb_hex: str,
                 chunk_hashes: list[tuple[bytes, int]]) -> None:
        for idx, (ch, clen) in enumerate(chunk_hashes):
            self._by_hash.setdefault(ch, (xorb_hex, idx, clen))

    def lookup(self, chunk_hash: bytes) -> tuple[str, int, int] | None:
        return self._by_hash.get(chunk_hash)



class Publisher:
    """Stateful CDC-dedup encoder over a growing xorb set.

    ``chunks_per_xorb`` caps the chunks packed per minted xorb; 0 means
    no count cap. Either way a xorb closes before it would outgrow the
    format's own caps (``XorbBuilder.would_overflow``: 64 MiB serialized,
    8192 chunks), so a file of any size publishes.

    ``url_prefix`` shapes the fetch_info URLs baked into emitted
    reconstructions (``{url_prefix}{xorb_hex}``). The publisher endpoint
    serves the ``/xorbs/{hex}`` route and absolutizes the URL at serve
    time, so the default is relative.
    """

    def __init__(self, chunks_per_xorb: int = 0,
                 url_prefix: str = "/xorbs/"):
        self.chunks_per_xorb = chunks_per_xorb
        self.url_prefix = url_prefix
        self.index = ChunkIndex()
        # xorb_hex -> frame offsets; covers seeded (base) AND minted
        # xorbs — referencing terms need the offsets to place their
        # fetch_info byte ranges whichever side the xorb came from.
        self._frame_offsets: dict[str, list[int]] = {}
        self._minted: dict[str, PublishedXorb] = {}
        self._drained: set[str] = set()

    # ── xorb registration ──

    def seed_xorb(self, xorb_hex: str, frame_offsets: list[int],
                  chunk_hashes: list[tuple[bytes, int]]) -> None:
        """Register an ALREADY-STORED xorb (e.g. the base revision's,
        read back from the local cache) as dedup material. Its bytes
        are never re-emitted; terms may reference into it."""
        if xorb_hex in self._frame_offsets:
            return
        self._frame_offsets[xorb_hex] = list(frame_offsets)
        self.index.add_xorb(xorb_hex, chunk_hashes)

    def _register_built(self, builder: XorbBuilder) -> str:
        xh_hex = hashing.hash_to_hex(builder.xorb_hash())
        if xh_hex not in self._frame_offsets:
            px = PublishedXorb(xh_hex, builder.serialize(),
                               builder.frame_offsets(),
                               builder.serialize_full())
            self._frame_offsets[xh_hex] = px.frame_offsets
            self.index.add_xorb(xh_hex, builder.chunk_hashes())
            self._minted[xh_hex] = px
        return xh_hex

    def drain_new_xorbs(self) -> list[PublishedXorb]:
        """Xorbs minted since the last drain — the bytes the caller
        must now store/serve. Each xorb is handed out exactly once."""
        fresh = [px for h, px in self._minted.items()
                 if h not in self._drained]
        self._drained.update(px.hash_hex for px in fresh)
        return fresh

    # ── the dedup encode ──

    def publish_file(self, path: str, data: bytes, dedup: bool = True,
                     chunks_per_xorb: int | None = None) -> PublishedFile:
        """Encode ``data`` against the current xorb set.

        With ``dedup=False`` every chunk is packed into new xorbs even
        when the index already holds it (a cold push has no base to
        reference anyway).
        """
        pieces = [(hashing.chunk_hash(piece), piece)
                  for piece in chunking.chunk_stream(data)]
        limit = (chunks_per_xorb if chunks_per_xorb is not None
                 else self.chunks_per_xorb) or len(pieces) or 1
        terms: list[recon.Term] = []
        fetch_info: dict[str, list[recon.FetchInfo]] = {}
        new_bytes = reused_bytes = 0

        def add_term(xh_hex: str, start: int, end: int,
                     nbytes: int) -> None:
            offs = self._frame_offsets[xh_hex]
            terms.append(recon.Term(
                xorb_hash=hashing.hex_to_hash(xh_hex),
                range=recon.ChunkRange(start, end),
                unpacked_length=nbytes,
            ))
            fi = recon.FetchInfo(
                url=f"{self.url_prefix}{xh_hex}",
                url_range_start=offs[start],
                url_range_end=offs[end],
                range=recon.ChunkRange(start, end),
            )
            entries = fetch_info.setdefault(xh_hex, [])
            if fi not in entries:
                entries.append(fi)

        pending: list[tuple[bytes, bytes]] = []  # new chunks to pack

        def flush_pending() -> None:
            nonlocal new_bytes
            i = 0
            while i < len(pending):
                # Close the xorb at ``limit`` chunks or before it would
                # outgrow the format caps, whichever comes first.
                builder = XorbBuilder()
                j = i
                while (j < len(pending) and j - i < limit
                       and not builder.would_overflow(len(pending[j][1]))):
                    builder.add_chunk(pending[j][1])
                    j += 1
                nbytes = builder.uncompressed_total
                add_term(self._register_built(builder), 0, j - i, nbytes)
                new_bytes += nbytes
                i = j
            pending.clear()

        i = 0
        while i < len(pieces):
            hit = self.index.lookup(pieces[i][0]) if dedup else None
            if hit is None:
                pending.append(pieces[i])
                i += 1
                continue
            flush_pending()
            # Extend a run of chunks that sit CONTIGUOUSLY in one
            # existing xorb — the run becomes one referencing term.
            xh_hex, idx, _len = hit
            j, expect, run_bytes = i, idx, 0
            while j < len(pieces):
                nxt = self.index.lookup(pieces[j][0])
                if nxt is None or nxt[0] != xh_hex or nxt[1] != expect:
                    break
                run_bytes += len(pieces[j][1])
                expect += 1
                j += 1
            add_term(xh_hex, idx, expect, run_bytes)
            reused_bytes += run_bytes
            i = j
        flush_pending()
        file_hash = hashing.file_hash([(h, len(p)) for h, p in pieces])
        file_hex = hashing.hash_to_hex(file_hash)
        rec = recon.Reconstruction(
            file_hash=file_hash, terms=terms, fetch_info=fetch_info)
        return PublishedFile(path=path, size=len(data), xet_hash=file_hex,
                             terms=terms, reconstruction=rec,
                             new_bytes=new_bytes, reused_bytes=reused_bytes)
