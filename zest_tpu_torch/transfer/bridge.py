"""XetBridge: the cache → CDN waterfall.

The counterpart of ``zest_tpu/transfer/bridge.py`` with tier 1 (the local
xorb cache, range-aware) and tier 3 (CDN byte ranges); the swarm's peer
tier comes with the p2p slice. Peer bytes come only from the cooperative
exchange (``transfer/coop.py``), which books them under ``peer``. Every
fetch is cached — under the full key only with whole-xorb evidence, else
as a partial entry keyed by its chunk offset, and never over a wider
entry — so this host can serve it on.

Coordinate frames: a fetched blob's chunk 0 is absolute chunk
``chunk_offset``; a term extracts ``[term.start - chunk_offset,
term.end - chunk_offset)`` from it.

:meth:`XetBridge.fetch_term` is the landing's per-term waterfall: a
cached blob whose chunks fail to decode is refetched from the CDN and the
term decodes from those bytes. Once any file's references could not be
resolved (:meth:`XetBridge.mark_evidence_incomplete`), no blob is cached
under a full key for the rest of the bridge's life.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from zest_tpu_torch import storage
from zest_tpu_torch.cas import reconstruction as recon
from zest_tpu_torch.cas.client import CasClient, CasError
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.cas.xorb import XorbReader
from zest_tpu_torch.config import Config


class BridgeError(RuntimeError):
    pass


# What a fetch through the waterfall can raise when a tier fails: the
# callers that degrade a unit to a later tier catch exactly these.
FETCH_ERRORS = (BridgeError, CasError, OSError)

# Hash-striped locks for the never-narrower cache write: the clobber race
# is between bridges (several hosts of one process share no bridge), so
# the locks are process-wide.
_WRITE_LOCKS = tuple(threading.Lock() for _ in range(64))


def _write_lock(hash_hex: str) -> threading.Lock:
    try:
        return _WRITE_LOCKS[int(hash_hex[:2], 16) % len(_WRITE_LOCKS)]
    except ValueError:
        return _WRITE_LOCKS[0]


@dataclass
class FetchStats:
    """Per-pull source accounting, in the JAX package's summary schema."""

    xorbs_from_cache: int = 0
    xorbs_from_peer: int = 0
    xorbs_from_cdn: int = 0
    bytes_from_cache: int = 0
    bytes_from_peer: int = 0
    bytes_from_cdn: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, source: str, nbytes: int) -> None:
        with self._lock:
            setattr(self, f"xorbs_from_{source}",
                    getattr(self, f"xorbs_from_{source}") + 1)
            setattr(self, f"bytes_from_{source}",
                    getattr(self, f"bytes_from_{source}") + nbytes)

    @property
    def p2p_ratio(self) -> float:
        total = self.bytes_from_peer + self.bytes_from_cdn
        return self.bytes_from_peer / total if total else 0.0

    def summary(self, cdn_retries: int = 0) -> dict:
        return {
            "xorbs": {"cache": self.xorbs_from_cache,
                      "peer": self.xorbs_from_peer,
                      "cdn": self.xorbs_from_cdn},
            "bytes": {"cache": self.bytes_from_cache,
                      "peer": self.bytes_from_peer,
                      "cdn": self.bytes_from_cdn},
            "p2p_ratio": round(self.p2p_ratio, 4),
            "resilience": {"cdn_retries": cdn_retries},
        }


@dataclass(frozen=True)
class XorbFetchResult:
    """Blob + the term's chunk range rebased into it."""

    data: bytes
    local_start: int
    local_end: int
    source: str = "cache"                      # cache | cdn


def _blob_covers(data: bytes, local_start: int, local_end: int) -> bool:
    """The blob parses as a frame stream holding [local_start, local_end)."""
    if local_start < 0 or local_end <= local_start:
        return False
    try:
        return len(XorbReader(data)) >= local_end
    except ValueError:
        return False


def provably_whole(entries, chunk_offset: int) -> bool:
    """A blob fetched at ``chunk_offset`` is the whole xorb only when every
    known reference to it is the same single range starting at chunk 0."""
    ranges = {(e.range.start, e.range.end) for e in entries}
    return (chunk_offset == 0 and len(ranges) == 1
            and next(iter(ranges))[0] == 0)


class XetBridge:
    def __init__(self, cfg: Config, cache: storage.XorbCache | None = None):
        self.cfg = cfg
        self.cache = cache or storage.XorbCache(cfg)
        self.cas: CasClient | None = None
        self.stats = FetchStats()
        self._recons: dict[str, recon.Reconstruction] = {}
        self._lock = threading.Lock()
        # A DCN listener the cooperative round started for this pull
        # (transfer/coop.py): peers still mid-exchange read from it after
        # this host's round returned, so it lives until close().
        self._coop_server = None
        # Set when some file's reconstruction could not be resolved: the
        # whole-xorb evidence is then incomplete for every xorb.
        self.evidence_incomplete = False

    def adopt_coop_server(self, server) -> None:
        """Own a coop-round DCN listener until :meth:`close`."""
        self._coop_server = server

    def close(self) -> None:
        """Stop the coop-round DCN listener this bridge owns, if any."""
        server, self._coop_server = self._coop_server, None
        if server is not None:
            server.shutdown()

    def authenticate(self, repo_id: str, revision: str = "main",
                     hub: HubClient | None = None) -> None:
        hub = hub or HubClient(self.cfg)
        cas_url, token = hub.xet_read_token(repo_id, revision)
        self.cas = CasClient(
            cas_url, token,
            token_refresher=lambda: hub.xet_read_token(repo_id, revision))

    def get_reconstruction(self, file_hash_hex: str) -> recon.Reconstruction:
        """Memoized: reconstructions are content-addressed and immutable."""
        if self.cas is None:
            raise BridgeError("call authenticate() first")
        with self._lock:
            cached = self._recons.get(file_hash_hex)
        if cached is None:
            cached = self.cas.get_reconstruction(file_hash_hex)
            with self._lock:
                cached = self._recons.setdefault(file_hash_hex, cached)
        return cached

    def known_reconstruction(self, file_hash_hex: str
                             ) -> recon.Reconstruction | None:
        with self._lock:
            return self._recons.get(file_hash_hex)

    # ── The waterfall ──

    def fetch_xorb_for_term(self, term: recon.Term,
                            rec: recon.Reconstruction) -> XorbFetchResult:
        fi = rec.find_fetch_info(term)
        if fi is None:
            raise BridgeError(f"no fetch info covers chunks "
                              f"[{term.range.start},{term.range.end}) of "
                              f"{term.hash_hex}")
        # 1. Local cache: the full xorb, or the partial entry for fi's
        # range — whichever actually covers the term.
        def covers(res: storage.CacheResult) -> bool:
            return _blob_covers(res.data,
                                term.range.start - res.chunk_offset,
                                term.range.end - res.chunk_offset)

        hit = self.cache.get_with_range(term.hash_hex, fi.range.start,
                                        covers=covers)
        if hit is not None:
            self.stats.record("cache", len(hit.data))
            return XorbFetchResult(hit.data,
                                   term.range.start - hit.chunk_offset,
                                   term.range.end - hit.chunk_offset)
        # 3. CDN byte range — fi's whole chunk range, so the cached entry
        # also serves later terms that share this fetch_info.
        return self._cdn_fetch_for_term(term, rec, fi)

    def _cdn_fetch_for_term(self, term: recon.Term,
                            rec: recon.Reconstruction,
                            fi: recon.FetchInfo) -> XorbFetchResult:
        """Tier 3 alone: the corruption heal forces it whatever the cache
        holds."""
        if self.cas is None:
            raise BridgeError("no CAS client and the xorb is not cached")
        data = self.cas.fetch_xorb_from_url(
            self._absolute_url(fi.url),
            (fi.url_range_start, fi.url_range_end))
        self.stats.record("cdn", len(data))
        if not _blob_covers(data, term.range.start - fi.range.start,
                            term.range.end - fi.range.start):
            raise BridgeError(f"CDN blob for {term.hash_hex[:12]} does not "
                              "hold the term's chunks")
        self._cache_fetched(rec, term.hash_hex, fi.range.start, data)
        return XorbFetchResult(data, term.range.start - fi.range.start,
                               term.range.end - fi.range.start, "cdn")

    def _known_entries(self, rec: recon.Reconstruction,
                       hash_hex: str) -> list[recon.FetchInfo]:
        """Every resolved reference to ``hash_hex``, across all memoized
        reconstructions (a xorb shared by two files may look whole from
        one file's fetch_info alone)."""
        entries = list(rec.fetch_info.get(hash_hex, []))
        with self._lock:
            others = [r for r in self._recons.values() if r is not rec]
        for other in others:
            entries.extend(other.fetch_info.get(hash_hex, []))
        return entries

    def _cache_fetched(self, rec: recon.Reconstruction, hash_hex: str,
                       chunk_offset: int, data: bytes) -> None:
        """Persist a fetched blob under the whole-xorb evidence of every
        resolved reference to it."""
        self.cache_blob(hash_hex, chunk_offset, data,
                        whole=self.whole_xorb_provable(
                            self._known_entries(rec, hash_hex), chunk_offset))

    def mark_evidence_incomplete(self) -> None:
        """Some file's references could not be resolved: from here on
        every cache write uses a partial key."""
        self.evidence_incomplete = True

    def whole_xorb_provable(self, entries, chunk_offset: int) -> bool:
        """The whole-xorb evidence every cache-write site consults,
        gated on this bridge's evidence being complete."""
        return (not self.evidence_incomplete
                and provably_whole(entries, chunk_offset))

    def cache_blob(self, hash_hex: str, chunk_offset: int, data: bytes,
                   whole: bool) -> None:
        """The one guarded cache write every blob-caching site uses: the
        full key when ``whole``, else a partial key at ``chunk_offset`` —
        skipped when an entry at that offset already covers at least this
        blob's chunks (never narrower), checked and written under a
        hash-striped lock."""
        with _write_lock(hash_hex):
            existing = self.cache.get_with_range(hash_hex, chunk_offset)
            if existing is not None and existing.chunk_offset <= chunk_offset:
                try:
                    if (existing.chunk_offset + len(XorbReader(existing.data))
                            >= chunk_offset + len(XorbReader(data))):
                        return
                except ValueError:
                    pass  # corrupt entry: overwrite
            if whole:
                self.cache.put(hash_hex, data)
            else:
                self.cache.put_partial(hash_hex, chunk_offset, data)

    # ── Fetch units (the cooperative round's currency) ──

    def fetch_unit(self, hash_hex: str, fi: recon.FetchInfo) -> bytes:
        """Raw blob for one fetch unit (a fetch_info chunk range) through
        the waterfall, without term rebasing."""
        return self.fetch_unit_tiered(hash_hex, fi)[0]

    def fetch_unit_tiered(self, hash_hex: str,
                          fi: recon.FetchInfo) -> tuple[bytes, str]:
        """:meth:`fetch_unit` plus the serving tier (``cache`` | ``cdn``):
        the cooperative round books its fallback bytes per tier."""
        data = self._cached_unit(hash_hex, fi)
        if data is not None:
            self.stats.record("cache", len(data))
            return data, "cache"
        if self.cas is None:
            raise BridgeError("no CAS client and the unit is not cached")
        data = self.cas.fetch_xorb_from_url(
            self._absolute_url(fi.url),
            (fi.url_range_start, fi.url_range_end))
        self.stats.record("cdn", len(data))
        return data, "cdn"

    def _cached_unit(self, hash_hex: str,
                     fi: recon.FetchInfo) -> bytes | None:
        """The unit's bytes from a covering cache entry, re-framed to
        exactly the unit's chunk range, or None (miss or corrupt entry)."""
        sliced: list[bytes] = []

        def covers(res: storage.CacheResult) -> bool:
            lo = fi.range.start - res.chunk_offset
            hi = fi.range.end - res.chunk_offset
            try:
                reader = XorbReader(res.data)
            except ValueError:
                return False  # corrupt entry: fall through, CDN heals
            if not (0 <= lo < hi <= len(reader)):
                return False
            sliced.append(res.data if lo == 0 and len(reader) == hi
                          else reader.slice_range(lo, hi))
            return True

        if self.cache.get_with_range(hash_hex, fi.range.start,
                                     covers=covers) is None:
            return None
        return sliced[0]

    def _absolute_url(self, url: str) -> str:
        if url.startswith(("http://", "https://")):
            return url
        if self.cas is None:
            raise BridgeError("relative fetch url without a CAS client")
        return self.cas.cas_url + url

    # ── Term extraction + file reconstruction ──

    def extract_term_into(self, term: recon.Term, result: XorbFetchResult,
                          out) -> None:
        """Decode the term's chunks into ``out`` (exactly
        ``term.unpacked_length`` bytes); a blob with a footer verifies
        every chunk's hash on the way."""
        reader = XorbReader(result.data)
        n = reader.extract_range_into(result.local_start, result.local_end,
                                      out)
        if n != term.unpacked_length:
            raise BridgeError(f"term decoded to {n} bytes, expected "
                              f"{term.unpacked_length}")

    def fetch_term(self, term: recon.Term,
                   rec: recon.Reconstruction) -> bytes:
        """The term's bytes through the waterfall. A cached blob that
        fails to decode is refetched once from the CDN and decoded from
        those bytes; CDN bytes that fail raise."""
        result = self.fetch_xorb_for_term(term, rec)
        out = bytearray(term.unpacked_length)
        try:
            self.extract_term_into(term, result, out)
        except (BridgeError, ValueError):
            fi = rec.find_fetch_info(term)
            if result.source == "cdn" or fi is None or self.cas is None:
                raise
            self.extract_term_into(
                term, self._cdn_fetch_for_term(term, rec, fi), out)
        return bytes(out)

    def reconstruct_to_file(self, file_hash_hex: str, out_path) -> int:
        """Fetch every term (in parallel, ``max_concurrent_downloads``
        wide), decode each into its place in the file, write atomically."""
        rec = self.get_reconstruction(file_hash_hex)
        offsets, total = [], 0
        for term in rec.terms:
            offsets.append(total)
            total += term.unpacked_length
        buf = bytearray(total)
        view = memoryview(buf)

        def work(i: int) -> None:
            term = rec.terms[i]
            start = offsets[i]
            self.extract_term_into(
                term, self.fetch_xorb_for_term(term, rec),
                view[start:start + term.unpacked_length])

        width = max(1, min(len(rec.terms), self.cfg.max_concurrent_downloads))
        with ThreadPoolExecutor(width, thread_name_prefix="zest-term") as pool:
            for fut in [pool.submit(work, i) for i in range(len(rec.terms))]:
                fut.result()
        view.release()
        storage.atomic_write(out_path, buf)
        return total
