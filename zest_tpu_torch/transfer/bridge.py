"""XetBridge: the cache → peer → CDN waterfall.

The counterpart of ``zest_tpu/transfer/bridge.py``: tier 1 is the local
xorb cache (range-aware), tier 2 the swarm (``transfer/swarm.py``: a
``SwarmDownloader`` with direct ``--peer`` candidates), tier 3 CDN byte
ranges. The cooperative exchange (``transfer/coop.py``) books its bytes
under ``peer`` too. Every fetch is cached — under the full key only with
whole-xorb evidence, else as a partial entry keyed by its chunk offset,
and never over a wider entry — so this host can serve it on.

The peer tier's trust boundary: a peer blob that is, by the evidence of
every resolved reconstruction, the whole xorb must hash back to the
xorb's merkle root (on the host, as in the JAX package) before it is
cached or used; anything else stays under the extraction-time checks. A
blob that fails is never cached, its peer takes a strike
(``SwarmDownloader.report_corrupt``) and the CDN serves. Peer bytes
cached without a whole-xorb proof keep their source in
``p2p.health.PROVENANCE``, so the seeding server can refuse them once
that peer is quarantined. With a pull deadline (``cfg.pull_deadline_s``)
or :meth:`XetBridge.arm_hedge`, a slow peer fetch is raced by the CDN
after a bounded head start.

Coordinate frames: a fetched blob's chunk 0 is absolute chunk
``chunk_offset``; a term extracts ``[term.start - chunk_offset,
term.end - chunk_offset)`` from it.

:meth:`XetBridge.fetch_term` is the landing's per-term waterfall: a
cached or peer-served blob whose chunks fail to decode is refetched from
the CDN and the term decodes from those bytes (a peer-served blob also
strikes its peer). Once any file's references could not be
resolved (:meth:`XetBridge.mark_evidence_incomplete`), no blob is cached
under a full key for the rest of the bridge's life.

With the pull service on (``transfer/tenancy.py``), ``pull_model`` wires
three shared pieces in: ``flights``, the process singleflight table — the
term and unit network tiers run under :meth:`XetBridge._deduped`, so one
fetch per ``(xorb, chunk range)`` crosses the network however many
sessions want it; ``cancel``, the session's ``CancelToken``, checked at
every term and unit; and ``on_reconstruction``, which pins each resolved
plan's xorbs against eviction. A cache write that hits ENOSPC
(``storage.CacheFullError``) is absorbed: the fetched bytes still serve.

With no peer tier, the warm fetch streams each unit's CDN body straight
into its cache file (:meth:`XetBridge.stream_unit_from_cdn`, a
``cdn.stream`` span). There a full disk or a body cut short raises (no
entry is written, and the unit falls to the landing's per-term
waterfall).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass, field

from zest_tpu_torch import storage, telemetry
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas import reconstruction as recon
from zest_tpu_torch.cas.client import CasClient, CasError
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.cas.xorb import XorbReader
from zest_tpu_torch.config import Config
from zest_tpu_torch.p2p.health import PROVENANCE
from zest_tpu_torch.storage import CacheFullError
from zest_tpu_torch.transfer.tenancy import PullCancelled

# Process-wide mirrors of the per-session FetchStats: the session object
# is the pull's report, these outlive it so a daemon's /v1/metrics sums
# every pull the process served.
_M_XORBS = telemetry.counter(
    "zest_fetch_xorbs_total", "Xorb fetches by source tier", ("source",))
_M_BYTES = telemetry.counter(
    "zest_fetch_bytes_total", "Fetched payload bytes by source tier",
    ("source",))
_M_EVENTS = telemetry.counter(
    "zest_fetch_events_total",
    "Resilience events on the fetch path (retries, hedges, heals)",
    ("event",))


class BridgeError(RuntimeError):
    pass


# What a fetch through the waterfall can raise when a tier fails: the
# callers that degrade a unit to a later tier catch exactly these.
FETCH_ERRORS = (BridgeError, CasError, OSError)

# Hedging: with a pull deadline armed, the peer tier gets at most this
# fraction of the remaining budget (capped) as a head start before a CDN
# fetch races it — one slow peer costs a bounded head start, not a 60 s
# stall. An evidence-armed hedge (arm_hedge) has no budget to take a
# fraction of and gives the peer a fixed head start.
_HEDGE_PEER_FRACTION = 0.3
_HEDGE_PEER_WAIT_CAP_S = 10.0
_HEDGE_PEER_WAIT_FLOOR_S = 0.05
_HEDGE_EVIDENCE_WAIT_S = 1.0

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
    # Resilience counters: CDN retry/backoff rounds, xet-token refreshes,
    # hedges (won = the CDN racer delivered, lost = it failed and the
    # peer tier finished after all), and corruption attributions (a
    # peer-served blob failed structural or BLAKE3 verification and was
    # refetched; healed = a term that failed to decode and decoded from
    # the CDN's bytes).
    cdn_retries: int = 0
    token_refreshes: int = 0
    hedges: int = 0
    hedges_won: int = 0
    hedges_lost: int = 0
    corrupt_from_peer: int = 0
    corrupt_healed: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, source: str, nbytes: int) -> None:
        with self._lock:
            setattr(self, f"xorbs_from_{source}",
                    getattr(self, f"xorbs_from_{source}") + 1)
            setattr(self, f"bytes_from_{source}",
                    getattr(self, f"bytes_from_{source}") + nbytes)
        _M_XORBS.inc(source=source)
        _M_BYTES.inc(nbytes, source=source)

    def bump(self, name: str, amount: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + amount)
        _M_EVENTS.inc(amount, event=name)

    @property
    def p2p_ratio(self) -> float:
        total = self.bytes_from_peer + self.bytes_from_cdn
        return self.bytes_from_peer / total if total else 0.0

    def summary(self) -> dict:
        return {
            "xorbs": {"cache": self.xorbs_from_cache,
                      "peer": self.xorbs_from_peer,
                      "cdn": self.xorbs_from_cdn},
            "bytes": {"cache": self.bytes_from_cache,
                      "peer": self.bytes_from_peer,
                      "cdn": self.bytes_from_cdn},
            "p2p_ratio": round(self.p2p_ratio, 4),
            "resilience": {
                "cdn_retries": self.cdn_retries,
                "token_refreshes": self.token_refreshes,
                "hedges": self.hedges,
                "hedges_won": self.hedges_won,
                "hedges_lost": self.hedges_lost,
                "corrupt_from_peer": self.corrupt_from_peer,
                "corrupt_healed": self.corrupt_healed,
            },
        }


@dataclass(frozen=True)
class XorbFetchResult:
    """Blob + the term's chunk range rebased into it. ``source`` and
    ``peer_addr`` route an extraction-time failure back to its origin."""

    data: bytes
    local_start: int
    local_end: int
    source: str = "cache"                      # cache | peer | cdn
    peer_addr: tuple[str, int] | None = None


def _blob_covers(data: bytes, local_start: int, local_end: int) -> bool:
    """The blob parses as a frame stream holding [local_start, local_end)."""
    if local_start < 0 or local_end <= local_start:
        return False
    try:
        return len(XorbReader(data)) >= local_end
    except ValueError:
        return False


def _exactly(pieces, want: int, url: str):
    """Yield ``pieces``, then raise :class:`CasError` when they did not
    add up to ``want`` bytes: inside ``atomic_write_stream`` that drops
    the temp file, so a body cut short never becomes a cache entry."""
    got = 0
    for piece in pieces:
        got += len(piece)
        yield piece
    if got != want:
        raise CasError(f"GET {url} returned {got} bytes for a {want}-byte "
                       "range")


def provably_whole(entries, chunk_offset: int) -> bool:
    """A blob fetched at ``chunk_offset`` is the whole xorb only when every
    known reference to it is the same single range starting at chunk 0."""
    ranges = {(e.range.start, e.range.end) for e in entries}
    return (chunk_offset == 0 and len(ranges) == 1
            and next(iter(ranges))[0] == 0)


class XetBridge:
    def __init__(self, cfg: Config, swarm=None,
                 cache: storage.XorbCache | None = None):
        """``swarm`` is a ``transfer.swarm.SwarmDownloader`` (None: no
        peer tier)."""
        self.cfg = cfg
        self.cache = cache or storage.XorbCache(cfg)
        self.swarm = swarm
        self.cas: CasClient | None = None
        self.stats = FetchStats()
        # Per-pull wall-clock budget (resilience.Deadline | None), set by
        # the pull before authenticate(): it flows into the CAS client and
        # into the swarm per call.
        self.deadline = None
        self._hedge_pool: ThreadPoolExecutor | None = None
        self._hedge_lock = threading.Lock()
        self._hedge_armed = False
        self._recons: dict[str, recon.Reconstruction] = {}
        self._lock = threading.Lock()
        # A DCN listener the cooperative round started for this pull
        # (transfer/coop.py): peers still mid-exchange read from it after
        # this host's round returned, so it lives until close().
        self._coop_server = None
        # Set when some file's reconstruction could not be resolved: the
        # whole-xorb evidence is then incomplete for every xorb.
        self.evidence_incomplete = False
        # The pull service's shared pieces, wired by pull_model when
        # tenancy is on (all None: the bridge runs alone): the process
        # Singleflight table, this pull's CancelToken, and a hook called
        # once per freshly resolved reconstruction (the session pins its
        # xorbs against eviction).
        self.flights = None
        self.cancel = None
        self.on_reconstruction = None

    def arm_hedge(self, reason: str = "policy") -> dict:
        """Arm hedging without a deadline: every later peer-tier fetch
        gives the peer a fixed ``_HEDGE_EVIDENCE_WAIT_S`` head start,
        then races the CDN, through the same hedge counters as the
        deadline path. The primary fetch is never cancelled, only
        raced."""
        already = self._hedge_armed
        self._hedge_armed = True
        return {"armed": True, "already": already, "reason": reason}

    def adopt_coop_server(self, server) -> None:
        """Own a coop-round DCN listener until :meth:`close`."""
        self._coop_server = server

    def close(self) -> None:
        """Release the hedge pool's threads and stop the coop-round DCN
        listener this bridge owns, if any."""
        with self._hedge_lock:
            pool, self._hedge_pool = self._hedge_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        server, self._coop_server = self._coop_server, None
        if server is not None:
            server.shutdown()

    def authenticate(self, repo_id: str, revision: str = "main",
                     hub: HubClient | None = None) -> None:
        hub = hub or HubClient(self.cfg)
        cas_url, token = hub.xet_read_token(repo_id, revision)
        self.cas = CasClient(
            cas_url, token,
            token_refresher=lambda: hub.xet_read_token(repo_id, revision),
            deadline=self.deadline, on_event=self.stats.bump)

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
            hook = self.on_reconstruction
            if hook is not None:
                try:
                    hook(cached)  # tenancy: pin this plan's xorbs
                except Exception:  # noqa: BLE001 - pinning is advisory
                    pass
        return cached

    def resolved_xorb_hashes(self) -> set[str]:
        """Every xorb hash a reconstruction this bridge resolved refers
        to: the pin set of a landed tree."""
        with self._lock:
            return {h for rec in self._recons.values()
                    for h in rec.fetch_info}

    def known_reconstruction(self, file_hash_hex: str
                             ) -> recon.Reconstruction | None:
        with self._lock:
            return self._recons.get(file_hash_hex)

    # ── The waterfall ──

    def fetch_xorb_for_term(self, term: recon.Term,
                            rec: recon.Reconstruction) -> XorbFetchResult:
        if self.cancel is not None:
            # Per-term cancellation point: a cancelled session stops at
            # the next term instead of finishing files it no longer wants.
            self.cancel.check()
        with telemetry.span("fetch.term", xorb=term.hash_hex) as sp:
            result = self._fetch_xorb_for_term(term, rec)
            sp.set("source", result.source)
            sp.add_bytes(len(result.data))
            return result

    def _fetch_xorb_for_term(self, term: recon.Term,
                             rec: recon.Reconstruction) -> XorbFetchResult:
        fi = rec.find_fetch_info(term)
        if fi is None:
            raise BridgeError(f"no fetch info covers chunks "
                              f"[{term.range.start},{term.range.end}) of "
                              f"{term.hash_hex}")
        # 1. Local cache: the full xorb, or the partial entry for fi's
        # range — whichever actually covers the term.
        hit = self._probe_term(term, fi)
        if hit is not None:
            return hit
        # Network tiers, deduped across sessions: the loser of a flight
        # reads the winner's cache entry instead of refetching.
        return self._deduped(
            (term.hash_hex, fi.range.start, fi.range.end),
            lambda: self._network_fetch_for_term(term, rec, fi,
                                                 term.hash_hex),
            lambda: self._probe_term(term, fi))

    def _probe_term(self, term: recon.Term,
                    fi: recon.FetchInfo) -> XorbFetchResult | None:
        """Tier 1: the covering cache entry as a term result (counted), or
        None. The coverage predicate runs inside the lookup, so a full
        entry that does not cover the term falls through to the partial
        one."""
        def covers(res: storage.CacheResult) -> bool:
            return _blob_covers(res.data,
                                term.range.start - res.chunk_offset,
                                term.range.end - res.chunk_offset)

        hit = self.cache.get_with_range(term.hash_hex, fi.range.start,
                                        covers=covers)
        if hit is None:
            return None
        self.stats.record("cache", len(hit.data))
        return XorbFetchResult(hit.data,
                               term.range.start - hit.chunk_offset,
                               term.range.end - hit.chunk_offset)

    def _deduped(self, key, fetch_fn, probe_fn):
        """Run ``fetch_fn`` under the process singleflight table (when
        wired): the first session to want ``key`` leads; every concurrent
        session waits, then serves itself from the winner's cache entry
        through ``probe_fn`` (a probe miss — the entry was evicted in the
        gap — is a solo refetch, never an error). A failed flight raises
        the leader's error in every waiter; a cancelled leader abdicates,
        so a live waiter takes the fetch over."""
        flights = self.flights
        if flights is None:
            return fetch_fn()
        role, flight = flights.join(key)
        first_lead = role == "lead"
        while True:
            if role == "lead":
                if first_lead:
                    # This session's cache miss may predate another
                    # flight's winner writing the entry and resolving:
                    # probing again turns that window into a hit instead
                    # of a second fetch. (A promoted waiter skips it.)
                    hit = probe_fn()
                    if hit is not None:
                        flights.resolve(flight)
                        flights.note_hit()
                        return hit
                try:
                    if self.cancel is not None:
                        self.cancel.check()
                    result = fetch_fn()
                except BaseException as exc:
                    if isinstance(exc, PullCancelled):
                        flights.abdicate(flight)
                    else:
                        flights.fail(flight, exc)
                    raise
                flights.resolve(flight)
                return result
            outcome = flights.wait(flight, cancel=self.cancel)
            if outcome == "lead":
                role = "lead"
                continue
            if outcome == "cancelled":
                raise PullCancelled(
                    "cancelled while waiting on a shared fetch")
            if outcome == "failed":
                raise flight.error
            hit = probe_fn()  # "done": the winner's bytes are cached
            if hit is not None:
                flights.note_hit()
                return hit
            return fetch_fn()  # evicted before we read: refetch solo

    def _network_fetch_for_term(self, term: recon.Term,
                                rec: recon.Reconstruction,
                                fi: recon.FetchInfo,
                                hash_hex: str) -> XorbFetchResult:
        # 2. Swarm — fi's whole chunk range, so the cached result serves
        # later terms that share this fetch_info; hedged when armed.
        if self.swarm is not None:
            peer_result = self._peer_tier(term, rec, fi, hash_hex)
            if isinstance(peer_result, XorbFetchResult):
                return peer_result  # the CDN hedge won; already cached
            if peer_result is not None:
                local_start = term.range.start - peer_result.chunk_offset
                local_end = term.range.end - peer_result.chunk_offset
                if _blob_covers(peer_result.data, local_start, local_end) \
                        and self._peer_blob_verifies(term, rec, hash_hex,
                                                     peer_result):
                    self.stats.record("peer", len(peer_result.data))
                    # Cached for seeding: the full key only with
                    # whole-xorb evidence, never a sliced prefix.
                    self._cache_fetched(rec, hash_hex,
                                        peer_result.chunk_offset,
                                        peer_result.data)
                    # Bytes admitted without a whole-xorb proof keep
                    # their source on record (the seeding server refuses
                    # them once it is quarantined); a proven whole-xorb
                    # write clears the suspicion. Under incomplete
                    # evidence even a root-verified blob is cached under
                    # a partial key, so other peers' suspicion survives.
                    if self.whole_xorb_provable(
                            self._known_entries(rec, hash_hex),
                            peer_result.chunk_offset):
                        PROVENANCE.clear(hash_hex)
                    else:
                        PROVENANCE.record(hash_hex, peer_result.addr)
                    return XorbFetchResult(
                        peer_result.data, local_start, local_end,
                        source="peer", peer_addr=peer_result.addr)
                # Malformed, short or hash-mismatched: never cached; the
                # peer takes the strike and the CDN serves.
                if peer_result.addr is not None:
                    self.stats.bump("corrupt_from_peer")
                    self.swarm.report_corrupt(peer_result.addr)
        # 3. CDN byte range.
        return self._cdn_fetch_for_term(term, rec, fi, hash_hex)

    def _peer_blob_verifies(self, term: recon.Term,
                            rec: recon.Reconstruction, hash_hex: str,
                            peer_result) -> bool:
        """The trust boundary for a peer blob: one that is (by the
        evidence of every resolved reference) the whole xorb must hash
        back to the xorb's merkle root before it is cached or extracted —
        wire blobs are footerless frame streams with no per-chunk hashes
        for extraction to check. Partial blobs stay under the
        extraction-time checks."""
        if not provably_whole(self._known_entries(rec, hash_hex),
                              peer_result.chunk_offset):
            return True
        try:
            return XorbReader(peer_result.data).xorb_hash() == term.xorb_hash
        except ValueError:
            return False

    def _unit_blob_verifies(self, xorb_hash: bytes, hash_hex: str,
                            peer_result) -> bool:
        """:meth:`_peer_blob_verifies` for the unit path (the landing's
        warm and header fetch, the coop fallback): the same trust rule
        across every resolved reconstruction."""
        if not self.whole_xorb_provable(self._known_entries(None, hash_hex),
                                        peer_result.chunk_offset):
            return True
        try:
            return XorbReader(peer_result.data).xorb_hash() == xorb_hash
        except ValueError:
            return False

    def _cdn_fetch_for_term(self, term: recon.Term,
                            rec: recon.Reconstruction,
                            fi: recon.FetchInfo,
                            hash_hex: str | None = None) -> XorbFetchResult:
        """Tier 3 alone: the hedge racer and the corruption heal force it
        whatever the cache and the peers hold (the cache write replaces a
        poisoned entry)."""
        hash_hex = hash_hex or term.hash_hex
        if self.cas is None:
            raise BridgeError("no CAS client and no peer had the xorb")
        with telemetry.span("cdn.fetch", xorb=hash_hex) as sp:
            data = self.cas.fetch_xorb_from_url(
                self._absolute_url(fi.url),
                (fi.url_range_start, fi.url_range_end))
            sp.add_bytes(len(data))
        self.stats.record("cdn", len(data))
        if not _blob_covers(data, term.range.start - fi.range.start,
                            term.range.end - fi.range.start):
            raise BridgeError(f"CDN blob for {hash_hex[:12]} does not "
                              "hold the term's chunks")
        self._cache_fetched(rec, hash_hex, fi.range.start, data)
        # Suspicion clears only when this write provably replaced the
        # WHOLE xorb: a partial refetch leaves other peer-sourced ranges
        # of it in the cache.
        if self.whole_xorb_provable(self._known_entries(rec, hash_hex),
                                    fi.range.start):
            PROVENANCE.clear(hash_hex)
        if self.swarm is not None:
            self.swarm.announce_available(term.xorb_hash, hash_hex)
        return XorbFetchResult(data, term.range.start - fi.range.start,
                               term.range.end - fi.range.start, "cdn")

    def _peer_tier(self, term: recon.Term, rec: recon.Reconstruction,
                   fi: recon.FetchInfo, hash_hex: str):
        """The swarm attempt, hedged when armed by a deadline or by
        :meth:`arm_hedge`: the peer fetch runs in a side thread with a
        head start, then a CDN fetch races it from this thread and the
        winner's :class:`XorbFetchResult` is returned. Unarmed, the
        swarm's ``PeerResult`` (or None)."""
        deadline = self.deadline
        if (deadline is None and not self._hedge_armed) or self.cas is None:
            return self.swarm.try_peer_download(
                term.xorb_hash, hash_hex, fi.range.start, fi.range.end,
                deadline=deadline)
        if deadline is not None:
            remaining = deadline.remaining()
            if remaining <= 0:
                return None  # budget gone: tier 3 fails fast on its own
            wait_s = min(max(remaining * _HEDGE_PEER_FRACTION,
                             _HEDGE_PEER_WAIT_FLOOR_S),
                         _HEDGE_PEER_WAIT_CAP_S)
        else:
            wait_s = _HEDGE_EVIDENCE_WAIT_S
        fut = self._ensure_hedge_pool().submit(
            self.swarm.try_peer_download,
            term.xorb_hash, hash_hex, fi.range.start, fi.range.end, deadline)
        try:
            # Peer errors are absorbed inside try_peer_download; anything
            # surfacing here is a real fault and propagates as unhedged.
            return fut.result(timeout=wait_s)
        except FutureTimeoutError:
            pass
        self.stats.bump("hedges")
        try:
            result = self._cdn_fetch_for_term(term, rec, fi, hash_hex)
        except FETCH_ERRORS:
            # The CDN racer failed: the in-flight peer fetch is the last
            # hope, waited out within the deadline when one is armed.
            self.stats.bump("hedges_lost")
            try:
                timeout = (max(deadline.remaining(), 0.001)
                           if deadline is not None else None)
                return fut.result(timeout=timeout)
            except FutureTimeoutError:
                return None
        self.stats.bump("hedges_won")
        # A started straggler runs to completion (its result is dropped);
        # a still-queued one is cancelled.
        fut.cancel()
        return result

    def _ensure_hedge_pool(self) -> ThreadPoolExecutor:
        with self._hedge_lock:
            if self._hedge_pool is None:
                # As wide as the term fetches: a narrower pool would queue
                # hedged peer fetches, and a queued fetch that spends its
                # head start counts as a hedge without the peer tried.
                self._hedge_pool = ThreadPoolExecutor(
                    max(4, self.cfg.max_concurrent_downloads),
                    thread_name_prefix="zest-hedge")
            return self._hedge_pool

    def _known_entries(self, rec: recon.Reconstruction | None,
                       hash_hex: str) -> list[recon.FetchInfo]:
        """Every resolved reference to ``hash_hex``, across all memoized
        reconstructions (a xorb shared by two files may look whole from
        one file's fetch_info alone); ``rec=None`` for the unit path."""
        entries = (list(rec.fetch_info.get(hash_hex, []))
                   if rec is not None else [])
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
        hash-striped lock. ENOSPC (``CacheFullError``: the eviction pass
        already ran) is absorbed: the bytes in hand still serve, they are
        just not cached."""
        try:
            with _write_lock(hash_hex):
                existing = self.cache.get_with_range(hash_hex, chunk_offset)
                if existing is not None \
                        and existing.chunk_offset <= chunk_offset:
                    try:
                        if (existing.chunk_offset
                                + len(XorbReader(existing.data))
                                >= chunk_offset + len(XorbReader(data))):
                            return
                    except ValueError:
                        pass  # corrupt entry: overwrite
                if whole:
                    self.cache.put(hash_hex, data)
                else:
                    self.cache.put_partial(hash_hex, chunk_offset, data)
        except CacheFullError:
            telemetry.record("cache_write_skipped", xorb=hash_hex,
                             reason="disk_full")

    # ── Fetch units (the cooperative round's currency) ──

    def fetch_unit(self, hash_hex: str, fi: recon.FetchInfo) -> bytes:
        """Raw blob for one fetch unit (a fetch_info chunk range) through
        the waterfall, without term rebasing."""
        return self.fetch_unit_tiered(hash_hex, fi)[0]

    def fetch_unit_tiered(self, hash_hex: str,
                          fi: recon.FetchInfo) -> tuple[bytes, str]:
        """:meth:`fetch_unit` plus the serving tier (``cache`` | ``peer``
        | ``cdn``): the cooperative round books its fallback bytes per
        tier. The caller caches what the network tiers return (with a
        singleflight table wired, the leader caches it first)."""
        with telemetry.span("fetch.unit", xorb=hash_hex) as sp:
            data, source = self._fetch_unit(hash_hex, fi)
            sp.set("source", source)
            sp.add_bytes(len(data))
            return data, source

    def _fetch_unit(self, hash_hex: str,
                    fi: recon.FetchInfo) -> tuple[bytes, str]:
        if self.cancel is not None:
            self.cancel.check()  # per-unit cancellation point
        hit = self._probe_unit(hash_hex, fi)
        if hit is not None:
            return hit
        return self._deduped(
            (hash_hex, fi.range.start, fi.range.end),
            lambda: self._network_fetch_unit(hash_hex, fi),
            lambda: self._probe_unit(hash_hex, fi))

    def _probe_unit(self, hash_hex: str,
                    fi: recon.FetchInfo) -> tuple[bytes, str] | None:
        data = self._cached_unit(hash_hex, fi)
        if data is None:
            return None
        self.stats.record("cache", len(data))
        return data, "cache"

    def _network_fetch_unit(self, hash_hex: str,
                            fi: recon.FetchInfo) -> tuple[bytes, str]:
        data, source = self._network_fetch_unit_raw(hash_hex, fi)
        if self.flights is not None:
            # The flight's waiters read the cache the moment this leader
            # resolves, so the bytes are cached here (the caller's own
            # cache write runs after return: too late for them). ENOSPC
            # is absorbed; the waiters then fetch for themselves.
            self._cache_fetched(None, hash_hex, fi.range.start, data)
        return data, source

    def _network_fetch_unit_raw(self, hash_hex: str,
                                fi: recon.FetchInfo) -> tuple[bytes, str]:
        if self.swarm is not None:
            xorb_hash = hashing.hex_to_hash(hash_hex)
            peer_result = self.swarm.try_peer_download(
                xorb_hash, hash_hex, fi.range.start, fi.range.end,
                deadline=self.deadline)
            if peer_result is not None:
                if (peer_result.chunk_offset == fi.range.start
                        and _blob_covers(peer_result.data, 0,
                                         fi.range.end - fi.range.start)
                        and self._unit_blob_verifies(xorb_hash, hash_hex,
                                                     peer_result)):
                    self.stats.record("peer", len(peer_result.data))
                    return peer_result.data, "peer"
                if peer_result.chunk_offset == fi.range.start \
                        and peer_result.addr is not None:
                    # Right frame, bad bytes: attributable (an off-offset
                    # blob may be a differently framed answer).
                    self.stats.bump("corrupt_from_peer")
                    self.swarm.report_corrupt(peer_result.addr)
        if self.cas is None:
            raise BridgeError("no CAS client and the unit is not cached")
        data = self.cas.fetch_xorb_from_url(
            self._absolute_url(fi.url),
            (fi.url_range_start, fi.url_range_end))
        self.stats.record("cdn", len(data))
        return data, "cdn"

    def stream_unit_from_cdn(self, hash_hex: str, fi: recon.FetchInfo,
                             full_key: bool) -> int:
        """The CDN tier streamed straight into the cache file, with no
        whole-unit buffer (``storage.atomic_write_stream``); returns the
        entry's size. The caller has checked the cache, and there is no
        peer tier. ``full_key`` is the whole-xorb evidence (the full key
        also needs this bridge's evidence complete). Cached bytes are
        verified at extraction, as every other entry is. Deduped on the
        unit and term paths' key, so one transfer serves every session;
        a waiter's result is the size of the entry the winner wrote."""
        if self.cancel is not None:
            self.cancel.check()  # per-unit cancellation point
        return self._deduped(
            (hash_hex, fi.range.start, fi.range.end),
            lambda: self._stream_unit_from_cdn(hash_hex, fi, full_key),
            lambda: self._probe_stream(hash_hex, fi))

    def _probe_stream(self, hash_hex: str,
                      fi: recon.FetchInfo) -> int | None:
        located = self.cache.locate_with_range(hash_hex, fi.range.start)
        if located is None:
            return None
        try:
            n = located[0].stat().st_size
        except OSError:
            return None  # evicted between locate and stat: refetch
        self.stats.record("cache", n)
        return n

    def _stream_unit_from_cdn(self, hash_hex: str, fi: recon.FetchInfo,
                              full_key: bool) -> int:
        if self.cas is None:
            raise BridgeError("no CAS client and the unit is not cached")
        url = self._absolute_url(fi.url)
        want = fi.url_range_end - fi.url_range_start
        with telemetry.span("cdn.stream", xorb=hash_hex) as sp:
            it = _exactly(self.cas.fetch_xorb_iter(
                url, (fi.url_range_start, fi.url_range_end)), want, url)
            if full_key and not self.evidence_incomplete:
                n = self.cache.put_stream(hash_hex, it)
            else:
                n = self.cache.put_partial_stream(hash_hex, fi.range.start,
                                                  it)
            sp.add_bytes(n)
        self.stats.record("cdn", n)
        return n

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
        """The term's bytes through the waterfall, healed (see
        :meth:`_term_into`)."""
        out = bytearray(term.unpacked_length)
        self._term_into(term, rec, out)
        return bytes(out)

    def _term_into(self, term: recon.Term, rec: recon.Reconstruction,
                   out) -> None:
        """Fetch and decode one term into ``out``. A blob that fails to
        decode is not trusted again: a peer-served one strikes its peer,
        then the CDN's bytes are fetched (replacing the cached entry) and
        decoded. CDN bytes that fail raise."""
        result = self.fetch_xorb_for_term(term, rec)
        try:
            self.extract_term_into(term, result, out)
        except (BridgeError, ValueError):
            if result.source == "cdn":
                raise
            if result.peer_addr is not None and self.swarm is not None:
                self.stats.bump("corrupt_from_peer")
                self.swarm.report_corrupt(result.peer_addr)
            fi = rec.find_fetch_info(term)
            if fi is None or self.cas is None:
                raise
            self.extract_term_into(
                term, self._cdn_fetch_for_term(term, rec, fi), out)
            self.stats.bump("corrupt_healed")

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
            self._term_into(term, rec,
                            view[start:start + term.unpacked_length])

        width = max(1, min(len(rec.terms), self.cfg.max_concurrent_downloads))
        with ThreadPoolExecutor(width, thread_name_prefix="zest-term") as pool:
            for fut in [pool.submit(work, i) for i in range(len(rec.terms))]:
                fut.result()
        view.release()
        storage.atomic_write(out_path, buf)
        return total
