"""CAS client: reconstruction queries and ranged xorb fetches.

The counterpart of ``zest_tpu/cas/client.py`` on ``urllib.request`` (the
card's machine has no ``requests``). Every byte that leaves this client
is still untrusted until chunk hashes verify downstream.

Every GET is treated as the idempotent request it is: transient failures
(5xx, 429, connection reset, timeout) retry with capped exponential
backoff + jitter (``ZEST_CDN_RETRIES``, ``ZEST_CDN_BACKOFF_S``), a
mid-stream drop resumes from the byte where it died via an adjusted
``Range`` header, and a 401/403 against the CAS origin refreshes the
xet-read token once and retries — tokens expire during long pulls. An
optional per-pull :class:`~zest_tpu_torch.resilience.Deadline` caps both
the per-request timeouts and the retry sleeps.
"""

from __future__ import annotations

import http.client
import json
import os
import threading

from zest_tpu_torch import faults, telemetry
from zest_tpu_torch.cas import reconstruction as recon
from zest_tpu_torch.cas.hub import request
from zest_tpu_torch.resilience import Backoff, Deadline, DeadlineExceeded


def _span_url(url: str) -> str:
    """Scheme, host and path only: a presigned CDN URL carries its auth
    in the query string, which must never reach a trace file."""
    return url.split("?", 1)[0]


class CasError(RuntimeError):
    pass


class CasTransientError(CasError):
    """A failure worth retrying (server hiccup, connection reset)."""

    def __init__(self, message: str, status: int | None = None):
        super().__init__(message)
        self.status = status


class _RefreshNeeded(Exception):
    """Internal: CAS origin said 401/403 — try a token refresh."""

    def __init__(self, status: int):
        super().__init__(f"status {status}")
        self.status = status


_RETRYABLE_STATUS = frozenset({429, 500, 502, 503, 504})
# What urllib raises for a connection that failed, dropped or timed out
# (``URLError`` and socket errors are ``OSError``s; a body cut short is
# an ``http.client.IncompleteRead``).
_NETWORK_ERRORS = (OSError, http.client.HTTPException)

DEFAULT_RETRIES = int(os.environ.get("ZEST_CDN_RETRIES", "3"))
DEFAULT_BACKOFF_BASE_S = float(os.environ.get("ZEST_CDN_BACKOFF_S", "0.2"))
_BACKOFF_CAP_S = 5.0
_READ_BYTES = 1024 * 1024


class CasClient:
    def __init__(
        self,
        cas_url: str,
        access_token: str | None = None,
        retries: int | None = None,
        backoff_base_s: float | None = None,
        token_refresher=None,
        deadline: Deadline | None = None,
        on_event=None,
        opener=None,
    ):
        """``token_refresher`` is ``() -> (cas_url, access_token)`` — the
        hub's xet-read-token exchange, re-run at most once per request on
        401/403. ``on_event(name)`` is the caller's counter hook (the
        bridge feeds ``FetchStats.bump``); ``deadline`` caps timeouts and
        retry sleeps. ``opener(url, headers, timeout=)`` returns a
        response for any status (default ``cas.hub.request``)."""
        self.cas_url = cas_url.rstrip("/")
        self.access_token = access_token
        self.retries = DEFAULT_RETRIES if retries is None else max(0, retries)
        self.backoff_base_s = (DEFAULT_BACKOFF_BASE_S if backoff_base_s is None
                               else backoff_base_s)
        self.token_refresher = token_refresher
        self.deadline = deadline
        self._on_event = on_event
        self._open = opener or request
        self._refresh_lock = threading.Lock()

    def _headers(self) -> dict[str, str]:
        if self.access_token:
            return {"Authorization": f"Bearer {self.access_token}"}
        return {}

    def _bump(self, name: str) -> None:
        if self._on_event is not None:
            self._on_event(name)

    def _timeout(self, base_s: float) -> float:
        if self.deadline is not None:
            self.deadline.check("CDN request")
            return self.deadline.cap(base_s)
        return base_s

    def _get(self, url: str, headers: dict, timeout: float):
        """The one chokepoint every CAS/CDN GET goes through — where the
        chaos harness injects server hiccups and connection resets. The
        response comes back for any status; the caller closes it."""
        if faults.fire("cdn_503"):
            raise CasTransientError(f"GET {url} -> 503 (injected)", 503)
        if faults.fire("cdn_reset"):
            raise ConnectionResetError(f"injected cdn_reset for {url}")
        return self._open(url, headers, timeout=timeout)

    def _refresh_token(self) -> bool:
        """Re-run the xet-read-token exchange; True when a new token was
        installed. Serialized: concurrent 401s from parallel term fetches
        must not stampede the hub."""
        if self.token_refresher is None:
            return False
        with self._refresh_lock:
            try:
                cas_url, token = self.token_refresher()
            except Exception:  # noqa: BLE001 - a failed refresh is a 401
                return False
            if cas_url:
                self.cas_url = cas_url.rstrip("/")
            self.access_token = token
        self._bump("token_refreshes")
        return True

    def _retry(self, url: str, attempt: int, backoff: Backoff,
               err: Exception) -> None:
        """Account one failed attempt: raise once the retries are spent
        or the deadline has no room for the backoff sleep."""
        if attempt > self.retries:
            raise CasError(
                f"GET {url} failed after {attempt} attempts: {err}"
            ) from err
        self._bump("cdn_retries")
        if not backoff.sleep(deadline=self.deadline):
            raise DeadlineExceeded(
                f"pull deadline exhausted retrying {url}") from err

    def get_reconstruction(self, file_hash_hex: str) -> recon.Reconstruction:
        """GET /v1/reconstructions/{hex} -> terms + fetch_info."""
        with telemetry.span("cas.reconstruction", file=file_hash_hex):
            return self._get_reconstruction(file_hash_hex)

    def _get_reconstruction(self, file_hash_hex: str
                            ) -> recon.Reconstruction:
        url = f"{self.cas_url}/v1/reconstructions/{file_hash_hex}"
        backoff = Backoff(self.backoff_base_s, _BACKOFF_CAP_S)
        attempt = 0
        refreshed = False
        while True:
            try:
                with self._get(url, self._headers(),
                               timeout=self._timeout(30)) as resp:
                    status = resp.status
                    body = resp.read() if status == 200 else b""
            except CasTransientError as exc:
                err = exc
            except _NETWORK_ERRORS as exc:
                err = CasTransientError(f"GET {url}: {exc}")
            else:
                if status == 200:
                    return recon.from_json(file_hash_hex, json.loads(body))
                if status == 404:
                    raise CasError(f"no reconstruction for {file_hash_hex}")
                if status in (401, 403) and not refreshed:
                    refreshed = True
                    if self._refresh_token():
                        url = (f"{self.cas_url}/v1/reconstructions/"
                               f"{file_hash_hex}")
                        continue
                if status in _RETRYABLE_STATUS:
                    err = CasTransientError(f"GET {url} -> {status}", status)
                else:
                    raise CasError(f"GET {url} -> {status}")
            attempt += 1
            self._retry(url, attempt, backoff, err)

    def fetch_xorb_from_url(
        self, url: str, byte_range: tuple[int, int] | None = None
    ) -> bytes:
        """Fetch xorb bytes; ``byte_range`` is half-open [start, end).

        Presigned CDN URLs carry their own auth — the bearer header is only
        sent to the CAS origin itself (same-origin check on the URL).
        """
        data = b"".join(self.fetch_xorb_iter(url, byte_range))
        if byte_range is not None and len(data) != byte_range[1] - \
                byte_range[0]:
            raise CasError(f"GET {url} returned {len(data)} bytes for a "
                           f"{byte_range[1] - byte_range[0]}-byte range")
        return data

    def fetch_xorb_iter(self, url: str,
                        byte_range: tuple[int, int] | None = None):
        """Same fetch as :meth:`fetch_xorb_from_url`, yielded as ~1 MiB
        pieces.

        Resumable: a transient failure after N yielded bytes re-requests
        from byte N (the GET is idempotent and ranged), so a large unit
        doesn't restart from zero on a mid-stream reset — and the
        consumer sees one uninterrupted byte stream either way."""
        with telemetry.span("cdn.get", url=_span_url(url)) as sp:
            for piece in self._fetch_xorb_iter(url, byte_range):
                sp.add_bytes(len(piece))
                yield piece

    def _fetch_xorb_iter(self, url: str,
                         byte_range: tuple[int, int] | None = None):
        if byte_range is not None:
            start, end = byte_range
            if not (0 <= start < end):
                raise CasError(f"invalid byte range [{start},{end})")
        backoff = Backoff(self.backoff_base_s, _BACKOFF_CAP_S)
        attempt = 0
        refreshed = False
        yielded = 0
        while True:
            try:
                for piece in self._stream_once(url, byte_range, yielded):
                    yielded += len(piece)
                    yield piece
                return
            except _RefreshNeeded as exc:
                if not refreshed:
                    refreshed = True
                    if self._refresh_token():
                        continue
                raise CasError(f"GET {url} -> {exc.status}") from exc
            except (CasTransientError, *_NETWORK_ERRORS) as exc:
                attempt += 1
                self._retry(url, attempt, backoff, exc)

    def _stream_once(self, url: str, byte_range: tuple[int, int] | None,
                     skip: int):
        """One streaming GET of the requested window minus its first
        ``skip`` bytes (already delivered by a previous attempt)."""
        headers: dict[str, str] = {}
        same_origin = url.startswith(self.cas_url)
        if same_origin:
            headers.update(self._headers())
        if byte_range is not None:
            lo, hi = byte_range[0] + skip, byte_range[1]
            if lo >= hi:
                return  # previous attempts already delivered the window
            headers["Range"] = f"bytes={lo}-{hi - 1}"
        else:
            lo, hi = skip, None
            if skip:
                headers["Range"] = f"bytes={skip}-"
        with self._get(url, headers, timeout=self._timeout(120)) as resp:
            status = resp.status
            if status in (401, 403) and same_origin:
                raise _RefreshNeeded(status)
            if status in _RETRYABLE_STATUS:
                raise CasTransientError(f"GET {url} -> {status}", status)
            if status not in (200, 206):
                raise CasError(f"GET {url} -> {status}")
            # A 200 to a ranged GET: the origin ignored the Range header;
            # trim the full body to the window as it streams past.
            trim = status == 200 and (byte_range is not None or skip)
            want = (hi - lo if hi is not None
                    else _content_length(resp) if not trim else None)
            pos = delivered = 0
            while want is None or delivered < want:
                piece = resp.read(_READ_BYTES)
                if not piece:
                    break
                if trim:
                    a = max(lo - pos, 0)
                    b = len(piece) if hi is None else min(hi - pos,
                                                          len(piece))
                    pos += len(piece)
                    if a < b:
                        if (a, b) != (0, len(piece)):
                            piece = piece[a:b]
                    else:
                        continue
                delivered += len(piece)
                yield piece
            if want is not None and delivered < want:
                # urllib ends a body cut short without an error: resume
                # from here like any other mid-stream drop.
                raise CasTransientError(
                    f"GET {url}: stream ended after {delivered} of {want} "
                    "bytes")


def _content_length(resp) -> int | None:
    try:
        return int(resp.headers.get("Content-Length"))
    except (TypeError, ValueError):
        return None
