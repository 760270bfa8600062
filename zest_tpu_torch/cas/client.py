"""CAS client: reconstruction queries and ranged xorb fetches.

The counterpart of ``zest_tpu/cas/client.py`` on ``urllib.request``.
Every GET is idempotent, so transient failures (5xx, 429, connection
errors) retry with capped exponential backoff, and a 401/403 from the CAS
origin refreshes the xet-read token once. Bytes that leave this client
are untrusted until they verify downstream.
"""

from __future__ import annotations

import json
import random
import time
import urllib.error

from zest_tpu_torch.cas import reconstruction as recon
from zest_tpu_torch.cas.hub import request


class CasError(RuntimeError):
    pass


_RETRYABLE_STATUS = frozenset({429, 500, 502, 503, 504})
DEFAULT_RETRIES = 3
_BACKOFF_BASE_S = 0.2
_BACKOFF_CAP_S = 5.0


class CasClient:
    def __init__(self, cas_url: str, access_token: str | None = None,
                 retries: int = DEFAULT_RETRIES, token_refresher=None):
        """``token_refresher`` is ``() -> (cas_url, access_token)``, re-run
        at most once per request on 401/403."""
        self.cas_url = cas_url.rstrip("/")
        self.access_token = access_token
        self.retries = max(0, retries)
        self.token_refresher = token_refresher
        self.retry_count = 0

    def _get(self, url: str, headers: dict[str, str],
             timeout: float) -> bytes:
        """GET ``url`` → body (200/206), retrying transient failures."""
        refreshed = False
        for attempt in range(self.retries + 1):
            same_origin = url.startswith(self.cas_url)
            hdrs = dict(headers)
            if same_origin and self.access_token:
                hdrs["Authorization"] = f"Bearer {self.access_token}"
            try:
                with request(url, hdrs, timeout=timeout) as resp:
                    status = resp.status
                    if status in (200, 206):
                        return resp.read()
            except (urllib.error.URLError, OSError) as exc:
                err: Exception = exc
            else:
                if (status in (401, 403) and same_origin and not refreshed
                        and self.token_refresher is not None):
                    refreshed = True
                    self.cas_url, self.access_token = self.token_refresher()
                    self.cas_url = self.cas_url.rstrip("/")
                    continue
                if status not in _RETRYABLE_STATUS:
                    raise CasError(f"GET {url} -> {status}")
                err = CasError(f"GET {url} -> {status}")
            if attempt == self.retries:
                raise CasError(f"GET {url} failed after {attempt + 1} "
                               f"attempts: {err}") from err
            self.retry_count += 1
            delay = min(_BACKOFF_CAP_S, _BACKOFF_BASE_S * 2 ** attempt)
            time.sleep(delay * (0.5 + 0.5 * random.random()))
        raise AssertionError("unreachable")

    def get_reconstruction(self, file_hash_hex: str) -> recon.Reconstruction:
        """GET /v1/reconstructions/{hex} -> terms + fetch_info."""
        url = f"{self.cas_url}/v1/reconstructions/{file_hash_hex}"
        return recon.from_json(file_hash_hex,
                               json.loads(self._get(url, {}, 30.0)))

    def fetch_xorb_from_url(self, url: str,
                            byte_range: tuple[int, int] | None = None
                            ) -> bytes:
        """Fetch xorb bytes; ``byte_range`` is half-open [start, end). The
        bearer header goes only to the CAS origin itself."""
        headers = {}
        if byte_range is not None:
            start, end = byte_range
            if not 0 <= start < end:
                raise CasError(f"invalid byte range [{start},{end})")
            headers["Range"] = f"bytes={start}-{end - 1}"
        data = self._get(url, headers, 120.0)
        if byte_range is not None and len(data) != end - start:
            raise CasError(f"GET {url} returned {len(data)} bytes for a "
                           f"{end - start}-byte range")
        return data
