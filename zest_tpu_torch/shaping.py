"""Link shaping: the shared token-bucket rate limiter.

The port's copy of ``zest_tpu/shaping.py``. The seeding server's upload
policy (``transfer.server.BtServer``: ``ZEST_SEED_RATE_BPS`` global +
``ZEST_SEED_PEER_BPS`` per-peer) is its one user in the port.
"""

from __future__ import annotations

import threading
import time


class TokenBucket:
    """Thread-safe global token bucket: ``rate_bps`` bytes/second shared
    by every caller of :meth:`acquire`.

    Models a WAN-shaped origin or a bounded upload allocation: N
    concurrent streams share the rate instead of each getting it —
    exactly the asymmetry the reference's tier-3 scenarios measure P2P
    against (DESIGN.md scenario table). Short bursts up to ~250 ms of
    rate are allowed so framing overhead doesn't distort small
    responses; ``capacity`` overrides the burst size."""

    def __init__(self, rate_bps: int, capacity: int | None = None):
        self.rate = max(1, int(rate_bps))
        self.capacity = (max(1, int(capacity)) if capacity is not None
                         else max(64 * 1024, self.rate // 4))
        self.tokens = float(self.capacity)
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def _debit_locked(self, n: int) -> float:
        """Take ``n`` tokens; returns the seconds the caller must wait
        for the bucket to be non-negative again (0.0 = no wait)."""
        now = time.monotonic()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self._t) * self.rate)
        self._t = now
        self.tokens -= n
        return -self.tokens / self.rate if self.tokens < 0 else 0.0

    def acquire(self, n: int, give_up_at: float | None = None) -> bool:
        """Debit ``n`` bytes and sleep out the induced wait.

        ``give_up_at`` (``time.monotonic()`` deadline) bounds the sleep:
        when honoring the rate would overrun the deadline, the debit is
        ROLLED BACK and False is returned — the caller (e.g. an upload
        holding a serving slot) aborts instead of pinning the slot past
        its request deadline. Unbounded callers always get True."""
        with self._lock:
            wait = self._debit_locked(n)
            if (give_up_at is not None and wait > 0
                    and time.monotonic() + wait > give_up_at):
                self.tokens += n  # roll back: the bytes were never sent
                return False
        if wait > 0:
            time.sleep(wait)
        return True

    def refund(self, n: int) -> None:
        """Return ``n`` tokens debited for bytes that were never sent —
        a caller holding debits from MULTIPLE buckets (per-peer then
        global) must undo the ones that succeeded when a later one
        gives up, or the peer carries phantom debt across requests."""
        with self._lock:
            self.tokens = min(float(self.capacity), self.tokens + n)
