"""Deadline budgets and retry backoff shared across the fetch path.

The port's copy of ``zest_tpu/resilience.py``.

A pull's failure handling is budgeted, not unbounded: ``Deadline`` is
the per-pull wall-clock budget (``ZEST_PULL_DEADLINE_S``) that flows
from ``transfer.pull`` through the bridge into the swarm and CDN tiers
— every blocking timeout is capped by what's left of it, so one dead
peer can never spend more of the budget than its share. ``Backoff`` is
the capped exponential retry pacing with deterministic jitter used by
the CDN client.
"""

from __future__ import annotations

import random
import time


class DeadlineExceeded(TimeoutError):
    """The pull's wall-clock budget ran out mid-operation."""


class Deadline:
    """Monotonic wall-clock budget, immutable and thread-safe by
    construction (two floats set once)."""

    __slots__ = ("total_s", "t_end")

    # Timeouts capped by an expired deadline degrade to this floor so
    # socket/HTTP calls error out promptly instead of raising ValueError
    # on a non-positive timeout.
    MIN_TIMEOUT_S = 0.001

    def __init__(self, total_s: float):
        self.total_s = float(total_s)
        self.t_end = time.monotonic() + self.total_s

    @classmethod
    def after(cls, total_s: float | None) -> "Deadline | None":
        """None for a falsy/non-positive budget — deadline off."""
        if not total_s or total_s <= 0:
            return None
        return cls(total_s)

    def remaining(self) -> float:
        return self.t_end - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise DeadlineExceeded(
                f"{what} exceeded the {self.total_s:.1f}s pull deadline"
            )

    def cap(self, timeout_s: float) -> float:
        """``timeout_s`` bounded by the remaining budget (floored so the
        caller's blocking call still errors fast rather than misusing a
        non-positive timeout)."""
        return max(min(timeout_s, self.remaining()), self.MIN_TIMEOUT_S)



class Backoff:
    """Capped exponential backoff with equal jitter.

    Delay ``n`` is ``min(cap, base * 2**n)`` scaled into
    ``[0.5, 1.0]``× by the jitter RNG — entropy-seeded by default so a
    fleet of hosts retrying the same CDN origin de-synchronizes instead
    of stampeding in lockstep. Pass ``seed`` for reproducible delays in
    tests (chaos determinism lives in the fault *firing* sequence, not
    in sleep lengths, so production keeps real entropy)."""

    def __init__(self, base_s: float = 0.2, cap_s: float = 5.0,
                 seed: int | None = None):
        self.base_s = max(0.0, base_s)
        self.cap_s = cap_s
        self._rng = random.Random(seed)  # None -> system entropy
        self._attempt = 0

    def next_delay(self) -> float:
        delay = min(self.cap_s, self.base_s * (2.0 ** self._attempt))
        self._attempt += 1
        return delay * (0.5 + 0.5 * self._rng.random())

    def sleep(self, deadline: Deadline | None = None) -> bool:
        """Sleep the next delay, truncated to the deadline's remainder.
        False when the deadline has no room left (caller should abort
        the retry loop instead of burning the tail of the budget)."""
        delay = self.next_delay()
        if deadline is not None:
            room = deadline.remaining()
            if room <= 0.0:
                return False
            delay = min(delay, room)
        if delay > 0.0:
            time.sleep(delay)
        return True
