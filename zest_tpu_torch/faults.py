"""Fault injection for the cooperative exchange.

The two hooks of ``zest_tpu/faults.py`` that the port fires:

==================  =====================================================
``dcn_reset``       ``DcnChannel.send_request`` dies mid-channel
``peer_timeout``    the cooperative exchange's window times out (a
                    silent owner host)
==================  =====================================================

A spec is comma-separated ``name:prob`` clauses, as in the JAX package's
``ZEST_FAULTS`` (its ``@arg`` scope filters are not ported). Tests call
:func:`install` and :func:`reset`; with nothing installed :func:`fire` is
one global read.
"""

from __future__ import annotations

import random
import threading

_lock = threading.Lock()
_probs: dict[str, float] | None = None
_fired: dict[str, int] = {}
_rng = random.Random(0)


def install(spec: str | None) -> None:
    """Install ``spec`` (``None`` disables) and zero the counters; a
    malformed clause raises ``ValueError``."""
    global _probs, _rng
    probs = None
    if spec is not None:
        probs = {}
        for clause in filter(None, (c.strip() for c in spec.split(","))):
            name, sep, prob = clause.partition(":")
            if not sep or not name.strip() or not 0.0 <= float(prob) <= 1.0:
                raise ValueError(f"bad fault clause {clause!r}: want "
                                 "name:prob with prob in [0, 1]")
            probs[name.strip()] = float(prob)
    with _lock:
        _probs = probs
        _fired.clear()
        _rng = random.Random(0)


def reset() -> None:
    """Disable injection."""
    install(None)


def fire(name: str) -> bool:
    """The hot-path hook: whether fault ``name`` fires at this site."""
    probs = _probs
    if probs is None or probs.get(name, 0.0) <= 0.0:
        return False
    with _lock:
        if _rng.random() >= probs[name]:
            return False
        _fired[name] = _fired.get(name, 0) + 1
    return True


def counters() -> dict[str, int]:
    """Times each fault fired since :func:`install`."""
    with _lock:
        return dict(_fired)
