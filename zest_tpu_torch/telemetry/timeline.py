"""Posted timeline cells and the pod clock offsets.

The part of ``zest_tpu/telemetry/timeline.py`` the collective exchange
reaches: the store of transient cells (``post``/``clear``: the current
phase index, partner and barrier seconds of an exchange) and the clock
offsets the last cooperative round measured (``set_clock_offsets``).
The sampler thread, the series rings, the anomaly detector and the
``/v1/timeline`` surfaces are not ported.

``ZEST_TIMELINE=0`` (or ``ZEST_TELEMETRY=0``) turns the layer off: every
call is one flag check and nothing is kept.
"""

from __future__ import annotations

import os
import threading

from zest_tpu_torch.telemetry import state

ENV_TIMELINE = "ZEST_TIMELINE"
_OFF_VALUES = frozenset({"0", "false", "off", "no"})

_lock = threading.Lock()
_enabled: bool | None = None
_cells: dict[str, float] = {}
_clock_offsets: dict[str, dict] = {}


def enabled() -> bool:
    if not state.enabled():
        return False
    global _enabled
    with _lock:
        if _enabled is None:
            raw = os.environ.get(ENV_TIMELINE, "").strip().lower()
            _enabled = raw not in _OFF_VALUES
        return _enabled


def set_enabled(on: bool | None) -> None:
    """Test override; ``None`` returns to the environment."""
    global _enabled
    with _lock:
        _enabled = on


def post(name: str, value: float) -> None:
    """Set a transient cell (the collective's phase index, partner,
    cumulative barrier seconds)."""
    if enabled():
        with _lock:
            _cells[name] = float(value)


def clear(prefix: str) -> None:
    """Drop every posted cell under ``prefix`` (the exchange is over)."""
    with _lock:
        for name in [n for n in _cells if n.startswith(prefix)]:
            del _cells[name]


def cells() -> dict[str, float]:
    with _lock:
        return dict(_cells)


def set_clock_offsets(offsets: dict) -> None:
    """Record the clock offsets the last coop round measured (host index
    → ``{"offset_s", "rtt_s"}``)."""
    if enabled() and offsets:
        with _lock:
            _clock_offsets.update({str(k): dict(v)
                                   for k, v in offsets.items()})


def clock_offsets() -> dict[str, dict]:
    with _lock:
        return {k: dict(v) for k, v in _clock_offsets.items()}


def reset() -> None:
    """Tests: drop every cell and offset, back to the environment."""
    set_enabled(None)
    with _lock:
        _cells.clear()
        _clock_offsets.clear()
