"""Process-wide telemetry on/off switch (``ZEST_TELEMETRY``).

The counterpart of ``zest_tpu/telemetry/state.py``. One flag gates every
telemetry surface (span recording, metric writes, flight-recorder
events), so with ``ZEST_TELEMETRY=0`` (or ``false``/``off``/``no``) a
call site costs one flag check. Default on: a daemon started with
telemetry off could never answer ``/v1/metrics``. Tracing has its own
opt-in (``ZEST_TRACE=path``).
"""

from __future__ import annotations

import os
import threading

ENV_TELEMETRY = "ZEST_TELEMETRY"

_OFF_VALUES = frozenset({"0", "false", "off", "no"})

_lock = threading.Lock()
_enabled: bool | None = None  # None = not yet resolved from env


def enabled() -> bool:
    """The hot-path gate: one global load in the common (resolved) case."""
    global _enabled
    on = _enabled
    if on is not None:
        return on
    with _lock:
        if _enabled is None:
            raw = os.environ.get(ENV_TELEMETRY, "").strip().lower()
            _enabled = raw not in _OFF_VALUES
        return _enabled


def set_enabled(on: bool | None) -> None:
    """Test/CLI override; ``None`` returns to env resolution."""
    global _enabled
    with _lock:
        _enabled = on


def reset() -> None:
    """Back to unresolved: the next ``enabled()`` re-reads the env."""
    set_enabled(None)
