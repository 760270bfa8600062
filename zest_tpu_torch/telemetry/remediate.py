"""The remediation target registry.

The part of ``zest_tpu/telemetry/remediate.py`` the collective exchange
reaches: owners inject action targets by name (``register_target``; the
exchange registers ``"collective"``, whose ``"strike"`` feeds peer
health and ``"abort"`` ends the exchange down the point-to-point ladder)
and take them back (``unregister_target``). The policy engine that maps
anomalies to actions is not ported; :func:`invoke` calls a target, as
that engine would.

``ZEST_REMEDIATE=0`` (or the timeline off) keeps no target.
"""

from __future__ import annotations

import os
import threading

from zest_tpu_torch.telemetry import timeline

ENV_REMEDIATE = "ZEST_REMEDIATE"
_OFF_VALUES = frozenset({"0", "false", "off", "no"})

_lock = threading.Lock()
_targets: dict[str, object] = {}


def enabled() -> bool:
    if not timeline.enabled():
        return False
    return os.environ.get(ENV_REMEDIATE, "").strip().lower() \
        not in _OFF_VALUES


def register_target(name: str, fn) -> bool:
    """Inject ``fn(cmd, *args)`` under ``name`` (the latest owner wins).
    False, and nothing kept, when the layer is off."""
    if not enabled():
        return False
    with _lock:
        _targets[name] = fn
    return True


def unregister_target(name: str, fn=None) -> None:
    """With ``fn``, only if it is still the registered one: an old
    owner's teardown must not drop its replacement."""
    with _lock:
        if fn is None or _targets.get(name) is fn:
            _targets.pop(name, None)


def invoke(name: str, *args):
    """Call the target registered under ``name``; None when there is
    none."""
    with _lock:
        fn = _targets.get(name)
    return None if fn is None else fn(*args)


def reset() -> None:
    with _lock:
        _targets.clear()
