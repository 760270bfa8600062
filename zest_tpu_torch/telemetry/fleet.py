"""Fleet trace identity: the one id every host of a cooperative pull
stamps on its spans.

The part of ``zest_tpu/telemetry/fleet.py`` the port reaches: trace
merging and pod metrics aggregation are not ported.
"""

from __future__ import annotations

import hashlib


def mint_trace_id(pull_key: str, nonce: str = "") -> str:
    """16-byte trace id (32 hex) of one cooperative pull.

    Derived, not drawn: every host mints the same id with no extra round.
    ``pull_key`` is ``repo@sha`` (or the unit-key set of a bare
    ``coop_round``); ``nonce``, shared through the process group's store
    when there is one (``transfer.coop.share_nonce_via_kv``), tells
    repeated pulls of one revision apart."""
    return hashlib.blake2b(f"zest-trace|{pull_key}|{nonce}".encode(),
                           digest_size=16).hexdigest()
