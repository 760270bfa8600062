"""Peer identity and swarm addressing on the BT wire.

Azureus-style 20-byte peer IDs and per-xorb SHA-1 info_hashes,
wire-compatible with the JAX package's and the reference swarms
(src/peer_id.zig:10-33). The domain-separation prefix ``zest-xet-v1:``
MUST match byte-for-byte or peers land in disjoint swarms. (Cooperating
hosts of one pull skip discovery: their xorb→owner assignment is a
function of the xorb hash, ``transfer/coop.py``.)
"""

from __future__ import annotations

import hashlib
import os

from zest_tpu_torch.version import CLIENT_PREFIX

# Domain separation for swarm addressing; byte-compatible with the reference
# (src/peer_id.zig:21-22) so both implementations join the same swarms.
INFO_HASH_PREFIX = b"zest-xet-v1:"


def generate() -> bytes:
    """20-byte Azureus-style peer ID: 8-byte client prefix + 12 random bytes."""
    return CLIENT_PREFIX + os.urandom(12)


def compute_info_hash(xorb_hash: bytes) -> bytes:
    """``info_hash = SHA-1("zest-xet-v1:" || xorb_hash)`` — one swarm per xorb.

    (reference: src/peer_id.zig:28-33)
    """
    if len(xorb_hash) != 32:
        raise ValueError(f"xorb hash must be 32 bytes, got {len(xorb_hash)}")
    return hashlib.sha1(INFO_HASH_PREFIX + xorb_hash).digest()
