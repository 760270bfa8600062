"""Content-addressing hash conventions.

- **BLAKE3 on the host**: one-shot hashing through the native C++
  library. The device kernel (``ops/blake3_cuda.py``) verifies whole
  batches on the card instead.
- **MerkleHash hex**: xorb cache keys and CAS API hex read the 32-byte
  hash as 4 little-endian u64 and print each as 16 hex digits.
- **Domain-separated keys**: chunk hashes and merkle interior nodes use
  distinct BLAKE3 keyed modes (the production Xet constants), so the
  addresses computed here are real HF CAS addresses.
"""

from __future__ import annotations

import struct

from zest_tpu_torch import native
from zest_tpu_torch.cas import xet_constants as _xc

HASH_LEN = 32

CHUNK_KEY = _xc.CHUNK_KEY
NODE_KEY = _xc.NODE_KEY
FILE_SALT = _xc.FILE_SALT


def blake3_hash(data: bytes) -> bytes:
    """Plain BLAKE3-256 of ``data`` on the host."""
    return native.lib.blake3(data)


def blake3_keyed(key: bytes, data: bytes) -> bytes:
    return native.lib.blake3_keyed(key, data)


def chunk_hash(data: bytes) -> bytes:
    """Content hash of one CDC chunk (keyed, chunk domain)."""
    return blake3_keyed(CHUNK_KEY, data)


# ── Merkle aggregation (production Xet tree; see xet_constants) ──


def node_hash(children: list[tuple[bytes, int]]) -> bytes:
    buf = []
    for h, length in children:
        if len(h) != HASH_LEN:
            raise ValueError("child hash must be 32 bytes")
        buf.append(f"{hash_to_hex(h)} : {length}\n")
    return blake3_keyed(NODE_KEY, "".join(buf).encode())


def _closes_group(child_hash: bytes, k: int) -> bool:
    if k >= _xc.GROUP_MAX:
        return True
    if k < _xc.GROUP_MIN:
        return False
    last = struct.unpack("<Q", child_hash[24:32])[0]
    return last % _xc.GROUP_MOD == 0


def merkle_root(leaves: list[tuple[bytes, int]]) -> tuple[bytes, int]:
    """Production Xet merkle root over (hash, length) leaves."""
    if not leaves:
        return chunk_hash(b""), 0
    level = list(leaves)
    while len(level) > 1:
        nxt: list[tuple[bytes, int]] = []
        group: list[tuple[bytes, int]] = []
        for child in level:
            group.append(child)
            if _closes_group(child[0], len(group)):
                nxt.append((node_hash(group), sum(s for _, s in group)))
                group = []
        if group:
            nxt.append((node_hash(group), sum(s for _, s in group)))
        level = nxt
    return level[0]


def xorb_hash(chunk_hashes: list[tuple[bytes, int]]) -> bytes:
    """Content address of a xorb = merkle root over its chunks."""
    return merkle_root(chunk_hashes)[0]


def file_hash(chunk_hashes: list[tuple[bytes, int]]) -> bytes:
    """Content address of a file: the salted merkle root over its chunk
    sequence. An empty file's address is the all-zero hash."""
    if not chunk_hashes:
        return bytes(HASH_LEN)
    return blake3_keyed(FILE_SALT, merkle_root(chunk_hashes)[0])


# ── Hex conventions ──


def hash_to_hex(h: bytes) -> str:
    """MerkleHash hex: 4 little-endian u64 groups, each printed %016x."""
    if len(h) != HASH_LEN:
        raise ValueError(f"hash must be {HASH_LEN} bytes, got {len(h)}")
    a, b, c, d = struct.unpack("<4Q", h)
    return f"{a:016x}{b:016x}{c:016x}{d:016x}"


def hex_to_hash(s: str) -> bytes:
    """Inverse of :func:`hash_to_hex`."""
    if len(s) != 64:
        raise ValueError(f"hex hash must be 64 chars, got {len(s)}")
    words = [int(s[i : i + 16], 16) for i in (0, 16, 32, 48)]
    return struct.pack("<4Q", *words)
