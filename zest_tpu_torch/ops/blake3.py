"""Batched BLAKE3 in plain PyTorch — the plain version of the CUDA kernel.

The counterpart of ``zest_tpu/ops/blake3.py`` (the JAX package's XLA
lowering). It hashes a batch of zero-padded chunks held as ``(B, cap/4)``
little-endian u32 words plus ``(B,)`` byte lengths, and returns ``(B, 8)``
u32 digests — the same contract as the CUDA kernel in
``ops/blake3_cuda.py``, which ``chip_smoke.py`` holds bit-exact against
this module on the card. The CPU tests run it against the JAX package.

PyTorch has no u32 add or shift, so the arithmetic runs in int64 with
every add masked by ``& 0xFFFFFFFF``; u32 tensors are only storage.

Vectorization follows the JAX version: one leaf (1 KiB BLAKE3 chunk) is 16
block compressions, all leaves of all rows step together with lanes masked
by each leaf's block count; leaf CVs then fold pairwise with odd-tail
promotion (BLAKE3's largest-power-of-two tree), and a one-leaf chunk takes
ROOT on its deferred last block.
"""

from __future__ import annotations

import numpy as np
import torch

from zest_tpu_torch.cas.blake3 import (
    BLOCK_LEN,
    CHUNK_END,
    CHUNK_LEN,
    CHUNK_START,
    IV,
    KEYED_HASH,
    MSG_PERMUTATION,
    PARENT,
    ROOT,
)

BLOCKS_PER_LEAF = CHUNK_LEN // BLOCK_LEN      # 16
WORDS_PER_BLOCK = BLOCK_LEN // 4              # 16
WORDS_PER_LEAF = CHUNK_LEN // 4               # 256
MAX_LEAVES = 128                              # 128 KiB: xet max chunk size
_M32 = 0xFFFFFFFF
_PERM = list(MSG_PERMUTATION)


def key_params(key: bytes | None) -> tuple[tuple[int, ...], int]:
    """``(key_words, base_flags)``: the 8 key words and KEYED_HASH for a
    32-byte key, the IV and no flag for plain hashing."""
    if key is None:
        return tuple(IV), 0
    if len(key) != 32:
        raise ValueError("key must be 32 bytes")
    return tuple(int(w) for w in np.frombuffer(key, dtype="<u4")), KEYED_HASH


class ChunkTooLarge(ValueError):
    """A chunk over the verifiers' 128 KiB capacity: the one ``ValueError``
    a well-framed but hostile blob can raise at the trust boundary."""


def check_batch(words: torch.Tensor, lengths: torch.Tensor) -> None:
    """The capacity rules every hasher enforces (``ValueError``)."""
    if words.dim() != 2:
        raise ValueError(f"words must be (B, cap/4), got {tuple(words.shape)}")
    if words.dtype != torch.uint32:
        raise ValueError(f"words must be torch.uint32, got {words.dtype}")
    if words.shape[-1] % WORDS_PER_LEAF:
        raise ValueError("padded capacity must be a 1 KiB multiple")
    if words.shape[-1] > MAX_LEAVES * WORDS_PER_LEAF:
        raise ChunkTooLarge(
            f"chunks larger than {MAX_LEAVES} KiB unsupported")
    if lengths.shape != (words.shape[0],):
        raise ValueError(f"lengths must be ({words.shape[0]},), "
                         f"got {tuple(lengths.shape)}")
    if lengths.device != words.device:
        raise ValueError("words and lengths must be on one device")


def stage_batch(chunks: list[bytes],
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunks → zero-padded ``(B, cap/4)`` u32 words and ``(B,)`` int32
    lengths on ``device``; ``cap`` is the longest chunk rounded up to
    1 KiB. A CUDA destination gets one pinned, batched host→device copy."""
    max_len = max(len(c) for c in chunks)
    cap = max(-(-max_len // CHUNK_LEN) * CHUNK_LEN, CHUNK_LEN)
    buf = torch.zeros((len(chunks), cap), dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    lengths = torch.empty(len(chunks), dtype=torch.int32)
    for i, c in enumerate(chunks):
        host[i, :len(c)] = np.frombuffer(c, dtype=np.uint8)
        lengths[i] = len(c)
    words = buf.view(torch.uint32)
    if device.type == "cuda":
        return (words.to(device, non_blocking=True),
                lengths.to(device, non_blocking=True))
    return words, lengths


def digests_to_bytes(digests: torch.Tensor) -> list[bytes]:
    """(B, 8) u32 digests → 32-byte little-endian digests."""
    host = digests.view(torch.int32).cpu().numpy().view("<u4")
    return [row.tobytes() for row in host]


def _u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & _M32


def _i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(
        torch.int32).view(torch.uint32)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(va, vb, vc, vd, mx, my):
    """Four G functions at once: lane i of each row is column (or, after
    the rolls, diagonal) i of the state matrix."""
    va = (va + vb + mx) & _M32
    vd = _rotr(vd ^ va, 16)
    vc = (vc + vd) & _M32
    vb = _rotr(vb ^ vc, 12)
    va = (va + vb + my) & _M32
    vd = _rotr(vd ^ va, 8)
    vc = (vc + vd) & _M32
    vb = _rotr(vb ^ vc, 7)
    return va, vb, vc, vd


def compress(cv: torch.Tensor, m: torch.Tensor, counter: torch.Tensor,
             block_len: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """BLAKE3 compression on int64 tensors holding u32 values.

    ``cv`` (..., 8), ``m`` (..., 16); ``counter``/``block_len``/``flags``
    broadcastable (...). Returns the full (..., 16) output state."""
    shape = torch.broadcast_shapes(cv.shape[:-1], m.shape[:-1],
                                   counter.shape, block_len.shape,
                                   flags.shape)
    cv = cv.expand(*shape, 8)
    m = m.expand(*shape, 16)
    va, vb = cv[..., 0:4], cv[..., 4:8]
    vc = torch.tensor(IV[:4], dtype=torch.int64,
                      device=cv.device).expand(*shape, 4)
    vd = torch.stack([counter.expand(shape),
                      torch.zeros(shape, dtype=torch.int64, device=cv.device),
                      block_len.expand(shape), flags.expand(shape)], dim=-1)
    for _ in range(7):
        va, vb, vc, vd = _g(va, vb, vc, vd, m[..., 0:8:2], m[..., 1:8:2])
        vb = torch.roll(vb, -1, -1)
        vc = torch.roll(vc, -2, -1)
        vd = torch.roll(vd, -3, -1)
        va, vb, vc, vd = _g(va, vb, vc, vd, m[..., 8:16:2], m[..., 9:16:2])
        vb = torch.roll(vb, 1, -1)
        vc = torch.roll(vc, 2, -1)
        vd = torch.roll(vd, 3, -1)
        m = m[..., _PERM]
    lo = torch.cat([va, vb], dim=-1)
    hi = torch.cat([vc, vd], dim=-1)
    return torch.cat([lo ^ hi, hi ^ cv], dim=-1)


def hash_words(words: torch.Tensor, lengths: torch.Tensor,
               key_words: tuple[int, ...], base_flags: int) -> torch.Tensor:
    """Plain BLAKE3 of each row: ``(B, cap/4)`` u32 words, ``(B,)``
    lengths → ``(B, 8)`` u32 digests on the same device. Bytes past each
    length are masked to zero first, so garbage there cannot change a
    digest; lengths are clamped to ``[0, cap]``."""
    check_batch(words, lengths)
    dev = words.device
    B, W = words.shape
    L = W // WORDS_PER_LEAF
    i64 = dict(dtype=torch.int64, device=dev)
    lengths = lengths.to(torch.int64).clamp(0, 4 * W)
    w = _u32_to_i64(words)

    word_idx = torch.arange(W, **i64)
    rem = (lengths[:, None] - 4 * word_idx[None, :]).clamp(0, 4)
    mask = torch.where(rem >= 4, torch.full_like(rem, _M32),
                       (torch.ones_like(rem) << (8 * rem)) - 1)
    w = (w & mask).reshape(B, L, BLOCKS_PER_LEAF, WORDS_PER_BLOCK)

    leaf_idx = torch.arange(L, **i64)
    leaf_bytes = (lengths[:, None] - CHUNK_LEN * leaf_idx[None, :]).clamp(
        0, CHUNK_LEN)                                          # (B, L)
    n_blocks = torch.maximum(
        (leaf_bytes + BLOCK_LEN - 1) // BLOCK_LEN,
        (leaf_idx == 0).to(torch.int64)[None, :])
    n_leaves = (n_blocks > 0).sum(dim=1).clamp(min=1)          # (B,)

    key = torch.tensor(key_words, **i64)
    cv = key.expand(B, L, 8)
    dcv = torch.zeros(B, 8, **i64)
    dblk = torch.zeros(B, WORDS_PER_BLOCK, **i64)
    dlen = torch.zeros(B, **i64)
    dflags = torch.zeros(B, **i64)
    for b in range(BLOCKS_PER_LEAF):
        m = w[:, :, b]
        last = n_blocks - 1 == b
        bl = (leaf_bytes - BLOCK_LEN * b).clamp(0, BLOCK_LEN)
        fl = (base_flags | (CHUNK_START if b == 0 else 0)
              | torch.where(last, CHUNK_END, 0))
        out = compress(cv, m, leaf_idx, bl, fl)
        # Leaf 0's last block is deferred: a one-leaf chunk re-runs it
        # with ROOT (the root flag belongs on that block).
        last0 = last[:, 0]
        dcv = torch.where(last0[:, None], cv[:, 0], dcv)
        dblk = torch.where(last0[:, None], m[:, 0], dblk)
        dlen = torch.where(last0, bl[:, 0], dlen)
        dflags = torch.where(last0, fl[:, 0], dflags)
        cv = torch.where((b < n_blocks)[..., None], out[..., :8], cv)

    root = _merge_tree(cv, n_leaves, key, base_flags)
    single = compress(dcv, dblk, torch.zeros(B, **i64), dlen,
                      dflags | ROOT)
    root = torch.where((n_leaves == 1)[:, None], single, root)
    return _i64_to_u32(root[:, :8])


def _merge_tree(cv: torch.Tensor, n_leaves: torch.Tensor,
                key: torch.Tensor, base_flags: int) -> torch.Tensor:
    """Fold (B, L, 8) leaf CVs pairwise with odd-tail promotion; the one
    merge with exactly two live nodes is the root and carries ROOT."""
    B, L, _ = cv.shape
    i64 = dict(dtype=torch.int64, device=cv.device)
    count = n_leaves.clone()
    root = torch.zeros(B, 16, **i64)
    while L > 1:
        if L % 2:
            cv = torch.cat([cv, torch.zeros(B, 1, 8, **i64)], dim=1)
            L += 1
        half = L // 2
        left = cv[:, 0::2]
        m = torch.cat([left, cv[:, 1::2]], dim=-1)             # (B, half, 16)
        is_root = count == 2
        flags = (base_flags | PARENT) | torch.where(is_root, ROOT, 0)
        out = compress(key.expand(B, half, 8), m,
                       torch.zeros(B, half, **i64),
                       torch.full((B, half), BLOCK_LEN, **i64),
                       flags[:, None].expand(B, half))
        merged = (2 * torch.arange(half, **i64)[None, :] + 1) < count[:, None]
        cv = torch.where(merged[..., None], out[..., :8], left)
        root = torch.where(is_root[:, None], out[:, 0], root)
        count = (count + 1) // 2
        L = half
    return root


class DeviceHasher:
    """Plain-PyTorch batched BLAKE3 on any device (``cpu`` by default):
    the counterpart of the JAX package's ``ops.blake3.DeviceHasher``."""

    def __init__(self, key: bytes | None = None,
                 device: torch.device | str = "cpu"):
        self.key_words, self.base_flags = key_params(key)
        self.device = torch.device(device)

    def hash_device(self, words: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
        """(B, cap/4) u32 + (B,) lengths → (B, 8) u32 digests."""
        return hash_words(words, lengths, self.key_words, self.base_flags)

    def hash_batch(self, chunks: list[bytes]) -> list[bytes]:
        """Byte strings → 32-byte digests."""
        if not chunks:
            return []
        return digests_to_bytes(
            self.hash_device(*stage_batch(chunks, self.device)))
