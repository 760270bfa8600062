"""BG4 regroup and the fused regroup → BLAKE3 verify, in plain PyTorch.

The counterpart of ``zest_tpu/ops/decode_pallas.py``. ByteGrouping4
(``cas.compression``, the scheme tensor bytes take) stores a chunk as four
byte planes; the receiver of a cooperative exchange decodes only the LZ4
stage on the host (``XorbReader.extract_chunk_planar``) and leaves the
regroup, ``out[4i+k] = plane_k[i]``, to the device, fused into the BLAKE3
verify kernel's loads, so the host never builds the interleaved bytes and
the device never stores them.

- :func:`stage_planar` lays each chunk's planes at word-aligned
  quarter-capacity slots, the static layout both regroups read;
- :func:`regroup_words` is the plain version of the CUDA kernel
  ``csrc/bg4.cu`` (``ops/bg4_cuda.py``), with the Pallas kernel's
  arithmetic: output word ``4g+s`` packs byte ``s`` of each plane's word
  ``g``;
- :func:`fused_regroup_hash` is the plain version of the fused kernel
  (``csrc/blake3.cu``'s planar loader, ``ops/bg4_cuda.launch_fused``):
  the regroup, then ``ops/blake3.hash_words``;
- :class:`FusedBg4Verifier` launches the fused kernel for a CUDA tensor
  and runs the plain pass only for a CPU one.

PyTorch has no u32 shift, so the arithmetic runs in int64 on u32 values.
"""

from __future__ import annotations

import numpy as np
import torch

from zest_tpu_torch.cas.blake3 import CHUNK_LEN
from zest_tpu_torch.ops import blake3
from zest_tpu_torch.ops.blake3 import MAX_LEAVES, WORDS_PER_LEAF


def bg4_plane_sizes(n: int) -> tuple[int, int, int, int]:
    """Byte count of each BG4 plane for an ``n``-byte chunk."""
    return tuple((n - k + 3) // 4 for k in range(4))


def check_planar(words: torch.Tensor) -> None:
    """The layout every regroup takes (``ValueError``)."""
    if words.dim() != 2:
        raise ValueError(f"planar words must be (B, W), got "
                         f"{tuple(words.shape)}")
    if words.dtype != torch.uint32:
        raise ValueError(f"planar words must be torch.uint32, got "
                         f"{words.dtype}")
    if words.shape[1] % 4:
        raise ValueError("planar capacity must be a 16-byte multiple")


def stage_planar(payloads: list[bytes], lengths: list[int],
                 device: torch.device | str = "cpu"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Planar payloads → zero-padded ``(B, cap/4)`` u32 words and ``(B,)``
    int32 lengths on ``device``: each chunk's plane ``k`` lands at byte
    ``k·cap/4`` of its row, ``cap`` being the longest chunk rounded up to
    1 KiB. A few memcpys per chunk, never a byte-level transform. A CUDA
    destination gets one pinned, batched host→device copy."""
    device = torch.device(device)
    if len(payloads) != len(lengths):
        raise ValueError("payloads and lengths differ in count")
    max_len = max(lengths) if lengths else 0
    cap = max(-(-max_len // CHUNK_LEN) * CHUNK_LEN, CHUNK_LEN)
    if cap > MAX_LEAVES * CHUNK_LEN:
        raise blake3.ChunkTooLarge(
            f"chunks larger than {MAX_LEAVES} KiB unsupported")
    slot = cap // 4
    buf = torch.zeros((len(payloads), cap), dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    for i, (payload, n) in enumerate(zip(payloads, lengths)):
        sizes = bg4_plane_sizes(n)
        if len(payload) != sum(sizes):
            raise ValueError(f"planar payload {i} is {len(payload)} bytes "
                             f"for a {n}-byte chunk")
        src = np.frombuffer(payload, dtype=np.uint8)
        off = 0
        for k, size in enumerate(sizes):
            host[i, k * slot:k * slot + size] = src[off:off + size]
            off += size
    words = buf.view(torch.uint32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    if device.type == "cuda":
        return (words.to(device, non_blocking=True),
                lens.to(device, non_blocking=True))
    return words, lens


def regroup_words(words: torch.Tensor) -> torch.Tensor:
    """Plain BG4 inverse: ``(B, W)`` u32 planar words (plane ``k`` at word
    ``k·W/4``) → ``(B, W)`` u32 regrouped words on the same device."""
    check_planar(words)
    B, W = words.shape
    planes = blake3._u32_to_i64(words).reshape(B, 4, W // 4)
    parts = []
    for s in range(4):
        b = (planes >> (8 * s)) & 0xFF                        # (B, 4, W/4)
        parts.append(b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
                     | (b[:, 3] << 24))
    return blake3._i64_to_u32(torch.stack(parts, dim=2).reshape(B, W))


def fused_regroup_hash(words: torch.Tensor, lengths: torch.Tensor,
                       key_words: tuple[int, ...],
                       base_flags: int) -> torch.Tensor:
    """Plain fused pass: digests ``(B, 8)`` u32 of the regrouped bytes of
    ``(B, cap/4)`` planar words with the original ``(B,)`` lengths."""
    return blake3.hash_words(regroup_words(words), lengths, key_words,
                             base_flags)


class FusedBg4Verifier:
    """Sibling of the hashers whose input is BG4 *planar* payloads: one
    call regroups and hashes on ``device`` (``cuda`` by default)."""

    def __init__(self, key: bytes | None = None,
                 device: torch.device | str = "cuda"):
        self.key_words, self.base_flags = blake3.key_params(key)
        self.device = torch.device(device)

    def hash_planar_device(self, words: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
        """``(B, cap/4)`` u32 plane-slotted words + ``(B,)`` original chunk
        lengths → ``(B, 8)`` u32 digests of the REGROUPED bytes. A CUDA
        tensor launches the fused kernel once; a CPU tensor takes the
        plain pass."""
        if words.dim() == 2 and words.shape[-1] % WORDS_PER_LEAF:
            raise ValueError("padded capacity must be a 1 KiB multiple")
        if words.device.type == "cuda":
            # Imported here: ops/bg4_cuda.py imports this module.
            from zest_tpu_torch.ops import bg4_cuda

            return bg4_cuda.launch_fused(words, lengths, self.key_words,
                                         self.base_flags)
        if words.device.type == "cpu":
            return fused_regroup_hash(words, lengths, self.key_words,
                                      self.base_flags)
        raise ValueError(f"unsupported device {words.device}")

    def hash_planar_batch(self, payloads: list[bytes],
                          lengths: list[int]) -> list[bytes]:
        """Planar BG4 payloads → 32-byte digests of the original chunk
        bytes, which the host never builds. Reading the digests back
        waits for this call's launches."""
        if not payloads:
            return []
        return blake3.digests_to_bytes(self.hash_planar_device(
            *stage_planar(payloads, lengths, self.device)))
