"""Whole-xorb verification on the device: the receipt check of peer blobs.

The part of ``zest_tpu/transfer/pod.py`` that the cooperative exchange
runs (the pod round itself comes with the multi-GPU slice). A blob that
provably is a whole xorb is verified against its content address before
it enters the cache: every chunk is hashed on the device (keyed, Xet
chunk domain) and the Merkle fold over the digests runs on the host.
BG4 chunks skip the host's byte regroup: only their LZ4 stage is decoded
on the host, the planar bytes cross to the card, and one kernel regroups
them as it loads them for BLAKE3 (``ops.FusedBg4Verifier``).

Unlike the JAX package, which counts every exception as a failed
verification, only a malformed blob fails here: bad framing
(``XorbFormatError``), a payload that does not decode
(``CompressionError``) or a chunk over the verifiers' 128 KiB capacity
(``ChunkTooLarge``). A kernel that does not build or launch raises, so a
pull can never look right while no kernel verified anything.
"""

from __future__ import annotations

from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.compression import CompressionError, Scheme
from zest_tpu_torch.cas.xorb import XorbFormatError, XorbReader
from zest_tpu_torch.ops import fused_verifier_for_backend, unit_verify_hasher
from zest_tpu_torch.ops.blake3 import ChunkTooLarge

MALFORMED = (XorbFormatError, CompressionError, ChunkTooLarge)


def _device_verify_full_xorb(data: bytes, hash_hex: str, hasher,
                             fused) -> bool:
    """True when ``data`` decodes to chunks whose xorb hash is
    ``hash_hex``: BG4 chunks through ``fused`` (planar), the rest through
    ``hasher``. False for a malformed blob; anything else raises."""
    try:
        reader = XorbReader(data)
        sizes = reader.chunk_sizes.tolist()
        digests: list[bytes | None] = [None] * len(reader)
        bg4 = [i for i, s in enumerate(reader.chunk_schemes.tolist())
               if s == int(Scheme.BG4_LZ4)]
        if bg4:
            planar = [reader.extract_chunk_planar(i) for i in bg4]
            for i, d in zip(bg4, fused.hash_planar_batch(
                    planar, [sizes[i] for i in bg4])):
                digests[i] = d
        rest = [i for i, d in enumerate(digests) if d is None]
        if rest:
            chunks = [reader.extract_chunk(i, verify=False) for i in rest]
            for i, d in zip(rest, hasher.hash_batch(chunks)):
                digests[i] = d
    except MALFORMED:
        return False
    return hashing.hash_to_hex(
        hashing.xorb_hash(list(zip(digests, sizes)))) == hash_hex


def make_unit_verifier(key: bytes | None = None, device="cuda"):
    """``verify(hash_hex, data) -> bool`` for provably whole xorb blobs,
    on ``device`` (``cuda`` by default: the CUDA kernels; ``cpu``: their
    plain versions). Built once per round: hasher setup is not per-unit
    work."""
    if key is None:
        key = hashing.CHUNK_KEY
    hasher = unit_verify_hasher(key, device)
    fused = fused_verifier_for_backend(key, device)

    def verify(hash_hex: str, data: bytes) -> bool:
        return _device_verify_full_xorb(data, hash_hex, hasher, fused)

    return verify
