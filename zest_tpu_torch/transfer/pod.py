"""Safetensors headers from the head terms, and the receipt check of peer
blobs on the device.

The parts of ``zest_tpu/transfer/pod.py`` that the direct landing and the
cooperative exchange run (the pod round itself comes with the multi-GPU
slice). :func:`fetch_file_header` decodes a file's head terms through the
waterfall; :func:`fetch_header_probe` reads only the head frames, for
callers that need the header before the units are fetched. A blob that
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

import struct

from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.compression import CompressionError, Scheme
from zest_tpu_torch.cas.xorb import FRAME_HEADER_LEN, XorbFormatError, XorbReader
from zest_tpu_torch.models.safetensors_io import parse_header_prefix
from zest_tpu_torch.ops import fused_verifier_for_backend, unit_verify_hasher
from zest_tpu_torch.ops.blake3 import ChunkTooLarge

MALFORMED = (XorbFormatError, CompressionError, ChunkTooLarge)


def _header_done(buf) -> bool:
    if len(buf) < 8:
        return False
    (hlen,) = struct.unpack_from("<Q", buf, 0)
    return len(buf) >= 8 + hlen


def fetch_file_header(bridge, rec):
    """A safetensors file's header, from its head terms through the
    waterfall (each fetched unit lands in the cache, where the landing
    reads it again). Raises ``ValueError`` for a file that is not
    safetensors."""
    buf = bytearray()
    for term in rec.terms:
        buf += bridge.fetch_term(term, rec)
        if _header_done(buf):
            break
    return parse_header_prefix(bytes(buf))


def fetch_header_probe(bridge, rec):
    """:func:`fetch_file_header` that fetches only the head chunk frames
    of an uncached unit (two small ranged reads per frame) instead of the
    whole unit: the cooperative round orders its units by the headers
    before it fetches them, and a whole head unit per host would put the
    head units on the CDN once per host. A term that does not start its
    unit, or is cached already, takes the waterfall."""
    buf = bytearray()
    probed = 0
    for term in rec.terms:
        if _header_done(buf):
            break
        fi = rec.find_fetch_info(term)
        if (fi is None or bridge.cas is None
                or term.range.start != fi.range.start
                or bridge.cache.locate_with_range(
                    term.hash_hex, fi.range.start) is not None):
            buf += bridge.fetch_term(term, rec)
            continue
        url = bridge._absolute_url(fi.url)
        pos = fi.url_range_start
        for _ in range(term.range.start, term.range.end):
            if pos + FRAME_HEADER_LEN > fi.url_range_end:
                raise XorbFormatError("head frame past its unit's range")
            head = bridge.cas.fetch_xorb_from_url(
                url, (pos, pos + FRAME_HEADER_LEN))
            clen = int.from_bytes(head[1:4], "little")
            end = pos + FRAME_HEADER_LEN + clen
            if end > fi.url_range_end:
                raise XorbFormatError("head frame past its unit's range")
            frame = head + (bridge.cas.fetch_xorb_from_url(
                url, (pos + FRAME_HEADER_LEN, end)) if clen else b"")
            probed += len(frame)
            buf += XorbReader(frame).extract_chunk(0)
            pos = end
            if _header_done(buf):
                break
        else:
            continue
        break
    if probed:
        bridge.stats.record("cdn", probed)
    return parse_header_prefix(bytes(buf))


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
