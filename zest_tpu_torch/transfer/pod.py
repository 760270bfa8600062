"""The pod round and its expert-routed form, safetensors headers from the
head terms, and the receipt check of peer blobs on the device.

The counterpart of ``zest_tpu/transfer/pod.py``. :func:`pod_round`
distributes a pull's fetch units over a slot mesh
(``parallel/mesh.py``): each slot's owner fetches only its units through
the waterfall, the gather gives every slot every blob
(``parallel/collectives.py``), each provably whole xorb is verified on the
mesh's device, and every blob that passes lands in the cache — so the
per-file landing that follows reads the cache. The round only speeds the
waterfall up: a unit it misses (a failed fetch, a rejected blob) is
fetched by the landing as usual. :func:`expert_pod_round` runs the
shared (dense) units through that round and has each expert's private
units fetched only by the slots that own the expert
(``parallel/expert.py``).

:func:`fetch_file_header` decodes a file's head terms through the
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
pull can never look right while no kernel verified anything. In the
same way an expert unit counts as failed only on a fetch error
(``FETCH_ERRORS``), where the JAX package counts any exception.
"""

from __future__ import annotations

import struct
import time

from zest_tpu_torch import telemetry
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.compression import CompressionError, Scheme
from zest_tpu_torch.cas.xorb import FRAME_HEADER_LEN, XorbFormatError, XorbReader
from zest_tpu_torch.models.safetensors_io import parse_header_prefix
from zest_tpu_torch.ops import fused_verifier_for_backend, unit_verify_hasher
from zest_tpu_torch.ops.blake3 import ChunkTooLarge
from zest_tpu_torch.parallel.collectives import PodDistributor, split_waves
from zest_tpu_torch.parallel.mesh import num_slots, pod_mesh
from zest_tpu_torch.parallel.plan import DistributionPlan
from zest_tpu_torch.transfer.bridge import FETCH_ERRORS

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


def local_slice_groups(n_hosts: int) -> tuple[int, ...] | None:
    """The slice id per coop host index as the runtime knows it, for the
    collective's link classes. The JAX package reads each TPU process's
    ``slice_index``; CUDA exposes no slice notion, so this is None and
    ``Config.coop_topology`` (``ZEST_COOP_TOPOLOGY``) is the only source
    of a multi-slice map."""
    return None


def expert_pod_round(bridge, file_maps, placement, mesh=None,
                     log=None) -> dict:
    """The expert-routed round over ``mesh`` (default ``pod_mesh()``):
    the shared units go through :func:`pod_round` (its fill verifies them
    with the kernels), each expert unit is fetched through the waterfall
    and cached by the process that owns its slot, never gathered. Returns
    the JAX package's stats keys. A verifier that fails to build or launch
    raises; a unit whose fetch fails is counted and left to the
    landing."""
    from zest_tpu_torch.parallel.expert import ExpertRoutedPlan

    with telemetry.span("pod.expert_round", files=len(file_maps)):
        return _expert_pod_round(bridge, file_maps, placement, mesh, log,
                                 ExpertRoutedPlan)


def _expert_pod_round(bridge, file_maps, placement, mesh, log,
                      ExpertRoutedPlan) -> dict:
    from zest_tpu_torch.transfer.federated import _entries_by_hash

    mesh = pod_mesh() if mesh is None else mesh
    routed = ExpertRoutedPlan.build(file_maps, placement)
    t0 = time.monotonic()
    shared_stats = pod_round(bridge, [], mesh=mesh, log=None,
                             _plan=routed.shared)
    # Placement hosts are the round's slots: this process fetches for the
    # slots its mesh stands for.
    my_hosts = [s for s in PodDistributor(mesh).local_slots()
                if s < placement.num_hosts]
    entries_map = _entries_by_hash([fm.rec for fm in file_maps])
    fetched = failed = expert_bytes = 0
    for h in my_hosts:
        for a in routed.expert_units.get(h, []):
            try:
                data = bridge.fetch_unit(a.hash_hex, a.fetch_info)
            except FETCH_ERRORS:
                failed += 1
                continue
            fi = a.fetch_info
            bridge.cache_blob(
                a.hash_hex, fi.range.start, data,
                whole=bridge.whole_xorb_provable(
                    entries_map.get(a.hash_hex, []), fi.range.start))
            fetched += 1
            expert_bytes += len(data)
    s = routed.summary()
    stats = {
        "shared": shared_stats,
        "expert_units_fetched": fetched,
        "expert_units_failed": failed,
        "expert_bytes": expert_bytes,
        "ici_bytes_saved": s["ici_bytes_saved"],
        "elapsed_s": round(time.monotonic() - t0, 3),
    }
    if log is not None:
        log(f"expert-routed pod round: {fetched} expert unit(s) "
            f"({expert_bytes} bytes) fetched by their owning slots, "
            f"{failed} failed; {s['ici_bytes_saved']} gather bytes saved")
    return stats


def pod_round(bridge, recs, mesh=None, log=None, budget_bytes=None,
              _plan=None) -> dict:
    """One distribution round for ``recs`` over ``mesh`` (default
    ``pod_mesh()``, every CUDA device). A one-slot mesh skips the round:
    the waterfall alone is optimal there. The plan splits into waves whose
    staged pool fits ``budget_bytes`` (default
    ``cfg.hbm_staging_bytes``); each wave is gathered, verified on the
    first slot's device and drained into ``bridge.cache`` before the next
    is staged. Returns the ``stats["pod"]`` block. A verifier that fails
    to build or launch raises. ``_plan`` replaces the plan of ``recs``
    (the expert round's shared units)."""
    with telemetry.span("pod.round", files=len(recs)):
        return _pod_round(bridge, recs, mesh, log, budget_bytes, _plan)


def _pod_round(bridge, recs, mesh, log, budget_bytes, _plan=None) -> dict:
    mesh = pod_mesh() if mesh is None else mesh
    n = num_slots(mesh)
    plan = _plan if _plan is not None else DistributionPlan.build(recs, n)
    if not plan.assignments or n <= 1:
        return {"slots": n, "units": len(plan.assignments), "skipped": True}
    if budget_bytes is None:
        budget_bytes = bridge.cfg.hbm_staging_bytes
    waves = split_waves(plan, budget_bytes)
    dist = PodDistributor(mesh)
    verifier = make_unit_verifier(device=mesh[0])
    filled = rejected = 0
    gather_s = fill_s = 0.0
    peak_pool = 0
    for wave in waves:
        tw = time.monotonic()
        pool = dist.distribute(
            wave, lambda a: bridge.fetch_unit(a.hash_hex, a.fetch_info))
        t_gather = time.monotonic()
        f, r = pool.fill_cache(bridge.cache, verify=verifier)
        filled += f
        rejected += r
        if r:
            telemetry.record("verify_rejected", tier="pod", count=r)
        peak_pool = max(peak_pool, pool.layout.pool_bytes)
        gather_s += t_gather - tw
        fill_s += time.monotonic() - t_gather
        del pool  # free the wave's replicas before staging the next
    stats = {
        "slots": n,
        "units": len(plan.assignments),
        "planned_bytes": plan.total_bytes,
        "waves": len(waves),
        "pool_bytes": peak_pool,
        "budget_bytes": budget_bytes,
        "balance": plan.summary()["balance"],
        "filled": filled,
        "verify_rejected": rejected,
        "gather_s": round(gather_s, 3),
        "fill_s": round(fill_s, 3),
    }
    if log is not None:
        log(f"pod round: {filled}/{stats['units']} units cached over {n} "
            f"slots in {len(waves)} wave(s) ({stats['planned_bytes']} "
            f"bytes, gather {stats['gather_s']}s)")
    return stats
