"""Delta pulls: chunk-level revision diffs over the content-addressed cache.

The counterpart of ``zest_tpu/transfer/delta.py``, same file layout and
JSON shape (``cache_dir/manifests/models--{org}--{name}@{sha}.json``).
A pull of revision B over a cached revision A diffs the two term lists
before any byte moves; the machinery here is planning and evidence, never
a new byte-moving tier:

- **Manifests**: every pull (and push) persists the revision's file →
  term-list map. That is the revision-A evidence a later pull of B diffs
  against; without it the delta degrades to a full pull.
- :class:`DeltaPlan`: B's fetch units split into *changed* (chunk ranges
  A never referenced: a pure function of the two revisions' metadata, so
  every host of a cooperative pull computes the same set) and *reused*
  (referenced by A; a local cache hit, counted *stale* when evicted).
- **Per-tensor fingerprints**: a tensor's bytes are identified by the
  canonical (xorb hash, chunk range, intra-segment window) cover of its
  file span; equal covers mean byte-identical tensors, by content
  addressing. The landing reuses a resident tensor of A whose cover is
  unchanged (the hot-swap, ``models.loader``), and, where the cached
  xorbs' chunk tables show it, one whose bytes sit in the same chunks at
  the same offsets however the terms cut them
  (:func:`aligned_tensor_names`, beyond the JAX package).

Everything is conservative: any metadata mismatch classifies as changed,
which costs work, never correctness. Planning opens a ``delta.plan``
span and books ``zest_delta_bytes_total{kind}``, as the JAX package
does.
"""

from __future__ import annotations

import bisect
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from zest_tpu_torch import storage, telemetry
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas import reconstruction as recon

_M_DELTA_BYTES = telemetry.counter(
    "zest_delta_bytes_total",
    "Checkpoint bytes classified by the delta plan: reused = served "
    "from the local cache with zero network, fetched = changed (or "
    "evicted) bytes that crossed the waterfall/coop tiers",
    ("kind",))

MANIFEST_FORMAT = 1


class DeltaSwapError(RuntimeError):
    """A hot-swap's landing failed. The caller's base dict holds every
    tensor the swap had taken to reuse (the same objects) and every base
    tensor not yet superseded; ``gone`` names the base tensors that a
    committed replacement had already superseded, ``restored`` counts the
    reused ones put back. Raised from the landing's error."""

    def __init__(self, cause: BaseException, gone: list[str],
                 restored: int):
        self.gone = gone
        self.restored = restored
        super().__init__(
            f"hot-swap landing failed ({type(cause).__name__}: {cause}); "
            f"{restored} reused tensor(s) restored to the base dict, "
            f"{len(gone)} superseded base tensor(s) gone: "
            f"{', '.join(gone) or '(none)'}")


# ── Revision manifests: the persisted revision-A evidence ──


def manifest_dir(cfg) -> Path:
    return cfg.cache_dir / "manifests"


def manifest_path(cfg, repo_id: str, commit_sha: str) -> Path:
    safe = "models--" + repo_id.replace("/", "--")
    return manifest_dir(cfg) / f"{safe}@{commit_sha}.json"


def terms_of(rec: recon.Reconstruction) -> list[list]:
    """Terms in the manifest wire shape:
    ``[hash_hex, chunk_start, chunk_end, unpacked_length]``."""
    return [[t.hash_hex, t.range.start, t.range.end, t.unpacked_length]
            for t in rec.terms]


def save_manifest(cfg, repo_id: str, commit_sha: str, entries,
                  rec_of, parent: str | None = None) -> bool:
    """Persist this revision's file → term-list map (atomic write).

    ``rec_of(entry)`` returns the entry's Reconstruction or None; the
    manifest is written only when every xet file's terms are known
    (complete or nothing: a partial manifest would pass for complete
    evidence). ``parent`` records lineage: the revision a push deduped
    against or a delta pull diffed with. Returns whether a manifest was
    written."""
    files: dict[str, dict] = {}
    for entry in entries:
        if not entry.is_xet:
            continue
        rec = rec_of(entry)
        if rec is None:
            return False
        files[entry.path] = {
            "size": int(entry.size),
            "xet_hash": entry.xet_hash,
            "terms": terms_of(rec),
        }
    doc = {
        "format": MANIFEST_FORMAT,
        "repo": repo_id,
        "revision": commit_sha,
        "saved_at": round(time.time(), 3),
        "files": files,
    }
    if parent and parent != commit_sha:
        doc["parent"] = parent
    storage.atomic_write(manifest_path(cfg, repo_id, commit_sha),
                         json.dumps(doc).encode())
    return True


def load_manifest(cfg, repo_id: str, commit_sha: str) -> dict | None:
    try:
        doc = json.loads(
            manifest_path(cfg, repo_id, commit_sha).read_text())
    except (OSError, ValueError):
        return None
    if (not isinstance(doc, dict)
            or doc.get("format") != MANIFEST_FORMAT
            or not isinstance(doc.get("files"), dict)):
        return None
    return doc


def find_base_manifest(cfg, repo_id: str, commit_sha: str,
                       base_revision: str | None = None) -> dict | None:
    """The revision-A evidence for a pull of ``commit_sha``.

    With ``base_revision`` (a ref name or a sha) only that revision's
    manifest qualifies; a ref resolves through the refs file the previous
    pull wrote (this pull rewrites it only at exit). Without one, the
    closest ancestor along the recorded ``parent`` chain wins, a
    descendant of ``commit_sha`` is never chosen, and among the rest the
    newest manifest (mtime) wins."""
    if base_revision:
        sha = base_revision
        if not manifest_path(cfg, repo_id, sha).exists():
            sha = storage.read_ref(cfg, repo_id, base_revision) \
                or base_revision
        if sha == commit_sha:
            return None
        return load_manifest(cfg, repo_id, sha)
    prefix = "models--" + repo_id.replace("/", "--") + "@"
    root = manifest_dir(cfg)
    shas: dict[str, float] = {}
    try:
        candidates = list(root.iterdir())
    except OSError:
        return None
    for p in candidates:
        if not p.name.startswith(prefix) or not p.name.endswith(".json"):
            continue
        sha = p.name[len(prefix):-len(".json")]
        if sha == commit_sha:
            continue
        try:
            shas[sha] = p.stat().st_mtime
        except OSError:
            continue
    if not shas:
        return None

    docs: dict[str, dict | None] = {}

    def _parent(sha: str) -> str | None:
        if sha not in docs:
            docs[sha] = load_manifest(cfg, repo_id, sha)
        doc = docs[sha]
        par = doc.get("parent") if doc else None
        return par if isinstance(par, str) and par else None

    # Closest ancestor: walk commit_sha's own lineage to the first hop
    # with evidence. The visited set and the hop bound stop a cyclic
    # chain.
    hops = 0
    seen = {commit_sha}
    cur = _parent(commit_sha)
    while cur and cur not in seen and hops <= len(shas) + 1:
        if cur in shas:
            return load_manifest(cfg, repo_id, cur)
        seen.add(cur)
        cur = _parent(cur)
        hops += 1

    def _descends_from_target(sha: str) -> bool:
        walked = {sha}
        cur = _parent(sha)
        while cur and cur not in walked and len(walked) <= len(shas) + 1:
            if cur == commit_sha:
                return True
            walked.add(cur)
            cur = _parent(cur)
        return False

    eligible = [s for s in shas if not _descends_from_target(s)]
    if not eligible:
        return None
    best = max(eligible, key=lambda s: shas[s])
    return load_manifest(cfg, repo_id, best)


# ── Canonical segments + per-tensor fingerprints ──


def _canonical_segments(terms) -> list[tuple[int, int, str, int, int]]:
    """A term list as canonical ``(file_lo, file_hi, xorb_hex,
    chunk_start, chunk_end)`` segments: adjacent terms over contiguous
    chunk ranges of one xorb merge, so two revisions that cut the same
    chunk runs into different terms compare equal where their bytes are
    equal. ``terms`` is the manifest wire shape (:func:`terms_of`)."""
    segs: list[tuple[int, int, str, int, int]] = []
    off = 0
    for hh, s, e, n in terms:
        hi = off + int(n)
        if segs:
            p_lo, p_hi, p_hex, p_cs, p_ce = segs[-1]
            if p_hex == hh and p_ce == s and p_hi == off:
                segs[-1] = (p_lo, hi, hh, p_cs, e)
                off = hi
                continue
        segs.append((off, hi, hh, int(s), int(e)))
        off = hi
    return segs


def tensor_fingerprints(terms, header) -> dict[str, str]:
    """Tensor name → BLAKE3 fingerprint of its dtype, shape and the
    canonical segment windows (xorb hash, chunk range, byte window)
    covering its file span. Equal fingerprints across revisions mean
    byte-identical tensor data. A span the terms do not cover gets a
    unique token, so it matches nothing."""
    segs = _canonical_segments(terms)
    starts = [s[0] for s in segs]
    out: dict[str, str] = {}
    for name, info in header.tensors.items():
        lo, hi = info.file_range(header.data_start)
        parts = [name, info.dtype, repr(tuple(info.shape))]
        j = max(0, bisect.bisect_right(starts, lo) - 1)
        covered = lo
        while j < len(segs) and segs[j][0] < hi:
            s_lo, s_hi, hh, cs, ce = segs[j]
            if s_hi > lo:
                if max(lo, s_lo) != covered:
                    break  # a gap: the cover is incomplete
                parts.append(
                    f"{hh}:{cs}:{ce}:{max(lo, s_lo) - s_lo}"
                    f":{min(hi, s_hi) - s_lo}")
                covered = min(hi, s_hi)
            j += 1
        if covered < hi:
            parts.append(f"uncovered:{covered}:{hi}")
        out[name] = hashing.blake3_hash("|".join(parts).encode()).hex()
    return out


def unchanged_tensor_names(base_terms, rec: recon.Reconstruction,
                           header) -> set[str]:
    """Tensors of ``header`` whose bytes are provably identical between
    the base revision (``base_terms``, manifest shape) and ``rec``: the
    set the landing reuses instead of decoding and copying."""
    fa = tensor_fingerprints(base_terms, header)
    fb = tensor_fingerprints(terms_of(rec), header)
    return {n for n, fp in fb.items() if fa.get(n) == fp}


def _chunk_rows(terms, chunk_sizes, ids: dict) -> np.ndarray:
    """A term list as one row per chunk, ``(file_lo, file_hi, xorb id,
    chunk index)``. A term whose xorb's chunk table is unknown, or
    disagrees with the term's length, is one row with id and index -1:
    nothing it covers can be proven unchanged."""
    rows = []
    off = 0
    for hh, s, e, n in terms:
        s, e, n = int(s), int(e), int(n)
        sizes = chunk_sizes(hh)
        if (sizes is None or e > len(sizes)
                or int(sizes[s:e].sum()) != n):
            rows.append(np.array([[off, off + n, -1, -1]], np.int64))
        else:
            ends = off + np.cumsum(sizes[s:e], dtype=np.int64)
            xid = ids.setdefault(hh, len(ids))
            rows.append(np.stack([ends - sizes[s:e], ends,
                                  np.full(e - s, xid, np.int64),
                                  np.arange(s, e, dtype=np.int64)], 1))
        off += n
    return (np.concatenate(rows) if rows
            else np.zeros((0, 4), np.int64))


def aligned_tensor_names(base_terms, rec: recon.Reconstruction, header,
                         chunk_sizes) -> set[str]:
    """Tensors of ``header`` whose every byte lies, in both revisions, at
    the same offset of the same chunk of the same xorb, so their bytes
    are identical by content addressing, however the two revisions' terms
    cut the xorbs. ``chunk_sizes(xorb_hex)`` returns a xorb's chunk sizes
    (from the local cache) or None; a chunk table must agree with every
    term's length before it is used.

    This goes past :func:`tensor_fingerprints`, which compares canonical
    segments from the term lists alone: a push that references the
    chunks on both sides of an edit as two terms of one xorb changes the
    segment of every tensor in that xorb, unchanged ones included."""
    ids: dict[str, int] = {}
    memo: dict[str, object] = {}

    def sizes(hh):
        if hh not in memo:
            memo[hh] = chunk_sizes(hh)
        return memo[hh]

    rows_a = _chunk_rows(base_terms, sizes, ids)
    rows_b = _chunk_rows(terms_of(rec), sizes, ids)

    def same(lo: int, hi: int) -> bool:
        """Bytes ``[lo, hi)`` are the same chunks at the same offsets."""
        picked = []
        for rows in (rows_a, rows_b):
            i = int(np.searchsorted(rows[:, 1], lo, side="right"))
            j = int(np.searchsorted(rows[:, 0], hi, side="left"))
            picked.append(rows[i:j])
        a, b = picked
        return bool(len(a) and a[0, 0] <= lo and a[-1, 1] >= hi
                    and (a[:, 2] >= 0).all() and np.array_equal(a, b))

    # The header must be the same bytes too: then every tensor of A's
    # file sat where B's header puts it.
    if not same(0, header.data_start):
        return set()
    out = set()
    for name, info in header.tensors.items():
        lo, hi = info.file_range(header.data_start)
        if hi > lo and same(lo, hi):
            out.add(name)
    return out


# ── The delta plan ──


def _coverage_map(manifest: dict) -> dict[str, list[tuple[int, int]]]:
    """xorb hex → merged, sorted chunk-range intervals the base revision
    referenced in any of its files."""
    raw: dict[str, list[tuple[int, int]]] = {}
    for f in manifest.get("files", {}).values():
        for hh, s, e, _n in f.get("terms", []):
            raw.setdefault(hh, []).append((int(s), int(e)))
    out: dict[str, list[tuple[int, int]]] = {}
    for hh, ivs in raw.items():
        ivs.sort()
        merged: list[tuple[int, int]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        out[hh] = merged
    return out


def _covered(cov: dict[str, list[tuple[int, int]]], hh: str,
             s: int, e: int) -> bool:
    ivs = cov.get(hh)
    if not ivs:
        return False
    i = bisect.bisect_right(ivs, (s, float("inf"))) - 1
    return i >= 0 and ivs[i][0] <= s and e <= ivs[i][1]


@dataclass
class DeltaPlan:
    """Chunk-level diff of a pull against its base manifest.

    ``changed_*`` depends only on the two revisions' metadata, so hosts
    with differently warm caches agree on it (the cooperative plan shards
    ``changed_units``). ``stale_*`` is this host's correction: unchanged
    units its cache no longer holds, refetched through the waterfall.
    ``reused_local_keys`` are unit keys both unchanged and present in the
    cache at plan time: the warm fetch skips them outright."""

    base_revision: str
    total_bytes: int = 0          # unpacked bytes of B
    changed_bytes: int = 0        # content-changed unpacked bytes
    total_chunks: int = 0
    changed_chunks: int = 0
    stale_units: int = 0
    stale_bytes: int = 0          # wire bytes of evicted units
    per_file: dict[str, dict] = field(default_factory=dict)
    changed_keys: frozenset = frozenset()
    changed_units: list = field(default_factory=list)
    reused_local_keys: frozenset = frozenset()

    @property
    def reused_bytes(self) -> int:
        return self.total_bytes - self.changed_bytes

    @property
    def delta_bytes_ratio(self) -> float:
        """The content-changed fraction of the checkpoint."""
        return (self.changed_bytes / self.total_bytes
                if self.total_bytes else 0.0)

    def summary(self) -> dict:
        out = {
            "base_revision": self.base_revision,
            "total_bytes": self.total_bytes,
            "changed_bytes": self.changed_bytes,
            "reused_bytes": self.reused_bytes,
            "delta_bytes_ratio": round(self.delta_bytes_ratio, 4),
            "chunks": {"total": self.total_chunks,
                       "changed": self.changed_chunks},
            "changed_units": len(self.changed_units),
            "files": self.per_file,
        }
        if self.stale_units:
            out["stale_units"] = self.stale_units
            out["stale_bytes"] = self.stale_bytes
        return out


def build_plan(base_manifest: dict, files_terms, units=None,
               cache=None) -> DeltaPlan:
    """Diff revision B against the base manifest.

    ``files_terms`` is ``[(path, terms)]`` in the manifest wire shape;
    ``units`` B's deduplicated ``[(hash_hex, FetchInfo)]`` fetch units
    (``parallel.plan.collect_units``), which feed ``changed_units`` and,
    with ``cache``, the stale-unit accounting. Books the
    ``zest_delta_bytes_total`` counters."""
    with telemetry.span("delta.plan",
                        base=base_manifest.get("revision", "")):
        plan = _build_plan(base_manifest, files_terms, units, cache)
    _M_DELTA_BYTES.inc(plan.reused_bytes, kind="reused")
    _M_DELTA_BYTES.inc(plan.changed_bytes + plan.stale_bytes,
                       kind="fetched")
    return plan


def _build_plan(base_manifest, files_terms, units, cache) -> DeltaPlan:
    cov = _coverage_map(base_manifest)
    plan = DeltaPlan(base_revision=base_manifest.get("revision", ""))
    for path, terms in files_terms:
        f_bytes = f_changed = f_chunks = f_chunks_changed = 0
        for hh, s, e, n in terms:
            n, nchunks = int(n), int(e) - int(s)
            f_bytes += n
            f_chunks += nchunks
            if not _covered(cov, hh, int(s), int(e)):
                f_changed += n
                f_chunks_changed += nchunks
        plan.total_bytes += f_bytes
        plan.changed_bytes += f_changed
        plan.total_chunks += f_chunks
        plan.changed_chunks += f_chunks_changed
        plan.per_file[path] = {
            "bytes": f_bytes,
            "bytes_changed": f_changed,
            "chunks": f_chunks,
            "chunks_changed": f_chunks_changed,
            "ratio": round(f_changed / f_bytes, 4) if f_bytes else 0.0,
        }
    if units is not None:
        changed = [(hh, fi) for hh, fi in units
                   if not _covered(cov, hh, fi.range.start, fi.range.end)]
        changed.sort(key=lambda u: (u[0], u[1].range.start))
        plan.changed_units = changed
        plan.changed_keys = frozenset(
            (hh, fi.range.start) for hh, fi in changed)
        if cache is not None:
            present = set()
            for hh, fi in units:
                key = (hh, fi.range.start)
                if key in plan.changed_keys:
                    continue
                if cache.locate_with_range(hh, fi.range.start) is None:
                    plan.stale_units += 1
                    plan.stale_bytes += (fi.url_range_end
                                         - fi.url_range_start)
                else:
                    present.add(key)
            plan.reused_local_keys = frozenset(present)
    return plan


# ── ``diff``: the dry run ──


def _resolve_spec_sha(cfg, hub, repo_id: str, rev: str) -> str:
    """Revision spec → commit sha, offline first: a local manifest or
    refs entry answers without the hub."""
    if load_manifest(cfg, repo_id, rev) is not None:
        return rev
    ref = storage.read_ref(cfg, repo_id, rev)
    if ref:
        return ref
    return hub.resolve_revision(repo_id, rev)


def _revision_terms(cfg, hub, repo_id: str, sha: str):
    """``(files_terms, units, manifest)`` of one revision: the local
    manifest when present (no network), else reconstructions from the
    hub (metadata only, never payloads)."""
    man = load_manifest(cfg, repo_id, sha)
    if man is not None:
        return ([(p, f["terms"]) for p, f in sorted(man["files"].items())],
                None, man)
    from zest_tpu_torch.parallel.plan import collect_units
    from zest_tpu_torch.transfer.bridge import XetBridge

    bridge = XetBridge(cfg)
    try:
        bridge.authenticate(repo_id, sha, hub=hub)
        files_terms, recs = [], []
        for entry in hub.list_files(repo_id, sha):
            if not entry.is_xet:
                continue
            rec = bridge.get_reconstruction(entry.xet_hash)
            files_terms.append((entry.path, terms_of(rec)))
            recs.append(rec)
    finally:
        bridge.close()
    units = [(hh, fi) for (hh, _s), fi in collect_units(recs)]
    man = {"format": MANIFEST_FORMAT, "repo": repo_id, "revision": sha,
           "files": {p: {"terms": t} for p, t in files_terms}}
    return files_terms, units, man


def diff_revisions(cfg, repo_a: str, rev_a: str, repo_b: str,
                   rev_b: str) -> dict:
    """The DeltaPlan of ``repo_b@rev_b`` over ``repo_a@rev_a`` against
    the local cache, without fetching a payload byte."""
    from zest_tpu_torch.cas.hub import HubClient

    hub = HubClient(cfg)
    sha_a = _resolve_spec_sha(cfg, hub, repo_a, rev_a)
    sha_b = _resolve_spec_sha(cfg, hub, repo_b, rev_b)
    _ft_a, _units_a, man_a = _revision_terms(cfg, hub, repo_a, sha_a)
    ft_b, units_b, _man_b = _revision_terms(cfg, hub, repo_b, sha_b)
    plan = build_plan(man_a, ft_b, units=units_b,
                      cache=storage.XorbCache(cfg))
    out = plan.summary()
    out.update({"base": f"{repo_a}@{sha_a}", "target": f"{repo_b}@{sha_b}"})
    return out


def format_diff(out: dict) -> str:
    """The human table ``diff`` prints."""
    lines = [f"delta {out['base']} -> {out['target']}"]
    width = max([len(p) for p in out["files"]] + [4])
    for path, f in sorted(out["files"].items()):
        lines.append(
            f"  {path:<{width}}  chunks {f['chunks_changed']:>6}/"
            f"{f['chunks']:<6}  bytes {f['bytes_changed']:>12}/"
            f"{f['bytes']:<12}  {f['ratio']:>7.2%}")
    chunks = out["chunks"]
    total_line = (
        f"total: {out['changed_bytes']} of {out['total_bytes']} bytes "
        f"changed ({out['delta_bytes_ratio']:.2%}); "
        f"{chunks['changed']}/{chunks['total']} chunks")
    if out["changed_units"] or not out["changed_bytes"]:
        # Unit counts exist only where reconstructions were resolved
        # (a manifest-only diff classifies terms, not units).
        total_line += (f"; {out['changed_units']} fetch unit(s) "
                       "would hit the network")
    lines.append(total_line)
    if out.get("stale_units"):
        lines.append(
            f"stale: {out['stale_units']} unchanged unit(s) "
            f"(~{out['stale_bytes']} wire bytes) evicted locally — "
            "a delta pull would re-fetch them too")
    return "\n".join(lines)
