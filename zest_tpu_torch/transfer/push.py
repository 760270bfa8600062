"""``push`` — the write path: CDC-dedup checkpoint publishing.

The counterpart of ``zest_tpu/transfer/push.py``. A push takes a
checkpoint directory (safetensors + sidecars), encodes it with the
CDC-dedup encoder (:mod:`zest_tpu_torch.cas.publish`) against the cached
base revision's xorb set, and lands the result where a pull would have:

- new xorbs → the local :class:`~zest_tpu_torch.storage.XorbCache`,
- a snapshot + ``refs/main`` → the normal HF cache layout,
- a revision manifest (with ``parent`` lineage) → :mod:`.delta`.

Every minted xorb is re-verified chunk by chunk before its bytes are
written (:func:`_verify_minted`): on ``cuda`` that is the CUDA BLAKE3
kernel, on ``cpu`` its plain PyTorch version.

:class:`PublisherIndex` is the read side: it answers the Hub/CAS API
shapes (revision, paths-info, xet-read-token, reconstructions, xorbs,
resolve) from local manifests, snapshots and the xorb cache, so a normal
pull on a second node, pointed at this publisher
(:mod:`zest_tpu_torch.api.http_api`), reassembles the revision byte for
byte.

The continuous fan-out: a push notifies the publisher
(:func:`notify_daemon`, ``POST /v1/push``), which wakes every ``POST
/v1/watch`` subscriber; :func:`watch_and_swap` is the subscriber, which
delta-pulls each pushed revision and swaps it into its resident tree, and
into the serving pool when the pool holds the old revision, and posts
each swap's push-to-swap latency to the live timeline
(``push.propagation_s``). :func:`preview_push` is ``zest diff
--push-preview``: the dedup outcome of a push, with nothing written.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

from zest_tpu_torch import ops, storage, telemetry
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas import reconstruction as recon
from zest_tpu_torch.cas.publish import Publisher, PublishedXorb, is_xet_path
from zest_tpu_torch.cas.xorb import XorbReader, parse_footer
from zest_tpu_torch.config import DEFAULT_DEVICE, Config, resolve_device
from zest_tpu_torch.transfer import delta

# Bearer token the publisher accepts/issues for its CAS routes: the token
# exists for API-shape parity with the real hub, not as a secret.
PUBLISHER_TOKEN = "zest-publisher-token"

# The timeline series a subscriber posts after every completed swap:
# trainer ``pushed_at`` to swap complete, in seconds.
SERIES_PROPAGATION = "push.propagation_s"


@dataclass
class PushResult:
    """What one publish did (also the ``--json`` CLI payload)."""

    repo_id: str
    revision: str
    parent: str | None
    preview: bool = False
    files: int = 0
    xet_files: int = 0
    total_bytes: int = 0
    xet_bytes: int = 0
    reused_bytes: int = 0
    new_xorbs: int = 0
    new_xorb_bytes: int = 0
    minted_chunks: int = 0
    elapsed_s: float = 0.0
    manifest_written: bool = False
    seeded_base_xorbs: int = 0
    xorb_digests: dict[str, str] = field(default_factory=dict)
    # The publisher's answer to the push notification (None: not sent,
    # or no publisher reachable).
    notified: dict | None = None

    @property
    def dedup_ratio(self) -> float:
        """Fraction of xet bytes that did NOT become new xorb payload."""
        if not self.xet_bytes:
            return 1.0
        return max(0.0, 1.0 - (self.new_xorb_bytes / self.xet_bytes))

    def summary(self) -> dict:
        return {
            "repo": self.repo_id,
            "revision": self.revision,
            "parent": self.parent,
            "preview": self.preview,
            "files": self.files,
            "xet_files": self.xet_files,
            "total_bytes": self.total_bytes,
            "xet_bytes": self.xet_bytes,
            "reused_bytes": self.reused_bytes,
            "new_xorbs": self.new_xorbs,
            "new_xorb_bytes": self.new_xorb_bytes,
            "minted_chunks": self.minted_chunks,
            "dedup_ratio": round(self.dedup_ratio, 4),
            "manifest_written": self.manifest_written,
            "seeded_base_xorbs": self.seeded_base_xorbs,
            "elapsed_s": round(self.elapsed_s, 3),
        }


def read_checkpoint_dir(checkpoint_dir: str | Path) -> dict[str, bytes]:
    """A checkpoint directory as {relative posix path: bytes}, sorted —
    deterministic walk order keeps the revision sha content-defined."""
    root = Path(checkpoint_dir)
    if not root.is_dir():
        raise ValueError(f"not a checkpoint directory: {root}")
    files: dict[str, bytes] = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            files[p.relative_to(root).as_posix()] = p.read_bytes()
    if not files:
        raise ValueError(f"checkpoint directory is empty: {root}")
    return files


def _resolve_base_sha(cfg: Config, repo_id: str,
                      base_revision: str | None) -> str | None:
    """The revision a push dedups against: explicit sha/ref, else
    whatever ``refs/main`` points at."""
    if base_revision:
        if delta.manifest_path(cfg, repo_id, base_revision).exists():
            return base_revision
        return storage.read_ref(cfg, repo_id, base_revision) or base_revision
    return storage.read_ref(cfg, repo_id, "main")


def _seed_from_base(pub: Publisher, base_man: dict,
                    cache: storage.XorbCache) -> int:
    """Feed the base revision's locally cached FULL xorbs into the dedup
    index; a missing or unreadable xorb only costs dedup."""
    seeded = 0
    seen: set[str] = set()
    for rec in (base_man.get("files") or {}).values():
        for term in rec.get("terms") or []:
            xh_hex = term[0]
            if xh_hex in seen:
                continue
            seen.add(xh_hex)
            blob = cache.get(xh_hex)
            if blob is None:
                continue
            try:
                reader = XorbReader(blob)
                pub.seed_xorb(xh_hex, reader.frame_offsets(),
                              reader.chunk_hashes())
            except ValueError:
                continue
            seeded += 1
    return seeded


def _revision_identities(cfg: Config, repo_id: str, sha: str,
                         man: dict | None) -> dict[str, str] | None:
    """Per-file identity map of a published revision (xet hash from its
    manifest, BLAKE3 for sidecars), or None when local state is too
    incomplete to compare. Feeds the no-op-push check."""
    try:
        snap = cfg.model_snapshot_dir(repo_id, sha)
    except ValueError:
        return None
    if not snap.is_dir():
        return None
    out: dict[str, str] = {}
    for p in sorted(snap.rglob("*")):
        if not p.is_file():
            continue
        rel = p.relative_to(snap).as_posix()
        if is_xet_path(rel):
            rec = ((man or {}).get("files") or {}).get(rel)
            if rec is None:
                return None
            out[rel] = rec["xet_hash"]
        else:
            out[rel] = hashing.blake3_hash(p.read_bytes()).hex()
    return out


def _content_sha(parent: str | None, identities: dict[str, str]) -> str:
    """Content-defined revision id: BLAKE3 over (parent, per-file
    identity), 40 hex chars like a git sha."""
    doc = json.dumps({"parent": parent or "", "files": identities},
                     sort_keys=True, separators=(",", ":"))
    return hashing.blake3_hash(doc.encode()).hex()[:40]


def _verify_minted(pub_xorbs: list[PublishedXorb],
                   device=DEFAULT_DEVICE) -> dict[str, str]:
    """Provenance gate: decode every minted xorb's chunks, re-hash them
    through ``ops.unit_verify_hasher`` (the CUDA kernel on ``cuda``) and
    compare with the chunk hashes the encoder packed into its footer.
    Returns {xorb_hex: blob BLAKE3 hex}; raises on any mismatch — corrupt
    bytes must never enter the cache."""
    hasher = ops.unit_verify_hasher(hashing.CHUNK_KEY, device)
    digests: dict[str, str] = {}
    for px in pub_xorbs:
        reader = XorbReader(px.blob)
        sizes = [int(s) for s in reader.chunk_sizes]
        decoded = bytearray(sum(sizes))
        if sizes:
            reader.extract_range_into(0, len(sizes), decoded)
        view, chunks, off = memoryview(decoded), [], 0
        for size in sizes:
            chunks.append(view[off:off + size])
            off += size
        got = hasher.hash_batch(chunks)
        want = parse_footer(px.full)[2]
        if got != want:
            raise RuntimeError(
                f"minted xorb {px.hash_hex[:12]} failed BLAKE3 "
                "verification — refusing to publish corrupt bytes")
        digests[px.hash_hex] = hashing.blake3_hash(px.blob).hex()
    return digests


def notify_daemon(cfg: Config, payload: dict, url: str | None = None,
                  timeout_s: float = 5.0) -> dict | None:
    """POST the push notification to a publisher's ``/v1/push``: ``url``
    is its base URL (default ``http://127.0.0.1:{cfg.http_port}``; a
    publisher on an ephemeral port must be named). Best effort: no
    publisher returns None; the push itself has already landed."""
    base = url or f"http://127.0.0.1:{cfg.http_port}"
    req = urllib.request.Request(
        base.rstrip("/") + "/v1/push", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode() or "{}")
    except (urllib.error.URLError, OSError, ValueError):
        return None


def push_checkpoint(cfg: Config, repo_id: str,
                    checkpoint_dir: str | Path | None = None,
                    files: dict[str, bytes] | None = None,
                    base_revision: str | None = None,
                    device=DEFAULT_DEVICE, notify: bool = True,
                    notify_url: str | None = None,
                    log=print) -> PushResult:
    """Publish a checkpoint as a new revision of ``repo_id``.

    ``files`` may be passed directly; otherwise ``checkpoint_dir`` is
    read. ``device`` (``cuda`` by default, or ``cpu``) is where the minted
    chunks are re-verified. With ``notify`` the publisher at
    ``notify_url`` (see :func:`notify_daemon`) is told, and wakes its
    watchers; a no-op push notifies no one. The push runs in a ``push``
    span."""
    with telemetry.span("push", repo=repo_id):
        return _push_checkpoint(cfg, repo_id, checkpoint_dir, files,
                                base_revision, device, notify, notify_url,
                                log)


def preview_push(cfg: Config, repo_id: str, checkpoint_dir: str | Path,
                 base_revision: str | None = None) -> dict:
    """``zest diff --push-preview``: what pushing ``checkpoint_dir``
    would mint and dedup against ``base_revision``, with nothing written,
    verified or notified (so no device is touched)."""
    with telemetry.span("push", repo=repo_id):
        return _push_checkpoint(cfg, repo_id, checkpoint_dir, None,
                                base_revision, None, False, None,
                                lambda *a, **k: None,
                                preview=True).summary()


def _push_checkpoint(cfg: Config, repo_id: str, checkpoint_dir, files,
                     base_revision, device, notify: bool, notify_url,
                     log, preview: bool = False) -> PushResult:
    t0 = time.monotonic()
    cfg.model_cache_dir(repo_id)  # repo-id validation (raises ValueError)
    if not preview:
        device = resolve_device(device)  # fail before the encode
    if files is None:
        if checkpoint_dir is None:
            raise ValueError("push needs a checkpoint_dir or files dict")
        files = read_checkpoint_dir(checkpoint_dir)

    cache = storage.XorbCache(cfg)
    base_sha = _resolve_base_sha(cfg, repo_id, base_revision)
    base_man = (delta.load_manifest(cfg, repo_id, base_sha)
                if base_sha else None)
    if base_sha and base_man is None and base_revision:
        log(f"push: no manifest for base {base_sha[:12]} — publishing "
            "without dedup evidence")

    pub = Publisher(chunks_per_xorb=cfg.push_chunks_per_xorb)
    seeded = _seed_from_base(pub, base_man, cache) if base_man else 0

    published: dict[str, object] = {}
    identities: dict[str, str] = {}
    result = PushResult(repo_id=repo_id, revision="",
                        parent=base_sha if base_man else None,
                        preview=preview, files=len(files),
                        seeded_base_xorbs=seeded)
    for path, data in files.items():
        result.total_bytes += len(data)
        if is_xet_path(path):
            pf = pub.publish_file(path, data, dedup=True)
            published[path] = pf
            identities[path] = pf.xet_hash
            result.xet_files += 1
            result.xet_bytes += pf.size
            result.reused_bytes += pf.reused_bytes
        else:
            identities[path] = hashing.blake3_hash(data).hex()

    minted = pub.drain_new_xorbs()
    result.new_xorbs = len(minted)
    result.new_xorb_bytes = sum(len(px.blob) for px in minted)
    result.minted_chunks = sum(len(px.frame_offsets) - 1 for px in minted)
    result.revision = _content_sha(result.parent, identities)

    # No-op push: bytes identical to the resolved base ARE the base.
    if result.parent and identities == _revision_identities(
            cfg, repo_id, result.parent, base_man):
        result.revision = result.parent
        result.parent = (base_man or {}).get("parent")
        result.elapsed_s = time.monotonic() - t0
        return result
    if preview:
        result.elapsed_s = time.monotonic() - t0
        return result

    # Provenance, then durable writes (xorbs → snapshot → manifest →
    # refs): a crash mid-push leaves extra cache bytes, never a ref
    # pointing at an unserveable revision.
    result.xorb_digests = _verify_minted(minted, device)
    for px in minted:
        if not cache.has(px.hash_hex):
            cache.put(px.hash_hex, px.blob)

    snap = cfg.model_snapshot_dir(repo_id, result.revision)
    snap.mkdir(parents=True, exist_ok=True)
    for path, data in files.items():
        storage.atomic_write(snap / path, data)

    entries = [SimpleNamespace(is_xet=True, path=p, size=pf.size,
                               xet_hash=pf.xet_hash)
               for p, pf in published.items()]
    result.manifest_written = delta.save_manifest(
        cfg, repo_id, result.revision, entries,
        lambda e: published[e.path].reconstruction, parent=result.parent)
    storage.write_ref(cfg, repo_id, "main", result.revision)
    if notify:
        result.notified = notify_daemon(cfg, {
            "repo": repo_id,
            "revision": result.revision,
            "parent": result.parent,
            "pushed_at": time.time(),
            "dedup_ratio": round(result.dedup_ratio, 4),
            "new_xorb_bytes": result.new_xorb_bytes,
            "xorbs": [[px.hash_hex, len(px.blob)] for px in minted],
        }, url=notify_url)
    result.elapsed_s = time.monotonic() - t0
    return result


# ── The watch client: the subscriber side of the fan-out ──


def watch_events(base_url: str, repos: list[str] | None = None,
                 timeout_s: float | None = None):
    """Generator over a publisher's ``POST /v1/watch`` SSE stream: the
    ``hello`` event, then ``revision`` events (``ping`` keepalives are
    swallowed). ``timeout_s`` bounds each read; its expiry ends the
    stream, as the publisher closing it does."""
    req = urllib.request.Request(
        base_url.rstrip("/") + "/v1/watch",
        data=json.dumps({"repos": repos or []}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    resp = urllib.request.urlopen(req, timeout=timeout_s)
    try:
        for raw in resp:
            line = raw.decode("utf-8", "replace").strip()
            if not line.startswith("data: "):
                continue
            try:
                ev = json.loads(line[len("data: "):])
            except ValueError:
                continue
            if ev.get("event") == "ping":
                continue
            yield ev
    except TimeoutError:
        return
    finally:
        resp.close()


def watch_and_swap(cfg: Config, repo_id: str,
                   publisher_url: str | None = None,
                   device=DEFAULT_DEVICE,
                   base_params: dict | None = None,
                   base_revision: str | None = None,
                   max_events: int = 1,
                   timeout_s: float | None = 120.0,
                   on_swap=None, log=print) -> list[dict]:
    """The subscriber: delta-pull and hot-swap every pushed revision.

    Subscribes to the publisher's ``/v1/watch`` (``publisher_url``,
    default ``http://127.0.0.1:{cfg.http_port}``), and pulls from it:
    each ``revision`` event of ``repo_id`` runs ``pull_model`` of the new
    sha on ``device`` with the resident tree as its base
    (``base_params`` of ``base_revision``, handed over and consumed), and
    the pulled tree becomes the base of the next event. Stops after
    ``max_events`` swaps (0: when the stream ends). ``on_swap(record,
    result)`` sees each event's ``PullResult`` before the next event
    consumes its tree. Returns one record per event: ``revision``,
    ``parent``, ``dedup_ratio``, ``time_to_swap_s`` (the pull's
    ``elapsed_s`` when it did not swap) and, when the push was stamped,
    ``propagation_s`` (push → swap complete).

    When the process's serving pool holds the old revision's tree, the
    new snapshot is swapped in there too (``HbmPool.swap_to``: the new
    tree lands pinned, then the old one is evicted) and the record gains
    ``pool_swap_s``. A swap that fails on the checkpoint or the disk
    (a ``ValueError`` or ``OSError``, also as a landing's cause) is
    recorded as ``pool_swap_error`` (its type name) and the watch goes
    on; any other error, a device error among them, raises. (The JAX
    package records every exception there.)"""
    from zest_tpu_torch.models import hbm_pool
    from zest_tpu_torch.transfer.pull import pull_model

    device = resolve_device(device)  # fail before subscribing
    if publisher_url is None:
        publisher_url = f"http://127.0.0.1:{cfg.http_port}"
    publisher_url = publisher_url.rstrip("/")
    if cfg.endpoint.rstrip("/") != publisher_url:
        cfg = dataclasses.replace(cfg, endpoint=publisher_url)
    telemetry.timeline.ensure_started()
    records: list[dict] = []
    for ev in watch_events(publisher_url, repos=[repo_id],
                           timeout_s=timeout_s):
        if ev.get("event") != "revision" or ev.get("repo") != repo_id:
            continue
        sha = ev.get("revision")
        if not sha or sha == base_revision:
            continue
        log(f"watch: {repo_id} bumped to {sha[:12]} "
            f"(parent {str(ev.get('parent'))[:12]}) — delta pulling",
            file=sys.stderr)
        old_snap = (cfg.model_snapshot_dir(repo_id, base_revision)
                    if base_revision else None)
        result = pull_model(
            cfg, repo_id, revision=sha, device=device,
            base_params=base_params,
            base_revision=base_revision if base_params else None, log=log)
        record = {
            "revision": sha,
            "parent": ev.get("parent"),
            "dedup_ratio": ev.get("dedup_ratio"),
            "time_to_swap_s": result.stats.get(
                "time_to_swap_s", result.stats.get("elapsed_s")),
        }
        pool = hbm_pool.pool(cfg, device)
        if pool is not None and old_snap is not None \
                and pool.digest(old_snap) is not None:
            try:
                entry, swap_s = pool.swap_to(
                    old_snap, cfg.model_snapshot_dir(repo_id, sha),
                    repo=repo_id)
                pool.release(entry)
                record["pool_swap_s"] = round(swap_s, 4)
            except (OSError, ValueError, hbm_pool.PoolLandError) as exc:
                if isinstance(exc, hbm_pool.PoolLandError) and not \
                        isinstance(exc.__cause__, (OSError, ValueError)):
                    raise
                record["pool_swap_error"] = type(
                    exc.__cause__ if isinstance(
                        exc, hbm_pool.PoolLandError) else exc).__name__
        pushed_at = ev.get("pushed_at")
        if isinstance(pushed_at, (int, float)):
            propagation = max(0.0, time.time() - pushed_at)
            record["propagation_s"] = round(propagation, 4)
            telemetry.timeline.post(SERIES_PROPAGATION, propagation)
        records.append(record)
        if on_swap is not None:
            on_swap(record, result)
        base_params = result.params if result.params else base_params
        base_revision = sha
        if max_events and len(records) >= max_events:
            break
    return records


# ── The publisher's read side: hub-shaped serving index ──


class PublisherIndex:
    """Answers the Hub/CAS API shapes from local state (manifests,
    snapshots, xorb cache) so a second node's unmodified pull can use
    this publisher as its endpoint."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.cache = storage.XorbCache(cfg)
        self._offsets: dict[str, list[int]] = {}

    # ── revision / file metadata ──

    def resolve_sha(self, repo_id: str, rev: str | None) -> str | None:
        rev = rev or "main"
        if delta.manifest_path(self.cfg, repo_id, rev).exists() \
                or self._snapshot_dir(repo_id, rev) is not None:
            return rev
        return storage.read_ref(self.cfg, repo_id, rev)

    def _snapshot_dir(self, repo_id: str, sha: str) -> Path | None:
        try:
            snap = self.cfg.model_snapshot_dir(repo_id, sha)
        except ValueError:
            return None
        return snap if snap.is_dir() else None

    def files_for(self, repo_id: str, sha: str) -> dict[str, dict] | None:
        """{path: {size, xetHash?}} for a revision, or None when unknown."""
        man = delta.load_manifest(self.cfg, repo_id, sha)
        snap = self._snapshot_dir(repo_id, sha)
        if man is None and snap is None:
            return None
        out: dict[str, dict] = {}
        if snap is not None:
            for p in sorted(snap.rglob("*")):
                if p.is_file():
                    rel = p.relative_to(snap).as_posix()
                    out[rel] = {"size": p.stat().st_size}
        for path, rec in ((man or {}).get("files") or {}).items():
            entry = out.setdefault(path, {"size": int(rec["size"])})
            entry["size"] = int(rec["size"])
            entry["xetHash"] = rec["xet_hash"]
        return out

    def revision_doc(self, repo_id: str, rev: str | None) -> dict | None:
        sha = self.resolve_sha(repo_id, rev)
        files = self.files_for(repo_id, sha) if sha else None
        if files is None:
            return None
        return {"sha": sha,
                "siblings": [{"rfilename": p} for p in sorted(files)]}

    def paths_info(self, repo_id: str, rev: str | None,
                   paths: list[str]) -> list[dict] | None:
        sha = self.resolve_sha(repo_id, rev)
        files = self.files_for(repo_id, sha) if sha else None
        if files is None:
            return None
        out = []
        for p in paths:
            meta = files.get(p)
            if meta is None:
                continue
            item = {"path": p, "size": meta["size"], "type": "file"}
            if meta.get("xetHash"):
                item["xetHash"] = meta["xetHash"]
            out.append(item)
        return out

    def resolve_file(self, repo_id: str, rev: str,
                     filename: str) -> bytes | None:
        sha = self.resolve_sha(repo_id, rev)
        snap = self._snapshot_dir(repo_id, sha) if sha else None
        if snap is None:
            return None
        try:
            target = (snap / filename).resolve()
            target.relative_to(snap.resolve())  # no traversal
            return target.read_bytes()
        except (OSError, ValueError):
            return None

    # ── CAS data plane ──

    def xorb_blob(self, xorb_hex: str) -> bytes | None:
        return self.cache.get(xorb_hex)

    def _frame_offsets(self, xorb_hex: str) -> list[int] | None:
        offs = self._offsets.get(xorb_hex)
        if offs is not None:
            return offs
        blob = self.cache.get(xorb_hex)
        if blob is None:
            return None
        try:
            offs = XorbReader(blob).frame_offsets()
        except ValueError:
            return None  # corrupt entry = unserveable
        self._offsets[xorb_hex] = offs
        return offs

    def _find_file_record(self, file_hex: str) -> dict | None:
        """Locate ``file_hex``'s term list in any local manifest."""
        root = delta.manifest_dir(self.cfg)
        try:
            paths = sorted(root.iterdir(),
                           key=lambda p: p.stat().st_mtime, reverse=True)
        except OSError:
            return None
        for p in paths:
            try:
                doc = json.loads(p.read_text())
            except (OSError, ValueError):
                continue
            for rec in (doc.get("files") or {}).values():
                if rec.get("xet_hash") == file_hex:
                    return rec
        return None

    def reconstruction_doc(self, file_hex: str, range_header: str | None,
                           base_url: str):
        """The reconstruction JSON for ``file_hex`` — or the string
        ``"range"`` for a 416 window, or None when unknown/unserveable."""
        rec_doc = self._find_file_record(file_hex)
        if rec_doc is None:
            return None
        terms: list[recon.Term] = []
        fetch_info: dict[str, list[recon.FetchInfo]] = {}
        for t in rec_doc.get("terms") or []:
            xh_hex, start, end, nbytes = t[0], int(t[1]), int(t[2]), int(t[3])
            offs = self._frame_offsets(xh_hex)
            if offs is None or end > len(offs) - 1:
                return None
            terms.append(recon.Term(
                xorb_hash=hashing.hex_to_hash(xh_hex),
                range=recon.ChunkRange(start, end), unpacked_length=nbytes))
            fi = recon.FetchInfo(
                url=f"/xorbs/{xh_hex}",
                url_range_start=offs[start], url_range_end=offs[end],
                range=recon.ChunkRange(start, end))
            entries = fetch_info.setdefault(xh_hex, [])
            if fi not in entries:
                entries.append(fi)
        rec_obj = recon.Reconstruction(
            file_hash=hashing.hex_to_hash(file_hex), terms=terms,
            fetch_info=fetch_info)

        total = rec_obj.total_bytes
        lo, hi = 0, total
        if range_header:
            start_s, _, end_s = range_header.split("=", 1)[-1].partition("-")
            try:
                lo = int(start_s or 0)
                hi = min(int(end_s) + 1 if end_s else total, total)
            except ValueError:
                lo, hi = 0, total
            if lo >= total and total > 0:
                return "range"
        doc = recon.to_json(rec_obj)
        if lo > 0 or hi < total:
            kept, off, offset_into_first = [], 0, 0
            for t, tj in zip(rec_obj.terms, doc["terms"]):
                t_lo, t_hi = off, off + t.unpacked_length
                if t_hi > lo and t_lo < hi:
                    if not kept:
                        offset_into_first = lo - t_lo
                    kept.append(tj)
                off = t_hi
            doc["terms"] = kept
            doc["offset_into_first_range"] = offset_into_first
            keep = {t["hash"] for t in kept}
            doc["fetch_info"] = {h: v for h, v in doc["fetch_info"].items()
                                 if h in keep}
        for entries in doc["fetch_info"].values():
            for fi in entries:
                if fi["url"].startswith("/"):
                    fi["url"] = base_url + fi["url"]
        return doc
