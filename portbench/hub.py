"""The loopback Hub + CAS + CDN that every cell pulls from.

A frozen copy of ``zest_tpu_torch/bench_hub.py``'s ``FixtureRepo`` and
``FixtureHub`` (revision and file listing, the read token,
``paths-info``, reconstructions with ``Range`` windows, ranged xorb
bodies, ``/resolve/`` files), kept here so that the yardstick does not
move when the program does. Content addressing stays with the port's own
publisher (``cas/publish.py``), which is what a trainer's push runs.

Differences from the original: no Mixtral fixture and no request log;
the CDN's pacing bucket is this file's own; the hub counts the xorb body
bytes it sends (``xorb_bytes_sent``), so a cell can tell whether a step
went to the network.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas import reconstruction as recon
from zest_tpu_torch.cas.publish import XET_SUFFIXES, Publisher


@dataclass
class _XorbFixture:
    hash_hex: str
    blob: bytes               # the frame stream
    frame_offsets: list[int]  # num_chunks + 1 entries
    full: bytes = b""         # frames + XETBLOB footer (what S3 holds)


@dataclass
class _FileFixture:
    path: str
    data: bytes
    xet_hash: str | None = None
    terms: list = field(default_factory=list)


class FixtureRepo:
    """A content-addressed repository. ``chunks_per_xorb`` (0: one xorb
    per file) splits files over several xorbs. :meth:`add_revision` adds
    a revision whose files chunk-dedup against every xorb the repo holds:
    unchanged chunks are referenced, new ones go into new xorbs."""

    def __init__(self, repo_id: str, files: dict[str, bytes],
                 commit_sha: str = "f1x7ure5ha" + "0" * 30,
                 chunks_per_xorb: int = 0):
        self.repo_id = repo_id
        self.commit_sha = commit_sha
        self.chunks_per_xorb = chunks_per_xorb
        self.files: dict[str, _FileFixture] = {}
        self.xorbs: dict[str, _XorbFixture] = {}
        self.reconstructions: dict[str, recon.Reconstruction] = {}
        self._publisher = Publisher(chunks_per_xorb=chunks_per_xorb)
        for path, data in files.items():
            if path.endswith(XET_SUFFIXES):
                # The first revision packs every chunk into its own xorbs;
                # only later revisions reference across.
                self._add_xet_file(path, data, self.files, dedup=False)
            else:
                self.files[path] = _FileFixture(path, data)
        # "main" (and any unknown ref) resolves to the latest revision.
        self.revisions: dict[str, dict[str, _FileFixture]] = {
            commit_sha: self.files}
        self._rev_order: list[str] = [commit_sha]

    @property
    def latest_sha(self) -> str:
        return self._rev_order[-1]

    def files_for(self, revision: str | None) -> dict[str, _FileFixture]:
        if revision in self.revisions:
            return self.revisions[revision]
        return self.revisions[self.latest_sha]

    def sha_for(self, revision: str | None) -> str:
        return revision if revision in self.revisions else self.latest_sha

    def xorbs_of(self, revision: str) -> set[str]:
        """Every xorb a revision's files reference."""
        return {t.hash_hex for f in self.files_for(revision).values()
                for t in f.terms}

    def add_revision(self, files: dict[str, bytes],
                     commit_sha: str | None = None) -> str:
        """Commit a revision chunk-deduped against the repo's xorbs and
        return its sha; "main" resolves to it from now on."""
        if commit_sha is None:
            commit_sha = hashing.blake3_hash(
                (self.latest_sha + str(len(self._rev_order))).encode()
            ).hex()[:40]
        fileset: dict[str, _FileFixture] = {}
        for path, data in files.items():
            if path.endswith(XET_SUFFIXES):
                self._add_xet_file(path, data, fileset, dedup=True)
            else:
                fileset[path] = _FileFixture(path, data)
        self.revisions[commit_sha] = fileset
        self._rev_order.append(commit_sha)
        self.files = fileset
        return commit_sha

    def _add_xet_file(self, path: str, data: bytes, fileset: dict,
                      dedup: bool) -> None:
        pf = self._publisher.publish_file(
            path, data, dedup=dedup, chunks_per_xorb=self.chunks_per_xorb)
        for px in self._publisher.drain_new_xorbs():
            self.xorbs[px.hash_hex] = _XorbFixture(
                px.hash_hex, px.blob, px.frame_offsets, px.full)
        fileset[path] = _FileFixture(path, data, pf.xet_hash, pf.terms)
        self.reconstructions[pf.xet_hash] = pf.reconstruction


class _Bucket:
    """A token bucket of ``rate`` bytes/s with one second of burst."""

    def __init__(self, rate: int):
        self.rate = float(rate)
        self.tokens = float(rate)
        self.t = time.monotonic()
        self.lock = threading.Lock()

    def acquire(self, n: int) -> None:
        with self.lock:
            now = time.monotonic()
            self.tokens = min(self.rate, self.tokens
                              + (now - self.t) * self.rate) - n
            self.t = now
            wait = -self.tokens / self.rate if self.tokens < 0 else 0.0
        if wait:
            time.sleep(wait)


class FixtureHub:
    """Threaded loopback server for FixtureRepos; a context manager."""

    def __init__(self, *repos: FixtureRepo, throttle_bps: int | None = None):
        self.repos = {r.repo_id: r for r in repos}
        self.xorb_bytes_sent = 0
        self._count_lock = threading.Lock()
        self.throttle = _Bucket(throttle_bps) if throttle_bps else None
        hub = self

        class Handler(BaseHTTPRequestHandler):
            # Keep-alive, as a CDN: HTTP/1.0 would open a connection per
            # ranged fetch. The socket timeout also fires on a stalled
            # send, so it is long enough for a large shaped body.
            protocol_version = "HTTP/1.1"
            timeout = 120

            def log_message(self, *args):
                pass

            def _send(self, code: int, body: bytes,
                      content_type: str = "application/octet-stream"):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, doc, code: int = 200):
                self._send(code, json.dumps(doc).encode(), "application/json")

            def do_GET(self):
                hub._handle_get(self)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                hub._handle_post(self, body)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="portbench-hub", daemon=True)

    def __enter__(self) -> "FixtureHub":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)

    @property
    def url(self) -> str:
        host, port = self._server.server_address
        return f"http://{host}:{port}"

    def _repo_for(self, handler, parts):
        repo = self.repos.get("/".join(parts[:2]))
        if repo is None:
            handler._send_json({"error": "RepoNotFound"}, 404)
        return repo

    def _handle_get(self, handler) -> None:
        path = handler.path
        if path.startswith("/api/models/"):
            rest = path[len("/api/models/"):].split("/")
            repo = self._repo_for(handler, rest)
            if repo is None:
                return
            action = rest[2] if len(rest) > 2 else ""
            if action == "revision":
                rev = rest[3] if len(rest) > 3 else None
                handler._send_json({
                    "sha": repo.sha_for(rev),
                    "siblings": [{"rfilename": p}
                                 for p in sorted(repo.files_for(rev))],
                })
            elif action == "xet-read-token":
                handler._send_json({"casUrl": self.url,
                                    "accessToken": "fixture-access-token",
                                    "exp": 4102444800})
            else:
                handler._send_json({"error": "unknown api"}, 404)
            return
        if path.startswith("/v1/reconstructions/"):
            if handler.headers.get("Authorization") \
                    != "Bearer fixture-access-token":
                handler._send_json({"error": "unauthorized"}, 401)
                return
            file_hex = path.rsplit("/", 1)[-1]
            for repo in self.repos.values():
                rec = repo.reconstructions.get(file_hex)
                if rec is not None:
                    doc = self._reconstruction_doc(
                        rec, handler.headers.get("Range"))
                    if doc is None:  # the window starts past EOF
                        handler._send_json({"error": "range"}, 416)
                    else:
                        handler._send_json(doc)
                    return
            handler._send_json({"error": "not found"}, 404)
            return
        if path.startswith("/xorbs/"):
            xh_hex = path.rsplit("/", 1)[-1]
            for repo in self.repos.values():
                xf = repo.xorbs.get(xh_hex)
                if xf is not None:
                    # The whole XETBLOB artifact; fetch ranges address
                    # only its frames.
                    self._send_ranged(handler, xf.full or xf.blob,
                                      xorb=True)
                    return
            handler._send(404, b"not found")
            return
        # /{org}/{name}/resolve/{rev}/{filename...}
        parts = path.lstrip("/").split("/")
        if len(parts) >= 5 and parts[2] == "resolve":
            repo = self._repo_for(handler, parts)
            if repo is None:
                return
            f = repo.files_for(parts[3]).get("/".join(parts[4:]))
            if f is None:
                handler._send(404, b"no such file")
            else:
                self._send_ranged(handler, f.data)
            return
        handler._send(404, b"unknown path")

    def _handle_post(self, handler, body: bytes) -> None:
        path = handler.path
        if path.startswith("/api/models/") and "/paths-info/" in path:
            rest = path[len("/api/models/"):].split("/")
            repo = self._repo_for(handler, rest)
            if repo is None:
                return
            rev = rest[3] if len(rest) > 3 else None
            out = []
            for p in json.loads(body or b"{}").get("paths", []):
                f = repo.files_for(rev).get(p)
                if f is None:
                    continue
                item = {"path": p, "size": len(f.data), "type": "file"}
                if f.xet_hash:
                    item["xetHash"] = f.xet_hash
                out.append(item)
            handler._send_json(out)
            return
        handler._send(404, b"unknown path")

    def _reconstruction_doc(self, rec, range_header):
        """The terms overlapping the ``Range`` window of the file (all of
        them without one) and ``offset_into_first_range``; None for a
        window that starts past EOF (416), which is how a client pages
        through a large file."""
        total = sum(t.unpacked_length for t in rec.terms)
        lo, hi = 0, total
        if range_header:
            start_s, _, end_s = range_header.split("=", 1)[-1].partition("-")
            lo = int(start_s or 0)
            hi = min(int(end_s) + 1 if end_s else total, total)
            if lo >= total and total > 0:
                return None
        doc = recon.to_json(rec)
        if lo > 0 or hi < total:
            terms, off, offset_into_first = [], 0, 0
            for t, tj in zip(rec.terms, doc["terms"]):
                t_lo, t_hi = off, off + t.unpacked_length
                if t_hi > lo and t_lo < hi:
                    if not terms:
                        offset_into_first = lo - t_lo
                    terms.append(tj)
                off = t_hi
            doc["terms"] = terms
            doc["offset_into_first_range"] = offset_into_first
            keep = {t["hash"] for t in terms}
            doc["fetch_info"] = {h: v for h, v in doc["fetch_info"].items()
                                 if h in keep}
        # Fetch URLs are absolute, as presigned links are.
        for entries in doc["fetch_info"].values():
            for fi in entries:
                if fi["url"].startswith("/"):
                    fi["url"] = self.url + fi["url"]
        return doc

    def _send_ranged(self, handler, blob: bytes, xorb: bool = False) -> None:
        """A body with HTTP Range support (``bytes=a-b``, inclusive)."""
        range_header = handler.headers.get("Range")
        piece = memoryview(blob)
        if range_header and range_header.startswith("bytes="):
            start_s, _, end_s = range_header[len("bytes="):].partition("-")
            start = int(start_s) if start_s else 0
            end = int(end_s) if end_s else len(blob) - 1
            if start >= len(blob):
                handler._send(416, b"range not satisfiable")
                return
            # A slice without a copy: the origin shares the host with the
            # client under measurement.
            piece = piece[start:end + 1]
            handler.send_response(206)
            handler.send_header(
                "Content-Range",
                f"bytes {start}-{start + len(piece) - 1}/{len(blob)}")
        else:
            handler.send_response(200)
        handler.send_header("Content-Type", "application/octet-stream")
        handler.send_header("Content-Length", str(len(piece)))
        handler.end_headers()
        if xorb:
            with self._count_lock:
                self.xorb_bytes_sent += len(piece)
        self._write_shaped(handler, piece)

    def _write_shaped(self, handler, piece) -> None:
        """Write a body, paced in 64 KiB quanta by the bucket when the hub
        is throttled."""
        if self.throttle is None:
            handler.wfile.write(piece)
            return
        step = 64 * 1024
        for off in range(0, piece.nbytes, step):
            part = piece[off:off + step]
            self.throttle.acquire(part.nbytes)
            handler.wfile.write(part)
