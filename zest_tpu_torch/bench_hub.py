"""The loopback Hub + CAS + CDN that the scale benches pull from.

A bench runs with no network: :class:`FixtureHub` serves one or more
:class:`FixtureRepo` over loopback HTTP in the API shapes the real Hub,
CAS and CDN speak (``cas/hub.py``): revision and file listing, the read
token, ``paths-info``, reconstructions (with ``Range`` windows), ranged
xorb bodies and ``/resolve/`` files. A repo content-addresses its files
with the port's own publisher (``cas/publish.py``: CDC chunks, xorbs,
merkle file hashes), ``chunks_per_xorb`` chunks to a xorb.

``throttle_bps`` paces the CDN's data plane (xorb and file bodies)
through one shared ``shaping.TokenBucket``: one WAN-rate origin for every
client; metadata stays unshaped. ``requests_seen`` and ``xorb_fetches``
(path, Range) record what the hub answered.

:func:`mixtral_checkpoint_files` is the small MoE checkpoint that
``bench_scale.bench_serve_pool`` pages experts from.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas import reconstruction as recon
from zest_tpu_torch.cas.publish import XET_SUFFIXES, Publisher
from zest_tpu_torch.shaping import TokenBucket


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
    terms: list[recon.Term] = field(default_factory=list)


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


class FixtureHub:
    """Threaded loopback server for FixtureRepos; a context manager."""

    def __init__(self, *repos: FixtureRepo, throttle_bps: int | None = None):
        self.repos = {r.repo_id: r for r in repos}
        self.requests_seen: list[str] = []
        # (path, Range) per xorb body served: the duplicate-fetch evidence
        # at unit granularity.
        self.xorb_fetches: list[tuple[str, str]] = []
        self.throttle = TokenBucket(throttle_bps) if throttle_bps else None
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
                hub.requests_seen.append(f"GET {self.path}")
                if self.path.startswith("/xorbs/"):
                    hub.xorb_fetches.append(
                        (self.path, self.headers.get("Range") or ""))
                hub._handle_get(self)

            def do_POST(self):
                hub.requests_seen.append(f"POST {self.path}")
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                hub._handle_post(self, body)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="bench-hub", daemon=True)

    def __enter__(self) -> "FixtureHub":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()

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
                    self._send_ranged(handler, xf.full or xf.blob)
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

    def _send_ranged(self, handler, blob: bytes) -> None:
        """A body with HTTP Range support (``bytes=a-b``, inclusive)."""
        range_header = handler.headers.get("Range")
        if range_header and range_header.startswith("bytes="):
            start_s, _, end_s = range_header[len("bytes="):].partition("-")
            start = int(start_s) if start_s else 0
            end = int(end_s) if end_s else len(blob) - 1
            if start >= len(blob):
                handler._send(416, b"range not satisfiable")
                return
            # A slice without a copy: the origin shares the host with the
            # client under measurement.
            piece = memoryview(blob)[start:end + 1]
            handler.send_response(206)
            handler.send_header("Content-Type", "application/octet-stream")
            handler.send_header(
                "Content-Range",
                f"bytes {start}-{start + len(piece) - 1}/{len(blob)}")
            handler.send_header("Content-Length", str(len(piece)))
            handler.end_headers()
            self._write_shaped(handler, piece)
        elif self.throttle is None:
            handler._send(200, blob)
        else:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/octet-stream")
            handler.send_header("Content-Length", str(len(blob)))
            handler.end_headers()
            self._write_shaped(handler, memoryview(blob))

    def _write_shaped(self, handler, piece) -> None:
        """Write a body, paced in 64 KiB quanta by the shared bucket when
        the hub is throttled."""
        if self.throttle is None:
            handler.wfile.write(piece)
            return
        mv = memoryview(piece)
        step = 64 * 1024
        for off in range(0, mv.nbytes, step):
            part = mv[off:off + step]
            self.throttle.acquire(part.nbytes)
            handler.wfile.write(part)


def safetensors_blob(tensors: dict) -> bytes:
    """A tensor dict as in-memory safetensors bytes."""
    import pathlib
    import tempfile

    from zest_tpu_torch.models.safetensors_io import write_safetensors

    with tempfile.NamedTemporaryFile(suffix=".safetensors") as f:
        write_safetensors(f.name, tensors)
        return pathlib.Path(f.name).read_bytes()


def mixtral_checkpoint_files(hidden_size: int = 64, n_layer: int = 2,
                             vocab_size: int = 256, n_ctx: int = 64,
                             n_experts: int = 8, top_k: int = 2,
                             seed: int = 0) -> dict[str, bytes]:
    """A small valid HF Mixtral checkpoint (config.json and
    model.safetensors, float32 from ``seed``): a small dense core and
    ``n_experts`` SwiGLU experts per layer, which carry most bytes."""
    import numpy as np

    E, L, V, X = hidden_size, n_layer, vocab_size, n_experts
    n_head, n_kv = 4, 2
    head_dim = E // n_head
    inter = 2 * E
    cfg = dict(model_type="mixtral", architectures=["MixtralForCausalLM"],
               vocab_size=V, hidden_size=E, intermediate_size=inter,
               num_hidden_layers=L, num_attention_heads=n_head,
               num_key_value_heads=n_kv, max_position_embeddings=n_ctx,
               num_local_experts=X, num_experts_per_tok=top_k,
               rms_norm_eps=1e-5, rope_theta=10000.0,
               torch_dtype="float32")
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(0, 0.02, shape).astype(np.float32)

    t = {
        "model.embed_tokens.weight": w(V, E),
        "model.norm.weight": np.ones(E, np.float32),
        "lm_head.weight": w(V, E),
    }
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = np.ones(E, np.float32)
        t[p + "post_attention_layernorm.weight"] = np.ones(E, np.float32)
        t[p + "self_attn.q_proj.weight"] = w(n_head * head_dim, E)
        t[p + "self_attn.k_proj.weight"] = w(n_kv * head_dim, E)
        t[p + "self_attn.v_proj.weight"] = w(n_kv * head_dim, E)
        t[p + "self_attn.o_proj.weight"] = w(E, n_head * head_dim)
        t[p + "block_sparse_moe.gate.weight"] = w(X, E)
        for x in range(X):
            ep = f"{p}block_sparse_moe.experts.{x}."
            t[ep + "w1.weight"] = w(inter, E)
            t[ep + "w2.weight"] = w(E, inter)
            t[ep + "w3.weight"] = w(inter, E)
    return {"config.json": json.dumps(cfg).encode(),
            "model.safetensors": safetensors_blob(t)}
