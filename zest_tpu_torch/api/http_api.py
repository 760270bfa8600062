"""The publisher endpoint: Hub/CAS routes on stdlib ``http.server``.

The publisher surface of ``zest_tpu/api/http_api.py``: a node that pushed
a revision serves it to a second node's unmodified pull, answering from
:class:`~zest_tpu_torch.transfer.push.PublisherIndex`:

    GET  /api/models/{org}/{name}/revision/{rev}       -> {"sha", "siblings"}
    POST /api/models/{org}/{name}/paths-info/{rev}     -> [{"path", "size", "xetHash"?}]
    GET  /api/models/{org}/{name}/xet-read-token/{rev} -> {"casUrl", "accessToken"}
    GET  /v1/reconstructions/{file_hex}                -> terms + fetch_info (Range-paged)
    GET  /xorbs/{xorb_hex}                             -> frame bytes (Range)
    GET  /{org}/{name}/resolve/{rev}/{file}            -> file bytes (Range)

and the continuous fan-out of pushed revisions:

    POST /v1/push   {"repo", "revision", "parent"?, ...} -> {"ok", "watchers", "delivered"}
    POST /v1/watch  {"repos": [...]}  -> SSE: hello, then revision events, ping keepalives

``/v1/watch`` answers 404 when ``Config.watch_enabled`` is off
(``ZEST_WATCH=0``); a push then notifies no one. The rest of the JAX
package's daemon API (pull/generate/status, and the registry, swarm and
gossip announce of a push) is not ported.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from zest_tpu_torch.config import Config
from zest_tpu_torch.transfer.push import PUBLISHER_TOKEN, PublisherIndex


class WatchHub:
    """Fan-out of push notifications to ``POST /v1/watch`` subscribers.

    One condition and a queue per subscriber: :meth:`notify` (from a
    ``/v1/push`` handler thread) appends to every matching subscriber's
    queue and wakes them; each :meth:`subscribe` generator drains its own
    queue into the SSE stream, with a ``ping`` keepalive after ``ping_s``
    of quiet (a dead client then surfaces as a broken pipe). A disconnect
    unregisters the subscriber; :meth:`close` ends every stream."""

    def __init__(self, ping_s: float = 15.0):
        self.ping_s = ping_s
        self._cond = threading.Condition()
        self._subs: list[dict] = []
        self._closed = False

    def watchers(self) -> int:
        with self._cond:
            return len(self._subs)

    def notify(self, event: dict) -> int:
        """Deliver ``event`` to matching subscribers; returns the count."""
        delivered = 0
        with self._cond:
            for sub in self._subs:
                repos = sub["repos"]
                if repos and event.get("repo") not in repos:
                    continue
                sub["queue"].append(dict(event))
                delivered += 1
            self._cond.notify_all()
        return delivered

    def subscribe(self, repos=None):
        """SSE event generator of one subscriber; ``repos`` filters (empty
        or None: every repo)."""
        sub = {"queue": [], "repos": set(repos) if repos else None}
        with self._cond:
            self._subs.append(sub)
        try:
            yield {"event": "hello",
                   "watching": sorted(sub["repos"] or [])}
            while True:
                with self._cond:
                    if not sub["queue"] and not self._closed:
                        self._cond.wait(timeout=self.ping_s)
                    batch, sub["queue"] = sub["queue"], []
                    closed = self._closed
                if not batch and not closed:
                    yield {"event": "ping"}
                for ev in batch:
                    yield ev
                if closed:
                    return
        finally:
            with self._cond:
                if sub in self._subs:
                    self._subs.remove(sub)

    def close(self) -> None:
        """End every subscriber's stream (after what is queued)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def push_notify(hub: WatchHub, req: dict) -> dict:
    """A ``POST /v1/push`` from a push: wake every watcher of the repo.
    Raises ValueError on a malformed notification (answered 400)."""
    repo, revision = req.get("repo"), req.get("revision")
    if not repo or not revision:
        raise ValueError("push notify needs repo and revision")
    try:
        [(str(h), int(n)) for h, n in (req.get("xorbs") or [])]
    except (TypeError, ValueError) as exc:
        raise ValueError("xorbs must be [[hex, size], ...]") from exc
    event = {"event": "revision", "repo": repo, "revision": revision,
             "parent": req.get("parent"),
             "pushed_at": req.get("pushed_at"),
             "dedup_ratio": req.get("dedup_ratio"),
             "new_xorb_bytes": req.get("new_xorb_bytes")}
    delivered = hub.notify(event)
    return {"ok": True, "watchers": hub.watchers(), "delivered": delivered}


class _Handler(BaseHTTPRequestHandler):
    # Keep-alive (HTTP/1.1): every response sets Content-Length, or is
    # chunked (the SSE stream).
    protocol_version = "HTTP/1.1"
    timeout = 120
    # Bound per server by PublisherServer.
    index: PublisherIndex
    hub: WatchHub
    cfg: Config

    def log_message(self, *args) -> None:  # quiet
        pass

    def _json(self, payload, code: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _base_url(self) -> str:
        """The URL the client dialed (fetch_info and casUrl point back)."""
        host = self.headers.get("Host")
        if host:
            return f"http://{host}"
        addr, port = self.server.server_address[:2]
        return f"http://{addr}:{port}"

    def _bytes_ranged(self, blob, range_header: str | None) -> None:
        """Serve bytes honoring an inclusive ``Range: bytes=a-b`` header:
        206 partial, 416 past EOF."""
        total = len(blob)
        if range_header:
            try:
                a_s, _, b_s = range_header.split("=", 1)[1].partition("-")
                a = int(a_s or 0)
                b = min(int(b_s), total - 1) if b_s else total - 1
            except (IndexError, ValueError):
                a, b = 0, total - 1
            if a >= total or a > b:
                self.send_response(416)
                self.send_header("Content-Range", f"bytes */{total}")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            body = memoryview(blob)[a:b + 1]
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {a}-{b}/{total}")
        else:
            body = blob
            self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802
        path = self.path.split("?", 1)[0]
        if path.startswith("/api/models/"):
            parts = path[len("/api/models/"):].strip("/").split("/")
            if len(parts) >= 4 and parts[2] == "revision":
                doc = self.index.revision_doc(f"{parts[0]}/{parts[1]}",
                                              "/".join(parts[3:]))
                if doc is None:
                    self._json({"error": "unknown revision"}, 404)
                else:
                    self._json(doc)
            elif len(parts) >= 4 and parts[2] == "xet-read-token":
                self._json({"casUrl": self._base_url(),
                            "accessToken": PUBLISHER_TOKEN,
                            "exp": int(time.time()) + 3600})
            else:
                self._json({"error": "not found"}, 404)
        elif path.startswith("/v1/reconstructions/"):
            doc = self.index.reconstruction_doc(
                path[len("/v1/reconstructions/"):].strip("/"),
                self.headers.get("Range"), self._base_url())
            if doc is None:
                self._json({"error": "unknown file"}, 404)
            elif doc == "range":
                self._json({"error": "range past EOF"}, 416)
            else:
                self._json(doc)
        elif path.startswith("/xorbs/"):
            blob = self.index.xorb_blob(path[len("/xorbs/"):].strip("/"))
            if blob is None:
                self._json({"error": "unknown xorb"}, 404)
            else:
                self._bytes_ranged(blob, self.headers.get("Range"))
        else:
            parts = path.strip("/").split("/")
            data = None
            if len(parts) >= 5 and parts[2] == "resolve":
                data = self.index.resolve_file(f"{parts[0]}/{parts[1]}",
                                               parts[3], "/".join(parts[4:]))
            if data is None:
                self._json({"error": "not found"}, 404)
            else:
                self._bytes_ranged(data, self.headers.get("Range"))

    def _stream_sse(self, events) -> None:
        """Answer with an event generator as chunked SSE, then close it."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for ev in events:
                data = f"data: {json.dumps(ev)}\n\n".encode()
                self.wfile.write(f"{len(data):x}\r\n".encode()
                                 + data + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # the subscriber went away
        finally:
            events.close()

    def _json_body(self, raw: bytes) -> dict | None:
        """The request body as a JSON object, or None after a 400."""
        try:
            req = json.loads(raw or b"{}")
            if not isinstance(req, dict):
                raise TypeError
        except (ValueError, TypeError):  # JSONDecodeError, bad UTF-8
            self._json({"error": "body must be a JSON object"}, 400)
            return None
        return req

    def do_POST(self) -> None:  # noqa: N802
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        if self.path == "/v1/watch":
            if not self.cfg.watch_enabled:
                self._json({"error": "watch disabled"}, 404)
                return
            req = self._json_body(raw)
            if req is None:
                return
            try:
                repos = [str(r) for r in (req.get("repos") or [])]
            except TypeError:
                self._json({"error": "repos must be a list"}, 400)
                return
            self._stream_sse(self.hub.subscribe(repos=repos))
            return
        if self.path == "/v1/push":
            req = self._json_body(raw)
            if req is None:
                return
            try:
                self._json(push_notify(self.hub, req))
            except ValueError as exc:
                self._json({"error": str(exc)}, 400)
            return
        parts = self.path[len("/api/models/"):].strip("/").split("/")
        if not (self.path.startswith("/api/models/") and len(parts) >= 4
                and parts[2] == "paths-info"):
            self._json({"error": "not found"}, 404)
            return
        req = self._json_body(raw)
        if req is None:
            return
        try:
            paths = [str(p) for p in (req.get("paths") or [])]
        except TypeError:
            self._json({"error": "paths must be a list"}, 400)
            return
        info = self.index.paths_info(f"{parts[0]}/{parts[1]}",
                                     "/".join(parts[3:]), paths)
        if info is None:
            self._json({"error": "unknown revision"}, 404)
        else:
            self._json(info)


class PublisherServer:
    """Threaded loopback publisher over ``cfg``'s cache. ``port=0`` binds
    an ephemeral port; use as a context manager or call :meth:`start` /
    :meth:`close`. ``hub`` is its watch fan-out."""

    def __init__(self, cfg: Config, host: str = "127.0.0.1", port: int = 0):
        self.hub = WatchHub()
        handler = type("PublisherHandler", (_Handler,),
                       {"index": PublisherIndex(cfg), "hub": self.hub,
                        "cfg": cfg})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="zest-publisher", daemon=True)

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "PublisherServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self.hub.close()  # ends the watchers' streams
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(timeout=10)
        self._httpd.server_close()

    def __enter__(self) -> "PublisherServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
