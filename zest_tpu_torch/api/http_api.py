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

The rest of the JAX package's daemon API (pull/generate/status, watch
fan-out) is not part of this slice.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from zest_tpu_torch.config import Config
from zest_tpu_torch.transfer.push import PUBLISHER_TOKEN, PublisherIndex


class _Handler(BaseHTTPRequestHandler):
    # Keep-alive (HTTP/1.1): every response sets Content-Length.
    protocol_version = "HTTP/1.1"
    timeout = 120
    index: PublisherIndex  # bound per server by PublisherServer

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

    def do_POST(self) -> None:  # noqa: N802
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        parts = self.path[len("/api/models/"):].strip("/").split("/")
        if not (self.path.startswith("/api/models/") and len(parts) >= 4
                and parts[2] == "paths-info"):
            self._json({"error": "not found"}, 404)
            return
        try:
            paths = [str(p) for p in (json.loads(raw or b"{}").get("paths")
                                      or [])]
        except (json.JSONDecodeError, AttributeError, TypeError):
            self._json({"error": "body must be a JSON object"}, 400)
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
    :meth:`close`."""

    def __init__(self, cfg: Config, host: str = "127.0.0.1", port: int = 0):
        handler = type("PublisherHandler", (_Handler,),
                       {"index": PublisherIndex(cfg)})
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
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(timeout=10)
        self._httpd.server_close()

    def __enter__(self) -> "PublisherServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
