"""Hub API client: file listing, xet detection, revision resolve.

The counterpart of ``zest_tpu/cas/hub.py`` on ``urllib.request`` (the
card's machine has no ``requests``). Endpoint shapes follow the Hub API;
the port's publisher (:mod:`zest_tpu_torch.api.http_api`) serves them:

    GET  /api/models/{repo}/revision/{rev}        -> {"sha", "siblings": [...]}
    POST /api/models/{repo}/paths-info/{rev}      -> [{"path","size","xetHash"?}]
    GET  /{repo}/resolve/{rev}/{file}             -> raw bytes (redirects ok)
    GET  /api/models/{repo}/xet-read-token/{rev}  -> {"accessToken","casUrl"}
"""

from __future__ import annotations

import json
import os
import tempfile
import urllib.error
import urllib.request
from dataclasses import dataclass
from pathlib import Path

from zest_tpu_torch.config import Config


class HubError(RuntimeError):
    pass


@dataclass(frozen=True)
class FileEntry:
    path: str
    size: int
    xet_hash: str | None = None  # 64-char hex when stored in Xet CAS

    @property
    def is_xet(self) -> bool:
        return self.xet_hash is not None


def request(url: str, headers: dict[str, str] | None = None,
            data: bytes | None = None, timeout: float = 30.0):
    """``urlopen`` that returns the response for any status: an HTTP
    error status comes back as its ``HTTPError`` (a response object),
    network failures raise ``urllib.error.URLError``."""
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="POST" if data is not None else "GET")
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as exc:
        return exc


class HubClient:
    def __init__(self, cfg: Config):
        self.cfg = cfg

    def _headers(self) -> dict[str, str]:
        if self.cfg.hf_token:
            return {"Authorization": f"Bearer {self.cfg.hf_token}"}
        return {}

    def _json(self, url: str, body: dict | None = None):
        headers = self._headers()
        data = None
        if body is not None:
            headers["Content-Type"] = "application/json"
            data = json.dumps(body).encode()
        with request(url, headers, data) as resp:
            if resp.status != 200:
                raise HubError(f"{'POST' if data else 'GET'} {url} -> "
                               f"{resp.status}")
            return json.loads(resp.read())

    def resolve_revision(self, repo_id: str, revision: str = "main") -> str:
        """Ref -> commit SHA."""
        doc = self._json(
            f"{self.cfg.endpoint}/api/models/{repo_id}/revision/{revision}")
        sha = doc.get("sha") if isinstance(doc, dict) else None
        if not isinstance(sha, str) or not sha:
            raise HubError(f"no sha in revision response for "
                           f"{repo_id}@{revision}")
        return sha

    def list_files(self, repo_id: str,
                   revision: str = "main") -> list[FileEntry]:
        """All files in the repo with sizes and xet hashes."""
        doc = self._json(
            f"{self.cfg.endpoint}/api/models/{repo_id}/revision/{revision}")
        siblings = doc.get("siblings", []) if isinstance(doc, dict) else []
        paths = [s["rfilename"] for s in siblings if "rfilename" in s]
        if not paths:
            return []
        items = self._json(
            f"{self.cfg.endpoint}/api/models/{repo_id}/paths-info/{revision}",
            {"paths": paths})
        return [FileEntry(path=item["path"], size=int(item.get("size", 0)),
                          xet_hash=item.get("xetHash"))
                for item in items if item.get("type") != "directory"]

    def download_regular_file(self, repo_id: str, revision: str,
                              filename: str, dest: Path) -> int:
        """Stream a non-xet file to ``dest`` (tmp file + rename); returns
        the byte count."""
        url = f"{self.cfg.endpoint}/{repo_id}/resolve/{revision}/{filename}"
        dest.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=dest.parent,
                                   prefix=f".tmp-{dest.name}.")
        total = 0
        try:
            with os.fdopen(fd, "wb") as f, \
                    request(url, self._headers(), timeout=60) as resp:
                if resp.status != 200:
                    raise HubError(f"GET {url} -> {resp.status}")
                while piece := resp.read(1 << 20):
                    f.write(piece)
                    total += len(piece)
            os.replace(tmp, dest)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return total

    def xet_read_token(self, repo_id: str,
                       revision: str = "main") -> tuple[str, str]:
        """The HF token exchanged for (cas_url, access_token)."""
        doc = self._json(f"{self.cfg.endpoint}/api/models/{repo_id}/"
                         f"xet-read-token/{revision}")
        if not isinstance(doc, dict):
            raise HubError("malformed xet-read-token response")
        try:
            return doc["casUrl"], doc["accessToken"]
        except KeyError as exc:
            raise HubError(f"xet-read-token missing {exc}") from exc
