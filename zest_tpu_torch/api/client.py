"""Client side of the public API: pull, and the daemon's status.

The counterpart of ``zest_tpu/api/client.py``: ``pull`` runs the
transfer pipeline in this process, and ``status`` asks the local daemon's
REST API, over ``urllib`` (the package needs no HTTP library beyond the
standard one).
"""

from __future__ import annotations

import json
import urllib.request
from typing import TYPE_CHECKING

from zest_tpu_torch.config import Config

if TYPE_CHECKING:
    from zest_tpu_torch.transfer.pull import PullResult


class ZestClient:
    def __init__(self, config: Config | None = None):
        self.config = config or Config.load()

    def pull(self, repo_id: str, revision: str = "main",
             device: str | None = None,
             tenant: str | None = None) -> "PullResult":
        """Pull ``repo_id`` through the swarm. The result is os.PathLike
        for the snapshot dir and carries ``.stats``. ``device=None``
        writes the snapshot's files only; ``"cuda"`` (or ``"cpu"``) also
        lands the tree there, in ``.params``."""
        from zest_tpu_torch.transfer.pull import pull_model

        return pull_model(self.config, repo_id, revision=revision,
                          device=device or "cpu", land=device is not None,
                          tenant=tenant)

    def status(self) -> dict:
        """The daemon's ``GET /v1/status``; raises ``urllib.error``'s
        errors (an ``OSError``) when no daemon answers."""
        url = (f"http://127.0.0.1:{self.config.effective_http_port()}"
               "/v1/status")
        with urllib.request.urlopen(url, timeout=5) as r:
            return json.loads(r.read().decode())
