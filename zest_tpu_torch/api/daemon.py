"""The local daemon's life cycle.

The counterpart of ``zest_tpu/api/daemon.py``: health-check the loopback
REST API, spawn a detached ``python -m zest_tpu_torch serve`` when none
answers, poll ``/v1/health`` until it does, and stop it with ``POST
/v1/stop``. The HTTP calls use ``urllib``.
"""

from __future__ import annotations

import subprocess
import sys
import time
import urllib.error
import urllib.request

from zest_tpu_torch.config import Config

# Start-up reads torch and the xorb cache's index before the port binds.
_HEALTH_TIMEOUT_S = 30.0
_POLL_INTERVAL_S = 0.1


class ZestServer:
    """``config`` names the daemon's port (``http_port`` 0: the port it
    records in its cache dir). ``env`` is the spawned daemon's
    environment (default this process'), ``args`` extra ``serve``
    arguments (e.g. ``["--device", "cuda"]``)."""

    def __init__(self, config: Config | None = None, env: dict | None = None,
                 args: list[str] | None = None):
        self.config = config or Config.load()
        self.env = env
        self.args = list(args or [])
        self._proc: subprocess.Popen | None = None

    @property
    def _base(self) -> str:
        return f"http://127.0.0.1:{self.config.effective_http_port()}"

    def is_running(self) -> bool:
        try:
            with urllib.request.urlopen(f"{self._base}/v1/health",
                                        timeout=1) as r:
                return r.status == 200
        except (OSError, urllib.error.URLError):
            return False

    def ensure_running(self) -> None:
        """Spawn the daemon unless one answers; raise if it does not
        become healthy in time (the spawned process is then stopped)."""
        if self.is_running():
            return
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "zest_tpu_torch", "serve",
             "--port", str(self.config.http_port), *self.args],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True, env=self.env)
        deadline = time.monotonic() + _HEALTH_TIMEOUT_S
        while time.monotonic() < deadline:
            if self.is_running():
                return
            if self._proc.poll() is not None:
                break
            time.sleep(_POLL_INTERVAL_S)
        self._kill()
        raise RuntimeError(
            f"zest daemon failed to become healthy within "
            f"{_HEALTH_TIMEOUT_S}s")

    def stop(self, timeout: float = 30.0) -> int | None:
        """Stop the daemon through the REST API (an already stopped one is
        fine). A daemon this object spawned is waited for, and killed if
        it outlives ``timeout``; returns its exit code (None otherwise)."""
        req = urllib.request.Request(f"{self._base}/v1/stop", data=b"",
                                     method="POST")
        try:
            urllib.request.urlopen(req, timeout=5).close()
        except (OSError, urllib.error.URLError):
            pass
        proc, self._proc = self._proc, None
        if proc is None:
            return None
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            return proc.wait()

    def _kill(self) -> None:
        proc, self._proc = self._proc, None
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
