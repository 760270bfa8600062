"""The package's user-facing shell, held to the JAX package's.

Mirrors ``tests/test_api_surface.py``: ``ZestClient.pull`` returns the
snapshot dir, the ``huggingface_hub`` patch pulls through zest and falls
back to the hub's own download when zest fails, ``POST /v1/pull``
streams a pull to its ``done`` event, and the daemon's ephemeral port
resolves the same way. Also the package-level ``pull`` and a
``ZestServer`` life cycle over a real ``serve`` child (CPU only: the
child starts without a card). All against a loopback fixture hub.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import urllib.request

import numpy as np
import pytest

import zest_tpu_torch
from tests.fixtures import FixtureHub, FixtureRepo
from zest_tpu.api.client import ZestClient as JZestClient
from zest_tpu.api.daemon import ZestServer as JZestServer
from zest_tpu.config import Config as JConfig
from zest_tpu_torch.api import hf_backend
from zest_tpu_torch.api.client import ZestClient
from zest_tpu_torch.api.daemon import ZestServer
from zest_tpu_torch.api.http_api import PublisherServer
from zest_tpu_torch.config import Config

REPO_ID = "acme/api-model"
FILES = {
    "config.json": b'{"model_type": "gpt2"}',
    "model.safetensors": np.random.default_rng(9).integers(
        0, 256, 300_000, dtype=np.uint8).tobytes(),
}
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO_ID, FILES, chunks_per_xorb=2)) as h:
        yield h


@pytest.fixture()
def cfg(hub, tmp_path):
    return Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                  hf_token="hf_test", endpoint=hub.url)


def test_client_pull_returns_snapshot(cfg, hub, tmp_path):
    res = ZestClient(cfg).pull(REPO_ID)
    snap = pathlib.Path(os.fspath(res))
    for name, data in FILES.items():
        assert (snap / name).read_bytes() == data
    assert res.stats["fetch"]["bytes"]["cdn"] > 0
    # Files only, as the JAX package's client: nothing landed.
    ref = JZestClient(JConfig(hf_home=tmp_path / "j/hf",
                              cache_dir=tmp_path / "j/zest",
                              hf_token="hf_test", endpoint=hub.url)
                      ).pull(REPO_ID)
    assert res.params is None and ref.params is None
    assert "hbm" not in res.stats and "time_to_hbm_s" not in res.stats
    assert res.stats["fetch"]["bytes"] == ref.stats["fetch"]["bytes"]


def test_hf_patch_pulls_through_zest(cfg):
    import huggingface_hub

    original = huggingface_hub.snapshot_download
    hf_backend.patch_hf_hub(ZestClient(cfg))
    try:
        assert huggingface_hub.snapshot_download is not original
        out = huggingface_hub.snapshot_download(REPO_ID)
        assert (pathlib.Path(out) / "model.safetensors").read_bytes() \
            == FILES["model.safetensors"]
        hf_backend.patch_hf_hub(ZestClient(cfg))  # idempotent
    finally:
        hf_backend.unpatch_hf_hub()
    assert huggingface_hub.snapshot_download is original


def test_hf_patch_falls_back_on_zest_failure(monkeypatch):
    """zest never makes a download fail that would otherwise succeed: a
    failing pull degrades to the hub's own downloader."""
    import huggingface_hub

    sentinel = object()
    monkeypatch.setattr(huggingface_hub, "snapshot_download",
                        lambda repo_id, *a, **k: sentinel)

    class BrokenClient:
        def pull(self, repo_id, revision="main"):
            raise RuntimeError("zest exploded")

    hf_backend.patch_hf_hub(BrokenClient())
    try:
        assert huggingface_hub.snapshot_download(REPO_ID) is sentinel
    finally:
        hf_backend.unpatch_hf_hub()


def test_sse_pull_streams_progress_and_completes(cfg):
    with PublisherServer(cfg, device="cpu") as server:
        req = urllib.request.Request(
            f"{server.url}/v1/pull", method="POST",
            data=json.dumps({"repo_id": REPO_ID}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            assert "text/event-stream" in r.headers["Content-Type"]
            events = [json.loads(line[6:]) for line in r
                      if line.startswith(b"data: ")]
    assert events[0]["event"] == "start"
    assert events[-1]["event"] == "done"
    assert events[-1]["stats"]["files_downloaded"] == len(FILES)
    snap = pathlib.Path(events[-1]["snapshot_dir"])
    for name, data in FILES.items():
        assert (snap / name).read_bytes() == data


def test_effective_http_port_resolves_ephemeral_daemon(tmp_path):
    for config, server in ((Config, ZestServer), (JConfig, JZestServer)):
        cfg = config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                     hf_token="hf_test", http_port=0)
        assert cfg.effective_http_port() == 0
        cfg.cache_dir.mkdir(parents=True, exist_ok=True)
        cfg.http_port_file().write_text("41513")
        assert cfg.effective_http_port() == 41513
        assert server(cfg)._base.endswith(":41513")
        cfg.http_port_file().write_text("not-a-port")
        assert cfg.effective_http_port() == 0
        cfg.http_port_file().write_text("41513")
        cfg2 = config(hf_home=cfg.hf_home, cache_dir=cfg.cache_dir,
                      hf_token="hf_test", http_port=5000)
        assert cfg2.effective_http_port() == 5000
        cfg.http_port_file().unlink()


def test_package_pull_writes_files_only(cfg, monkeypatch):
    monkeypatch.setattr(zest_tpu_torch, "_client", ZestClient(cfg))
    res = zest_tpu_torch.pull(REPO_ID)
    assert res.params is None
    assert (pathlib.Path(res) / "config.json").read_bytes() \
        == FILES["config.json"]


def test_zest_server_life_cycle(hub, tmp_path):
    """``ensure_running`` spawns ``python -m zest_tpu_torch serve`` on an
    ephemeral port and polls it healthy; ``status()`` and ``stop`` go
    through the REST API, and the child exits 0."""
    env = dict(os.environ, ZEST_CACHE_DIR=str(tmp_path / "zest"),
               HF_HOME=str(tmp_path / "hf"), HF_ENDPOINT=hub.url,
               ZEST_HTTP_PORT="0", ZEST_LISTEN_PORT="0", ZEST_DCN_PORT="0",
               ZEST_TENANT_MAX_PULLS="1", ZEST_TENANT_QUEUE="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    cfg = Config.load(env)
    server = ZestServer(cfg, env=env, args=["--device", "cpu"])
    server.ensure_running()
    try:
        assert server.is_running()
        status = ZestClient(cfg).status()
        assert status["tenancy"]["max_pulls"] == 1
        assert status["tenancy"]["queue_cap"] == 1
        assert (cfg.cache_dir / "zest.pid").exists()
    finally:
        rc = server.stop()
    assert rc == 0
    assert not (cfg.cache_dir / "zest.pid").exists()
    assert not server.is_running()
    assert sys.modules["zest_tpu_torch"] is zest_tpu_torch
