"""The port's serving daemon against the JAX package's ``HttpApi``, on the CPU.

Over one fixture hub, ``POST /v1/generate`` (plain and streamed, Llama,
Mixtral and GPT-2) must answer with the JAX package's event names, the
same ``done`` keys and the same ids; a warm request must skip the hub;
``/v1/status`` and ``/v1/models`` keep the reference's pool-on/pool-off
schema rule; ``_pull_memo`` runs one pull for concurrent misses; a
failing landing reaches the client as an ``error`` event; and the
control routes and the ``models`` command answer. The port's daemon runs
on ``device="cpu"``; the reference's ``generate_events`` is driven
directly.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import pytest

from tests.fixtures import (
    FixtureHub,
    FixtureRepo,
    gpt2_checkpoint_files,
    llama_checkpoint_files,
    mixtral_checkpoint_files,
)
from zest_tpu import telemetry as j_telemetry
from zest_tpu.api.http_api import HttpApi as JHttpApi
from zest_tpu.config import Config as JConfig
from zest_tpu.models import hbm_pool as j_pool
from zest_tpu_torch import cli, telemetry
from zest_tpu_torch.api.http_api import HttpApi, PublisherServer
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import hbm_pool

LLAMA, MOE, GPT2 = "acme/serve-llama", "acme/serve-moe", "acme/serve-gpt2"


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("ZEST_HBM_POOL", "ZEST_HBM_POOL_BYTES", "ZEST_SLO_TTFT_S",
                 "ZEST_TELEMETRY", "ZEST_TIMELINE", "ZEST_REMEDIATE",
                 "ZEST_TENANCY"):
        monkeypatch.delenv(name, raising=False)
    for mod in (hbm_pool, j_pool):
        mod.reset()
    telemetry.reset_all()
    j_telemetry.reset_all()
    yield
    for mod in (hbm_pool, j_pool):
        mod.reset()
    telemetry.reset_all()
    j_telemetry.reset_all()


@pytest.fixture(scope="module")
def hub():
    repos = [
        FixtureRepo(LLAMA, llama_checkpoint_files(seed=4),
                    chunks_per_xorb=4),
        FixtureRepo(MOE, mixtral_checkpoint_files(seed=5),
                    chunks_per_xorb=4),
        FixtureRepo(GPT2, gpt2_checkpoint_files(n_embd=64, n_layer=2),
                    chunks_per_xorb=4),
    ]
    with FixtureHub(*repos) as h:
        yield h


def _cfg(hub, root, **kw) -> Config:
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _jcfg(hub, root, **kw) -> JConfig:
    return JConfig(hf_home=root / "jhf", cache_dir=root / "jzest",
                   hf_token="hf_test", endpoint=hub.url, **kw)


@pytest.fixture
def daemon(hub, tmp_path):
    with PublisherServer(_cfg(hub, tmp_path), device="cpu") as server:
        yield server


def _post_sse(url: str, body: dict) -> list[dict]:
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return [json.loads(line[len(b"data: "):])
                for line in r.read().splitlines()
                if line.startswith(b"data: ")]


def _get(url: str, path: str):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        body = r.read()
        if r.headers.get("Content-Type", "").startswith("application/json"):
            return json.loads(body)
        return body.decode()


def _reference(hub, root, repo: str, req: dict) -> list[dict]:
    api = JHttpApi(_jcfg(hub, root))
    try:
        return list(api.generate_events(repo, req))
    finally:
        api.close()


@pytest.mark.parametrize("repo,stream", [
    (LLAMA, False), (LLAMA, True), (MOE, False), (MOE, True),
    (GPT2, False), (GPT2, True)])
def test_generate_matches_reference(daemon, hub, tmp_path, repo, stream):
    req = {"repo_id": repo, "ids": [5, 6, 7], "steps": 5, "stream": stream}
    got = _post_sse(daemon.url, req)
    want = _reference(hub, tmp_path, repo, req)
    assert [e["event"] for e in got] == [e["event"] for e in want], got
    assert set(got[-1]) == set(want[-1])
    assert got[-1]["ids"] == want[-1]["ids"]
    assert got[-1]["model_type"] == want[-1]["model_type"]
    if stream:
        assert [e["event"] for e in got[2:-1]] == ["token"] * 5
        assert [(e["pos"], e["id"]) for e in got if e["event"] == "token"] \
            == [(e["pos"], e["id"]) for e in want if e["event"] == "token"]
    if repo == GPT2:
        assert "pool" not in got[-1]
    else:
        pool = got[-1]["pool"]
        assert set(pool) == set(want[-1]["pool"])
        assert pool["temp"] == want[-1]["pool"]["temp"] == "cold"
        if repo == MOE:
            assert set(pool["experts"]) == set(want[-1]["pool"]["experts"])
            assert 0 < pool["experts"]["residency"] < 0.5


def test_warm_request_skips_hub_and_runs_hot(daemon, hub):
    req = {"repo_id": LLAMA, "ids": [1, 2, 3], "steps": 3}
    first = _post_sse(daemon.url, req)
    seen = len(hub.requests_seen)
    second = _post_sse(daemon.url, req)
    assert len(hub.requests_seen) == seen  # the memo answered
    assert second[-1]["ids"] == first[-1]["ids"]
    assert first[-1]["pool"]["temp"] == "cold"
    assert second[-1]["pool"]["temp"] == "hot"


def test_sampled_generate_matches_family(daemon, hub, tmp_path):
    """A seeded sampled request on the pool path gives the family path's
    tokens (one torch.Generator draw per position)."""
    from zest_tpu_torch.models.generate import load_generator

    req = {"repo_id": LLAMA, "ids": [9, 8], "steps": 6,
           "temperature": 0.8, "top_k": 20, "seed": 3}
    got = _post_sse(daemon.url, req)
    snap = got[1]["snapshot_dir"]
    _, fam = load_generator(snap, device="cpu")
    want = fam([9, 8], 6, temperature=0.8, top_k=20, seed=3)
    assert got[-1]["ids"] == [int(t) for t in want]


def test_status_and_models_schema_pool_on_off(hub, tmp_path):
    on = HttpApi(_cfg(hub, tmp_path), device="cpu")
    off = HttpApi(_cfg(hub, tmp_path, hbm_pool_enabled=False), device="cpu")
    j_on = JHttpApi(_jcfg(hub, tmp_path))
    try:
        s_on, s_off = on.status_payload(), off.status_payload()
        assert "hbm_pool" in s_on and "hbm_pool" not in s_off
        assert set(s_on) - {"hbm_pool"} == set(s_off)
        assert set(s_on["hbm_pool"]) == set(j_on.status_payload()["hbm_pool"])
        assert set(s_on["telemetry"]) == set(
            j_on.status_payload()["telemetry"])
        # The pull service's and the timeline's blocks carry the JAX
        # package's keys; the mesh block of a landing mesh is absent.
        j_status = j_on.status_payload()
        assert set(s_on["tenancy"]) == set(j_status["tenancy"])
        assert set(s_on["pulls"]) == set(j_status["pulls"])
        assert set(s_on["timeline"]) == set(j_status["timeline"])
        assert "mesh_axes" not in s_on
        m_on, m_off = on.models_payload(), off.models_payload()
        assert set(m_on) == {"models", "resident"}
        assert set(m_off) == {"models"}
    finally:
        on.close()
        off.close()
        j_on.close()


def test_models_rows_carry_pool_state(daemon, hub):
    _post_sse(daemon.url, {"repo_id": LLAMA, "ids": [1, 2], "steps": 2})
    doc = _get(daemon.url, "/v1/models")
    row = next(m for m in doc["models"] if m["repo_id"] == LLAMA)
    assert row["pool_state"] == "resident" and row["files"] >= 2
    assert [r["repo"] for r in doc["resident"]] == [LLAMA]
    assert doc["resident"][0]["state"] == "resident"


def test_status_counts_kernel_launches(daemon):
    """``/v1/status`` carries the kernel wrappers' launch and row counts,
    by kernel, as they stand when it is asked."""
    from zest_tpu_torch.ops import blake3_cuda

    _post_sse(daemon.url, {"repo_id": LLAMA, "ids": [1, 2], "steps": 2})
    kernels = _get(daemon.url, "/v1/status")["kernels"]
    assert set(kernels) == {"blake3_chunks", "bg4_regroup",
                            "bg4_fused_verify"}
    before = kernels["blake3_chunks"]
    assert all(set(k) == {"launches", "rows"} for k in kernels.values())
    blake3_cuda.COUNTER.add(5)
    try:
        after = _get(daemon.url, "/v1/status")["kernels"]["blake3_chunks"]
    finally:
        with blake3_cuda.COUNTER._lock:
            blake3_cuda.COUNTER.launches -= 1
            blake3_cuda.COUNTER.rows -= 5
    assert after == {"launches": before["launches"] + 1,
                     "rows": before["rows"] + 5}


def test_pull_memo_singleflight(hub, tmp_path, monkeypatch):
    """Concurrent misses of one key share one pull; a pinned key never
    expires."""
    from zest_tpu_torch.transfer import pull as pull_mod

    api = HttpApi(_cfg(hub, tmp_path), device="cpu")
    real = pull_mod.pull_model
    calls = []

    def slow(*a, **kw):
        calls.append(kw.get("land"))
        time.sleep(0.3)
        return real(*a, **kw)

    monkeypatch.setattr(pull_mod, "pull_model", slow)
    out = []
    threads = [threading.Thread(
        target=lambda: out.append(api._pull_memo(LLAMA, "main")))
        for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert calls == [False]  # one pull, files only
        assert len(set(out)) == 1 and len(out) == 4
        api._pin_snapshot((LLAMA, "main"))
        api._pulled[(LLAMA, "main")] = (out[0], time.monotonic() - 1)
        assert api._pull_memo(LLAMA, "main") == out[0]  # pinned: no expiry
        assert calls == [False]
        api._unpin_snapshot((LLAMA, "main"))
        assert api._pull_memo(LLAMA, "main") == out[0]  # expired: re-pull
        assert calls == [False, False]
    finally:
        api.close()


def test_landing_failure_is_an_error_event(daemon, monkeypatch):
    from zest_tpu_torch.models import loader

    def broken(*a, **kw):
        raise RuntimeError("injected commit fault")

    monkeypatch.setattr(loader, "commit_tensors", broken)
    events = _post_sse(daemon.url, {"repo_id": LLAMA, "ids": [1, 2],
                                    "steps": 2, "stream": True})
    assert [e["event"] for e in events] == ["start", "pulled", "error"]
    assert "landing" in events[-1]["message"]
    assert "failed" in events[-1]["message"]


def test_bad_requests(daemon):
    for body in (b"[1]", b"{}", b"not json"):
        req = urllib.request.Request(daemon.url + "/v1/generate", data=body,
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
    events = _post_sse(daemon.url, {"repo_id": LLAMA, "steps": 2})
    assert events[-1]["event"] == "error"
    assert "need ids" in events[-1]["message"]


def test_control_routes(daemon, hub):
    assert _get(daemon.url, "/v1/health") == {"status": "ok"}
    _post_sse(daemon.url, {"repo_id": LLAMA, "ids": [1, 2], "steps": 2})
    text = _get(daemon.url, "/v1/metrics")
    assert 'zest_ttft_seconds_count{temp="cold"} 1' in text
    assert "# TYPE zest_hbm_pool_bytes gauge" in text
    status = _get(daemon.url, "/v1/status")
    assert status["hbm_pool"]["models"][0]["repo"] == LLAMA
    assert status["http_port"] == daemon.api.port
    req = urllib.request.Request(daemon.url + "/v1/stop", data=b"",
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read()) == {"status": "stopping"}
    # The handler answers, then sets the event.
    assert daemon.api.shutdown_event.wait(10)


def test_cli_models_resident(daemon, hub, monkeypatch, capsys):
    _post_sse(daemon.url, {"repo_id": MOE, "ids": [1, 2], "steps": 2})
    cfg = daemon.api.cfg
    monkeypatch.setenv("HF_HOME", str(cfg.hf_home))
    monkeypatch.setenv("ZEST_CACHE_DIR", str(cfg.cache_dir))
    monkeypatch.setenv("ZEST_HTTP_PORT", str(daemon.api.port))
    assert cli.main(["models", "--resident"]) == 0
    out = capsys.readouterr().out
    assert MOE in out and "resident" in out and "experts 38%" in out
    assert cli.main(["models", "--resident", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)["resident"]
    assert [r["repo"] for r in rows] == [MOE]
    assert cli.main(["models"]) == 0
    out = capsys.readouterr().out
    assert f"{MOE}  rev" in out and "[hbm:resident]" in out


def test_cli_models_no_daemon(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("ZEST_CACHE_DIR", str(tmp_path / "zest"))
    monkeypatch.setenv("ZEST_HTTP_PORT", "0")
    assert cli.main(["models", "--resident"]) == 1
    assert "no HBM pool state" in capsys.readouterr().err
    assert cli.main(["models"]) == 0
    assert "no models pulled" in capsys.readouterr().out
