"""Push → serve → pull: the port against the JAX package, on the CPU.

- the port's ``push_checkpoint`` and the JAX package's give the same
  revision sha, xorb set and ``xorb_digests`` for the same files;
- the port's ``pull_model(device="cpu")`` from the JAX package's
  ``FixtureHub`` reassembles the same bytes and lands a tree whose
  ``params_digest`` equals the JAX landing's;
- the JAX package's pull from the port's publisher endpoint reassembles
  the pushed files byte for byte;
- the port's own push → serve → pull loop works end to end.
"""

from __future__ import annotations

import pytest

from tests.fixtures import FixtureHub, FixtureRepo, gpt2_checkpoint_files
from zest_tpu.config import Config as JConfig
from zest_tpu.models import loader as j_loader
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer import push as j_push
from zest_tpu_torch.api.http_api import PublisherServer
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import loader
from zest_tpu_torch.ops import blake3_cuda
from zest_tpu_torch.transfer.pull import pull_model
from zest_tpu_torch.transfer.push import push_checkpoint

REPO = "org/tiny-gpt2"


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def files() -> dict[str, bytes]:
    return gpt2_checkpoint_files(n_embd=64, n_layer=2, seed=3)


def _cfg(root, name, **kw) -> Config:
    return Config(hf_home=root / name / "hf", cache_dir=root / name / "zest",
                  hf_token="hf_test", **kw)


def _jcfg(root, name, **kw) -> JConfig:
    return JConfig(hf_home=root / name / "hf",
                   cache_dir=root / name / "zest", hf_token="hf_test", **kw)


@pytest.mark.parametrize("chunks_per_xorb", [0, 3])
def test_push_matches_reference(tmp_path, files, chunks_per_xorb):
    mine = push_checkpoint(_cfg(tmp_path, "port",
                                push_chunks_per_xorb=chunks_per_xorb),
                           REPO, files=files, device="cpu", log=_quiet)
    ref = j_push.push_checkpoint(
        _jcfg(tmp_path, "ref", push_chunks_per_xorb=chunks_per_xorb),
        REPO, files=files, notify=False, log=_quiet)
    assert mine.revision == ref.revision
    assert mine.xorb_digests == ref.xorb_digests
    assert (mine.new_xorbs, mine.new_xorb_bytes, mine.xet_bytes) == (
        ref.new_xorbs, ref.new_xorb_bytes, ref.xet_bytes)
    assert mine.new_xorbs == (1 if chunks_per_xorb == 0 else
                              -(-mine.minted_chunks // chunks_per_xorb))


def test_second_push_dedups_like_reference(tmp_path, files):
    """Revision B over A: same parent lineage, revision and reuse."""
    edited = dict(files)
    blob = bytearray(files["model.safetensors"])
    blob[-5000:-4000] = bytes(1000)
    edited["model.safetensors"] = bytes(blob)
    cfg, jcfg = _cfg(tmp_path, "port"), _jcfg(tmp_path, "ref")
    results = []
    for fileset in (files, edited):
        results.append((
            push_checkpoint(cfg, REPO, files=fileset, device="cpu",
                            log=_quiet),
            j_push.push_checkpoint(jcfg, REPO, files=fileset, notify=False,
                                   log=_quiet)))
    (a, ja), (b, jb) = results
    assert (b.revision, b.parent, b.reused_bytes) == (
        jb.revision, jb.parent, jb.reused_bytes)
    assert b.parent == a.revision == ja.revision
    assert b.reused_bytes > 0 and b.seeded_base_xorbs == 1


def test_pull_from_fixture_hub_matches_reference_landing(tmp_path, files):
    blake3_cuda.COUNTER.reset()
    with FixtureHub(FixtureRepo(REPO, files, chunks_per_xorb=3)) as hub:
        res = pull_model(_cfg(tmp_path, "b", endpoint=hub.url), REPO,
                         device="cpu", log=_quiet)
    for name, data in files.items():
        assert (res.snapshot_dir / name).read_bytes() == data
    assert res.stats["fetch"]["xorbs"]["cdn"] > 1
    assert res.stats["fallback_files"] == 0
    assert res.stats["time_to_hbm_s"] <= res.stats["elapsed_s"]
    # The direct streaming landing's stages, as the JAX package's
    # pull --device=tpu reports them.
    assert set(res.stats["stages"]) == {
        "resolve", "cas_metadata", "fetch", "decode", "first_layer",
        "hbm_commit", "files"}
    assert res.stats["hbm"]["direct"] is True
    assert res.stats["hbm"]["tensors"] == len(res.params)
    assert all(t.device.type == "cpu" for t in res.params.values())
    j_params, _ = j_loader.stage_snapshot_to_hbm(res.snapshot_dir)
    assert loader.params_digest(res.params) == j_loader.params_digest(
        j_params)
    assert blake3_cuda.COUNTER.launches == 0


def test_second_pull_serves_from_cache(tmp_path, files):
    with FixtureHub(FixtureRepo(REPO, files, chunks_per_xorb=3)) as hub:
        cfg = _cfg(tmp_path, "b", endpoint=hub.url)
        first = pull_model(cfg, REPO, device="cpu", log=_quiet)
        # A fresh snapshot dir over the same xorb cache: the header, the
        # landing and the files read tier 1, nothing crosses the network.
        cfg2 = _cfg(tmp_path, "b", endpoint=hub.url)
        cfg2.hf_home = tmp_path / "b2" / "hf"
        second = pull_model(cfg2, REPO, device="cpu", log=_quiet)
    assert first.stats["fetch"]["bytes"]["cdn"] > 0
    assert second.stats["fetch"]["bytes"]["cdn"] == 0
    assert second.stats["fetch"]["bytes"]["cache"] >= len(
        files["model.safetensors"])
    assert second.stats["hbm"]["direct"] is True
    assert loader.params_digest(second.params) == loader.params_digest(
        first.params)


def test_reference_pull_from_port_publisher(tmp_path, files):
    cfg_a = _cfg(tmp_path, "a", push_chunks_per_xorb=3)
    pushed = push_checkpoint(cfg_a, REPO, files=files, device="cpu",
                             log=_quiet)
    with PublisherServer(cfg_a) as server:
        res = j_pull.pull_model(_jcfg(tmp_path, "b", endpoint=server.url),
                                REPO, no_p2p=True, log=_quiet)
    assert res.stats["revision"] == pushed.revision
    for name, data in files.items():
        assert (res.snapshot_dir / name).read_bytes() == data


def test_port_push_serve_pull_loop(tmp_path, files):
    cfg_a = _cfg(tmp_path, "a", push_chunks_per_xorb=2)
    pushed = push_checkpoint(cfg_a, REPO, files=files, device="cpu",
                             log=_quiet)
    assert pushed.manifest_written and pushed.minted_chunks > 2
    # Re-pushing identical bytes is the same revision and writes nothing.
    again = push_checkpoint(cfg_a, REPO, files=files, device="cpu",
                            log=_quiet)
    assert again.revision == pushed.revision and not again.xorb_digests
    with PublisherServer(cfg_a) as server:
        res = pull_model(_cfg(tmp_path, "b", endpoint=server.url), REPO,
                         device="cpu", log=_quiet)
    assert res.stats["revision"] == pushed.revision
    assert res.stats["fallback_files"] == 0
    # Node B started empty: every minted byte crossed the CDN tier.
    assert res.stats["fetch"]["bytes"]["cdn"] >= pushed.new_xorb_bytes
    for name, data in files.items():
        assert (res.snapshot_dir / name).read_bytes() == data
    assert loader.params_digest(res.params) == loader.params_digest(
        loader.load_checkpoint(res.snapshot_dir, "cpu"))


def test_landing_dtype_never_casts_ints(tmp_path):
    import torch

    host = {"w": torch.tensor([1.5, -2.0]), "ids": torch.tensor([7, 9]),
            "mask": torch.tensor([True, False]),
            "nan": torch.tensor([0x7FC00001], dtype=torch.int32).view(
                torch.float32)}
    out = loader.commit_tensors(host, "cpu", dtype=torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int64 and out["ids"].tolist() == [7, 9]
    assert out["mask"].dtype == torch.bool
    kept = loader.commit_tensors(host, "cpu")
    assert kept["nan"].view(torch.int32).item() == 0x7FC00001
