"""The port's pod round and pod pre-pass against the JAX package's.

Mirrors tests/test_pod_pull.py without the expert-routed cases. The JAX
package gathers over the 8-device virtual CPU mesh; the port over the
slot mesh ``["cpu"] * 8``, verifying whole xorbs with the plain versions
of the kernels (``device="cpu"``). The same fixture repos go through
both: the round's stats (times excepted), the cache it fills, the files
and the landed ``params_digest`` must be equal.

Also: the round into a ``TieredCache`` (HBM staging over disk) feeding a
pull with no CDN bytes, a corrupted owned unit rejected and healed, and
a verifier that fails to launch raising out of ``pod_round`` and
``pull_model`` instead of being healed from the CDN.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from tests.fixtures import FixtureHub, FixtureRepo, gpt2_checkpoint_files
from zest_tpu.cas.hub import HubClient as JHubClient
from zest_tpu.config import Config as JConfig
from zest_tpu.models import loader as j_loader
from zest_tpu.ops import best_hasher
from zest_tpu.parallel.mesh import pod_mesh as j_pod_mesh
from zest_tpu.transfer import pod as j_pod
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer.bridge import XetBridge as JXetBridge
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.cas.xorb import XorbBuilder
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import loader
from zest_tpu_torch.ops import bg4, fused_verifier_for_backend
from zest_tpu_torch.ops import unit_verify_hasher
from zest_tpu_torch.parallel import (
    DistributionPlan,
    HbmStagingCache,
    PoolLayout,
    TieredCache,
    pod_mesh,
)
from zest_tpu_torch.storage import XorbCache
from zest_tpu_torch.transfer import pull as port_pull
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.pod import _device_verify_full_xorb, pod_round
from zest_tpu_torch.transfer.pull import pull_model

REPO_ID = "acme/pod-model"
FILES = {
    "config.json": b'{"model_type": "podtest"}',
    "model.safetensors": np.random.default_rng(5).bytes(600_000),
    "extra.safetensors": np.random.default_rng(6).bytes(200_000),
}
GPT2_REPO = "acme/pod-gpt2"
SLOTS = ["cpu"] * 8
TIMES = ("gather_s", "fill_s")


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO_ID, FILES, chunks_per_xorb=2)) as h:
        yield h


@pytest.fixture(scope="module")
def gpt2_hub():
    files = gpt2_checkpoint_files(n_embd=64, n_layer=2, seed=11)
    with FixtureHub(FixtureRepo(GPT2_REPO, files, chunks_per_xorb=2)) as h:
        yield h, files


@pytest.fixture
def slot_mesh(monkeypatch):
    """The pull's pod pre-pass spans ``["cpu"] * 8`` (no card here)."""
    monkeypatch.setattr(port_pull, "pod_mesh", lambda devices=None:
                        pod_mesh(SLOTS))


def _cfg(hub, root, **kw):
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _jcfg(hub, root):
    return JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                   hf_token="hf_test", endpoint=hub.url)


def _bridge(hub, root, repo_id=REPO_ID, cache=None):
    b = XetBridge(_cfg(hub, root), cache=cache)
    b.authenticate(repo_id)
    return b


def _recs(bridge, repo_id=REPO_ID):
    return [bridge.get_reconstruction(e.xet_hash)
            for e in HubClient(bridge.cfg).list_files(repo_id) if e.is_xet]


def _jbridge(hub, root, repo_id=REPO_ID):
    b = JXetBridge(_jcfg(hub, root))
    b.authenticate(repo_id)
    return b


def _jrecs(bridge, repo_id=REPO_ID):
    return [bridge.get_reconstruction(e.xet_hash)
            for e in JHubClient(bridge.cfg).list_files(repo_id) if e.is_xet]


def _untimed(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k not in TIMES}


def _cache_entries(cfg) -> dict[str, bytes]:
    root = cfg.xorb_cache_dir()
    return {f.name: f.read_bytes() for f in root.rglob("*") if f.is_file()}


# ── the round ──


def test_pod_round_matches_reference(hub, tmp_path):
    b = _bridge(hub, tmp_path / "p")
    recs = _recs(b)
    stats = pod_round(b, recs, mesh=pod_mesh(SLOTS))
    jb = _jbridge(hub, tmp_path / "j")
    ref = j_pod.pod_round(jb, _jrecs(jb))
    assert _untimed(stats) == _untimed(ref)
    assert stats["slots"] == 8 and stats["filled"] == stats["units"] > 0
    assert stats["verify_rejected"] == 0
    assert _cache_entries(b.cfg) == _cache_entries(jb.cfg)
    for rec in recs:
        for term in rec.terms:
            fi = rec.find_fetch_info(term)
            assert b.cache.get_with_range(term.hash_hex,
                                          fi.range.start) is not None


def test_pod_round_single_slot_skips(hub, tmp_path):
    b = _bridge(hub, tmp_path / "p")
    jb = _jbridge(hub, tmp_path / "j")
    stats = pod_round(b, _recs(b), mesh=pod_mesh(["cpu"]))
    assert stats == j_pod.pod_round(jb, _jrecs(jb),
                                    mesh=j_pod_mesh(jax.devices()[:1]))
    assert stats["skipped"] and stats["slots"] == 1
    assert _cache_entries(b.cfg) == {}


def test_pod_round_windowed_waves_match_reference(hub, tmp_path):
    b = _bridge(hub, tmp_path / "win")
    recs = _recs(b)
    plan = DistributionPlan.build(recs, 8)
    full_pool = PoolLayout.from_plan(plan).pool_bytes
    biggest = max(PoolLayout.from_plan(DistributionPlan(8, [a])).pool_bytes
                  for a in plan.assignments)
    budget = max(biggest, full_pool // 3)
    assert budget < full_pool
    stats = pod_round(b, recs, mesh=pod_mesh(SLOTS), budget_bytes=budget)
    jb = _jbridge(hub, tmp_path / "jwin")
    ref = j_pod.pod_round(jb, _jrecs(jb), budget_bytes=budget)
    assert _untimed(stats) == _untimed(ref)
    assert stats["waves"] > 1 and stats["pool_bytes"] <= budget
    one = _bridge(hub, tmp_path / "one")
    assert pod_round(one, _recs(one), mesh=pod_mesh(SLOTS),
                     budget_bytes=0)["waves"] == 1
    assert _cache_entries(b.cfg) == _cache_entries(one.cfg)


def test_pod_round_failed_fetch_degrades(hub, tmp_path):
    b = _bridge(hub, tmp_path)
    recs = _recs(b)
    real = b.fetch_unit
    calls = {"n": 0}

    def flaky(hash_hex, fi):
        calls["n"] += 1
        if calls["n"] % 2:
            raise OSError("cdn hiccup")
        return real(hash_hex, fi)

    b.fetch_unit = flaky
    stats = pod_round(b, recs, mesh=pod_mesh(SLOTS))
    assert 0 < stats["filled"] < stats["units"]
    b.fetch_unit = real
    for e in HubClient(b.cfg).list_files(REPO_ID):
        if e.is_xet:
            b.reconstruct_to_file(e.xet_hash, tmp_path / "out.bin")
            assert (tmp_path / "out.bin").read_bytes() == FILES[e.path]


def test_corrupt_owned_unit_rejected_and_healed(hub, tmp_path):
    """One owner's fetch returns a byte-flipped whole xorb: the receipt
    verification rejects it (never cached), and the pull that follows
    fetches exactly that unit from the CDN."""
    b = _bridge(hub, tmp_path)
    recs = _recs(b)
    layout = PoolLayout.from_plan(DistributionPlan.build(recs, 8))
    victim = sorted(layout.full_xorbs)[0]
    real = b.fetch_unit

    def corrupting(hash_hex, fi):
        data = real(hash_hex, fi)
        if hash_hex != victim:
            return data
        bad = bytearray(data)
        bad[len(bad) // 2] ^= 0xFF
        return bytes(bad)

    b.fetch_unit = corrupting
    stats = pod_round(b, recs, mesh=pod_mesh(SLOTS))
    assert stats["verify_rejected"] == 1
    assert stats["filled"] == stats["units"] - 1
    assert not b.cfg.xorb_cache_path(victim).exists()
    res = pull_model(b.cfg, REPO_ID, device="cpu", pod=False, land=False,
                     no_p2p=True, log=_quiet)
    victim_bytes = sum(fi.url_range_end - fi.url_range_start
                       for rec in recs for fi in rec.fetch_info.get(victim,
                                                                    []))
    assert res.stats["fetch"]["bytes"]["cdn"] == victim_bytes
    for name, data in FILES.items():
        assert (res.snapshot_dir / name).read_bytes() == data


# ── the receipt check ──


def test_device_verify_matches_reference(hub):
    repo = hub.repos[REPO_ID]
    hasher = unit_verify_hasher(hashing.CHUNK_KEY, "cpu")
    fused = fused_verifier_for_backend(hashing.CHUNK_KEY, "cpu")
    jhasher = best_hasher(hashing.CHUNK_KEY)
    for hash_hex, xf in sorted(repo.xorbs.items())[:2]:
        bad = bytearray(xf.blob)
        bad[len(bad) // 2] ^= 0xFF
        for blob in (xf.blob, bytes(bad), b"garbage"):
            assert _device_verify_full_xorb(blob, hash_hex, hasher, fused) \
                == j_pod._device_verify_full_xorb(blob, hash_hex, jhasher)
    b = XorbBuilder()
    b.add_chunk(bytes(200 * 1024))  # a legal frame, over the 128 KiB cap
    hh = hashing.hash_to_hex(b.xorb_hash())
    assert _device_verify_full_xorb(b.serialize(), hh, hasher, fused) \
        is False


def test_get_reconstruction_memoized(hub, tmp_path):
    b = _bridge(hub, tmp_path)
    fhash = hub.repos[REPO_ID].files["model.safetensors"].xet_hash
    before = len(hub.requests_seen)
    r1 = b.get_reconstruction(fhash)
    mid = len(hub.requests_seen)
    assert b.get_reconstruction(fhash) is r1
    assert len(hub.requests_seen) == mid > before


# ── the pull's pre-pass ──


def test_pull_pod_matches_reference(hub, tmp_path, monkeypatch, slot_mesh):
    res = pull_model(_cfg(hub, tmp_path / "p"), REPO_ID, device="cpu",
                     pod=True, land=False, no_p2p=True, log=_quiet)
    ref = j_pull.pull_model(_jcfg(hub, tmp_path / "j"), REPO_ID,
                            no_p2p=True, pod=True, log=_quiet)
    assert _untimed(res.stats["pod"]) == _untimed(ref.stats["pod"])
    assert res.stats["pod"]["filled"] == res.stats["pod"]["units"] > 0
    assert res.stats["fetch"]["xorbs"]["cache"] >= res.stats["pod"]["units"]
    assert res.stats["fetch"]["bytes"]["cdn"] == \
        ref.stats["fetch"]["bytes"]["cdn"]
    for name, data in FILES.items():
        assert (res.snapshot_dir / name).read_bytes() == data
    plain = pull_model(_cfg(hub, tmp_path / "plain"), REPO_ID, device="cpu",
                       land=False, no_p2p=True, log=_quiet)
    assert "pod" not in plain.stats
    monkeypatch.undo()  # the pre-pass's own mesh: the one CPU device
    one = pull_model(_cfg(hub, tmp_path / "one"), REPO_ID, device="cpu",
                     pod=True, land=False, no_p2p=True, log=_quiet)
    jb = _jbridge(hub, tmp_path / "jone")
    assert one.stats["pod"] == j_pod.pod_round(
        jb, _jrecs(jb), mesh=j_pod_mesh(jax.devices()[:1]))


def test_pod_round_into_tiered_cache_then_pull(gpt2_hub, tmp_path):
    """The card's phase 10 at a small size: the round fills HBM staging
    over the disk cache, then a pull lands from the disk cache with no
    CDN bytes and the reference landing's digest."""
    h, files = gpt2_hub
    cfg = _cfg(h, tmp_path / "p")
    hbm = HbmStagingCache(1 << 30, device="cpu")
    b = _bridge(h, tmp_path / "p", GPT2_REPO,
                cache=TieredCache(XorbCache(cfg), hbm))
    stats = pod_round(b, _recs(b, GPT2_REPO), mesh=pod_mesh(SLOTS))
    assert stats["filled"] == stats["units"] and not stats["verify_rejected"]
    assert hbm.summary()["entries"] == stats["units"]
    res = pull_model(cfg, GPT2_REPO, device="cpu", log=_quiet)
    assert res.stats["fetch"]["bytes"]["cdn"] == 0
    ref = j_pull.pull_model(_jcfg(h, tmp_path / "j"), GPT2_REPO,
                            no_p2p=True, log=_quiet)
    j_params, _ = j_loader.stage_snapshot_to_hbm(ref.snapshot_dir)
    assert loader.params_digest(res.params) == \
        j_loader.params_digest(j_params)
    for name, data in files.items():
        assert (res.snapshot_dir / name).read_bytes() == data


def test_verifier_launch_error_raises_out_of_the_round(gpt2_hub, tmp_path,
                                                       monkeypatch,
                                                       slot_mesh):
    """A verifier that fails to launch is the round's error, and the
    pull's: never a rejection healed from the CDN."""
    def broken(self, words, lengths):
        raise RuntimeError("BG4 regroup kernel launch failed: cudaError 98")

    monkeypatch.setattr(bg4.FusedBg4Verifier, "hash_planar_device", broken)
    h, _files = gpt2_hub
    b = _bridge(h, tmp_path / "r", GPT2_REPO)
    with pytest.raises(RuntimeError, match="cudaError 98"):
        pod_round(b, _recs(b, GPT2_REPO), mesh=pod_mesh(SLOTS))
    with pytest.raises(RuntimeError, match="cudaError 98"):
        pull_model(_cfg(h, tmp_path / "p"), GPT2_REPO, device="cpu",
                   pod=True, log=_quiet)


def test_cli_pull_prints_the_collective_and_pod_lines(gpt2_hub, tmp_path,
                                                      monkeypatch, capsys,
                                                      slot_mesh):
    """``pull --coop ... --pod``: the reference's ``Collective:`` and
    ``Pod round:`` lines; ``--no-pod`` prints no pod line."""
    from zest_tpu_torch.cli import main
    from zest_tpu_torch.transfer.dcn import DcnServer
    from zest_tpu_torch.transfer.federated import warm_units_parallel

    h, _files = gpt2_hub
    owner = _bridge(h, tmp_path / "owner", GPT2_REPO)
    warm_units_parallel(owner, _recs(owner, GPT2_REPO))
    server = DcnServer(owner.cfg, owner.cache)
    port = server.start()
    monkeypatch.setenv("HF_TOKEN", "hf_test")
    monkeypatch.setenv("HF_ENDPOINT", h.url)
    monkeypatch.setenv("ZEST_DCN_PORT", "0")
    try:
        for pod_flag, root in (("--pod", "a"), ("--no-pod", "b")):
            monkeypatch.setenv("HF_HOME", str(tmp_path / root / "hf"))
            monkeypatch.setenv("ZEST_CACHE_DIR", str(tmp_path / root / "z"))
            assert main(["pull", GPT2_REPO, "--device", "cpu", "--no-p2p",
                         "--coop", "--coop-hosts", "2", "--coop-index", "0",
                         "--coop-addr", f"1=127.0.0.1:{port}",
                         pod_flag]) == 0
            out = capsys.readouterr().out
            assert "Collective: hypercube 1 phase(s)" in out, out
            assert ("Pod round:  " in out) == (pod_flag == "--pod"), out
    finally:
        server.shutdown()
