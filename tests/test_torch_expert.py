"""The expert-routed distribution against the JAX package's, on the CPU.

- ``ExpertPlacement`` and ``ExpertRoutedPlan`` (mirroring
  tests/test_moe.py): contiguous placement blocks, the routed plan's
  partition of every unit, each expert unit on its consuming host, the
  gather bytes saved, the single host, and plans equal to the
  reference's unit for unit;
- ``expert_pod_round`` over eight CPU slots: stats (times excepted) and
  cache entries equal to the reference's round on its 8-device mesh; a
  failed expert unit counted as the reference counts it; a raising
  verifier surfaces;
- ``pull_model`` over an eight-slot mesh takes the expert-routed round
  (``expert_routed``, ``n_experts``) as the reference's pull does, and
  its pre-pass degrades to the plain round only on a fetch or parse
  error;
- ``land_moe_expert_sharded``: every slot's shard of the stacked tree
  equals the reference's on the device of the same index.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from tests.fixtures import FixtureHub, FixtureRepo, _safetensors_blob
from zest_tpu.config import Config as JConfig, MeshConfig as JMesh
from zest_tpu.models import direct as j_direct, loader as j_loader
from zest_tpu.models import moe as j_moe
from zest_tpu.models.safetensors_io import parse_header as j_parse_header
from zest_tpu.parallel import expert as j_expert
from zest_tpu.parallel.mesh import model_mesh as j_model_mesh
from zest_tpu.transfer import pod as j_pod, pull as j_pull
from zest_tpu.transfer.bridge import XetBridge as JXetBridge
from zest_tpu.transfer.federated import (
    warm_units_parallel as j_warm_units_parallel,
)
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import direct, loader, moe
from zest_tpu_torch.models.safetensors_io import (
    parse_header,
    parse_header_prefix,
)
from zest_tpu_torch.parallel import DistributionPlan, pod_mesh
from zest_tpu_torch.parallel.expert import (
    ExpertPlacement,
    ExpertRoutedPlan,
    classify_file,
)
from zest_tpu_torch.parallel.mesh import model_mesh
from zest_tpu_torch.transfer import pod, pull as port_pull
from zest_tpu_torch.transfer.bridge import BridgeError, XetBridge
from zest_tpu_torch.transfer.federated import warm_units_parallel
from zest_tpu_torch.transfer.pull import pull_model

REPO = "acme/expert-moe"
TIMES = ("elapsed_s", "gather_s", "fill_s")


def _mixtral_files(E=64, F=512, V=64, L=1, X=4, H=4, KV=2, seed=21):
    """An HF Mixtral checkpoint whose expert tensors (E x F float32,
    128 KB) outgrow the 64 KB chunk target, as real Mixtral's do: most
    chunks fall inside one expert's tensor and route privately."""
    rng = np.random.default_rng(seed)
    D = E // H

    def w(*shape):
        return rng.normal(0, 0.02, shape).astype(np.float32)

    t = {"model.embed_tokens.weight": w(V, E),
         "model.norm.weight": np.ones(E, np.float32),
         "lm_head.weight": w(V, E)}
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = np.ones(E, np.float32)
        t[p + "post_attention_layernorm.weight"] = np.ones(E, np.float32)
        t[p + "self_attn.q_proj.weight"] = w(H * D, E)
        t[p + "self_attn.k_proj.weight"] = w(KV * D, E)
        t[p + "self_attn.v_proj.weight"] = w(KV * D, E)
        t[p + "self_attn.o_proj.weight"] = w(E, H * D)
        t[p + "block_sparse_moe.gate.weight"] = w(X, E)
        for x in range(X):
            ep = f"{p}block_sparse_moe.experts.{x}."
            t[ep + "w1.weight"] = w(F, E)
            t[ep + "w2.weight"] = w(E, F)
            t[ep + "w3.weight"] = w(F, E)
    cfg = dict(model_type="mixtral", vocab_size=V, hidden_size=E,
               intermediate_size=F, num_hidden_layers=L,
               num_attention_heads=H, num_key_value_heads=KV,
               max_position_embeddings=64, num_local_experts=X,
               num_experts_per_tok=2, rms_norm_eps=1e-5, rope_theta=1e4)
    return {"config.json": json.dumps(cfg).encode(),
            "model.safetensors": _safetensors_blob(t)}


FILES = _mixtral_files()
DATA = FILES["model.safetensors"]


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO, FILES, chunks_per_xorb=2)) as h:
        yield h


def _rec(hub):
    r = hub.repos[REPO]
    return r.reconstructions[r.files["model.safetensors"].xet_hash]


def _routed(hub, num_hosts=4, n_experts=4):
    rec = _rec(hub)
    header = parse_header_prefix(DATA[:1 << 20])
    placement = ExpertPlacement(n_experts, num_hosts)
    fm = classify_file(rec, header, moe.expert_of_tensor)
    return rec, placement, ExpertRoutedPlan.build([fm], placement)


def _units(assignments):
    return {(a.hash_hex, a.fetch_info.range.start) for a in assignments}


def test_placement_contiguous_blocks():
    pl = ExpertPlacement(n_experts=8, num_hosts=4)
    assert [pl.host_of_expert(x) for x in range(8)] == [0, 0, 1, 1, 2, 2,
                                                        3, 3]
    assert pl.experts_of_host(2) == [4, 5]
    assert sorted(x for h in range(4) for x in pl.experts_of_host(h)) == \
        list(range(8))
    ref = j_expert.ExpertPlacement(8, 4)
    assert [pl.experts_of_host(h) for h in range(4)] == [
        ref.experts_of_host(h) for h in range(4)]


def test_placement_more_hosts_than_experts_and_bad_input():
    pl = ExpertPlacement(n_experts=2, num_hosts=8)
    assert (pl.host_of_expert(0), pl.host_of_expert(1)) == (0, 4)
    with pytest.raises(ValueError):
        pl.host_of_expert(2)
    with pytest.raises(ValueError, match="positive"):
        ExpertPlacement(0, 4)


def test_routed_plan_partitions_all_units(hub):
    rec, placement, routed = _routed(hub)
    base = _units(DistributionPlan.build([rec], 4).assignments)
    shared = _units(routed.shared.assignments)
    expert = _units(a for u in routed.expert_units.values() for a in u)
    assert shared | expert == base and not shared & expert
    assert routed.expert_units


def test_routed_plan_units_on_consuming_host(hub):
    _rec_, placement, routed = _routed(hub)
    for host, units in routed.expert_units.items():
        assert placement.experts_of_host(host)
        assert all(a.owner == host for a in units)


def test_units_for_host_cover_everything_once(hub):
    rec, placement, routed = _routed(hub)
    seen = [(a.hash_hex, a.fetch_info.range.start)
            for h in range(4) for a in routed.units_for_host(h)]
    assert len(seen) == len(set(seen)) == len(
        DistributionPlan.build([rec], 4).assignments)


def test_routed_plan_saves_gather_bytes(hub):
    s = _routed(hub)[2].summary()
    assert s["expert_bytes"] > 0
    assert s["ici_bytes_saved"] == s["expert_bytes"] * 3
    assert s["expert_bytes"] > s["shared"]["total_bytes"]


def test_single_host_routed_plan_degenerates(hub):
    rec, _placement, routed = _routed(hub, num_hosts=1)
    assert len(routed.units_for_host(0)) == len(
        DistributionPlan.build([rec], 1).assignments)


@pytest.mark.parametrize("hosts", [1, 2, 4, 8])
def test_routed_plan_equals_reference(hub, hosts):
    rec, _p, routed = _routed(hub, num_hosts=hosts)
    jheader = j_parse_header(DATA)
    jfm = j_expert.classify_file(rec, jheader, j_moe.expert_of_tensor)
    jrouted = j_expert.ExpertRoutedPlan.build(
        [jfm], j_expert.ExpertPlacement(4, hosts))
    assert routed.summary() == jrouted.summary()

    def rows(assignments):
        return [(a.hash_hex, a.fetch_info.range.start,
                 a.fetch_info.range.end, a.owner) for a in assignments]

    assert rows(routed.shared.assignments) == rows(jrouted.shared.assignments)
    assert {h: rows(u) for h, u in routed.expert_units.items()} == {
        h: rows(u) for h, u in jrouted.expert_units.items()}
    assert [list(s) for s in classify_file(
        rec, parse_header(DATA), moe.expert_of_tensor).tensor_experts] == [
        list(s) for s in jfm.tensor_experts]


def _cfg(hub, root, **kw):
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _jcfg(hub, root, **kw):
    return JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                   hf_token="hf_test", endpoint=hub.url, **kw)


def _bridges(hub, root):
    b = XetBridge(_cfg(hub, root / "p"))
    b.authenticate(REPO)
    jb = JXetBridge(_jcfg(hub, root / "j"))
    jb.authenticate(REPO)
    return b, jb, b.get_reconstruction(
        hub.repos[REPO].files["model.safetensors"].xet_hash)


def _maps(b, jb, rec):
    fm = classify_file(rec, pod.fetch_file_header(b, rec),
                       moe.expert_of_tensor)
    jfm = j_expert.classify_file(rec, j_pod.fetch_file_header(jb, rec),
                                 j_moe.expert_of_tensor)
    return fm, jfm


def _untimed(stats):
    if isinstance(stats, dict):
        return {k: _untimed(v) for k, v in stats.items() if k not in TIMES}
    return stats


def _entries(cfg):
    root = cfg.xorb_cache_dir()
    return {f.name: f.read_bytes() for f in root.rglob("*") if f.is_file()}


def test_expert_pod_round_matches_reference(hub, tmp_path):
    b, jb, rec = _bridges(hub, tmp_path)
    fm, jfm = _maps(b, jb, rec)
    stats = pod.expert_pod_round(b, [fm], ExpertPlacement(4, 8),
                                 mesh=pod_mesh(["cpu"] * 8))
    ref = j_pod.expert_pod_round(jb, [jfm], j_expert.ExpertPlacement(4, 8))
    assert _untimed(stats) == _untimed(ref)
    assert stats["expert_units_fetched"] > 0
    assert stats["expert_units_failed"] == 0
    assert stats["ici_bytes_saved"] > 0
    assert stats["shared"]["filled"] == stats["shared"]["units"] > 0
    assert _entries(b.cfg) == _entries(jb.cfg)


def test_failed_expert_unit_counted_as_reference(hub, tmp_path,
                                                 monkeypatch):
    b, jb, rec = _bridges(hub, tmp_path)
    fm, jfm = _maps(b, jb, rec)
    routed = ExpertRoutedPlan.build([fm], ExpertPlacement(4, 8))
    victim = next(a.hash_hex for u in routed.expert_units.values()
                  for a in u)
    fetch, jfetch = b.fetch_unit, jb.fetch_unit

    def flaky(hash_hex, fi, *a, **k):
        if hash_hex == victim:
            raise BridgeError("unit unavailable")
        return fetch(hash_hex, fi, *a, **k)

    def jflaky(hash_hex, fi, *a, **k):
        if hash_hex == victim:
            raise RuntimeError("unit unavailable")
        return jfetch(hash_hex, fi, *a, **k)

    monkeypatch.setattr(b, "fetch_unit", flaky)
    monkeypatch.setattr(jb, "fetch_unit", jflaky)
    stats = pod.expert_pod_round(b, [fm], ExpertPlacement(4, 8),
                                 mesh=pod_mesh(["cpu"] * 8))
    ref = j_pod.expert_pod_round(jb, [jfm], j_expert.ExpertPlacement(4, 8))
    assert stats["expert_units_failed"] == ref["expert_units_failed"] >= 1
    assert stats["expert_units_fetched"] == ref["expert_units_fetched"]

    def broken(hash_hex, fi, *a, **k):
        raise TypeError("not a fetch error")

    monkeypatch.setattr(b, "fetch_unit", broken)
    with pytest.raises(TypeError, match="not a fetch error"):
        pod.expert_pod_round(b, [fm], ExpertPlacement(4, 1),
                             mesh=pod_mesh(["cpu"]))


def test_raising_verifier_surfaces(hub, tmp_path, monkeypatch):
    b, jb, rec = _bridges(hub, tmp_path)
    fm, _jfm = _maps(b, jb, rec)

    def verifier(**_k):
        def verify(hash_hex, data):
            raise RuntimeError("kernel launch failed")
        return verify

    monkeypatch.setattr(pod, "make_unit_verifier", verifier)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        pod.expert_pod_round(b, [fm], ExpertPlacement(4, 8),
                             mesh=pod_mesh(["cpu"] * 8))


AXES = {"data": 2, "expert": 4}


def _pulls(hub, root, **kw):
    res = pull_model(_cfg(hub, root / "p"), REPO, device="cpu", pod=True,
                     mesh=model_mesh(AXES, ["cpu"] * 8), no_p2p=True,
                     log=_quiet, **kw)
    jres = j_pull.pull_model(_jcfg(hub, root / "j",
                                   mesh=JMesh(mesh_axes=AXES)),
                             REPO, device="tpu", pod=True, no_p2p=True,
                             log=_quiet)
    return res, jres


def test_pull_takes_the_expert_round_as_reference(hub, tmp_path):
    res, jres = _pulls(hub, tmp_path)
    st, jst = res.stats["pod"], jres.stats["pod"]
    assert st["expert_routed"] is jst["expert_routed"] is True
    assert st["n_experts"] == jst["n_experts"] == 4
    assert _untimed(st) == _untimed(jst)
    assert res.stats["fetch"]["bytes"]["cdn"] == \
        jres.stats["fetch"]["bytes"]["cdn"]
    assert loader.params_digest(res.params) == j_loader.params_digest(
        jres.params)


def test_pre_pass_degrades_only_on_fetch_or_parse_errors(hub, tmp_path,
                                                         monkeypatch):
    lines, calls = [], []
    real = port_pull.fetch_file_header

    def bad_header(bridge, rec):
        calls.append(rec)
        if len(calls) == 1:  # the pre-pass's; the landing's reads it
            raise ValueError("not a safetensors file")
        return real(bridge, rec)

    monkeypatch.setattr(port_pull, "fetch_file_header", bad_header)
    res = pull_model(_cfg(hub, tmp_path / "a"), REPO, device="cpu",
                     pod=True, mesh=model_mesh(AXES, ["cpu"] * 8),
                     no_p2p=True, log=lambda *a, **k: lines.append(a[0]))
    st = res.stats["pod"]
    assert "expert_routed" not in st and st["slots"] == 8
    assert st["filled"] == st["units"] > 0
    assert any("expert routing unavailable" in line for line in lines)

    def broken(bridge, rec):
        raise KeyError("a bug, not a fetch error")

    monkeypatch.setattr(port_pull, "fetch_file_header", broken)
    with pytest.raises(KeyError, match="a bug"):
        pull_model(_cfg(hub, tmp_path / "b"), REPO, device="cpu", pod=True,
                   mesh=model_mesh(AXES, ["cpu"] * 8), no_p2p=True,
                   log=_quiet)


def test_land_moe_expert_sharded_matches_reference(hub, tmp_path):
    b, jb, rec = _bridges(hub, tmp_path)
    warm_units_parallel(b, [rec])
    j_warm_units_parallel(jb, [rec])
    header = pod.fetch_file_header(b, rec)
    jheader = j_pod.fetch_file_header(jb, rec)
    cfg = moe.MoEConfig.from_hf(json.loads(FILES["config.json"]))
    jcfg = j_moe.MoEConfig.from_hf(json.loads(FILES["config.json"]))
    mesh = model_mesh({"expert": 4}, ["cpu"] * 4)
    tree = direct.land_moe_expert_sharded(b.cache, [(rec, header)], cfg,
                                          mesh, ExpertPlacement(4, 4))
    jmesh = j_model_mesh({"expert": 4}, jax.devices()[:4])
    jtree = j_direct.land_moe_expert_sharded(
        jb.cache, [(rec, jheader)], jcfg, jmesh,
        j_expert.ExpertPlacement(4, 4))
    devices = jax.devices()

    def walk(mine, ref, path=""):
        if isinstance(ref, dict):
            assert set(mine) == set(ref), path
            for k in ref:
                walk(mine[k], ref[k], f"{path}.{k}")
            return
        shards = {devices.index(s.device): np.asarray(s.data)
                  for s in ref.addressable_shards}
        assert set(shards) == set(mine.shards), path
        for slot, want in shards.items():
            assert np.array_equal(mine.shard(slot).numpy(), want), (path,
                                                                   slot)

    walk(tree, jtree)
    pl = ExpertPlacement(4, 4)
    w1 = tree["blocks"]["moe"]["w1"]
    for slot in range(4):
        assert w1.shard(slot).shape[1] == 1
        assert pl.experts_of_host(slot) == [slot]
    with pytest.raises(direct.DirectLandingError, match="placement"):
        direct.land_moe_expert_sharded(b.cache, [(rec, header)], cfg, mesh,
                                       ExpertPlacement(8, 4))
