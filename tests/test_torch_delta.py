"""The port's delta pull and hot-swap against the JAX package's, on the CPU.

Mirrors tests/test_delta.py on a smaller cut of its fixture
(``llama_checkpoint_files(0.006, shard_bytes=1 MiB, scale=16)``: three
layers in eight shards of bf16 random bytes, revision B with ~1% of the
bytes flipped in place), the JAX package's ``pull_model(device="tpu")``
under ``JAX_PLATFORMS=cpu`` as the oracle:

- ``find_base_manifest`` over one manifests directory (closest ancestor,
  never a descendant, newest mtime without lineage), ``tensor_fingerprints``,
  ``unchanged_tensor_names`` and ``build_plan(...).summary()`` equal the
  reference's;
- a streamed and a stream-off hot-swap: ``params_digest`` equal to the
  reference's swap and to the port's own cold pull of B, ``stats["delta"]``
  and ``hbm.swap`` equal to the reference's, reused tensors are the base's
  objects, the base dict emptied, the files exact. That comparison runs on
  the same revisions packed one chunk per xorb, where the reference's
  fingerprints see every unchanged chunk; packed eight chunks per xorb the
  port reuses a superset (``delta.aligned_tensor_names``: the cached chunk
  tables prove tensors in the cut xorbs unchanged), and still lands the
  reference's tree;
- the dtype guard, ``base_params`` without ``base_revision``, the degraded
  pulls (no base manifest, a complete snapshot), ``ZEST_DELTA=0``;
- a corrupt owner serving changed units over the cooperative exchange:
  rejected at receipt, healed from the CDN, the swap exact; the coop plan
  over the changed units agrees with the reference's fingerprint;
- ``diff`` on the CLI fetches no payload and prints the reference's plan;
- a swap whose commit fails after its first group (streamed, stream-off,
  and through ``watch_and_swap``): the caller's dict holds every reused
  tensor as the same object, and the ``DeltaSwapError`` names exactly the
  base tensors a committed group superseded.
"""

from __future__ import annotations

import json
import os
import random
import time

import pytest
import torch

from tests.fixtures import FixtureHub, FixtureRepo
from zest_tpu.bench_scale import llama_checkpoint_files
from zest_tpu.config import Config as JConfig
from zest_tpu.models import loader as j_loader
from zest_tpu.models.safetensors_io import parse_header as j_parse_header
from zest_tpu.parallel.plan import collect_units as j_collect_units
from zest_tpu.storage import XorbCache as JXorbCache
from zest_tpu.transfer import coop as j_coop
from zest_tpu.transfer import delta as j_delta
from zest_tpu.transfer import pull as j_pull
from zest_tpu_torch import telemetry
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import loader
from zest_tpu_torch.models.safetensors_io import parse_header
from zest_tpu_torch.parallel.plan import collect_units
from zest_tpu_torch.storage import XorbCache
from zest_tpu_torch.transfer import coop, delta
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.dcn import DcnServer
from zest_tpu_torch.transfer.federated import warm_units_parallel
from zest_tpu_torch.transfer.pull import pull_model

REPO = "acme/delta"
REPO_1 = "acme/delta-1"  # another seed, one chunk per xorb


def _files(gb: float, seed: int, mutate: float | None = None
           ) -> dict[str, bytes]:
    return llama_checkpoint_files(gb, seed=seed, shard_bytes=1024 * 1024,
                                  scale=16, mutate_fraction=mutate)


FILES_A, FILES_B = _files(0.006, 0), _files(0.006, 0, 0.01)  # 30 tensors
# The same geometry with its own bytes (file hashes do not depend on the
# xorb packing, and the hub answers a reconstruction by file hash).
FILES_A1, FILES_B1 = _files(0.006, 1), _files(0.006, 1, 0.01)
SHARDS = sorted(n for n in FILES_A if n.endswith(".safetensors"))
SHA_A = "f1x7ure5ha" + "0" * 30  # FixtureRepo's default commit sha
SHA_B = "b" * 40
# Port-only pull stats: the device name and the whole-file fallbacks.
PORT_ONLY = {"device", "fallback_files"}


def _make_repo(repo_id=REPO, chunks_per_xorb=8, files=(FILES_A, FILES_B)
               ) -> FixtureRepo:
    repo = FixtureRepo(repo_id, files[0], chunks_per_xorb=chunks_per_xorb)
    repo.add_revision(files[1], commit_sha=SHA_B)
    return repo


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(_make_repo(),
                    _make_repo(REPO_1, 1, (FILES_A1, FILES_B1))) as h:
        yield h


def _quiet(*a, **k):
    pass


def _cfg(hub, root, **kw) -> Config:
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _pull(hub, root, revision, cfg_kw=None, repo=REPO, **kw):
    kw.setdefault("log", _quiet)
    kw.setdefault("no_p2p", True)  # as the reference pull below
    return pull_model(_cfg(hub, root, **(cfg_kw or {})), repo,
                      revision=revision, device="cpu", **kw)


def _ref_pull(hub, root, revision, cfg_kw=None, repo=REPO, **kw):
    return j_pull.pull_model(
        JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                hf_token="hf_test", endpoint=hub.url, **(cfg_kw or {})),
        repo, revision=revision, device="tpu", pod=False, no_p2p=True,
        log=_quiet, **kw)


def _assert_files_exact(res, files=FILES_B):
    for name, data in files.items():
        assert (res.snapshot_dir / name).read_bytes() == data, name


def _base_manifest(repo) -> dict:
    return {"format": 1, "repo": REPO, "revision": SHA_A, "files": {
        s: {"terms": delta.terms_of(
            repo.reconstructions[repo.revisions[SHA_A][s].xet_hash])}
        for s in SHARDS}}


def _recs_b(repo):
    return [repo.reconstructions[repo.revisions[SHA_B][s].xet_hash]
            for s in SHARDS]


# ── Manifests and base selection ──


def test_manifest_roundtrip_and_base_resolution(tmp_path):
    repo = _make_repo()
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    jcfg = JConfig(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    ff = repo.revisions[SHA_A][SHARDS[0]]
    rec = repo.reconstructions[ff.xet_hash]

    class E:
        path, size, xet_hash, is_xet = SHARDS[0], len(ff.data), \
            ff.xet_hash, True

    assert delta.save_manifest(cfg, REPO, SHA_A, [E], lambda e: rec)
    man = delta.load_manifest(cfg, REPO, SHA_A)
    assert man == j_delta.load_manifest(jcfg, REPO, SHA_A)
    assert man["files"][SHARDS[0]]["terms"] == j_delta.terms_of(rec)
    for args in ((SHA_B, SHA_A), (SHA_B, None), (SHA_A, None)):
        assert delta.find_base_manifest(cfg, REPO, *args) == \
            j_delta.find_base_manifest(jcfg, REPO, *args)
    assert delta.find_base_manifest(cfg, REPO, SHA_A) is None
    # A ref name resolves through the refs file.
    from zest_tpu_torch import storage

    storage.write_ref(cfg, REPO, "main", SHA_A)
    assert delta.find_base_manifest(cfg, REPO, SHA_B, "main") == man
    assert not delta.save_manifest(cfg, REPO, "x" * 40, [E], lambda e: None)
    assert delta.load_manifest(cfg, REPO, "x" * 40) is None


def _write_manifest(cfg, repo, sha, parent=None, mtime=None):
    doc = {"format": delta.MANIFEST_FORMAT, "repo": repo, "revision": sha,
           "saved_at": 0.0, "files": {"model.safetensors": {
               "size": 4, "xet_hash": "ab" * 32, "terms": []}}}
    if parent:
        doc["parent"] = parent
    path = delta.manifest_path(cfg, repo, sha)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc))
    if mtime is not None:
        os.utime(path, (mtime, mtime))


A, B, C, D = ("a" * 40), ("b" * 40), ("c" * 40), ("d" * 40)
# (manifests as (sha, parent, mtime), shas deleted afterwards, target,
# expected base): the closest ancestor beats the newest; a broken chain
# falls back to the newest non-descendant; a descendant never wins; no
# lineage keeps newest-mtime order; a cyclic chain neither hangs nor
# crashes.
BASE_CASES = {
    "closest_ancestor": ([(A, None, 1_000_300), (B, A, 1_000_010),
                          (C, B, 1_000_020), (D, C, 1_000_030)], (), D, C),
    "broken_chain": ([(A, None, 1_000_300), (B, A, 1_000_010),
                      (C, B, 1_000_020), (D, C, 1_000_030)], (C,), D, A),
    "descendant": ([(A, None, 1_000_000), (C, B, 1_000_500)], (), B, A),
    "only_descendant": ([(A, None, 1_000_000), (C, B, 1_000_500)], (A,), B,
                        None),
    "no_lineage": ([("1" * 40, None, 1_000_000),
                    ("2" * 40, None, 1_000_100)], (), "9" * 40, "2" * 40),
    "cyclic": ([("1" * 40, "2" * 40, 1_000_000),
                ("2" * 40, "1" * 40, 1_000_100)], (), "9" * 40, "2" * 40),
}


@pytest.mark.parametrize("case", sorted(BASE_CASES))
def test_find_base_matches_reference(tmp_path, case):
    manifests, deleted, target, want = BASE_CASES[case]
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    jcfg = JConfig(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    for sha, parent, mtime in manifests:
        _write_manifest(cfg, "acme/lineage", sha, parent, mtime)
    for sha in deleted:
        delta.manifest_path(cfg, "acme/lineage", sha).unlink()
    got = delta.find_base_manifest(cfg, "acme/lineage", target)
    ref = j_delta.find_base_manifest(jcfg, "acme/lineage", target)
    assert (got or {}).get("revision") == (ref or {}).get("revision") == want


# ── Fingerprints and the plan ──


def test_tensor_fingerprints_match_reference():
    repo = _make_repo()
    changed, reused = set(), set()
    for shard in SHARDS:
        fa = repo.revisions[SHA_A][shard]
        fb = repo.revisions[SHA_B][shard]
        rec_a = repo.reconstructions[fa.xet_hash]
        rec_b = repo.reconstructions[fb.xet_hash]
        header, j_header = parse_header(fb.data), j_parse_header(fb.data)
        terms_a = delta.terms_of(rec_a)
        assert delta.tensor_fingerprints(terms_a, header) == \
            j_delta.tensor_fingerprints(terms_a, j_header)
        assert delta._canonical_segments(terms_a) == \
            j_delta._canonical_segments(terms_a)
        got = delta.unchanged_tensor_names(terms_a, rec_b, header)
        assert got == j_delta.unchanged_tensor_names(terms_a, rec_b,
                                                     j_header)
        for name, info in header.tensors.items():
            lo, hi = info.file_range(header.data_start)
            if fa.data[lo:hi] != fb.data[lo:hi]:
                assert name not in got, name
                changed.add(name)
            elif name in got:
                reused.add(name)
    assert changed and reused
    rec = repo.reconstructions[repo.revisions[SHA_A][SHARDS[0]].xet_hash]
    header = parse_header(repo.revisions[SHA_A][SHARDS[0]].data)
    assert delta.unchanged_tensor_names(delta.terms_of(rec), rec,
                                        header) == set(header.tensors)


def test_plan_summary_matches_reference(hub, tmp_path):
    """Cold and against a warm cache of A: the port's plan equals the
    reference's dict for dict, and its classification does not depend on
    the cache."""
    repo = hub.repos[REPO]
    base = _base_manifest(repo)
    recs = _recs_b(repo)
    files_terms = [(s, delta.terms_of(r)) for s, r in zip(SHARDS, recs)]
    units = [(hh, fi) for (hh, _s), fi in collect_units(recs)]
    j_units = [(hh, fi) for (hh, _s), fi in j_collect_units(recs)]
    cold = delta.build_plan(base, files_terms, units=units)
    j_cold = j_delta.build_plan(base, files_terms, units=j_units)
    assert cold.summary() == j_cold.summary()
    assert cold.changed_keys == j_cold.changed_keys
    assert 0 < cold.delta_bytes_ratio < 0.10
    _pull(hub, tmp_path, SHA_A)
    warm = delta.build_plan(base, files_terms, units=units,
                            cache=XorbCache(_cfg(hub, tmp_path)))
    j_warm = j_delta.build_plan(
        base, files_terms, units=j_units,
        cache=JXorbCache(JConfig(hf_home=tmp_path / "hf",
                                 cache_dir=tmp_path / "zest")))
    assert warm.summary() == j_warm.summary()
    assert warm.reused_local_keys == j_warm.reused_local_keys
    assert warm.changed_keys == cold.changed_keys
    assert warm.stale_units == 0 and warm.reused_local_keys
    assert cold.changed_units == sorted(
        cold.changed_units, key=lambda u: (u[0], u[1].range.start))
    assert delta.format_diff({**cold.summary(), "base": "a", "target": "b"}
                             ) == j_delta.format_diff(
        {**j_cold.summary(), "base": "a", "target": "b"})


def test_coop_plan_over_changed_units_fingerprint_agrees(hub):
    repo = hub.repos[REPO]
    recs = _recs_b(repo)
    base = _base_manifest(repo)
    files_terms = [(s, delta.terms_of(r)) for s, r in zip(SHARDS, recs)]
    plan = delta.build_plan(base, files_terms, units=[
        (hh, fi) for (hh, _s), fi in collect_units(recs)])
    j_plan = j_delta.build_plan(base, files_terms, units=[
        (hh, fi) for (hh, _s), fi in j_collect_units(recs)])
    assert plan.changed_units
    p1 = coop.CoopPlan.build(recs, 4, units=plan.changed_units)
    shuffled = list(plan.changed_units)
    random.Random(7).shuffle(shuffled)
    p2 = coop.CoopPlan.build(list(reversed(recs)), 4, units=shuffled)
    ref = j_coop.CoopPlan.build(recs, 4, units=j_plan.changed_units)
    assert p1.fingerprint() == p2.fingerprint() == ref.fingerprint()
    assert len(p1.units) == len(plan.changed_units)
    assert p1.fingerprint() != coop.CoopPlan.build(recs, 4).fingerprint()


# ── End to end: the hot-swap against the reference ──


def _swap(pull, hub, root, cfg_kw=None, repo=REPO):
    """Pull A, then B over it with A's tree as the base: ``(A's tree as
    it was, the swap's result, the base dict afterwards)``."""
    res_a = pull(hub, root, SHA_A, cfg_kw=cfg_kw, repo=repo)
    base = res_a.params
    before = dict(base)
    res_b = pull(hub, root, SHA_B, cfg_kw=cfg_kw, repo=repo,
                 base_params=base, base_revision=SHA_A)
    return before, res_b, base


def _reused(before: dict, res) -> set[str]:
    return {n for n, t in res.params.items() if before.get(n) is t}


@pytest.mark.parametrize("land_stream", [True, False],
                         ids=["streamed", "stream_off"])
def test_hot_swap_matches_reference(hub, tmp_path, land_stream):
    kw = {"land_stream": land_stream}
    before, res, base = _swap(_pull, hub, tmp_path / "port", kw, REPO_1)
    j_before, ref, j_base = _swap(_ref_pull, hub, tmp_path / "ref", kw,
                                  REPO_1)
    cold = _pull(hub, tmp_path / "cold", SHA_B, cfg_kw=kw, repo=REPO_1)
    st, j_st = res.stats, ref.stats

    digest = loader.params_digest(res.params)
    assert digest == j_loader.params_digest(ref.params)
    assert digest == loader.params_digest(cold.params)
    assert st["delta"] == j_st["delta"]
    assert st["hbm"]["swap"] == j_st["hbm"]["swap"]
    assert set(st) - PORT_ONLY == set(j_st)
    assert st["time_to_swap_s"] == st["time_to_hbm_s"]
    assert st["delta"]["fetched_bytes"] == st["fetch"]["bytes"]["cdn"]
    assert st["fetch"]["bytes"]["cdn"] < 0.10 * sum(
        map(len, FILES_B1.values()))

    reused = _reused(before, res)
    assert reused == _reused(j_before, ref)
    assert 0 < len(reused) == st["hbm"]["swap"]["reused_tensors"] \
        == st["delta"]["tensors"]["reused"]
    assert not base and not j_base, "the base dict is consumed"
    # Delta shards come from the cache lane, the others from the landing.
    _assert_files_exact(res, FILES_B1)
    lanes = st["files_pipeline"]["lane_bytes"]
    assert lanes.get("copy", 0) + lanes.get("decode", 0) > 0
    # A cold pull in a fresh cache has no evidence: no delta keys.
    assert "delta" not in cold.stats and "time_to_swap_s" not in cold.stats


def test_hot_swap_reuses_aligned_tensors_beyond_reference(hub, tmp_path):
    """Eight chunks per xorb: B's terms cut A's xorbs around each edit,
    which changes the canonical segment of every tensor in a cut xorb.
    The reference re-lands those; the port proves the unchanged ones from
    the cached chunk tables and reuses them. Same tree either way."""
    before, res, base = _swap(_pull, hub, tmp_path / "port")
    j_before, ref, _j_base = _swap(_ref_pull, hub, tmp_path / "ref")
    cold = _pull(hub, tmp_path / "cold", SHA_B)
    digest = loader.params_digest(res.params)
    assert digest == j_loader.params_digest(ref.params) == \
        loader.params_digest(cold.params)
    mine, theirs = _reused(before, res), _reused(j_before, ref)
    assert theirs < mine, (sorted(theirs), sorted(mine))
    assert len(mine) == res.stats["hbm"]["swap"]["reused_tensors"]
    assert res.stats["delta"] == {
        **ref.stats["delta"], "tensors": {"reused": len(mine),
                                          "landed": 30 - len(mine)}}
    assert not base
    # Every tensor the port reused holds B's bytes.
    for name in mine:
        assert torch.equal(res.params[name].view(torch.uint8),
                           cold.params[name].view(torch.uint8)), name
    _assert_files_exact(res)


def test_phase_5b_fine_tune_lands_only_the_boundary_tensors(tmp_path):
    """``chip_smoke.py`` phase 5b's revision on a 192-wide, 12-layer GPT-2
    (one xorb): B's push cuts A's xorb around the edits, so the
    reference's fingerprints reuse none of the 148 tensors; the chunk
    tables prove 138 unchanged and leave the 4 redrawn tensors and the 6
    that share their boundary chunks."""
    import chip_smoke
    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.cas import reconstruction as recon
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.transfer.pull import _chunk_table
    from zest_tpu_torch.transfer.push import push_checkpoint

    gpt2 = dict(chip_smoke.GPT2_CONFIG, vocab_size=512, n_embd=192,
                n_positions=64, n_ctx=64)
    a = chip_smoke.gpt2_checkpoint(0, gpt2)
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    shas = []
    for name, tensors in (("a", a), ("b", chip_smoke.revision_b(a, 1))):
        ckpt = tmp_path / name
        ckpt.mkdir()
        write_safetensors(ckpt / "model.safetensors", tensors)
        shas.append(push_checkpoint(
            cfg, "org/gpt2", ckpt, device="cpu", notify=False,
            base_revision=shas[0] if shas else None, log=_quiet).revision)
    terms_a, terms_b = (delta.load_manifest(cfg, "org/gpt2", sha)["files"][
        "model.safetensors"]["terms"] for sha in shas)
    rec_b = recon.Reconstruction(
        file_hash=b"\0" * 32, fetch_info={}, terms=[
            recon.Term(xorb_hash=hashing.hex_to_hash(hh),
                       range=recon.ChunkRange(s, e), unpacked_length=n)
            for hh, s, e, n in terms_b])
    header = parse_header((tmp_path / "b" / "model.safetensors").read_bytes())
    assert len({t[0] for t in terms_a}) == 1 and len(header.tensors) == 148
    cache = XorbCache(cfg)
    assert delta.unchanged_tensor_names(terms_a, rec_b, header) == set()
    same = delta.aligned_tensor_names(terms_a, rec_b, header,
                                      lambda hh: _chunk_table(cache, hh))
    assert set(header.tensors) - same == set(chip_smoke.REDRAWN) | {
        "h.11.attn.c_proj.weight", "h.11.attn.c_proj.bias",
        "h.11.ln_2.weight", "h.11.ln_2.bias", "h.11.mlp.c_fc.bias",
        "h.11.mlp.c_proj.bias"}


def test_aligned_names_need_agreeing_chunk_tables(hub, tmp_path):
    """The alignment proof reads the chunk tables of the cache: without
    them it proves nothing, and a table that disagrees with a term's
    length (a corrupt entry) is not used."""
    repo = hub.repos[REPO]
    _pull(hub, tmp_path, SHA_A)
    cache = XorbCache(_cfg(hub, tmp_path))
    from zest_tpu_torch.transfer.pull import _chunk_table

    tables = {}
    for shard in SHARDS:
        rec_b = repo.reconstructions[repo.revisions[SHA_B][shard].xet_hash]
        terms_a = delta.terms_of(
            repo.reconstructions[repo.revisions[SHA_A][shard].xet_hash])
        header = parse_header(repo.revisions[SHA_B][shard].data)
        got = delta.aligned_tensor_names(
            terms_a, rec_b, header,
            lambda hh: tables.setdefault(hh, _chunk_table(cache, hh)))
        assert delta.unchanged_tensor_names(terms_a, rec_b, header) <= got
        assert delta.aligned_tensor_names(terms_a, rec_b, header,
                                          lambda hh: None) == set()
        skewed = delta.aligned_tensor_names(
            terms_a, rec_b, header,
            lambda hh: None if tables.get(hh) is None
            else tables[hh] + 1)
        assert skewed == set()


def test_dtype_mismatch_reuses_nothing(hub, tmp_path):
    """A base tree landed at another dtype than this pull's: nothing is
    reused, the base is still consumed, and the tree equals a cold pull
    at the new dtype, as the reference's does."""
    kw = {"land_dtype": "f32"}
    res_a = _pull(hub, tmp_path / "d", SHA_A)  # the checkpoint's bf16
    base = res_a.params
    res = _pull(hub, tmp_path / "d", SHA_B, cfg_kw=kw, base_params=base,
                base_revision=SHA_A)
    ref_a = _ref_pull(hub, tmp_path / "r", SHA_A)
    ref = _ref_pull(hub, tmp_path / "r", SHA_B, cfg_kw=kw,
                    base_params=ref_a.params, base_revision=SHA_A)
    cold = _pull(hub, tmp_path / "cold", SHA_B, cfg_kw=kw)
    assert res.stats["hbm"]["swap"] == ref.stats["hbm"]["swap"]
    assert res.stats["hbm"]["swap"]["reused_tensors"] == 0
    assert not base
    assert res.stats["time_to_swap_s"] is not None
    assert loader.params_digest(res.params) == loader.params_digest(
        cold.params) == j_loader.params_digest(ref.params)


def test_base_on_another_device_is_not_reused(hub, tmp_path):
    """A base tensor the landing would not give this device (here on
    ``meta``) is never reused: the swap lands every tensor and still
    consumes the base."""
    res_a = _pull(hub, tmp_path / "d", SHA_A)
    base = {n: t.to("meta") for n, t in res_a.params.items()}
    res = _pull(hub, tmp_path / "d", SHA_B, base_params=base,
                base_revision=SHA_A)
    assert res.stats["hbm"]["swap"]["reused_tensors"] == 0
    assert not base
    assert all(t.device.type == "cpu" for t in res.params.values())
    assert loader.params_digest(res.params) == loader.params_digest(
        _pull(hub, tmp_path / "cold", SHA_B).params)


@pytest.mark.parametrize("error,degrades", [
    (ValueError("manifest terms do not parse"), True),
    (OSError("manifest vanished"), True),
    (RuntimeError("CUDA error: an illegal memory access"), False)])
def test_plan_errors_degrade_only_for_missing_evidence(
        hub, tmp_path, monkeypatch, error, degrades):
    """The reference degrades on any exception of the plan; the port only
    on the errors that mean "no plan" (fetch, OS, parse), so a device or
    programming error fails the pull."""
    res_a = _pull(hub, tmp_path, SHA_A)
    base = res_a.params

    def boom(*a, **k):
        raise error

    monkeypatch.setattr(delta, "build_plan", boom)
    if not degrades:
        with pytest.raises(RuntimeError, match="CUDA error"):
            _pull(hub, tmp_path, SHA_B, base_params=base,
                  base_revision=SHA_A)
        return
    said = []
    res = _pull(hub, tmp_path, SHA_B, base_params=base, base_revision=SHA_A,
                log=lambda *a, **k: said.append(" ".join(map(str, a))))
    assert "delta" not in res.stats and len(base) == 30
    assert any("delta plan unavailable" in m for m in said), said
    _assert_files_exact(res)


def test_base_params_without_base_revision_raises(hub, tmp_path):
    with pytest.raises(ValueError, match="base_revision"):
        _pull(hub, tmp_path, SHA_B, base_params={})
    assert not (tmp_path / "zest").exists()


def _degraded_events() -> list[dict]:
    return [e for e in telemetry.recorder.tail()
            if e["kind"] == "delta_degraded"]


def test_missing_base_manifest_degrades(hub, tmp_path):
    """The revision-A evidence is gone: a full pull that says so, records
    a ``delta_degraded`` flight event as the JAX package does, and leaves
    the base tree untouched."""
    import shutil

    res_a = _pull(hub, tmp_path, SHA_A)
    base = res_a.params
    shutil.rmtree(delta.manifest_dir(_cfg(hub, tmp_path)))
    telemetry.reset_all()
    said = []
    res = _pull(hub, tmp_path, SHA_B, base_params=base, base_revision=SHA_A,
                log=lambda *a, **k: said.append(" ".join(map(str, a))))
    assert "delta" not in res.stats and "time_to_swap_s" not in res.stats
    assert "swap" not in res.stats["hbm"]
    assert base.keys() == res_a.params.keys() and len(base) == 30
    assert any("no base-revision manifest" in s for s in said), said
    (ev,) = _degraded_events()
    assert (ev["repo"], ev["revision"], ev["reason"]) == (
        REPO, SHA_B, "missing rev-A manifest")
    _assert_files_exact(res)


def test_complete_snapshot_degrades_loudly(hub, tmp_path):
    """Both snapshots complete on disk: the direct landing defers to disk
    staging, so the pull says the swap was skipped (and records a
    ``delta_degraded`` flight event) and leaves the base alone instead of
    returning a second tree silently."""
    res_a = _pull(hub, tmp_path, SHA_A)
    _pull(hub, tmp_path, SHA_B).params = None  # materializes B
    base = res_a.params
    telemetry.reset_all()
    said = []
    res = _pull(hub, tmp_path, SHA_B, base_params=base, base_revision=SHA_A,
                log=lambda *a, **k: said.append(" ".join(map(str, a))))
    assert len(base) == 30
    assert "time_to_swap_s" not in res.stats
    assert res.stats["hbm"]["direct"] is False
    assert any("snapshot already materialized" in s for s in said), said
    (ev,) = _degraded_events()
    assert (ev["repo"], ev["revision"], ev["reason"]) == (
        REPO, SHA_B, "snapshot already complete")
    assert loader.params_digest(res.params) == loader.params_digest(
        _pull(hub, tmp_path / "cold", SHA_B).params)


def test_delta_off_writes_no_manifest(hub, tmp_path):
    """``ZEST_DELTA=0``: no plan, no manifest, no swap keys, the base
    ignored; the stats keys of a plain pull."""
    kw = {"delta_pull": False}
    res_a = _pull(hub, tmp_path, SHA_A, cfg_kw=kw)
    base = res_a.params
    res = _pull(hub, tmp_path, SHA_B, cfg_kw=kw, base_params=base,
                base_revision=SHA_A)
    plain = _pull(hub, tmp_path / "plain", SHA_B, cfg_kw=kw)
    assert "delta" not in res.stats and "time_to_swap_s" not in res.stats
    assert "swap" not in res.stats["hbm"]
    assert set(res.stats) == set(plain.stats)
    assert len(base) == 30
    assert not delta.manifest_dir(_cfg(hub, tmp_path)).exists()
    _assert_files_exact(res)


def test_config_delta_and_watch_env_parsing():
    base = {"HF_HOME": "/tmp/x", "ZEST_CACHE_DIR": "/tmp/y"}
    for name, field in (("ZEST_DELTA", "delta_pull"),
                        ("ZEST_WATCH", "watch_enabled")):
        assert getattr(Config.load(base), field) is True
        assert getattr(Config.load({**base, name: "0"}), field) is False
        assert getattr(Config.load({**base, name: "1"}), field) is True
        for bad in ("false", "off"):
            with pytest.raises(ValueError, match=name):
                Config.load({**base, name: bad})
    assert Config.load({**base, "ZEST_DELTA": "0"}).delta_pull == \
        JConfig.load({**base, "ZEST_DELTA": "0"}).delta_pull


# ── Corruption through the delta ──


def test_corrupt_owner_of_changed_units_rejected_and_healed(hub, tmp_path):
    """A cooperative delta pull over two hosts, the other host's cache
    entries of its changed units byte-flipped: the exchange rejects them
    at receipt (the trust boundary), the CDN heals them, and the swap is
    exact with only the changed units planned."""
    owner_cfg = _cfg(hub, tmp_path / "owner", dcn_port=0)
    b0 = XetBridge(owner_cfg)
    b0.authenticate(REPO, SHA_B)
    recs = [b0.get_reconstruction(e.xet_hash)
            for e in HubClient(owner_cfg).list_files(REPO, SHA_B)
            if e.is_xet]
    base = _base_manifest(hub.repos[REPO])
    plan = delta.build_plan(base, [], units=[
        (hh, fi) for (hh, _s), fi in collect_units(recs)])
    owned = coop.CoopPlan.build(recs, 2, units=plan.changed_units
                                ).for_host(0)
    assert owned
    warm_units_parallel(b0, recs, units=owned)
    for hh, fi in owned:
        entry = b0.cache.get_with_range(hh, fi.range.start)
        bad = bytearray(entry.data)
        bad[len(bad) // 2] ^= 0xFF
        b0.cache.put(hh, bytes(bad))
    server = DcnServer(owner_cfg, b0.cache)
    port = server.start()
    try:
        root = tmp_path / "puller"
        res_a = _pull(hub, root, SHA_A)
        base_params = res_a.params
        res = pull_model(_cfg(hub, root, dcn_port=0), REPO, revision=SHA_B,
                         device="cpu", coop=True, coop_hosts=2, coop_index=1,
                         coop_addrs={0: ("127.0.0.1", port)},
                         base_params=base_params, base_revision=SHA_A,
                         log=_quiet)
    finally:
        server.shutdown()
    c = res.stats["coop"]
    assert c["plan"]["units"] == len(plan.changed_units)
    # Measured once: the exchange's wire bytes are booked as peer bytes.
    fetch = res.stats["fetch"]["bytes"]
    assert res.stats["delta"]["fetched_bytes"] == fetch["cdn"] + fetch["peer"]
    assert fetch["peer"] >= c["exchange"]["wire_bytes"]
    assert c["exchange"]["verify_rejected"] >= 1 and c["fallbacks"] >= 1, c
    assert res.stats["hbm"]["swap"]["reused_tensors"] > 0
    assert not base_params
    assert loader.params_digest(res.params) == loader.params_digest(
        _pull(hub, tmp_path / "cold", SHA_B).params)
    _assert_files_exact(res)


# ── ``diff`` on the CLI ──


def test_diff_cli_dry_run_no_payload_fetch(hub, tmp_path, monkeypatch,
                                           capsys):
    from zest_tpu_torch import cli

    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("ZEST_CACHE_DIR", str(tmp_path / "zest"))
    monkeypatch.setenv("HF_TOKEN", "hf_test")
    monkeypatch.setenv("HF_ENDPOINT", hub.url)
    seen = len(hub.requests_seen)
    assert cli.main(["diff", f"{REPO}@{SHA_A}", f"{REPO}@{SHA_B}"]) == 0
    out = capsys.readouterr().out
    assert f"delta {REPO}@{SHA_A} -> {REPO}@{SHA_B}" in out
    assert "bytes changed" in out
    new = hub.requests_seen[seen:]
    assert not any("/xorbs/" in r for r in new), new
    assert any("/v1/reconstructions/" in r for r in new)
    assert cli.main(["diff", f"{REPO}@{SHA_A}", SHA_B, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    ref = j_delta.diff_revisions(
        JConfig(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                hf_token="hf_test", endpoint=hub.url), REPO, SHA_A, REPO,
        SHA_B)
    assert doc == json.loads(json.dumps(ref))
    assert 0 < doc["delta_bytes_ratio"] < 0.10


def test_swap_keeps_reused_tensors_without_a_copy(hub, tmp_path):
    """The streamed swap's reused tensors keep their storage (no commit
    and no cast touched them) and every landed one is new."""
    before, res, _base = _swap(_pull, hub, tmp_path, {})
    for name, t in res.params.items():
        old = before[name]
        if t is old:
            assert t.data_ptr() == old.data_ptr()
        else:
            assert t.data_ptr() != old.data_ptr()
            assert isinstance(t, torch.Tensor) and t.dtype == old.dtype


# ── A swap whose landing fails gives the caller back what it still has ──


class _PopLog(dict):
    """A base dict that records every name popped from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.popped: list[str] = []

    def pop(self, key, *default):
        self.popped.append(key)
        return super().pop(key, *default)


def _fail_after_first_group(monkeypatch, land_stream: bool, base: _PopLog):
    """Make the landing's commit raise at its first call after a committed
    group superseded a base tensor. Returns ``(the reused names, the
    names committed before the failure)``."""
    reused: list[str] = []
    committed: list[str] = []

    def gate(names):
        if not committed:  # the reused tensors left before any commit
            reused.extend(base.popped)
        elif len(base.popped) > len(reused):
            raise RuntimeError("commit failed")
        committed.extend(names)

    if land_stream:
        orig = loader._DeviceCommit.commit

        def commit(self, items):
            gate([it[0] for it in items])
            return orig(self, items)

        monkeypatch.setattr(loader._DeviceCommit, "commit", commit)
    else:
        orig_tensors = loader.commit_tensors

        def commit_tensors(host, *a, **k):
            gate(list(host))
            return orig_tensors(host, *a, **k)

        monkeypatch.setattr(loader, "commit_tensors", commit_tensors)
    return reused, committed


def _assert_base_kept(err, base: dict, before: dict, reused, committed):
    """The caller's dict after a failed swap: every tensor still held is
    A's object, every reused one among them; the error names exactly the
    superseded tensors, each one a committed group had replaced."""
    assert isinstance(err, delta.DeltaSwapError)
    assert str(err.__cause__) == "commit failed"
    assert 0 < err.restored == len(reused)
    assert set(reused) <= set(base)
    assert all(base[n] is before[n] for n in base)
    gone = sorted(set(before) - set(base))
    assert err.gone == gone and gone, "a committed group superseded none"
    assert set(gone) <= set(committed) - set(reused)
    assert set(base) | set(gone) == set(before)
    for name in gone:
        assert name in str(err)


@pytest.mark.parametrize("land_stream", [True, False],
                         ids=["streamed", "stream_off"])
def test_failed_swap_keeps_the_base(hub, tmp_path, monkeypatch,
                                    land_stream):
    """A commit that fails after the first group: the caller's dict holds
    every reused tensor (the same objects) and every base tensor not yet
    superseded, and the error lists the superseded ones. The pull still
    fails (no disk staging)."""
    kw = {"land_stream": land_stream, "land_ring_slots": 4}
    res_a = _pull(hub, tmp_path, SHA_A, cfg_kw=kw)
    base = _PopLog(res_a.params)
    before = dict(base)
    reused, committed = _fail_after_first_group(monkeypatch, land_stream,
                                                base)
    disk = []
    monkeypatch.setattr(loader, "load_checkpoint",
                        lambda *a, **k: disk.append(a))
    with pytest.raises(delta.DeltaSwapError, match="commit failed") as ei:
        _pull(hub, tmp_path, SHA_B, cfg_kw=kw, base_params=base,
              base_revision=SHA_A)
    assert not disk
    _assert_base_kept(ei.value, base, before, reused, committed)


def test_failed_swap_through_watch_and_swap_keeps_the_base(tmp_path,
                                                           monkeypatch):
    """The watcher's swap fails after its first group: ``watch_and_swap``
    raises the same error and the caller's tree is left as above."""
    import threading

    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.transfer.push import push_checkpoint, watch_and_swap

    kw = {"land_ring_slots": 4}
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest")
    sha_a = push_checkpoint(cfg_a, REPO, files=FILES_A, device="cpu",
                            notify=False, log=_quiet).revision
    errors: list = []
    with PublisherServer(cfg_a) as server:
        cfg_s = Config(hf_home=tmp_path / "s" / "hf",
                       cache_dir=tmp_path / "s" / "zest",
                       endpoint=server.url, **kw)
        base = _PopLog(pull_model(cfg_s, REPO, device="cpu",
                                  log=_quiet).params)
        before = dict(base)
        reused, committed = _fail_after_first_group(monkeypatch, True, base)

        def watch():
            try:
                watch_and_swap(cfg_s, REPO, publisher_url=server.url,
                               device="cpu", base_params=base,
                               base_revision=sha_a, timeout_s=60,
                               log=_quiet)
            except Exception as exc:  # noqa: BLE001 - asserted below
                errors.append(exc)

        t = threading.Thread(target=watch)
        t.start()
        deadline = time.monotonic() + 30
        while server.hub.watchers() < 1:
            assert time.monotonic() < deadline and t.is_alive()
            time.sleep(0.02)
        push_checkpoint(cfg_a, REPO, files=FILES_B, base_revision=sha_a,
                        device="cpu", notify_url=server.url, log=_quiet)
        t.join(timeout=120)
    assert not t.is_alive() and len(errors) == 1, errors
    _assert_base_kept(errors[0], base, before, reused, committed)
