"""The port's direct landing against the JAX package's, on the CPU.

Mirrors tests/test_direct_landing.py (without the expert cases) on a
small GPT-2 checkpoint (f32, mostly BG4-compressed chunks) and the
streaming suite's Llama-shaped fixture (bf16 random bytes: stored
chunks, which take the ``preadv`` lane):

- ``CachedFileReader.read`` / ``read_into`` / ``copy_plan`` and
  ``land_tensors`` are bit-exact with the JAX package's over one cache;
- ``fetch_file_header`` equals the reference's, and the head-frame probe
  the cooperative round orders by reads far less than a head unit;
- ``pull_model(device="cpu")`` lands directly (no disk read), the
  resumed pull stages from disk, and the landing dtype matches the JAX
  package's cast, NaN and inf included;
- a corrupt cache entry heals through the per-term waterfall, and a
  commit that raises fails the pull instead of falling back to disk.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.fixtures import FixtureHub, FixtureRepo, gpt2_checkpoint_files
from zest_tpu.bench_scale import llama_checkpoint_files
from zest_tpu.config import Config as JConfig
from zest_tpu import storage as j_storage
from zest_tpu.models import direct as j_direct
from zest_tpu.models import loader as j_loader
from zest_tpu.models.safetensors_io import parse_header as j_parse_header
from zest_tpu.transfer import bridge as j_bridge
from zest_tpu.transfer import pod as j_pod
from zest_tpu.transfer import pull as j_pull
from zest_tpu_torch.cas.xorb import XorbReader
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import direct, loader
from zest_tpu_torch.models.safetensors_io import parse_header, tensor_bytes
from zest_tpu_torch.parallel.plan import collect_units
from zest_tpu_torch.transfer import pod
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.federated import warm_units_parallel
from zest_tpu_torch.transfer.pull import pull_model

GPT2 = "acme/tiny-gpt2"
LLAMA = "acme/tiny-llama"
GPT2_FILES = gpt2_checkpoint_files(n_embd=64, n_layer=2, seed=4)
LLAMA_FILES = llama_checkpoint_files(0.012, shard_bytes=3 * 1024 * 1024,
                                     scale=8)
LLAMA_SHARD = min(p for p in LLAMA_FILES if p.endswith(".safetensors"))
READS = [(0, 100), (131_000, 197_123), (5000, 5000)]


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(GPT2, GPT2_FILES, chunks_per_xorb=2),
                    FixtureRepo(LLAMA, LLAMA_FILES,
                                chunks_per_xorb=8)) as h:
        yield h


def _cfg(hub, root, **kw) -> Config:
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _bridge(hub, root, repo=GPT2) -> XetBridge:
    b = XetBridge(_cfg(hub, root))
    b.authenticate(repo)
    return b


def _rec(hub, repo=GPT2, path="model.safetensors"):
    r = hub.repos[repo]
    return r.reconstructions[r.files[path].xet_hash]


def _warm(hub, root, repo=GPT2, path="model.safetensors"):
    """A port bridge with the file's units cached, the file's rec, and
    the JAX package's cache over the same directory."""
    b = _bridge(hub, root, repo)
    rec = _rec(hub, repo, path)
    warm_units_parallel(b, [rec])
    jcache = j_storage.XorbCache(JConfig(hf_home=root / "hf",
                                         cache_dir=root / "zest"))
    return b, rec, jcache


@pytest.mark.parametrize("repo,path", [
    (GPT2, "model.safetensors"),
    (LLAMA, LLAMA_SHARD)])
def test_reader_bit_exact_with_reference(hub, tmp_path, repo, path):
    b, rec, jcache = _warm(hub, tmp_path, repo, path)
    data = (GPT2_FILES if repo == GPT2 else LLAMA_FILES)[path]
    mine = direct.CachedFileReader(b.cache, rec)
    ref = j_direct.CachedFileReader(jcache, rec)
    assert mine.size == ref.size == len(data)
    for lo, hi in READS + [(0, len(data)), (len(data) - 10, len(data))]:
        assert mine.read(lo, hi) == ref.read(lo, hi) == data[lo:hi], (lo, hi)
        buf = bytearray(hi - lo)
        assert mine.read_into(lo, hi, memoryview(buf)) == hi - lo
        assert bytes(buf) == data[lo:hi]
    if repo == LLAMA:  # stored chunks: the preadv lane read them
        assert mine.preadv_stats["terms"] > 0
    with pytest.raises(direct.DirectLandingError, match="out buffer"):
        mine.read_into(0, 100, memoryview(bytearray(99)))
    with pytest.raises(direct.DirectLandingError):
        mine.read(0, len(data) + 1)


def test_read_that_cuts_a_term_decodes_only_its_chunks(hub, tmp_path,
                                                       monkeypatch):
    """A read inside one term decodes the chunks it touches, not the
    term: one chunk cut at both ends, then three chunks cut at the outer
    two (the middle one decoded in place); no whole term is memoized."""
    b, rec, _ = _warm(hub, tmp_path, LLAMA, LLAMA_SHARD)
    data = LLAMA_FILES[LLAMA_SHARD]
    t_lo = 0
    for term in rec.terms:
        fi = rec.find_fetch_info(term)
        entry = b.cache.get_with_range_mapped(term.hash_hex, fi.range.start)
        cs = term.range.start - entry.chunk_offset
        sizes = XorbReader(entry.data).chunk_sizes[
            cs:term.range.end - entry.chunk_offset].astype(np.int64)
        if len(sizes) >= 3:
            break
        t_lo += term.unpacked_length
    ends = t_lo + np.cumsum(sizes)
    starts = ends - sizes
    cuts: list = []
    orig = XorbReader.extract_chunk
    monkeypatch.setattr(XorbReader, "extract_chunk",
                        lambda self, i, verify=True: cuts.append(i)
                        or orig(self, i, verify))
    reader = direct.CachedFileReader(b.cache, rec, use_preadv=False)
    for (lo, hi), n_cut in (((int(starts[1]) + 1, int(ends[1]) - 1), 1),
                            ((int(starts[0]) + 1, int(ends[2]) - 1), 2)):
        cuts.clear()
        assert reader.read(lo, hi) == data[lo:hi]
        assert len(cuts) == n_cut
    assert not reader._term_bytes


@pytest.mark.parametrize("repo,path", [
    (GPT2, "model.safetensors"),
    (LLAMA, LLAMA_SHARD)])
def test_copy_plan_matches_reference(hub, tmp_path, repo, path):
    b, rec, jcache = _warm(hub, tmp_path, repo, path)
    size = rec.total_bytes
    for lo, hi in [(0, size), (1000, size - 1000)]:
        copies, left = direct.CachedFileReader(b.cache, rec).copy_plan(lo, hi)
        jcopies, jleft = j_direct.CachedFileReader(jcache, rec).copy_plan(
            lo, hi)
        assert left == jleft
        assert len(copies) == len(jcopies)
        for c, jc in zip(copies, jcopies):
            assert str(c[0]) == str(jc[0])
            for a, ja in zip(c[1:], jc[1:]):
                np.testing.assert_array_equal(a, ja)
    if repo == LLAMA:
        assert copies  # stored chunks are copyable


def test_reader_requires_cached_units(hub, tmp_path):
    reader = direct.CachedFileReader(_bridge(hub, tmp_path).cache,
                                     _rec(hub))
    with pytest.raises(direct.DirectLandingError, match="not in cache"):
        reader.read(0, 100)
    # The lossy overlay with nothing staged: the reader still misses.
    overlay = direct.CachedFileReader(reader.cache, _rec(hub),
                                      allow_lossy=True)
    with pytest.raises(direct.DirectLandingError, match="not in cache"):
        overlay.read(0, 100)


def _corrupt_entries(root, how):
    for path in (root / "zest").rglob("*"):
        if path.is_file():
            blob = bytearray(path.read_bytes())
            path.write_bytes(how(blob))


@pytest.mark.parametrize("how", ["payload", "truncated"])
def test_reader_reports_corrupt_cache_with_cause(hub, tmp_path, how):
    """A corrupt entry and no bridge: the decode failure surfaces with
    its cause, for a bad payload and for a frame stream that does not
    parse alike."""
    _b, rec, _j = _warm(hub, tmp_path)

    def payload(blob):
        blob[8:64] = b"\xff" * 56
        return blob

    _corrupt_entries(tmp_path,
                     payload if how == "payload" else lambda b: b[:20])
    reader = direct.CachedFileReader(_b.cache, rec)
    with pytest.raises(direct.DirectLandingError,
                       match="failed to decode") as ei:
        reader.read(0, 100)
    assert isinstance(ei.value.__cause__, ValueError)


def test_land_tensors_bit_exact_with_reference(hub, tmp_path):
    b, rec, jcache = _warm(hub, tmp_path)
    header = parse_header(GPT2_FILES["model.safetensors"])
    got = direct.land_tensors(b.cache, rec, header)
    want = j_direct.land_tensors(
        jcache, rec, j_parse_header(GPT2_FILES["model.safetensors"]))
    assert set(got) == set(want)
    for name, arr in want.items():
        assert str(got[name].dtype).removeprefix("torch.") == str(arr.dtype)
        assert tuple(got[name].shape) == arr.shape
        assert tensor_bytes(got[name]).tobytes() == arr.tobytes(), name
    some = direct.land_tensors(b.cache, rec, header,
                               predicate=lambda n: n.startswith("h.1."))
    assert some and set(some) == {n for n in want if n.startswith("h.1.")}
    for name, t in some.items():
        assert tensor_bytes(t).tobytes() == want[name].tobytes()


def test_fetch_file_header_and_probe(hub, tmp_path):
    rec = _rec(hub)
    want = j_parse_header(GPT2_FILES["model.safetensors"])
    b = _bridge(hub, tmp_path / "a")
    jb = j_bridge.XetBridge(JConfig(hf_home=tmp_path / "j" / "hf",
                                    cache_dir=tmp_path / "j" / "zest",
                                    hf_token="hf_test", endpoint=hub.url))
    jb.authenticate(GPT2)
    header = pod.fetch_file_header(b, rec)
    ref = j_pod.fetch_file_header(jb, rec)
    assert header.data_start == ref.data_start == want.data_start
    assert {n: (i.dtype, i.shape, i.data_offsets)
            for n, i in header.tensors.items()} == {
        n: (i.dtype, i.shape, i.data_offsets) for n, i in ref.tensors.items()}
    assert b.stats.bytes_from_cdn == jb.stats.bytes_from_cdn
    # The probe reads the head frames alone, caching nothing.
    cold = _bridge(hub, tmp_path / "b")
    probed = pod.fetch_header_probe(cold, rec)
    assert probed.tensors == header.tensors
    head = rec.terms[0]
    fi = rec.find_fetch_info(head)
    assert 0 < cold.stats.bytes_from_cdn < (fi.url_range_end
                                            - fi.url_range_start)
    assert cold.cache.locate_with_range(head.hash_hex,
                                        fi.range.start) is None


@pytest.mark.parametrize("src,bits", [
    ("f32", [0x3F800000, 0x3F808000, 0x3F818000, 0x7F800000, 0xFF800000,
             0x7FC00000, 0xFFC00000, 0x7FC00001, 0x7F800001, 0xFFFFFFFF,
             0x00000001, 0x80000001, 0x7F7FFFFF]),
    ("f32-random", None)])
def test_landing_cast_matches_reference(src, bits):
    """float32 → bfloat16 on the host equals the JAX package's
    ``ml_dtypes`` cast bit for bit: round to nearest even, infinities
    kept, every NaN the quiet NaN of its sign."""
    import ml_dtypes

    if bits is None:
        bits = np.random.default_rng(7).integers(
            0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    u = np.asarray(bits, dtype=np.uint32)
    with np.errstate(invalid="ignore"):
        want = u.view(np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)
    got = loader.cast_floating(torch.from_numpy(u.copy()).view(torch.float32),
                               torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), want)
    ids = torch.tensor([3, 4])
    assert loader.cast_floating(ids, torch.bfloat16) is ids
    with pytest.raises(ValueError, match="landing dtype"):
        loader.resolve_dtype("fp8")


@pytest.mark.parametrize("land_dtype", [None, "bf16"])
def test_pull_lands_direct_like_reference(hub, tmp_path, monkeypatch,
                                          land_dtype):
    """The cpu pull lands from the cache (never from the files it
    writes), with the JAX package's digest, stages and files."""
    disk = []
    monkeypatch.setattr(loader, "load_checkpoint",
                        lambda *a, **k: disk.append(a))
    res = pull_model(_cfg(hub, tmp_path / "p", land_dtype=land_dtype), GPT2,
                     device="cpu", log=_quiet)
    ref = j_pull.pull_model(
        JConfig(hf_home=tmp_path / "r" / "hf",
                cache_dir=tmp_path / "r" / "zest", hf_token="hf_test",
                endpoint=hub.url, land_dtype=land_dtype),
        GPT2, device="tpu", pod=False, no_p2p=True, log=_quiet)
    assert not disk
    assert res.stats["hbm"]["direct"] is True
    assert loader.params_digest(res.params) == j_loader.params_digest(
        ref.params)
    if land_dtype:
        assert res.params["h.0.attn.c_attn.weight"].dtype == torch.bfloat16
    for name, data in GPT2_FILES.items():
        assert (res.snapshot_dir / name).read_bytes() == data
    stages, busy = res.stats["stages"], res.stats["stages_busy"]
    assert set(stages) == set(ref.stats["stages"]) == set(busy)
    for stage, wall in stages.items():
        assert 0 <= wall <= res.stats["elapsed_s"] + 0.05
        assert busy[stage] >= wall - 0.05
    assert res.stats["time_to_hbm_s"] <= res.stats["elapsed_s"] + 0.05
    assert res.stats["files_pipeline"]["lane_bytes"]["tensors"] == len(
        GPT2_FILES["model.safetensors"])


def test_resumed_pull_stages_from_disk(hub, tmp_path):
    cfg = _cfg(hub, tmp_path)
    first = pull_model(cfg, GPT2, device="cpu", log=_quiet)
    again = pull_model(cfg, GPT2, device="cpu", log=_quiet)
    assert again.stats["hbm"]["direct"] is False
    assert "time_to_first_layer_s" not in again.stats
    assert again.stats["files_after_hbm_s"] == 0.0
    assert again.stats["files_skipped"] == len(GPT2_FILES)
    assert loader.params_digest(again.params) == loader.params_digest(
        first.params)


@pytest.mark.parametrize("how", ["payload", "truncated"])
def test_corrupt_cache_entry_healed(hub, tmp_path, how):
    """Every cached entry corrupted, then a pull over that cache into a
    fresh snapshot: a payload that fails to decode heals through the
    reader's per-term waterfall, an entry that does not parse through
    the warm's refetch; tree and files come out exact."""
    first = pull_model(_cfg(hub, tmp_path), GPT2, device="cpu", log=_quiet)
    digest = loader.params_digest(first.params)

    def payload(blob):
        blob[8:64] = b"\xff" * 56
        return blob

    _corrupt_entries(tmp_path,
                     payload if how == "payload" else lambda b: b[:20])
    cfg = _cfg(hub, tmp_path)
    cfg.hf_home = tmp_path / "hf2"
    res = pull_model(cfg, GPT2, device="cpu", log=_quiet)
    assert res.stats["hbm"]["direct"] is True
    assert res.stats["fetch"]["bytes"]["cdn"] > 0
    assert loader.params_digest(res.params) == digest
    for name, data in GPT2_FILES.items():
        assert (res.snapshot_dir / name).read_bytes() == data


@pytest.mark.parametrize("land_stream", [True, False])
def test_commit_error_fails_the_pull(hub, tmp_path, monkeypatch,
                                     land_stream):
    """A commit that raises leaves ``pull_model``: no disk staging, and
    the files left behind are whole (no temp file survives)."""
    def boom(*a, **k):
        raise RuntimeError("commit failed")

    monkeypatch.setattr(loader._DeviceCommit, "commit", boom)
    monkeypatch.setattr(loader, "commit_tensors", boom)
    disk = []
    monkeypatch.setattr(loader, "load_checkpoint",
                        lambda *a, **k: disk.append(a))
    cfg = _cfg(hub, tmp_path, land_stream=land_stream)
    with pytest.raises(RuntimeError, match="commit failed"):
        pull_model(cfg, GPT2, device="cpu", log=_quiet)
    assert not disk
    for path in cfg.hub_dir().rglob("*"):
        assert not path.name.startswith(".tmp-"), path
        if path.is_file() and path.name in GPT2_FILES:
            assert path.read_bytes() == GPT2_FILES[path.name]


def test_unit_keys_and_priorities_match_reference(hub, tmp_path):
    b = _bridge(hub, tmp_path, LLAMA)
    rwh = []
    for path in sorted(p for p in LLAMA_FILES if p.endswith(".safetensors")):
        rec = _rec(hub, LLAMA, path)
        rwh.append((rec, pod.fetch_file_header(b, rec)))
    jrwh = [(rec, j_parse_header(LLAMA_FILES[path]))
            for (rec, _h), path in zip(rwh, sorted(
                p for p in LLAMA_FILES if p.endswith(".safetensors")))]
    prio = direct.unit_layer_priorities(rwh)
    assert prio == j_direct.unit_layer_priorities(jrwh)
    assert set(prio) == {k for k, _fi in collect_units(
        [r for r, _h in rwh])}
    for (rec, h), (_r, jh) in zip(rwh, jrwh):
        assert direct.tensor_unit_keys(rec, h) == \
            j_direct.tensor_unit_keys(rec, jh)
    units = [(k[0], fi) for k, fi in collect_units([r for r, _h in rwh])]
    assert sorted(units, key=direct.unit_priority_sort_key(prio)) == sorted(
        units, key=j_direct.unit_priority_sort_key(prio))
