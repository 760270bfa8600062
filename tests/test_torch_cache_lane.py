"""The port's copy-range cache lane against the JAX package's, on the CPU.

Mirrors tests/test_files_async.py's cache-lane cases on the streaming
suite's Llama-shaped fixture (bf16 random bytes: stored chunks, which the
lane moves with ``copy_file_range``):

- ``CachedFileReader.copy_plan`` on a warm cache tiles each file with the
  decode leftovers, and executing it reproduces the file;
- with the landing's file lanes declined, every shard is written by the
  cache lane after the landing, byte-identical, with the ``copy`` and
  ``decode`` lane bytes of the JAX package's pull;
- a truncated or vanished cache entry declines (no temp file left) to the
  waterfall, which refetches and heals it, and the lane then serves it.
"""

from __future__ import annotations

import os
import tempfile

import pytest

from tests.fixtures import FixtureHub, FixtureRepo
from zest_tpu.bench_scale import llama_checkpoint_files
from zest_tpu.config import Config as JConfig
from zest_tpu.transfer import pull as j_pull
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import direct
from zest_tpu_torch.transfer import pull as port_pull
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.pull import pull_model

REPO = "acme/cache-lane"
FILES = llama_checkpoint_files(0.006, shard_bytes=1024 * 1024, scale=16)
SHARDS = sorted(n for n in FILES if n.endswith(".safetensors"))


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO, FILES, chunks_per_xorb=8)) as h:
        yield h


def _cfg(hub, root, **kw) -> Config:
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, **kw)


def _warm_bridge(hub, root):
    """A bridge over a cache that a pull filled, with the files' entries."""
    cfg = _cfg(hub, root)
    pull_model(cfg, REPO, device="cpu", log=_quiet)
    bridge = XetBridge(cfg)
    bridge.authenticate(REPO)
    entries = {e.path: e for e in HubClient(cfg).list_files(REPO)}
    return bridge, entries


def _entry_files(root):
    return [p for p in (root / "zest" / "xorbs").rglob("*") if p.is_file()]


@pytest.mark.parametrize("shard", [SHARDS[0], SHARDS[-1]])
def test_copy_plan_covers_stored_runs_and_decodes_rest(hub, tmp_path,
                                                       shard):
    bridge, entries = _warm_bridge(hub, tmp_path)
    rec = bridge.get_reconstruction(entries[shard].xet_hash)
    reader = direct.CachedFileReader(bridge.cache, rec, workers=1)
    size = reader.size
    copies, leftovers = reader.copy_plan(0, size)
    assert copies, "a warm bf16 shard planned no copy runs"
    planned = sum(int(lens.sum()) for _p, _s, _d, lens in copies)
    assert planned + sum(hi - lo for lo, hi in leftovers) == size
    fd, tmp = tempfile.mkstemp(dir=tmp_path)
    try:
        os.ftruncate(fd, size)
        assert port_pull._execute_copy_plan(copies, fd) == planned
        for d_lo, d_hi in leftovers:
            os.pwrite(fd, reader.read(d_lo, d_hi), d_lo)
        assert os.pread(fd, size, 0) == FILES[shard]
    finally:
        os.close(fd)
        os.unlink(tmp)


def test_declined_handoff_materializes_from_cache_byte_identical(
        hub, tmp_path, monkeypatch):
    """No file from the landing's slots: every shard is written by the
    cache lane after the landing, byte for byte, with the JAX package's
    lane bytes (its handoff declined the same way). ``config.json`` books
    its 311 B on the port's waterfall lane on every pull: the port's
    early read of it is a private download. The reference's early read
    writes the snapshot's copy and races its file loop for it (ROADMAP
    Queue 3, the reference's flaky tests), so its waterfall lane holds
    the file or nothing; every other lane is held equal."""
    monkeypatch.setattr(port_pull, "_tensors_tile", lambda *a: False)
    monkeypatch.setattr(port_pull, "_write_file_from_tensors",
                        lambda *a, **k: None)
    monkeypatch.setattr(j_pull, "_write_file_from_tensors",
                        lambda *a, **k: None)
    for stream in (True, False):
        res = pull_model(_cfg(hub, tmp_path / f"p{stream}",
                              land_stream=stream), REPO, device="cpu",
                         log=_quiet)
        ref = j_pull.pull_model(
            JConfig(hf_home=tmp_path / f"r{stream}" / "hf",
                    cache_dir=tmp_path / f"r{stream}" / "zest",
                    hf_token="hf_test", endpoint=hub.url,
                    land_stream=stream),
            REPO, device="tpu", pod=False, no_p2p=True, log=_quiet)
        lanes = res.stats["files_pipeline"]["lane_bytes"]
        assert lanes.get("tensors", 0) == 0
        assert lanes["copy"] > 0
        assert lanes["waterfall"] == len(FILES["config.json"])
        ref_lanes = dict(ref.stats["files_pipeline"]["lane_bytes"])
        assert ref_lanes.pop("waterfall", 0) in (0, lanes["waterfall"])
        assert {k: v for k, v in lanes.items() if k != "waterfall"} == \
            ref_lanes
        assert lanes["copy"] + lanes.get("decode", 0) == sum(
            len(FILES[s]) for s in SHARDS)
        for name, data in FILES.items():
            assert (res.snapshot_dir / name).read_bytes() == data, name


@pytest.mark.parametrize("when", ["before_plan", "mid_copy", "vanished"])
def test_truncated_entry_declines_then_heals(hub, tmp_path, monkeypatch,
                                             when):
    """An entry truncated before the plan (it no longer parses), cut
    under a running copy (``copy_file_range`` meets its end), or removed
    after the plan: the lane declines with no temp file left, the
    waterfall refetches and rewrites the entry, and the lane then writes
    the file exactly from the cache."""
    bridge, entries = _warm_bridge(hub, tmp_path)
    entry = entries[SHARDS[0]]
    victims = _entry_files(tmp_path)

    def cut(paths):
        for p in paths:
            if when == "vanished":
                p.unlink()
            else:
                blob = p.read_bytes()
                p.write_bytes(blob[:len(blob) // 2])

    if when == "before_plan":
        cut(victims)
    else:
        real = direct.CachedFileReader.copy_plan

        def plan_then_cut(self, lo, hi):
            copies, leftovers = real(self, lo, hi)
            cut({p for p, _s, _d, _n in copies})
            return copies, leftovers

        monkeypatch.setattr(direct.CachedFileReader, "copy_plan",
                            plan_then_cut)
    dest = tmp_path / "out" / SHARDS[0]
    lanes: dict = {}

    def note(lane, n):
        lanes[lane] = lanes.get(lane, 0) + n

    assert port_pull._write_file_from_cache(
        bridge, entry.xet_hash, dest, lane_note=note) is None
    assert not lanes
    assert not list(dest.parent.glob(".tmp-*"))
    monkeypatch.undo()
    cdn = bridge.stats.bytes_from_cdn
    bridge.reconstruct_to_file(entry.xet_hash, dest)  # the waterfall heals
    assert bridge.stats.bytes_from_cdn > cdn
    assert dest.read_bytes() == FILES[SHARDS[0]]
    tmp = port_pull._write_file_from_cache(bridge, entry.xet_hash,
                                           tmp_path / "again" / SHARDS[0],
                                           lane_note=note)
    assert tmp is not None and lanes.get("copy", 0) > 0
    with open(tmp, "rb") as f:
        assert f.read() == FILES[SHARDS[0]]


def test_pull_with_truncated_entries_heals_through_the_waterfall(
        hub, tmp_path):
    """A pull whose landing does not run (a shard is already complete on
    disk) over a cache of truncated entries: each file's cache lane
    declines, the waterfall heals it, the files come out exact, and the
    lane then serves a healed file from the cache."""
    bridge, entries = _warm_bridge(hub, tmp_path)
    for p in _entry_files(tmp_path):
        blob = p.read_bytes()
        p.write_bytes(blob[:len(blob) // 2])
    cfg = _cfg(hub, tmp_path)
    cfg.hf_home = tmp_path / "hf2"
    snap = cfg.model_snapshot_dir(REPO, hub.repos[REPO].commit_sha)
    snap.mkdir(parents=True)
    (snap / SHARDS[0]).write_bytes(FILES[SHARDS[0]])
    res = pull_model(cfg, REPO, device="cpu", log=_quiet)
    assert res.stats["hbm"]["direct"] is False
    lanes = res.stats["files_pipeline"]["lane_bytes"]
    assert "copy" not in lanes
    assert lanes["waterfall"] == sum(len(FILES[n]) for n in FILES
                                     if n != SHARDS[0])
    assert res.stats["fetch"]["bytes"]["cdn"] > 0
    for name, data in FILES.items():
        assert (res.snapshot_dir / name).read_bytes() == data, name
    healed: dict = {}
    tmp = port_pull._write_file_from_cache(
        bridge, entries[SHARDS[-1]].xet_hash, tmp_path / "x" / SHARDS[-1],
        lane_note=lambda lane, n: healed.update({lane: n}))
    assert tmp is not None and healed.get("copy", 0) > 0
    with open(tmp, "rb") as f:
        assert f.read() == FILES[SHARDS[-1]]


@pytest.mark.parametrize("pin", ["cycle", "kept_error"])
def test_decode_error_pinned_by_a_cycle_declines(hub, tmp_path,
                                                 monkeypatch, pin):
    """A decode error that leaves a slice of the lane's mmap reachable
    declines like any decode miss, instead of failing the pull with the
    mmap close's BufferError (seen under concurrent pulls of one cache):
    ``cycle``, an object in a reference cycle holding the slice (the
    collector frees it); ``kept_error``, the error itself kept alive
    after the read, its traceback reaching the reading frame (the lane
    drops the tracebacks of what it catches)."""
    import gc

    bridge, entries = _warm_bridge(hub, tmp_path)
    entry = entries[SHARDS[0]]
    monkeypatch.setattr(direct.CachedFileReader, "copy_plan",
                        lambda self, lo, hi: ([], [(lo, hi)]))
    kept = []

    class Pinned:
        pass

    def read_into(self, lo, hi, out):
        view = memoryview(out).cast("B")
        if pin == "cycle":
            p = Pinned()
            p.cycle, p.view = p, view
            raise direct.DirectLandingError("unit not in cache")
        try:
            raise ValueError("chunk range out of bounds")
        except ValueError as exc:
            err = direct.DirectLandingError("failed to decode")
            err.__cause__ = exc
            kept.append(err)
        raise err

    monkeypatch.setattr(direct.CachedFileReader, "read_into", read_into)
    dest = tmp_path / "out" / SHARDS[0]
    gc.disable()
    try:
        assert port_pull._write_file_from_cache(
            bridge, entry.xet_hash, dest) is None
    finally:
        gc.enable()
    assert not list(dest.parent.glob(".tmp-*"))
    assert all(e.__traceback__ is None for e in kept)
