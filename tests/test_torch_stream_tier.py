"""The warm fetch's CDN stream tier and the header prefetch, against the
JAX package, on the CPU.

With no swarm both packages' warm fetches stream each wanted unit's CDN
body straight into its cache file (``XetBridge.stream_unit_from_cdn``,
``storage.atomic_write_stream``). On the cache-lane suite's Llama-shaped
fixture (``llama_checkpoint_files(0.006, shard_bytes=1 MiB, scale=16)``,
eight chunks a xorb):

- a pull's files, ``params_digest``, ``fetch`` stats by tier, lane bytes
  and ``hbm.warm`` equal the reference's, every wanted unit streamed and
  none fetched whole;
- a body cut short past the client's retries never becomes a cache entry
  under any key (the port counts the unit failed; the reference renames
  the short body into place, to fail at extraction), and the pull still
  lands the reference's digest through the per-term waterfall;
- a full disk (ENOSPC) while a unit streams: no temp file, a
  ``disk_pressure`` event, the unit failed, the pull lands all the same;
- a corrupt body streamed into the cache (its first frame garbled) is
  found at extraction and healed, as the reference heals it: the same
  digest and files; a byte flipped inside a stored chunk is not found,
  in either package (a shared fault, ROADMAP Queue 3);
- after the background header prefetch the landing's header pass makes
  no network request.
"""

from __future__ import annotations

import errno
import os

import pytest

from tests.fixtures import FixtureHub, FixtureRepo
from zest_tpu.bench_scale import llama_checkpoint_files
from zest_tpu.cas import client as j_client
from zest_tpu.config import Config as JConfig
from zest_tpu.models import loader as j_loader
from zest_tpu.transfer import pull as j_pull
from zest_tpu.transfer.bridge import XetBridge as JXetBridge
from zest_tpu.transfer.federated import (
    warm_units_parallel as j_warm_units_parallel,
)
from zest_tpu_torch import storage, telemetry
from zest_tpu_torch.cas import client as port_client
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import loader
from zest_tpu_torch.transfer import pull as port_pull
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.federated import warm_units_parallel
from zest_tpu_torch.transfer.pull import pull_model

REPO = "acme/stream-tier"
FILES = llama_checkpoint_files(0.006, shard_bytes=1024 * 1024, scale=16)
SHARDS = sorted(n for n in FILES if n.endswith(".safetensors"))


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO, FILES, chunks_per_xorb=8)) as h:
        yield h


@pytest.fixture(autouse=True)
def _telemetry():
    telemetry.recorder.reset()
    yield
    telemetry.recorder.reset()


def _cfg(hub, root) -> Config:
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url)


def _jcfg(hub, root) -> JConfig:
    return JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                   hf_token="hf_test", endpoint=hub.url)


def _pull(hub, root):
    return pull_model(_cfg(hub, root), REPO, device="cpu", no_p2p=True,
                      log=_quiet)


def _ref_pull(hub, root):
    return j_pull.pull_model(_jcfg(hub, root), REPO, device="tpu",
                             pod=False, no_p2p=True, log=_quiet)


@pytest.fixture(scope="module")
def ref(hub, tmp_path_factory):
    """The reference's pull of the fixture, and its digest."""
    res = _ref_pull(hub, tmp_path_factory.mktemp("ref"))
    return res, j_loader.params_digest(res.params)


@pytest.fixture(scope="module")
def clean(hub, tmp_path_factory):
    """A clean port pull's cache: entry name → bytes."""
    root = tmp_path_factory.mktemp("clean")
    _pull(hub, root)
    return {f.name: f.read_bytes() for f in _entries(_cfg(hub, root))}


def _assert_files_exact(res):
    for name, data in FILES.items():
        assert (res.snapshot_dir / name).read_bytes() == data, name


def _lanes_equal(mine: dict, theirs: dict) -> None:
    """Lane bytes equal; the reference's early config.json read races its
    file loop for the file (tests/test_torch_cache_lane.py), so its
    waterfall lane holds config.json's bytes or nothing."""
    theirs = dict(theirs)
    assert theirs.pop("waterfall", 0) in (0, mine["waterfall"])
    assert mine["waterfall"] == len(FILES["config.json"])
    assert {k: v for k, v in mine.items() if k != "waterfall"} == theirs


def _recs(bridge_cls, cfg):
    bridge = bridge_cls(cfg)
    bridge.authenticate(REPO)
    entries = HubClient(cfg).list_files(REPO)
    return bridge, [bridge.get_reconstruction(e.xet_hash) for e in entries
                    if e.is_xet]


def _target(recs):
    """A unit the warm fetch streams: the last unit of the last shard's
    largest xorb (no header term is in it)."""
    rec = recs[-1]
    hash_hex = max(rec.fetch_info, key=lambda h: sum(
        f.url_range_end - f.url_range_start for f in rec.fetch_info[h]))
    return hash_hex, rec.fetch_info[hash_hex][-1]


def _entries(cfg) -> list:
    return [f for f in cfg.xorb_cache_dir().rglob("*") if f.is_file()]


def _patch_iter(monkeypatch, module, fi, edit, times: int):
    """``module.CasClient.fetch_xorb_iter`` with ``edit`` applied to the
    target unit's body (its byte range) for the first ``times`` GETs."""
    real = module.CasClient.fetch_xorb_iter
    seen = []

    def fetch_xorb_iter(self, url, byte_range=None):
        if byte_range == (fi.url_range_start, fi.url_range_end) \
                and len(seen) < times:
            seen.append(url)
            return edit(real(self, url, byte_range))
        return real(self, url, byte_range)

    monkeypatch.setattr(module.CasClient, "fetch_xorb_iter",
                        fetch_xorb_iter)
    return seen


def _short(pieces):
    """The body ending early, with no error: the first half only."""
    body = b"".join(pieces)
    yield body[:len(body) // 2]


def _corrupt(pieces):
    """The first chunk frame's compressed length garbled: the entry no
    longer parses."""
    body = bytearray(b"".join(pieces))
    body[1:4] = b"\xff\xff\xff"
    yield bytes(body)


def _flip(pieces):
    """One byte flipped in the middle of the body (a stored chunk's
    payload in this fixture's random bf16 bytes)."""
    body = bytearray(b"".join(pieces))
    body[len(body) // 2] ^= 0xFF
    yield bytes(body)


def test_stream_tier_pull_equals_reference(hub, ref, tmp_path, monkeypatch):
    streamed, whole = [], []
    real_stream = XetBridge.stream_unit_from_cdn
    real_unit = XetBridge.fetch_unit_tiered

    def stream(self, hash_hex, fi, full_key):
        streamed.append((hash_hex, fi.range.start))
        return real_stream(self, hash_hex, fi, full_key)

    def unit(self, hash_hex, fi):
        whole.append(hash_hex)
        return real_unit(self, hash_hex, fi)

    monkeypatch.setattr(XetBridge, "stream_unit_from_cdn", stream)
    monkeypatch.setattr(XetBridge, "fetch_unit_tiered", unit)
    # The reference's device="tpu" pull prefetches the headers (its cache
    # counts read them back): the port's card path does too, and the CPU
    # stands in for the card here.
    monkeypatch.setattr(port_pull, "_background_metadata", lambda dev: True)
    res = _pull(hub, tmp_path)
    jres, jdigest = ref
    _assert_files_exact(res)
    assert loader.params_digest(res.params) == jdigest
    st, jst = res.stats, jres.stats
    for key in ("xorbs", "bytes"):
        assert st["fetch"][key] == jst["fetch"][key], key
    assert st["hbm"]["warm"] == jst["hbm"]["warm"]
    _lanes_equal(st["files_pipeline"]["lane_bytes"],
                 jst["files_pipeline"]["lane_bytes"])
    warm = st["hbm"]["warm"]
    assert warm["units"] == len(streamed) == len(set(streamed)) > 0
    assert warm["failed"] == 0 and whole == []
    # Every CDN byte sits in the cache once: the streamed units and the
    # head units the header prefetch fetched.
    assert sum(f.stat().st_size for f in _entries(_cfg(hub, tmp_path))) == \
        st["fetch"]["bytes"]["cdn"]


def test_short_body_never_becomes_an_entry(hub, ref, clean, tmp_path,
                                           monkeypatch):
    cfg = _cfg(hub, tmp_path / "warm")
    bridge, recs = _recs(XetBridge, cfg)
    hash_hex, fi = _target(recs)
    _patch_iter(monkeypatch, port_client, fi, _short, times=10)
    stats = warm_units_parallel(bridge, recs)
    bridge.close()
    assert stats["failed"] == 1
    names = [f.name for f in _entries(cfg)]
    assert not any(n.startswith(".tmp-") for n in names)
    assert hash_hex not in names and f"{hash_hex}.{fi.range.start}" \
        not in names
    assert len(names) == stats["units"] - 1
    # The reference renames the short body into place, to fail later.
    jcfg = _jcfg(hub, tmp_path / "jwarm")
    jbridge, jrecs = _recs(JXetBridge, jcfg)
    _patch_iter(monkeypatch, j_client, fi, _short, times=10)
    jstats = j_warm_units_parallel(jbridge, jrecs)
    jbridge.close()
    assert jstats["failed"] == 0
    short = [f for f in _entries(jcfg) if f.name.split(".")[0] == hash_hex]
    assert short and short[0].stat().st_size < \
        fi.url_range_end - fi.url_range_start
    # A pull whose warm fetch gets the short body (and the retry) lands
    # through the per-term waterfall: the reference's digest, the files.
    monkeypatch.undo()
    seen = _patch_iter(monkeypatch, port_client, fi, _short, times=2)
    res = _pull(hub, tmp_path / "pull")
    assert len(seen) == 2 and res.stats["hbm"]["warm"]["failed"] == 1
    _assert_files_exact(res)
    assert loader.params_digest(res.params) == ref[1]
    # The healed unit's entry is the clean pull's, byte for byte.
    assert {f.name: f.read_bytes()
            for f in _entries(_cfg(hub, tmp_path / "pull"))} == clean


def test_full_disk_during_a_streamed_unit(hub, ref, tmp_path, monkeypatch):
    cfg = _cfg(hub, tmp_path)
    bridge, recs = _recs(XetBridge, cfg)
    hash_hex, fi = _target(recs)
    bridge.close()
    real_fdopen = os.fdopen
    hits = []

    class Full:
        def __init__(self, f):
            self.f = f
            self.n = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()

        def write(self, b):
            self.n += len(b)
            if self.n > 4096:
                hits.append(self.n)
                raise OSError(errno.ENOSPC, "No space left on device")
            return self.f.write(b)

    def fdopen(fd, *a, **k):
        f = real_fdopen(fd, *a, **k)
        try:
            where = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            return f
        if f"/{hash_hex[:2]}/" in where and ".tmp-" in where \
                and str(cfg.xorb_cache_dir()) in where:
            return Full(f)
        return f

    monkeypatch.setattr(storage.os, "fdopen", fdopen)
    res = _pull(hub, tmp_path)
    monkeypatch.undo()
    assert hits, "the streamed unit never hit the full disk"
    assert res.stats["hbm"]["warm"]["failed"] >= 1
    names = [f.name for f in _entries(cfg)]
    assert not any(n.startswith(".tmp-") for n in names)
    assert hash_hex not in names
    assert any(e["kind"] == "disk_pressure"
               for e in telemetry.recorder.tail())
    _assert_files_exact(res)
    assert loader.params_digest(res.params) == ref[1]


def test_corrupt_streamed_body_heals_as_the_reference(hub, ref, tmp_path,
                                                       monkeypatch):
    _, recs = _recs(XetBridge, _cfg(hub, tmp_path / "probe"))
    _, fi = _target(recs)
    seen = _patch_iter(monkeypatch, port_client, fi, _corrupt, times=1)
    jseen = _patch_iter(monkeypatch, j_client, fi, _corrupt, times=1)
    res = _pull(hub, tmp_path / "port")
    jres = _ref_pull(hub, tmp_path / "ref")
    assert len(seen) == len(jseen) == 1
    _assert_files_exact(res)
    _assert_files_exact(jres)
    assert loader.params_digest(res.params) == \
        j_loader.params_digest(jres.params) == ref[1]
    # The port's landing stays direct: the corrupt entry was streamed in
    # whole, then found at extraction and healed through the per-term
    # waterfall (one more CDN fetch of the unit at least).
    st = res.stats
    assert st["hbm"]["direct"] and st["hbm"]["warm"]["failed"] == 0
    extra = st["fetch"]["bytes"]["cdn"] - ref[0].stats["fetch"]["bytes"][
        "cdn"]
    assert extra >= fi.url_range_end - fi.url_range_start


def test_flipped_stored_byte_lands_as_in_the_reference(hub, tmp_path,
                                                       monkeypatch):
    """A fault shared with the reference (ROADMAP Queue 3): a CDN body
    with one payload byte flipped in a stored chunk still parses and
    decodes, and extraction hashes no chunk of a cache entry, so the
    flipped byte reaches the tree and the file in both packages, at the
    same offset."""
    _, recs = _recs(XetBridge, _cfg(hub, tmp_path / "probe"))
    _, fi = _target(recs)
    _patch_iter(monkeypatch, port_client, fi, _flip, times=1)
    _patch_iter(monkeypatch, j_client, fi, _flip, times=1)
    res = _pull(hub, tmp_path / "port")
    jres = _ref_pull(hub, tmp_path / "ref")
    name = SHARDS[-1]
    mine = (res.snapshot_dir / name).read_bytes()
    theirs = (jres.snapshot_dir / name).read_bytes()
    assert mine == theirs != FILES[name]
    assert sum(a != b for a, b in zip(mine, FILES[name])) == 1
    assert loader.params_digest(res.params) == \
        j_loader.params_digest(jres.params)


def test_landing_header_pass_reads_the_prefetched_headers(hub, tmp_path,
                                                          monkeypatch):
    calls = []
    real = port_pull._hdr_fan

    def fan(fn, items):
        before = len(hub.requests_seen)
        out = real(fn, items)
        calls.append(len(hub.requests_seen) - before)
        return out

    monkeypatch.setattr(port_pull, "_hdr_fan", fan)
    # A CPU landing reads its headers itself: one fan, over the network.
    res = _pull(hub, tmp_path / "cpu")
    _assert_files_exact(res)
    assert len(calls) == 1 and calls[0] > 0
    # The card's landing prefetches them; the CPU stands in for the card.
    calls.clear()
    monkeypatch.setattr(port_pull, "_background_metadata", lambda dev: True)
    res = _pull(hub, tmp_path / "card")
    _assert_files_exact(res)
    # The prefetch's fan first (reconstructions and head units over the
    # network), then the landing's: every header from the cache.
    assert len(calls) == 2
    assert calls[0] > 0 and calls[1] == 0


def test_traced_pull_records_one_stream_span_per_unit(hub, tmp_path):
    """``chip_smoke.stream_span_gates`` (phase 7's) on a traced fixture
    landing, and the same ``cdn.stream`` spans (count and bytes) as the
    reference's traced pull."""
    import chip_smoke
    from zest_tpu import telemetry as j_telemetry

    tracer = telemetry.trace.install(None)
    try:
        res = _pull(hub, tmp_path / "port")
    finally:
        telemetry.trace.uninstall()
    chip_smoke.stream_span_gates("fixture", tracer.spans(), res.stats)
    jtracer = j_telemetry.trace.install(None)
    try:
        _ref_pull(hub, tmp_path / "ref")
    finally:
        j_telemetry.trace.uninstall()

    def streams(spans):
        return sorted(sp.attrs["bytes"] for sp in spans
                      if sp.name == "cdn.stream")

    assert streams(tracer.spans()) == streams(jtracer.spans())
