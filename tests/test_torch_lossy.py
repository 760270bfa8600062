"""The port's lossy tier against the JAX package's, on the CPU.

Mirrors the lossy half of tests/test_transport.py on the same fixture
(random-normal float32 weights that BG4 compresses, incompressible
bytes, a small JSON file; two chunks per xorb), with ``device="cpu"``:

- ZQLS containers byte-identical to ``zest_tpu.transfer.lossy``'s for
  float blobs (at every byte phase), mixed and non-float blobs and the
  fixture's own units; the per-block error bound; format errors; a chunk
  the codec reads off its float grid, as the reference's does;
- the staging registry and its rebasing lookup;
- serving: byte-exact by default, quantized only on ``FLAG_QUANT_OK``, a
  staged container forwarded verbatim only on ``FLAG_LOSSY_OK``, each
  answer equal to the reference's;
- a cross-slice collective round with ``collective_lossy="dcn"`` (and
  ``"wan"``, which arms no dcn link): quantized payloads land in the
  staging overlay only, the exchange stats equal the reference's, not a
  ZQLS byte reaches a cache, the overlay reader is within the bound and
  a byte-exact read heals through the waterfall;
- the overlay gate of ``CachedFileReader``, ``land_tensors`` and the
  streaming reader; and ``pull_model`` with the lossy tier armed lands a
  byte-exact tree (its landings share their bytes with the files, so
  they never read the overlay, as in the JAX package).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import chip_smoke
from tests.fixtures import FixtureHub, FixtureRepo, gpt2_checkpoint_files
from zest_tpu.cas.xorb import encode_frame as j_encode_frame
from zest_tpu.config import Config as JConfig
from zest_tpu.storage import XorbCache as JXorbCache
from zest_tpu.transfer import coop as j_coop
from zest_tpu.transfer import dcn as j_dcn
from zest_tpu.transfer import lossy as j_lossy
from zest_tpu.transfer.bridge import XetBridge as JXetBridge
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.hub import HubClient
from zest_tpu_torch.cas.xorb import XorbReader, encode_frame
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import direct, loader
from zest_tpu_torch.models.safetensors_io import parse_header_prefix
from zest_tpu_torch.transfer import coop, lossy
from zest_tpu_torch.transfer.bridge import XetBridge
from zest_tpu_torch.transfer.dcn import (
    FLAG_LOSSY,
    FLAG_LOSSY_OK,
    FLAG_QUANT_OK,
    DcnServer,
    serve_chunk_range,
)
from zest_tpu_torch.transfer.federated import warm_units_parallel
from zest_tpu_torch.transfer.pull import pull_model

REPO_ID = "acme/lossy-model"
_RNG = np.random.default_rng(11)
_FLOATS = _RNG.standard_normal(300_000).astype("<f4")
FILES = {
    "config.json": b'{"model_type": "lossy"}',
    "weights.bin": _FLOATS.tobytes(),
    "blob.bin": _RNG.bytes(1_200_000),
}
EX_KEYS = {"units", "wire_bytes", "unpacked_bytes", "fallback_units",
           "fallback_bytes", "verify_rejected", "retries", "budget_bytes",
           "inflight_peak_bytes"}


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def hub():
    with FixtureHub(FixtureRepo(REPO_ID, FILES, chunks_per_xorb=2)) as h:
        yield h


@pytest.fixture(autouse=True)
def _clean():
    lossy.reset_stagings()
    j_lossy.reset_stagings()
    yield
    lossy.reset_stagings()
    j_lossy.reset_stagings()


def _bridge(hub, root, **cfg_kw):
    cfg = Config(hf_home=root / "hf", cache_dir=root / "zest",
                 hf_token="hf_test", endpoint=hub.url, dcn_port=0, **cfg_kw)
    b = XetBridge(cfg)
    b.authenticate(REPO_ID)
    return b


def _jbridge(hub, root, **cfg_kw):
    cfg = JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=hub.url, dcn_port=0,
                  **cfg_kw)
    b = JXetBridge(cfg)
    b.authenticate(REPO_ID)
    return b


def _recs(bridge):
    return [bridge.get_reconstruction(e.xet_hash)
            for e in HubClient(bridge.cfg).list_files(REPO_ID) if e.is_xet]


def _rec_for(bridge, path):
    for e in HubClient(bridge.cfg).list_files(REPO_ID):
        if e.is_xet and e.path == path:
            return bridge.get_reconstruction(e.xet_hash)
    raise AssertionError(f"no xet file {path}")


def _units(rec):
    return [(hh, fi) for hh, entries in rec.fetch_info.items()
            for fi in entries]


# ── The ZQLS codec ──


def _frames(*raws) -> bytes:
    return b"".join(encode_frame(r)[0] for r in raws)


def _float_raws(n=3, vals=16384, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(vals).astype("<f4").tobytes()
            for _ in range(n)]


BLOBS = {
    "floats": lambda: _frames(*_float_raws()),
    "phase_1": lambda: _frames(b"\x01" + _float_raws(1)[0][:-1]),
    "phase_3": lambda: _frames(b"abc" + _float_raws(1, seed=4)[0] + b"z"),
    "mixed": lambda: _frames(_float_raws(1)[0], b'{"k": 1}' * 2000,
                             np.random.default_rng(5).bytes(5000)),
    "zeros": lambda: _frames(bytes(65536)),
    "stored": lambda: _frames(np.random.default_rng(5).bytes(100_000)),
    "text": lambda: _frames(b'{"k": 1}' * 20_000),
    "garbage": lambda: b"\xff" * 64,
    "empty": lambda: b"",
}


@pytest.mark.parametrize("name", list(BLOBS))
def test_container_byte_identical_to_reference(name):
    blob = BLOBS[name]()
    got, want = lossy.quantize_blob(blob), j_lossy.quantize_blob(blob)
    assert got == want
    if want is not None:
        assert lossy.is_lossy_container(got)
        assert lossy.exact_len(got) == j_lossy.exact_len(want) == len(blob)
        assert lossy.dequantize_blob(got) == j_lossy.dequantize_blob(want)


def test_encode_frame_matches_reference():
    for raw in _float_raws(2) + [b"", b"x" * 1000]:
        assert encode_frame(raw) == j_encode_frame(raw)


def test_fixture_units_quantize_as_reference(hub, tmp_path):
    b = _bridge(hub, tmp_path)
    try:
        warm_units_parallel(b, _recs(b))
        n = 0
        for path in ("weights.bin", "blob.bin"):
            for hh, fi in _units(_rec_for(b, path)):
                blob = b.cache.get_with_range(hh, fi.range.start).data
                got = lossy.quantize_blob(blob)
                assert got == j_lossy.quantize_blob(blob)
                n += got is not None
                assert (got is not None) == (path == "weights.bin")
        assert n > 0
    finally:
        b.close()


def test_round_trip_error_within_each_block():
    raws = _float_raws()
    blob = _frames(*raws)
    container = lossy.quantize_blob(blob)
    assert len(container) < len(blob) * 0.5
    reader = XorbReader(lossy.dequantize_blob(container))
    assert len(reader) == len(raws)
    for i, raw in enumerate(raws):
        got = np.frombuffer(reader.extract_chunk(i, verify=False), "<f4")
        want = np.frombuffer(raw, "<f4")
        for s in range(0, want.size, lossy.BLOCK_VALUES):
            blk = slice(s, s + lossy.BLOCK_VALUES)
            bound = np.max(np.abs(want[blk])) / 127.0 + 1e-6
            assert np.max(np.abs(got[blk] - want[blk])) <= bound


def test_codec_reads_a_chunk_off_its_float_grid_as_the_reference_does():
    """A fault the port shares with the JAX package: the codec takes the
    byte phase with the best float32 SNR, and a misphased reading whose
    squares overflow float32 scores infinite. This chunk of N(0, 0.02)
    floats, cut one byte into a float (its grid is phase 3), is quantized
    at phase 0; the reference makes the same container. Read at the
    codec's phase every value keeps its block bound; in the float grid
    the weights move far past theirs."""
    floats = np.random.default_rng(74).standard_normal(
        3200, dtype=np.float32) * np.float32(0.02)
    raw = floats.tobytes()[1:1 + 12555]
    payload = lossy._quantize_chunk(raw)
    assert payload == j_lossy._quantize_chunk(raw)
    assert payload[0] == 0
    got = lossy._dequantize_chunk(payload, len(raw))
    assert chip_smoke.within_block_bound(raw, got, 0)
    assert not chip_smoke.within_block_bound(raw, got, 3)
    assert chip_smoke.squares_overflow(raw, 0)
    assert not chip_smoke.squares_overflow(raw, 3)
    x = np.frombuffer(raw, "<f4", offset=3, count=3000)
    y = np.frombuffer(got, "<f4", offset=3, count=3000)
    assert np.max(np.abs(x - y)) > np.max(np.abs(x))


def _mangled():
    c = lossy.quantize_blob(BLOBS["floats"]())
    return {
        "not_a_container": b"not a container",
        "version": c[:4] + b"\x02" + c[5:],
        "block": c[:8] + (128).to_bytes(4, "little") + c[12:],
        "truncated": c[:-7],
        "trailing": c + b"\x00",
        "kind": c[:20] + b"\x07" + c[21:],
    }


@pytest.mark.parametrize("case", ["not_a_container", "version", "block",
                                  "truncated", "trailing", "kind"])
def test_malformed_containers_raise_as_reference(case):
    bad = _mangled()[case]
    with pytest.raises(ValueError):
        j_lossy.dequantize_blob(bad)
    with pytest.raises(lossy.LossyFormatError):
        lossy.dequantize_blob(bad)


def test_staging_registry_and_rebase(tmp_path):
    st = lossy.staging_for(tmp_path / "zest")
    assert st is lossy.staging_for(tmp_path / "zest")
    assert st is not lossy.staging_for(tmp_path / "other")
    container = lossy.quantize_blob(BLOBS["floats"]())
    st.put("ab" * 32, 4, container)
    assert st.units() == 1 and st.total_bytes() == len(container)
    assert st.get_with_range("ab" * 32, 6) == (container, 4)
    assert st.get_with_range("ab" * 32, 2) is None
    assert st.get_with_range("cd" * 32, 6) is None
    lossy.reset_stagings()
    assert lossy.staging_for(tmp_path / "zest").units() == 0


# ── Serving ──


@pytest.fixture
def owner(hub, tmp_path):
    b = _bridge(hub, tmp_path / "owner")
    warm_units_parallel(b, _recs(b))
    yield b
    b.close()


def _jserve(bridge, h, fi, flags):
    """The JAX package's answer over the same cache directory."""
    jcfg = JConfig(hf_home=bridge.cfg.hf_home, cache_dir=bridge.cfg.cache_dir)
    return j_dcn.serve_chunk_range(jcfg, JXorbCache(jcfg), h,
                                   fi.range.start, fi.range.end, flags)


@pytest.mark.parametrize("flags", [0, FLAG_LOSSY_OK, FLAG_QUANT_OK,
                                   FLAG_LOSSY_OK | FLAG_QUANT_OK])
def test_serve_matches_reference(owner, flags):
    for path in ("weights.bin", "blob.bin"):
        for hh, fi in _units(_rec_for(owner, path)):
            h = hashing.hex_to_hash(hh)
            got = serve_chunk_range(owner.cfg, owner.cache, h,
                                    fi.range.start, fi.range.end, flags)
            assert got == _jserve(owner, h, fi, flags)
            lossy_answer = bool(got[2] & FLAG_LOSSY)
            assert lossy_answer == (bool(flags & FLAG_QUANT_OK)
                                    and path == "weights.bin")
            assert lossy.is_lossy_container(got[1]) == lossy_answer


def test_serve_forwards_staged_container_only_on_opt_in(hub, owner,
                                                       tmp_path):
    hh, fi = _units(_rec_for(owner, "weights.bin"))[0]
    h = hashing.hex_to_hash(hh)
    off, container, flags = serve_chunk_range(
        owner.cfg, owner.cache, h, fi.range.start, fi.range.end,
        FLAG_LOSSY_OK | FLAG_QUANT_OK)
    assert flags & FLAG_LOSSY
    puller = _bridge(hub, tmp_path / "staged-only")
    try:
        lossy.staging_for(puller.cfg.cache_dir).put(hh, off, container)
        j_lossy.staging_for(puller.cfg.cache_dir).put(hh, off, container)
        for ask in (0, FLAG_QUANT_OK):
            assert serve_chunk_range(puller.cfg, puller.cache, h,
                                     fi.range.start, fi.range.end,
                                     ask) is None
            assert _jserve(puller, h, fi, ask) is None
        got = serve_chunk_range(puller.cfg, puller.cache, h, fi.range.start,
                                fi.range.end, FLAG_LOSSY_OK)
        assert got == (off, container, FLAG_LOSSY)
        assert got == _jserve(puller, h, fi, FLAG_LOSSY_OK)
    finally:
        puller.close()


# ── The lossy round ──


def _run_hosts(hub, tmp_path, n, ref=False, **cfg_kw):
    make, server_cls, round_fn = (
        (_jbridge, j_dcn.DcnServer, j_coop.coop_round) if ref
        else (_bridge, DcnServer, coop.coop_round))
    kwargs = {} if ref else {"device": "cpu"}
    bridges, servers, addrs = [], [], {}
    for i in range(n):
        b = make(hub, tmp_path / f"{'j' if ref else 'h'}{i}", **cfg_kw)
        s = server_cls(b.cfg, b.cache)
        addrs[i] = ("127.0.0.1", s.start())
        bridges.append(b)
        servers.append(s)
    results, errors = [None] * n, []

    def run(i):
        try:
            recs = [bridges[i].get_reconstruction(e.xet_hash)
                    for e in HubClient(bridges[i].cfg).list_files(REPO_ID)
                    if e.is_xet]
            results[i] = round_fn(bridges[i], recs, i, n, addrs,
                                  server=servers[i], **kwargs)
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append((i, exc))

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for s in servers:
        s.shutdown()
    assert not errors, errors
    return bridges, results


def _cached_blobs(bridge):
    return [p for p in (bridge.cfg.cache_dir / "xorbs").rglob("*")
            if p.is_file()]


@pytest.mark.parametrize("mode", ["dcn", "wan"])
def test_lossy_round_lands_staging_only(hub, tmp_path, mode):
    """Two hosts in two slices (every link is dcn): with ``dcn`` the float
    units cross quantized into the staging overlay and the stats equal
    the reference round's; ``wan`` arms no dcn link, so the round stays
    byte-exact, as the reference's does."""
    topo = dict(coop_topology=(0, 1), collective_lossy=mode)
    bridges, results = _run_hosts(hub, tmp_path, 2, **topo)
    jbridges, jresults = _run_hosts(hub, tmp_path, 2, ref=True, **topo)
    want = np.frombuffer(FILES["weights.bin"], "<f4")
    try:
        for b, r, jr in zip(bridges, results, jresults):
            cx, ex, jex = r["collective"], r["exchange"], jr["exchange"]
            assert cx["lossy"] == jr["collective"]["lossy"] == mode
            assert "aborted" not in cx
            for k in ("units", "wire_bytes", "unpacked_bytes",
                      "fallback_units", "verify_rejected", "lossy_bytes",
                      "bits_saved_ratio"):
                assert ex.get(k) == jex.get(k), k
            assert cx["link_bytes"] == jr["collective"]["link_bytes"]
            st = lossy.staging_for(b.cfg.cache_dir)
            cached = _cached_blobs(b)
            assert cached
            for p in cached:
                assert not lossy.is_lossy_container(p.read_bytes()), p
            rec = _rec_for(b, "weights.bin")
            if mode == "wan":
                assert set(ex) == EX_KEYS and st.units() == 0
                continue
            assert set(ex) == EX_KEYS | {"lossy_bytes", "bits_saved_ratio"}
            assert ex["lossy_bytes"] > 0 and 0 < ex["bits_saved_ratio"] < 1
            assert st.units() > 0
            got = np.frombuffer(direct.CachedFileReader(
                b.cache, rec, allow_lossy=True).read(0, want.nbytes), "<f4")
            err = np.abs(got - want)
            assert np.max(err) <= np.max(np.abs(want)) / 127.0 + 1e-6
            assert np.any(err > 0), "the lossy tier never engaged"
            with pytest.raises(direct.DirectLandingError):
                direct.CachedFileReader(b.cache, rec).read(0, want.nbytes)
            before = b.stats.bytes_from_cdn
            healed = direct.CachedFileReader(b.cache, rec, bridge=b)
            assert healed.read(0, want.nbytes) == FILES["weights.bin"]
            assert b.stats.bytes_from_cdn > before
            blob_rec = _rec_for(b, "blob.bin")
            assert direct.CachedFileReader(b.cache, blob_rec).read(
                0, len(FILES["blob.bin"])) == FILES["blob.bin"]
    finally:
        for b in bridges + jbridges:
            b.close()


def test_overlay_reader_gate(hub, owner, tmp_path):
    """A staged container is read only by a reader built with
    ``allow_lossy`` (within the bound); byte-exact cache data wins."""
    puller = _bridge(hub, tmp_path / "p")
    try:
        rec = _rec_for(puller, "weights.bin")
        st = lossy.staging_for(puller.cfg.cache_dir)
        units = _units(rec)
        for k, (hh, fi) in enumerate(units):
            entry = owner.cache.get_with_range(hh, fi.range.start)
            blob = XorbReader(entry.data).slice_range(
                fi.range.start - entry.chunk_offset,
                fi.range.end - entry.chunk_offset)
            container = lossy.quantize_blob(blob)
            assert container is not None
            st.put(hh, fi.range.start, container)
            if k == 0:  # one unit byte-exact in the cache too: it wins
                puller.cache.put_partial(hh, fi.range.start, blob)
        want = np.frombuffer(FILES["weights.bin"], "<f4")
        got = np.frombuffer(direct.CachedFileReader(
            puller.cache, rec, allow_lossy=True).read(0, want.nbytes), "<f4")
        assert np.max(np.abs(got - want)) \
            <= np.max(np.abs(want)) / 127.0 + 1e-6
        first = rec.terms[0].unpacked_length // 4
        np.testing.assert_array_equal(got[:first], want[:first])
        assert np.any(got != want)
        with pytest.raises(direct.DirectLandingError, match="not in cache"):
            direct.CachedFileReader(puller.cache, rec).read(0, want.nbytes)
        st.clear()  # nothing staged: the overlay reader misses as well
        with pytest.raises(direct.DirectLandingError, match="not in cache"):
            direct.CachedFileReader(puller.cache, rec,
                                    allow_lossy=True).read(0, want.nbytes)
    finally:
        puller.close()


GPT2_REPO = "acme/lossy-gpt2"


@pytest.fixture(scope="module")
def gpt2_hub():
    files = gpt2_checkpoint_files(n_embd=64, n_layer=2, seed=21)
    with FixtureHub(FixtureRepo(GPT2_REPO, files, chunks_per_xorb=2)) as h:
        yield h, files


def _gpt2_cfg(h, root, **kw):
    return Config(hf_home=root / "hf", cache_dir=root / "zest",
                  hf_token="hf_test", endpoint=h.url, dcn_port=0, **kw)


def test_landings_read_the_overlay_only_without_a_file_sink(gpt2_hub,
                                                           tmp_path):
    """After a lossy round, ``stage_cached_to_hbm`` with no file sink
    lands the staged units lossy (streaming and shard by shard alike),
    while a ``pull_model`` of two cooperating hosts with the tier armed
    lands the byte-exact tree: its landings write files from the decoded
    bytes, so they never read the overlay."""
    h, files = gpt2_hub
    kw = dict(coop_topology=(0, 1), collective_lossy="dcn")
    cfgs = [_gpt2_cfg(h, tmp_path / f"n{i}", **kw) for i in range(2)]
    exact = loader.load_checkpoint(_write(tmp_path / "exact", files), "cpu")
    bridges = [XetBridge(c) for c in cfgs]
    for b in bridges:
        b.authenticate(GPT2_REPO)
    servers = [DcnServer(c, b.cache) for c, b in zip(cfgs, bridges)]
    addrs = {i: ("127.0.0.1", s.start()) for i, s in enumerate(servers)}
    recs = [[b.get_reconstruction(e.xet_hash)
             for e in HubClient(b.cfg).list_files(GPT2_REPO) if e.is_xet]
            for b in bridges]
    out = [None, None]

    def run(i):
        out[i] = coop.coop_round(bridges[i], recs[i], i, 2, addrs,
                                 server=servers[i], device="cpu")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for s in servers:
        s.shutdown()
    assert all(o["exchange"].get("lossy_bytes") for o in out), out
    st_file = next(e for e in HubClient(cfgs[0]).list_files(GPT2_REPO)
                   if e.path == "model.safetensors")
    rec = bridges[0].get_reconstruction(st_file.xet_hash)
    data = files["model.safetensors"]
    header = parse_header_prefix(data)
    for stream in (True, False):
        tree, _ = loader.stage_cached_to_hbm(bridges[0], [(rec, header)],
                                             "cpu", stream=stream)
        assert any(not torch.equal(tree[n], exact[n]) for n in exact), \
            "the staged units were not read"
        landed = bytearray(data)
        for name, t in tree.items():
            lo, hi = header.tensors[name].file_range(header.data_start)
            landed[lo:hi] = t.contiguous().view(torch.uint8).numpy() \
                .tobytes()
        faults, moved, _ = chip_smoke.overlay_faults(
            data, landed, header.data_start, rec,
            lossy.staging_for(cfgs[0].cache_dir))
        assert not faults and moved
    for b in bridges:
        b.close()

    lossy.reset_stagings()
    pulled = [None, None]
    servers = [DcnServer(_gpt2_cfg(h, tmp_path / f"p{i}", **kw))
               for i in range(2)]
    addrs = {i: ("127.0.0.1", s.start()) for i, s in enumerate(servers)}

    def pull(i):
        pulled[i] = pull_model(
            servers[i].cfg, GPT2_REPO, device="cpu", coop=True, coop_hosts=2,
            coop_index=i, coop_addrs=addrs, coop_server=servers[i],
            log=_quiet)

    threads = [threading.Thread(target=pull, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for s in servers:
        s.shutdown()
    for i, res in enumerate(pulled):
        assert res.stats["coop"]["exchange"].get("lossy_bytes"), res.stats
        assert lossy.staging_for(servers[i].cfg.cache_dir).units() > 0
        assert loader.params_digest(res.params) == loader.params_digest(
            exact)
        for name, data in files.items():
            assert (res.snapshot_dir / name).read_bytes() == data


def _write(root, files):
    root.mkdir(parents=True)
    for name, data in files.items():
        (root / name).write_bytes(data)
    return root
