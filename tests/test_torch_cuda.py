"""The port on the card: the CUDA kernels and the slice on ``cuda``.

Every test here needs a CUDA device (``cuda`` marker) and skips with a
reason where there is none. This file imports nothing of jax or the JAX
package, so it runs on the card's machine, which has neither:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: tests/conftest.py configures jax for the JAX
package's tests.) ``chip_smoke.py`` runs the same slice at full GPT-2
width.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from zest_tpu_torch import native
from zest_tpu_torch.cas import compression
from zest_tpu_torch.cas.hashing import CHUNK_KEY
from zest_tpu_torch.config import Config
from zest_tpu_torch.ops import CudaHasher, DeviceHasher, unit_verify_hasher
from zest_tpu_torch.ops import bg4, bg4_cuda, blake3_cuda
from zest_tpu_torch.ops import blake3 as plain

pytestmark = pytest.mark.cuda

_RNG = np.random.default_rng(17)
_LENGTHS = (0, 1, 63, 64, 1023, 1024, 1025, 2049, 7 * 1024 + 3, 65536,
            131071, 131072)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("key", [None, CHUNK_KEY], ids=["plain", "chunk_key"])
def test_kernel_matches_plain_and_native(cuda_device, key):
    chunks = [_RNG.bytes(n) for n in _LENGTHS]
    got = CudaHasher(key, cuda_device).hash_batch(chunks)
    assert got == DeviceHasher(key).hash_batch(chunks)
    assert got == [native.lib.blake3(c) if key is None
                   else native.lib.blake3_keyed(key, c) for c in chunks]


def test_kernel_masks_garbage_past_length(cuda_device):
    chunks = [_RNG.bytes(n) for n in _LENGTHS]
    words, lengths = plain.stage_batch(chunks, cuda_device)
    raw = words.view(torch.uint8)
    junk = torch.randint(0, 256, raw.shape, device=cuda_device,
                         dtype=torch.uint8)
    past = (torch.arange(raw.shape[1], device=cuda_device)[None, :]
            >= lengths[:, None])
    dirty = torch.where(past, junk, raw).contiguous().view(torch.uint32)
    h = CudaHasher(CHUNK_KEY, cuda_device)
    assert torch.equal(h.hash_device(dirty, lengths),
                       h.hash_device(words, lengths))


def test_launch_count(cuda_device):
    blake3_cuda.COUNTER.reset()
    h = unit_verify_hasher(CHUNK_KEY)
    assert isinstance(h, CudaHasher)
    assert h.hash_batch([]) == []
    h.hash_batch([b"abc", b"x" * 5000])
    torch.cuda.synchronize()
    assert (blake3_cuda.COUNTER.launches, blake3_cuda.COUNTER.rows) == (1, 2)


def test_kernel_rejects_bad_capacity_on_card(cuda_device):
    h = CudaHasher(device=cuda_device)
    with pytest.raises(ValueError, match="128 KiB"):
        h.hash_device(
            torch.zeros((1, 129 * 256), dtype=torch.uint32,
                        device=cuda_device),
            torch.zeros(1, dtype=torch.int32, device=cuda_device))


_BG4_LENGTHS = (0, 1, 2, 3, 4, 5, 1023, 1024, 1025, 65535, 65536, 131072)


def _bg4_batch(device):
    chunks = [(_RNG.standard_normal(-(-n // 4), dtype=np.float32) * 0.02)
              .tobytes()[:n] for n in _BG4_LENGTHS]
    words, lengths = bg4.stage_planar([compression._bg4(c) for c in chunks],
                                      list(_BG4_LENGTHS), device)
    return chunks, words, lengths


def test_bg4_regroup_matches_plain(cuda_device):
    chunks, words, _ = _bg4_batch(cuda_device)
    bg4_cuda.COUNTER.reset()
    got = bg4_cuda.launch(words)
    torch.cuda.synchronize()
    assert torch.equal(got, bg4.regroup_words(words))
    assert (bg4_cuda.COUNTER.launches, bg4_cuda.COUNTER.rows) == (
        1, len(chunks))
    rows = got.cpu().view(torch.uint8).numpy()
    for row, c in zip(rows, chunks):
        assert row[:len(c)].tobytes() == c
    with pytest.raises(ValueError, match="16-byte multiple"):
        bg4_cuda.launch(torch.zeros((1, 6), dtype=torch.uint32,
                                    device=cuda_device))


@pytest.mark.parametrize("key", [None, CHUNK_KEY], ids=["plain", "chunk_key"])
def test_bg4_fused_matches_plain_and_native(cuda_device, key):
    chunks, words, lengths = _bg4_batch(cuda_device)
    raw = words.view(torch.uint8)
    junk = torch.randint(0, 256, raw.shape, device=cuda_device,
                         dtype=torch.uint8)
    slot = raw.shape[1] // 4
    keep = torch.zeros_like(raw, dtype=torch.bool)
    for i, n in enumerate(_BG4_LENGTHS):
        for k, size in enumerate(bg4.bg4_plane_sizes(n)):
            keep[i, k * slot:k * slot + size] = True
    dirty = torch.where(keep, raw, junk).contiguous().view(torch.uint32)
    v = bg4.FusedBg4Verifier(key, cuda_device)
    got = v.hash_planar_device(dirty, lengths)
    assert torch.equal(got, v.hash_planar_device(words, lengths))
    assert torch.equal(got, bg4.fused_regroup_hash(
        words, lengths, v.key_words, v.base_flags))
    assert plain.digests_to_bytes(got) == [
        native.lib.blake3(c) if key is None
        else native.lib.blake3_keyed(key, c) for c in chunks]


# Every leaf count 1-128 at its last leaf's edges: one byte short of n
# KiB, n KiB, and one byte over (the 32-leaf group edges among them).
_EDGE_LENGTHS = tuple(sorted({max(1024 * n + d, 0) for n in range(1, 129)
                              for d in (-1, 0, 1)} - {131073}))


def _dirty_past(words, keep):
    """``words`` with random bytes wherever ``keep`` is False."""
    raw = words.view(torch.uint8)
    junk = torch.randint(0, 256, raw.shape, device=raw.device,
                         dtype=torch.uint8)
    return torch.where(keep, raw, junk).contiguous().view(torch.uint32)


@pytest.mark.parametrize("key", [None, CHUNK_KEY], ids=["plain", "chunk_key"])
def test_kernel_every_leaf_count(cuda_device, key):
    """Kernel #1 at every leaf count and group edge, garbage past every
    length: equal to its plain version and the native host BLAKE3."""
    chunks = [_RNG.bytes(n) for n in _EDGE_LENGTHS]
    words, lengths = plain.stage_batch(chunks, cuda_device)
    dirty = _dirty_past(words, torch.arange(
        words.shape[1] * 4, device=cuda_device)[None, :] < lengths[:, None])
    h = CudaHasher(key, cuda_device)
    got = h.hash_device(dirty, lengths)
    assert torch.equal(got, plain.hash_words(words, lengths, h.key_words,
                                             h.base_flags))
    assert plain.digests_to_bytes(got) == [
        native.lib.blake3(c) if key is None
        else native.lib.blake3_keyed(key, c) for c in chunks]


@pytest.mark.parametrize("key", [None, CHUNK_KEY], ids=["plain", "chunk_key"])
def test_fused_every_leaf_count(cuda_device, key):
    """The fused kernel at every leaf count and group edge, garbage past
    every plane: equal to the plain fused pass and the native host BLAKE3;
    one fused launch, no regroup launch."""
    chunks = [(_RNG.standard_normal(-(-n // 4), dtype=np.float32) * 0.02)
              .tobytes()[:n] for n in _EDGE_LENGTHS]
    words, lengths = bg4.stage_planar([compression._bg4(c) for c in chunks],
                                      list(_EDGE_LENGTHS), cuda_device)
    slot = words.shape[1]
    keep = torch.zeros((len(chunks), 4 * slot), dtype=torch.bool)
    for i, n in enumerate(_EDGE_LENGTHS):
        for k, size in enumerate(bg4.bg4_plane_sizes(n)):
            keep[i, k * slot:k * slot + size] = True
    dirty = _dirty_past(words, keep.to(cuda_device))
    v = bg4.FusedBg4Verifier(key, cuda_device)
    bg4_cuda.COUNTER.reset()
    bg4_cuda.FUSED_COUNTER.reset()
    got = v.hash_planar_device(dirty, lengths)
    torch.cuda.synchronize()
    assert (bg4_cuda.FUSED_COUNTER.launches, bg4_cuda.FUSED_COUNTER.rows,
            bg4_cuda.COUNTER.launches) == (1, len(chunks), 0)
    assert torch.equal(got, bg4.fused_regroup_hash(
        words, lengths, v.key_words, v.base_flags))
    assert plain.digests_to_bytes(got) == [
        native.lib.blake3(c) if key is None
        else native.lib.blake3_keyed(key, c) for c in chunks]


def _tiny_gpt2(root):
    from zest_tpu_torch.models.safetensors_io import write_safetensors

    rng = np.random.default_rng(5)
    E, L, V, C = 64, 2, 256, 64
    cfg = dict(model_type="gpt2", vocab_size=V, n_positions=C, n_ctx=C,
               n_embd=E, n_layer=L, n_head=4, layer_norm_epsilon=1e-5)
    t = {"wte.weight": rng.normal(0, 0.02, (V, E)),
         "wpe.weight": rng.normal(0, 0.01, (C, E)),
         "ln_f.weight": np.ones(E), "ln_f.bias": np.zeros(E)}
    shapes = {"ln_1.weight": (E,), "ln_1.bias": (E,), "ln_2.weight": (E,),
              "ln_2.bias": (E,), "attn.c_attn.weight": (E, 3 * E),
              "attn.c_attn.bias": (3 * E,), "attn.c_proj.weight": (E, E),
              "attn.c_proj.bias": (E,), "mlp.c_fc.weight": (E, 4 * E),
              "mlp.c_fc.bias": (4 * E,), "mlp.c_proj.weight": (4 * E, E),
              "mlp.c_proj.bias": (E,)}
    for i in range(L):
        for leaf, shape in shapes.items():
            t[f"h.{i}.{leaf}"] = rng.normal(0, 0.02, shape)
    root.mkdir()
    (root / "config.json").write_text(json.dumps(cfg))
    write_safetensors(root / "model.safetensors",
                      {k: v.astype(np.float32) for k, v in t.items()})
    return root


def test_slice_on_card(cuda_device, tmp_path):
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    ckpt = _tiny_gpt2(tmp_path / "ckpt")
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest", push_chunks_per_xorb=2)
    blake3_cuda.COUNTER.reset()
    pushed = push_checkpoint(cfg_a, "org/tiny", ckpt)
    assert blake3_cuda.COUNTER.launches == pushed.new_xorbs > 1
    assert blake3_cuda.COUNTER.rows == pushed.minted_chunks
    with PublisherServer(cfg_a) as server:
        res = pull_model(Config(hf_home=tmp_path / "b" / "hf",
                                cache_dir=tmp_path / "b" / "zest",
                                endpoint=server.url), "org/tiny")
    hbm = res.stats["hbm"]
    assert hbm["direct"] is hbm["streamed"] is True
    assert all(t.device == cuda_device for t in res.params.values())
    assert params_digest(res.params) == params_digest(
        load_checkpoint(res.snapshot_dir, "cpu"))
    _, gen = load_generator(res.snapshot_dir, tensors=res.params)
    _, gen_cpu = load_generator(res.snapshot_dir, device="cpu")
    prompts = [[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]]
    assert np.array_equal(gen(prompts, 16), gen_cpu(prompts, 16))


def test_peer_pull_on_card(cuda_device, tmp_path):
    """The peer tier on the card: node B pulls from the CDN and seeds its
    cache over the BT wire; node C pulls with B as its direct peer onto
    ``cuda:0``. Every xorb byte comes from the peer, the landing streams,
    and the tree's digest equals a CPU landing of the same repo."""
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.models.loader import params_digest
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint
    from zest_tpu_torch.transfer.server import BtServer
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    ckpt = _tiny_gpt2(tmp_path / "ckpt")
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest", push_chunks_per_xorb=2)
    push_checkpoint(cfg_a, "org/tiny", ckpt)

    def node(name):
        return Config(hf_home=tmp_path / name / "hf",
                      cache_dir=tmp_path / name / "zest",
                      endpoint=server.url, listen_port=0)

    with PublisherServer(cfg_a) as server:
        cpu = pull_model(node("b"), "org/tiny", device="cpu", no_p2p=True)
        seeder = BtServer(node("b"))
        port = seeder.start()
        swarm = SwarmDownloader(node("c"))
        swarm.add_direct_peer("127.0.0.1", port)
        try:
            res = pull_model(node("c"), "org/tiny", swarm=swarm)
        finally:
            swarm.close()
            seeder.shutdown()
    fetch = res.stats["fetch"]
    assert fetch["bytes"]["cdn"] == 0 and fetch["p2p_ratio"] == 1.0
    assert res.stats["swarm"]["peer_failures"] == 0
    hbm = res.stats["hbm"]
    assert hbm["direct"] is hbm["streamed"] is True
    assert all(t.device == cuda_device for t in res.params.values())
    assert params_digest(res.params) == params_digest(cpu.params)


def test_discovered_parallel_rung_on_card(cuda_device, tmp_path):
    """Phase 15d at a tiny width: a seeder registered with a loopback
    tracker, found through it by a files-only pull on ``cuda`` (the
    default device) whose xet file the ``ParallelDownloader`` writes over
    the shared term pool; then a landing on ``cuda:0`` through the same
    swarm. Every xorb byte from the peer, no kernel launch on the path."""
    import chip_smoke
    from zest_tpu_torch import cli, storage
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.p2p.tracker import TrackerClient
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint
    from zest_tpu_torch.transfer.server import BtServer
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    ckpt = _tiny_gpt2(tmp_path / "ckpt")
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest", push_chunks_per_xorb=2)
    push_checkpoint(cfg_a, "org/tiny", ckpt)

    def node(name):
        return Config(hf_home=tmp_path / name / "hf",
                      cache_dir=tmp_path / name / "zest",
                      endpoint=server.url, listen_port=0)

    tracker = chip_smoke.LoopbackTracker()
    with PublisherServer(cfg_a) as server:
        cfg_b = node("b")
        pull_model(cfg_b, "org/tiny", device="cpu", no_p2p=True)
        seeder = BtServer(cfg_b)
        cfg_b.listen_port = seeder.start()
        seed = SwarmDownloader(cfg_b, peer_sources=[TrackerClient(
            tracker.url, b"s" * 20, listen_port=cfg_b.listen_port)])
        seed.announce_xorbs(storage.list_cached_xorbs(cfg_b))
        seed.close()
        swarm = cli._build_swarm(node("c"), tracker=tracker.url, dht=False)
        blake3_cuda.COUNTER.reset()
        bg4_cuda.FUSED_COUNTER.reset()
        try:
            with chip_smoke.RungLog() as rungs:
                files = pull_model(node("c"), "org/tiny", swarm=swarm,
                                   land=False)
            landed = pull_model(node("d"), "org/tiny", swarm=swarm)
        finally:
            swarm.close()
            seeder.shutdown()
            tracker.close()
    assert sorted(rungs.rows) == [("parallel", "model.safetensors"),
                                  ("plain", "config.json")]
    for res in (files, landed):
        assert res.stats["fetch"]["bytes"]["cdn"] == 0
        assert res.stats["swarm"]["peers_discovered"] > 0
        for f in ckpt.iterdir():
            assert (res.snapshot_dir / f.name).read_bytes() == f.read_bytes()
    assert files.stats["files_pipeline"]["lane_bytes"] == {
        "waterfall": sum(f.stat().st_size for f in ckpt.iterdir())}
    assert files.stats["fallback_files"] == 0
    assert all(t.device == cuda_device for t in landed.params.values())
    assert params_digest(landed.params) == params_digest(
        load_checkpoint(ckpt, "cpu"))
    assert blake3_cuda.COUNTER.launches == 0
    assert bg4_cuda.FUSED_COUNTER.launches == 0


def test_coop_pull_on_card(cuda_device, tmp_path):
    """Four in-process hosts pull cooperatively on ``cuda``: every received
    whole xorb's BG4 chunks go through the fused kernel once, and the
    standalone regroup kernel never runs."""
    import threading

    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.cas.compression import Scheme
    from zest_tpu_torch.cas.xorb import XorbReader
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.transfer.dcn import DcnServer
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    ckpt = _tiny_gpt2(tmp_path / "ckpt")
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest", push_chunks_per_xorb=2)
    pushed = push_checkpoint(cfg_a, "org/tiny", ckpt)
    bg4_chunks = sum(
        int((XorbReader(cfg_a.xorb_cache_path(h).read_bytes()).chunk_schemes
             == int(Scheme.BG4_LZ4)).sum()) for h in pushed.xorb_digests)
    assert bg4_chunks > 0
    n = 4
    cfgs = [Config(hf_home=tmp_path / f"h{i}" / "hf",
                   cache_dir=tmp_path / f"h{i}" / "zest", dcn_port=0)
            for i in range(n)]
    servers = [DcnServer(c) for c in cfgs]
    addrs = {i: ("127.0.0.1", s.start()) for i, s in enumerate(servers)}
    results, errors = [None] * n, []
    bg4_cuda.COUNTER.reset()
    bg4_cuda.FUSED_COUNTER.reset()
    with PublisherServer(cfg_a) as server:
        for c in cfgs:
            c.endpoint = server.url

        def run(i):
            try:
                results[i] = pull_model(
                    cfgs[i], "org/tiny", coop=True, coop_hosts=n,
                    coop_index=i,
                    coop_addrs={j: a for j, a in addrs.items() if j != i},
                    coop_server=servers[i], log=lambda *a, **k: None)
            except Exception as exc:  # noqa: BLE001 - asserted below
                errors.append(exc)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    for s in servers:
        s.shutdown()
    assert not errors, errors
    want = params_digest(load_checkpoint(ckpt, "cpu"))
    for res in results:
        c = res.stats["coop"]
        assert c["fallbacks"] == 0 and c["exchange"]["verify_rejected"] == 0
        assert params_digest(res.params) == want
    assert bg4_cuda.FUSED_COUNTER.rows == (n - 1) * bg4_chunks
    assert bg4_cuda.COUNTER.launches == 0


# ── The streaming landing on the card ──


def test_ring_slots_pinned_and_reused(cuda_device):
    """Ring slots are page-locked, and a released slot's buffer serves the
    next acquire that fits (no second pinned allocation)."""
    from zest_tpu_torch.models.loader import HostRing

    ring = HostRing(1 << 20, 4, pin=True)
    a = ring.acquire(600_000)
    assert a.tensor.is_pinned() and a.buffer.is_pinned()
    ptr = a.buffer.data_ptr()
    a.release()
    b = ring.acquire(500_000)
    assert b.buffer.data_ptr() == ptr
    assert (ring.allocs, ring.reuses) == (1, 1)
    b.release()
    ring.close()


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["raw", "bf16"])
def test_commit_orders_current_stream_after_copies(cuda_device, dtype):
    """The side stream's copies run behind a ~50 ms spin; the landed
    tensors read on the current stream after ``finish`` (with no device
    sync) hold the slot's bytes, cast on the host where asked."""
    from zest_tpu_torch.models.loader import (
        HostRing, _DeviceCommit, cast_floating,
    )
    from zest_tpu_torch.models.safetensors_io import TensorInfo

    rng = np.random.default_rng(3)
    host = {"a": rng.standard_normal((256, 64), dtype=np.float32),
            "b": rng.integers(0, 1 << 30, (1000,), dtype=np.int32)}
    ring = HostRing(1 << 22, 4, pin=True)
    slot = ring.acquire(sum(a.nbytes for a in host.values()))
    items, off = [], 0
    for name, arr in host.items():
        raw = arr.reshape(-1).view(np.uint8)
        slot.view[off:off + raw.nbytes] = raw
        info = TensorInfo(name, "F32" if arr.dtype == np.float32 else "I32",
                          arr.shape, (off, off + raw.nbytes))
        items.append((name, info, slot, off, off + raw.nbytes))
        off += raw.nbytes
    committer = _DeviceCommit(cuda_device, dtype)
    with torch.cuda.stream(committer.side):
        torch.cuda._sleep(100_000_000)
    landed, (done, _keep) = committer.commit(items)
    committer.finish()
    copies = {n: t.clone() for n, t in landed.items()}
    torch.cuda.current_stream(cuda_device).synchronize()
    assert done.query()
    for name, arr in host.items():
        want = cast_floating(torch.from_numpy(arr), dtype)
        got = copies[name]
        assert got.device == cuda_device and got.dtype == want.dtype
        assert torch.equal(got.cpu().view(torch.uint8),
                           want.contiguous().view(torch.uint8))
    slot.release()
    ring.close()


def test_tight_ring_landing_on_card(cuda_device, tmp_path):
    """The streaming landing on ``cuda`` straight from a warm cache
    through a ring far smaller than the checkpoint (no file sink holds a
    slot): slots are reused, the first layer is resident before the
    landing returns, and the tree sits on ``cuda:0`` with the CPU
    landing's digest, read on the current stream with no device sync."""
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.models.loader import (
        load_checkpoint, params_digest, stage_cached_to_hbm,
    )
    from zest_tpu_torch.transfer.bridge import XetBridge
    from zest_tpu_torch.transfer.federated import warm_units_parallel
    from zest_tpu_torch.transfer.pod import fetch_file_header
    from zest_tpu_torch.transfer.push import push_checkpoint

    ckpt = _tiny_gpt2(tmp_path / "ckpt")
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest", push_chunks_per_xorb=2)
    push_checkpoint(cfg_a, "org/tiny", ckpt)
    first: list = []
    with PublisherServer(cfg_a) as server:
        cfg = Config(hf_home=tmp_path / "b" / "hf",
                     cache_dir=tmp_path / "b" / "zest", endpoint=server.url)
        bridge = XetBridge(cfg)
        try:
            bridge.authenticate("org/tiny")
            entry = next(e for e in HubClient(cfg).list_files("org/tiny")
                         if e.path == "model.safetensors")
            rec = bridge.get_reconstruction(entry.xet_hash)
            header = fetch_file_header(bridge, rec)
            warm_units_parallel(bridge, [rec])
            params, stats = stage_cached_to_hbm(
                bridge, [(rec, header)], cuda_device, stream=True,
                ring_bytes=256 * 1024, ring_slots=2,
                on_first_layer=lambda: first.append(True))
        finally:
            bridge.close()
    assert stats["streamed"] is True and first == [True]
    assert stats["ring"]["buffer_reuses"] > 0
    assert all(t.device == cuda_device for t in params.values())
    assert params_digest(params) == params_digest(
        load_checkpoint(ckpt, "cpu"))


# ── The hot-swap on the card ──


SWAP_REDRAWN = ("h.1.mlp.c_fc.weight", "h.1.mlp.c_proj.weight",
                "ln_f.weight", "ln_f.bias")


def _gpt2_revisions(root):
    """Revisions A and B of a small GPT-2 (B redraws the last block's MLP
    and the final norm), pushed to a publisher node; returns its config
    and both shas."""
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.transfer.push import push_checkpoint

    rng = np.random.default_rng(21)
    E, L, V, C = 256, 2, 512, 64
    cfg = dict(model_type="gpt2", vocab_size=V, n_positions=C, n_ctx=C,
               n_embd=E, n_layer=L, n_head=4, layer_norm_epsilon=1e-5)
    t = {"wte.weight": rng.normal(0, 0.02, (V, E)),
         "wpe.weight": rng.normal(0, 0.01, (C, E)),
         "ln_f.weight": np.ones(E), "ln_f.bias": np.zeros(E)}
    for i in range(L):
        for leaf, shape in (
                ("ln_1.weight", (E,)), ("ln_1.bias", (E,)),
                ("ln_2.weight", (E,)), ("ln_2.bias", (E,)),
                ("attn.c_attn.weight", (E, 3 * E)),
                ("attn.c_attn.bias", (3 * E,)),
                ("attn.c_proj.weight", (E, E)), ("attn.c_proj.bias", (E,)),
                ("mlp.c_fc.weight", (E, 4 * E)), ("mlp.c_fc.bias", (4 * E,)),
                ("mlp.c_proj.weight", (4 * E, E)),
                ("mlp.c_proj.bias", (E,))):
            t[f"h.{i}.{leaf}"] = rng.normal(0, 0.02, shape)
    fine = np.random.default_rng(22)
    cfg_p = Config(hf_home=root / "p" / "hf", cache_dir=root / "p" / "zest")
    shas = []
    for rev in ("a", "b"):
        if rev == "b":
            for name in SWAP_REDRAWN:
                t[name] = (t[name] + fine.normal(0, 0.02, t[name].shape))
        ckpt = root / f"ckpt_{rev}"
        ckpt.mkdir()
        (ckpt / "config.json").write_text(json.dumps(cfg))
        write_safetensors(ckpt / "model.safetensors",
                          {k: v.astype(np.float32) for k, v in t.items()})
        shas.append(push_checkpoint(
            cfg_p, "org/swap", ckpt, notify=False,
            base_revision=shas[0] if shas else None).revision)
    return cfg_p, shas[0], shas[1]


def test_hot_swap_on_card(cuda_device, tmp_path):
    """A delta pull of B over A's tree on ``cuda``: reused tensors keep
    A's ``data_ptr``, the allocated bytes stay within A's tree plus the
    changed tensors (and one commit group at the peak), the base dict
    empties, the tree equals B's CPU landing, and B's files come from
    the cache lane."""
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.transfer.pull import pull_model

    cfg_p, sha_a, sha_b = _gpt2_revisions(tmp_path)
    torch.cuda.synchronize()
    floor = torch.cuda.memory_allocated(cuda_device)
    with PublisherServer(cfg_p) as server:
        cfg = Config(hf_home=tmp_path / "n" / "hf",
                     cache_dir=tmp_path / "n" / "zest", endpoint=server.url,
                     land_ring_bytes=1 << 20, land_ring_slots=4)
        tree = pull_model(cfg, "org/swap", revision=sha_a,
                          log=lambda *a, **k: None).params
        a_bytes = torch.cuda.memory_allocated(cuda_device) - floor
        ptrs = {n: t.data_ptr() for n, t in tree.items()}
        torch.cuda.reset_peak_memory_stats(cuda_device)
        before = torch.cuda.memory_allocated(cuda_device)
        res = pull_model(cfg, "org/swap", revision=sha_b, base_params=tree,
                         base_revision=sha_a, log=lambda *a, **k: None)
        peak = torch.cuda.max_memory_allocated(cuda_device) - before
    swap = res.stats["hbm"]["swap"]
    reused = {n for n, t in res.params.items() if ptrs[n] == t.data_ptr()}
    assert len(reused) == swap["reused_tensors"] > 0
    assert set(SWAP_REDRAWN) <= set(res.params) - reused
    assert not tree
    group = min(64 << 20, (1 << 20) // 4)
    slack = 512 * (swap["landed_tensors"] + 2)  # allocator rounding
    assert peak <= swap["landed_bytes"] + group + slack, (peak, swap)
    after = torch.cuda.memory_allocated(cuda_device) - floor
    assert after <= a_bytes + swap["landed_bytes"] + slack, (after, swap)
    assert params_digest(res.params) == params_digest(
        load_checkpoint(tmp_path / "ckpt_b", "cpu"))


def test_copy_lane_writes_delta_shard_on_card(cuda_device, tmp_path):
    """The swap's shard decodes only its changed tensors, so its file
    comes from the cache lane (stored runs copied, the rest decoded in
    place), byte for byte, while the tree lands on ``cuda``."""
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.transfer.pull import pull_model

    cfg_p, sha_a, sha_b = _gpt2_revisions(tmp_path)
    with PublisherServer(cfg_p) as server:
        cfg = Config(hf_home=tmp_path / "n" / "hf",
                     cache_dir=tmp_path / "n" / "zest", endpoint=server.url)
        tree = pull_model(cfg, "org/swap", revision=sha_a,
                          log=lambda *a, **k: None).params
        res = pull_model(cfg, "org/swap", revision=sha_b, base_params=tree,
                         base_revision=sha_a, log=lambda *a, **k: None)
    lanes = res.stats["files_pipeline"]["lane_bytes"]
    size = (tmp_path / "ckpt_b" / "model.safetensors").stat().st_size
    assert "tensors" not in lanes
    assert lanes.get("copy", 0) + lanes.get("decode", 0) == size, lanes
    for f in ("model.safetensors", "config.json"):
        assert (res.snapshot_dir / f).read_bytes() == (
            tmp_path / "ckpt_b" / f).read_bytes()
    assert all(t.device == cuda_device for t in res.params.values())


def test_swap_waits_for_reads_of_superseded_tensors(cuda_device, tmp_path):
    """A ~50 ms spin on the current stream, then a read of a base tensor
    the swap supersedes, both queued before the swap runs; the caller
    drops its own reference, so the swap's release frees the tensor's
    block while the read is still queued. The new groups' copies wait
    for the current stream: the read sees A's bytes."""
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.transfer.pull import pull_model

    cfg_p, sha_a, sha_b = _gpt2_revisions(tmp_path)
    with PublisherServer(cfg_p) as server:
        cfg = Config(hf_home=tmp_path / "n" / "hf",
                     cache_dir=tmp_path / "n" / "zest", endpoint=server.url,
                     land_ring_bytes=1 << 20, land_ring_slots=4)
        landed = pull_model(cfg, "org/swap", revision=sha_a,
                            log=lambda *a, **k: None).params
        # One block per tensor, as a trainer's tree holds them.
        tree = {n: t.clone() for n, t in landed.items()}
        del landed
        torch.cuda.synchronize()
        name = "h.1.mlp.c_fc.weight"
        want = tree[name].cpu()
        victim = tree[name]
        torch.cuda._sleep(100_000_000)
        seen = victim.clone()  # queued behind the spin
        del victim
        res = pull_model(cfg, "org/swap", revision=sha_b, base_params=tree,
                         base_revision=sha_a, log=lambda *a, **k: None)
        torch.cuda.synchronize()
    assert not tree
    assert torch.equal(seen.cpu(), want)
    assert not torch.equal(res.params[name].cpu(), want)


# ── The Llama family and the sampler on the card ──


def _tiny_llama_tensors(seed: int = 0) -> tuple[dict, dict]:
    """A small Llama-3.2-shaped config (GQA 4:1, llama3 rope scaling,
    tied embeddings) and its HF-named float32 tensors from a seed."""
    cfg = {"model_type": "llama", "vocab_size": 512, "hidden_size": 128,
           "intermediate_size": 256, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 1,
           "head_dim": 32, "max_position_embeddings": 131072,
           "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
           "tie_word_embeddings": True,
           "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                            "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                            "original_max_position_embeddings": 8192}}
    rng = np.random.default_rng(seed)
    E, F, V = 128, 256, 512

    def w(*shape):
        return torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32))

    t = {"model.embed_tokens.weight": w(V, E), "model.norm.weight": 1 + w(E)}
    for i in range(2):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + w(E)
        t[p + "post_attention_layernorm.weight"] = 1 + w(E)
        for name, shape in (("q_proj", (E, E)), ("k_proj", (32, E)),
                            ("v_proj", (32, E)), ("o_proj", (E, E))):
            t[f"{p}self_attn.{name}.weight"] = w(*shape)
        for name, shape in (("gate_proj", (F, E)), ("up_proj", (F, E)),
                            ("down_proj", (E, F))):
            t[f"{p}mlp.{name}.weight"] = w(*shape)
    return cfg, t


def test_llama_cached_decode_on_card_matches_cpu(cuda_device):
    """Prefill and cached-step logits on ``cuda`` (TF32 off) within
    rtol 1e-4 / atol 1e-5 of the CPU's float32 uncached forward at every
    position; greedy tokens equal; the rotary embedding at positions near
    131072 within atol 2e-5 of the CPU's."""
    from zest_tpu_torch.models import llama

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg_json, host = _tiny_llama_tensors()
    cfg = llama.LlamaConfig.from_hf(cfg_json)
    params_cpu = llama.params_from_hf(host, cfg)
    params = llama.params_from_hf(
        {n: t.to(cuda_device) for n, t in host.items()}, cfg)
    prompts = torch.from_numpy(_RNG.integers(0, 512, (4, 6)))
    out = llama.generate_cached(params, cfg, prompts, 10)
    assert torch.equal(out.cpu(), llama.generate_cached(params_cpu, cfg,
                                                        prompts, 10))
    toks = out.to(cuda_device)
    cache = llama.init_kv_cache(cfg, 4, 16, device=cuda_device)
    logits, cache = llama.decode_window(params, cache, toks[:, :6], 0, cfg)
    got = [logits]
    for pos in range(6, 15):
        step, cache = llama.decode_step(params, cache, toks[:, pos], pos,
                                        cfg)
        got.append(step[:, None])
    want = llama.forward(params_cpu, out.cpu(), cfg)[:, :15]
    torch.testing.assert_close(torch.cat(got, 1).cpu(), want, rtol=1e-4,
                               atol=1e-5)
    far = torch.from_numpy(_RNG.normal(0, 1, (2, 8, 4, 32)).astype(
        np.float32))
    torch.testing.assert_close(
        llama._rope(far.to(cuda_device), cfg, 131072 - 8).cpu(),
        llama._rope(far, cfg, 131072 - 8), rtol=0, atol=2e-5)


@pytest.mark.parametrize("settings", [
    {"temperature": 0.8, "top_k": 50}, {"temperature": 1.0, "top_p": 0.9},
    {"temperature": 0.8, "top_k": 50, "top_p": 0.9},
    {"temperature": 3.0, "top_p": 1e-6}])
def test_sampler_masks_on_card_match_cpu(cuda_device, settings):
    """The top-k and nucleus masks, and the draw under one injected
    noise, are the CPU's on the card."""
    from zest_tpu_torch.models import sampling

    logits = torch.from_numpy(_RNG.normal(0, 2, (8, 4096)).astype(
        np.float32))
    logits[0, :16] = 1.0  # ties at the boundary
    cpu = sampling.sample_scores(logits, **settings)
    card = sampling.sample_scores(logits.to(cuda_device), **settings).cpu()
    assert torch.equal(torch.isinf(card), torch.isinf(cpu))
    noise = sampling.gumbel_noise(logits.shape,
                                  torch.Generator().manual_seed(1))
    assert torch.equal(
        sampling.sample_token(logits.to(cuda_device), noise=noise,
                              **settings).cpu(),
        sampling.sample_token(logits, noise=noise, **settings))


def test_seeded_sampling_on_card_repeats(cuda_device):
    from zest_tpu_torch.models import llama

    cfg_json, host = _tiny_llama_tensors(1)
    cfg = llama.LlamaConfig.from_hf(cfg_json)
    params = llama.params_from_hf(
        {n: t.to(cuda_device) for n, t in host.items()}, cfg)
    kw = {"temperature": 0.8, "top_k": 50, "top_p": 0.9}
    prompts = [[1, 2, 3], [4, 5, 6]]
    runs = [llama.generate_cached(params, cfg, prompts, 12, seed=s, **kw)
            for s in (3, 3, 4)]
    assert runs[0].device == cuda_device
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def _tiny_mixtral_tensors(seed: int = 0):
    """A small Mixtral config (8 experts, top-2, GQA 4:2) and its
    HF-named float32 tensors from a seed."""
    cfg = {"model_type": "mixtral", "vocab_size": 512, "hidden_size": 128,
           "intermediate_size": 256, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "max_position_embeddings": 256, "num_local_experts": 8,
           "num_experts_per_tok": 2, "rms_norm_eps": 1e-5,
           "rope_theta": 1e6, "tie_word_embeddings": False}
    rng = np.random.default_rng(seed)
    E, F, V = 128, 256, 512

    def w(*shape):
        return torch.from_numpy(rng.normal(0, 0.05, shape).astype(np.float32))

    t = {"model.embed_tokens.weight": w(V, E), "model.norm.weight": 1 + w(E),
         "lm_head.weight": w(V, E)}
    for i in range(2):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + w(E)
        t[p + "post_attention_layernorm.weight"] = 1 + w(E)
        for name, shape in (("q_proj", (E, E)), ("k_proj", (64, E)),
                            ("v_proj", (64, E)), ("o_proj", (E, E))):
            t[f"{p}self_attn.{name}.weight"] = w(*shape)
        t[p + "block_sparse_moe.gate.weight"] = w(8, E)
        for x in range(8):
            ep = f"{p}block_sparse_moe.experts.{x}."
            t[ep + "w1.weight"] = w(F, E)
            t[ep + "w3.weight"] = w(F, E)
            t[ep + "w2.weight"] = w(E, F)
    return cfg, t


def _snapshot(root, cfg, tensors):
    from zest_tpu_torch.models.safetensors_io import write_safetensors

    root.mkdir(parents=True)
    (root / "config.json").write_text(json.dumps(cfg))
    write_safetensors(root / "model.safetensors", tensors)
    return root


def test_pool_gated_decode_sees_every_commit(cuda_device, tmp_path):
    """Cold decodes racing their landing (a commit group per layer, no
    delay) read every tensor only after its copy completed: each cold
    run's tokens equal the hot run's and the CPU pool's, over several
    evict → re-land cycles, at batch 1 and 4."""
    from zest_tpu_torch.models import hbm_pool

    cfg_json, host = _tiny_llama_tensors(2)
    snap = _snapshot(tmp_path / "llama", cfg_json, host)
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    card, cpu = hbm_pool.HbmPool(cfg, cuda_device), hbm_pool.HbmPool(cfg,
                                                                     "cpu")
    card.group_bytes = 1
    prompts = _RNG.integers(0, 512, (4, 6)).tolist()
    try:
        for batch in (prompts[:1], prompts):
            want, _ = cpu.generate_for(snap, "org/l", batch, 12)
            for cycle in range(3):
                got, info = card.generate_for(snap, "org/l", batch, 12)
                assert info["temp"] == "cold"
                np.testing.assert_array_equal(got, want)
                hot, info = card.generate_for(snap, "org/l", batch, 12)
                assert info["temp"] == "hot"
                np.testing.assert_array_equal(hot, want)
                assert card.evict(snap)
        entry = card._entries[str(snap.resolve())]
        assert entry.lands == 6
    finally:
        card.close()
        cpu.close()


def test_pool_evict_gives_the_memory_back(cuda_device, tmp_path):
    """Evicting a Llama tree and a Mixtral tree (dense core and paged
    experts) brings ``torch.cuda.memory_allocated`` back to where it was;
    the digest survives the round trip."""
    from zest_tpu_torch.models import hbm_pool
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest

    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    pool = hbm_pool.HbmPool(cfg, cuda_device)
    try:
        for name, (cfg_json, host) in (("llama", _tiny_llama_tensors(3)),
                                       ("moe", _tiny_mixtral_tensors(3))):
            snap = _snapshot(tmp_path / name, cfg_json, host)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(cuda_device)
            out, info = pool.generate_for(snap, f"org/{name}", [[1, 2, 3]],
                                          8, temperature=0.9, seed=1)
            entry = pool._entries[str(snap.resolve())]
            held = torch.cuda.memory_allocated(cuda_device) - base
            assert held >= entry.bytes + (entry.pager.bytes
                                          if entry.pager else 0) > 0
            digest = pool.digest(snap)
            if entry.pager is None:
                assert digest == params_digest(load_checkpoint(snap, "cpu"))
            assert pool.evict(snap)
            torch.cuda.synchronize()
            assert torch.cuda.memory_allocated(cuda_device) == base
            again, _ = pool.generate_for(snap, f"org/{name}", [[1, 2, 3]],
                                         8, temperature=0.9, seed=1)
            np.testing.assert_array_equal(again, out)
            assert pool.digest(snap) == digest
            assert pool.evict(snap)
            if entry.pager is not None:
                ex = info["experts"]
                assert ex["page_ins"] > 0 and ex["residency"] < 0.5
    finally:
        pool.close()


def test_daemon_generate_on_card(cuda_device, tmp_path):
    """``POST /v1/generate`` on a daemon serving from ``cuda``: a pushed
    Llama and Mixtral pulled through the daemon's memo and decoded from
    the pool, equal to the family paths on the card."""
    import urllib.request

    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.models import hbm_pool
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.transfer.push import push_checkpoint

    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest")
    for name, (cfg_json, host) in (("llama", _tiny_llama_tensors(4)),
                                   ("moe", _tiny_mixtral_tensors(4))):
        push_checkpoint(cfg_a, f"org/{name}",
                        _snapshot(tmp_path / name, cfg_json, host),
                        notify=False)
    hbm_pool.reset()
    with PublisherServer(cfg_a) as hub:
        cfg_c = Config(hf_home=tmp_path / "c" / "hf",
                       cache_dir=tmp_path / "c" / "zest", endpoint=hub.url)
        with PublisherServer(cfg_c) as daemon:
            for name in ("llama", "moe"):
                body = json.dumps({"repo_id": f"org/{name}",
                                   "ids": [5, 6, 7], "steps": 6,
                                   "stream": True}).encode()
                req = urllib.request.Request(daemon.url + "/v1/generate",
                                             data=body, method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    events = [json.loads(ln[6:]) for ln in
                              r.read().splitlines()
                              if ln.startswith(b"data: ")]
                done = events[-1]
                assert done["event"] == "done", events
                assert [e["event"] for e in events].count("token") == 6
                assert done["pool"]["temp"] == "cold"
                _, family = load_generator(events[1]["snapshot_dir"],
                                           device=cuda_device)
                assert done["ids"] == family([5, 6, 7], 6).tolist()
    hbm_pool.reset()


def test_mesh_pull_and_tensor_parallel_decode_on_card(cuda_device,
                                                     tmp_path):
    """A Llama and a Mixtral repo pulled onto ``["cuda:0"] * 4`` slot
    meshes (``{"model": 4}``, ``{"expert": 4}``): every shard equals the
    same slice of the CPU landing, the digests are the unsharded
    landing's, the Mixtral pull takes the expert-routed round, and the
    tensor- and expert-parallel decodes give the CPU's tokens."""
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.models import moe, tensor_parallel
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    cfg_json, host = _tiny_llama_tensors(6)
    cfg_json = dict(cfg_json, num_key_value_heads=4)
    rng = np.random.default_rng(6)
    for i in range(2):
        for name in ("k_proj", "v_proj"):
            host[f"model.layers.{i}.self_attn.{name}.weight"] = \
                torch.from_numpy(rng.normal(0, 0.02, (128, 128)).astype(
                    np.float32))
    mix_json, mix_host = _tiny_mixtral_tensors(6)
    mix_json = dict(mix_json, num_key_value_heads=4)
    for i in range(2):
        for name in ("k_proj", "v_proj"):
            mix_host[f"model.layers.{i}.self_attn.{name}.weight"] = \
                torch.from_numpy(rng.normal(0, 0.05, (128, 128)).astype(
                    np.float32))
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest")
    for name, cj, h in (("llama", cfg_json, host),
                        ("moe", mix_json, mix_host)):
        push_checkpoint(cfg_a, f"org/{name}",
                        _snapshot(tmp_path / name, cj, h), notify=False)
    prompts = _RNG.integers(0, 512, (4, 6)).tolist()
    with PublisherServer(cfg_a) as hub:
        for name, axes in (("llama", {"model": 4}), ("moe", {"expert": 4})):
            mesh = model_mesh(axes, ["cuda:0"] * 4)
            res = pull_model(Config(hf_home=tmp_path / name / "n" / "hf",
                                    cache_dir=tmp_path / name / "n" / "z",
                                    endpoint=hub.url),
                             f"org/{name}", mesh=mesh)
            assert res.stats["hbm"]["sharded"] is True
            cpu = load_checkpoint(res.snapshot_dir, "cpu")
            for tname, st in res.params.items():
                for slot in range(4):
                    shard = st.shard(slot)
                    assert shard.device == cuda_device
                    assert torch.equal(shard.cpu(),
                                       cpu[tname][st.index(slot)])
            assert params_digest(res.params) == params_digest(cpu)
            if name == "moe":
                pod = res.stats["pod"]
                assert pod["expert_routed"] and pod["n_experts"] == 8
            _, gen = load_generator(res.snapshot_dir, tensors=res.params)
            _, gen_cpu = load_generator(res.snapshot_dir, device="cpu")
            assert np.array_equal(gen(prompts, 8, stop_at_eos=False),
                                  gen_cpu(prompts, 8, stop_at_eos=False))
            if name == "moe":
                mcfg = moe.MoEConfig.from_hf(mix_json)
                params = tensor_parallel.decode_params(
                    moe.params_from_hf(res.params, mcfg), mcfg)
                assert isinstance(params, tensor_parallel.TPParams)
                # Whole experts a slot, each gathered once onto it.
                assert params.experts == [range(2 * s, 2 * s + 2)
                                          for s in range(4)]


def test_adamw_step_on_card_matches_cpu(cuda_device):
    """One AdamW step of Llama (tiny, float32, TF32 off) on the card
    against the same step on the CPU: the loss within 1e-5, the params
    within 1e-5 (Adam's eps-scale gradients amplify the last-ulp
    differences of a few elements; tests/test_torch_training.py has
    why), the moments within 1e-6. Skips without a card."""
    import functools

    from zest_tpu_torch.models import llama, training

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    batch = torch.from_numpy(_RNG.integers(0, cfg.vocab_size, (2, 17)))
    out = []
    for dev in ("cpu", cuda_device):
        tx = training.adamw(lr=1e-3, warmup_steps=0, total_steps=10)
        step = training.make_train_step(
            tx, functools.partial(llama.loss_fn, cfg=cfg))
        # The step updates in place: each run takes its own copy.
        state = training.create_state(
            training.tree_map(lambda t: t.to(dev, copy=True), params), tx)
        state, loss = step(state, batch.to(dev))
        assert state.params["wte"].device.type == torch.device(dev).type
        out.append((state, float(loss)))
    (cpu, cpu_loss), (card, card_loss) = out
    assert abs(card_loss - cpu_loss) <= 1e-5
    for tree, tol in ((lambda s: s.params, 1e-5),
                      (lambda s: s.opt_state.mu, 1e-6)):
        for a, b in zip(training.tree_leaves(tree(cpu)),
                        training.tree_leaves(tree(card))):
            assert float((a - b.cpu()).abs().max()) <= tol


def test_ring_gradient_on_card_slots(cuda_device):
    """Ring attention over ``["cuda:0"] * 4``: the output and the
    gradients of the reverse ring equal dense attention on the card, no
    NaN under causal masking. Skips without a card."""
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.parallel.ring import ring_attention

    mesh = model_mesh({"seq": 4}, [cuda_device] * 4)
    rng = np.random.default_rng(5)
    shapes = ((2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16))

    def run(fn):
        q, k, v = (torch.tensor(rng_arr, device=cuda_device,
                                requires_grad=True)
                   for rng_arr in arrays)
        out = fn(q, k, v)
        (out ** 2).sum().backward()
        return out.detach(), [t.grad for t in (q, k, v)]

    def dense(q, k, v):
        kk = k.repeat_interleave(2, dim=2).transpose(1, 2)
        vv = v.repeat_interleave(2, dim=2).transpose(1, 2)
        scores = q.transpose(1, 2) @ kk.transpose(-1, -2) / 4.0
        mask = torch.ones(32, 32, dtype=torch.bool,
                          device=cuda_device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
        return (torch.softmax(scores, -1) @ vv).transpose(1, 2)

    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    got, g_ring = run(lambda q, k, v: ring_attention(q, k, v, mesh))
    want, g_dense = run(dense)
    assert float((got - want).abs().max()) <= 1e-5
    for a, b in zip(g_ring, g_dense):
        assert not torch.isnan(a).any()
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-4)


def test_federated_round_and_hierarchical_fill_on_card(cuda_device,
                                                       tmp_path):
    """Two pods pull a tiny GPT-2 over ``{"model": 2}`` slots of the card,
    pod 0 first, pod 1 from pod 0 over DCN: pod 1's pod pre-pass launches
    kernels #3/#1 once per whole-xorb unit of its plan and lands the
    CPU's tree. A hierarchical (2, 2) round over the card's slots fills a
    fresh cache through the same kernels, one launch per unit again.
    The launches each fill owes come from ``chip_smoke.plan_launches``,
    phase 14's own rule."""
    import chip_smoke
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.parallel import (
        DistributionPlan,
        HierarchicalDistributor,
        HierarchicalPlan,
        hier_mesh,
    )
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.storage import XorbCache
    from zest_tpu_torch.transfer.bridge import XetBridge
    from zest_tpu_torch.transfer.dcn import DcnServer
    from zest_tpu_torch.transfer.pod import make_unit_verifier
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    ckpt = _tiny_gpt2(tmp_path / "ckpt")
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest", push_chunks_per_xorb=2)
    push_checkpoint(cfg_a, "org/tiny", ckpt, notify=False)
    mesh = model_mesh({"model": 2}, [cuda_device] * 2)
    want_digest = params_digest(load_checkpoint(ckpt, "cpu"))
    with PublisherServer(cfg_a) as hub:
        def node(name):
            return Config(hf_home=tmp_path / name / "hf",
                          cache_dir=tmp_path / name / "zest",
                          endpoint=hub.url, dcn_port=0)

        res0 = pull_model(node("p0"), "org/tiny", pods=2, pod_index=0,
                          mesh=mesh)
        server = DcnServer(node("p0"))
        port = server.start()
        try:
            chip_smoke.reset_counters()
            res1 = pull_model(node("p1"), "org/tiny", pods=2, pod_index=1,
                              pod_addrs={0: ("127.0.0.1", port)}, mesh=mesh)
            got = chip_smoke.read_counters()
        finally:
            server.shutdown()
        bridge = XetBridge(node("p1"))
        bridge.authenticate("org/tiny")
        recs = [bridge.get_reconstruction(e.xet_hash)
                for e in HubClient(bridge.cfg).list_files("org/tiny")
                if e.is_xet]
        bridge.close()
    fed = res1.stats["federated"]
    assert fed["dcn_units"] > 0 and fed["failed_units"] == 0
    assert fed["fallback_units"] == 0
    for res in (res0, res1):
        assert res.stats["pod"]["verify_rejected"] == 0
        assert params_digest(res.params) == want_digest
    assert (got, 0) == chip_smoke.plan_launches(
        DistributionPlan.build(recs, 2), cfg_a)

    plan = HierarchicalPlan.build(recs, 2, 2)
    chip_smoke.reset_counters()
    pool = HierarchicalDistributor(hier_mesh(2, 2, [cuda_device] * 4)) \
        .distribute(plan, lambda a: cfg_a.xorb_cache_path(
            a.hash_hex).read_bytes()[a.fetch_info.url_range_start:
                                     a.fetch_info.url_range_end])
    fresh = Config(hf_home=tmp_path / "h" / "hf",
                   cache_dir=tmp_path / "h" / "zest")
    filled, rejected = pool.fill_cache(XorbCache(fresh),
                                       verify=make_unit_verifier())
    assert (filled, rejected) == (len(plan.flat.assignments), 0)
    assert all(r.device == cuda_device for r in pool.replicas)
    assert (chip_smoke.read_counters(), 0) == chip_smoke.plan_launches(
        plan.flat, cfg_a)


def test_concurrent_tenant_landings_on_card(cuda_device, tmp_path):
    """Two tenants land one revision onto ``cuda:0`` at once, each with
    its own commit stream and events: one CDN copy between them, both
    trees the CPU landing's, both sessions ok."""
    import threading

    from zest_tpu_torch import telemetry
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.models.loader import params_digest
    from zest_tpu_torch.transfer import tenancy
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    tenancy.reset()
    telemetry.session.reset()
    ckpt = _tiny_gpt2(tmp_path / "ckpt")
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest", push_chunks_per_xorb=2)
    push_checkpoint(cfg_a, "org/tiny", ckpt)
    out: dict = {}
    with PublisherServer(cfg_a) as server:
        cpu = pull_model(Config(hf_home=tmp_path / "c" / "hf",
                                cache_dir=tmp_path / "c" / "zest",
                                endpoint=server.url), "org/tiny",
                         device="cpu", no_p2p=True)
        cfg = Config(hf_home=tmp_path / "t" / "hf",
                     cache_dir=tmp_path / "t" / "zest", endpoint=server.url)
        barrier = threading.Barrier(2)

        def pull(tenant):
            barrier.wait()
            out[tenant] = pull_model(cfg, "org/tiny", device=cuda_device,
                                     tenant=tenant, no_p2p=True)

        threads = [threading.Thread(target=pull, args=(t,))
                   for t in ("t0", "t1")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    cdn = sum(r.stats["fetch"]["bytes"]["cdn"] for r in out.values())
    assert cdn == cpu.stats["fetch"]["bytes"]["cdn"]
    for res in out.values():
        assert all(t.device == cuda_device for t in res.params.values())
        assert params_digest(res.params) == params_digest(cpu.params)
    assert sorted((s.tenant, s.status)
                  for s in telemetry.session.SESSIONS.recent()[:2]) \
        == [("t0", "ok"), ("t1", "ok")]
    tenancy.reset()


def test_cancel_mid_landing_gives_the_memory_back(cuda_device, tmp_path):
    """A cancel fired when the first layer is resident: ``PullCancelled``,
    the session ``cancelled``, and after a synchronize and a collection
    the card's allocation is back at its level before the pull."""
    import gc

    import chip_smoke
    from zest_tpu_torch import telemetry
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.transfer import tenancy
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint
    from zest_tpu_torch.transfer.tenancy import CancelToken, PullCancelled

    tenancy.reset()
    telemetry.session.reset()
    ckpt = _tiny_gpt2(tmp_path / "ckpt")
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest", push_chunks_per_xorb=2)
    push_checkpoint(cfg_a, "org/tiny", ckpt)
    token = CancelToken()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    with PublisherServer(cfg_a) as server:
        cfg = Config(hf_home=tmp_path / "t" / "hf",
                     cache_dir=tmp_path / "t" / "zest", endpoint=server.url,
                     land_ring_bytes=64 * 1024, land_ring_slots=4)
        with chip_smoke.first_layer_hook(lambda: token.cancel("test")):
            with pytest.raises(PullCancelled):
                pull_model(cfg, "org/tiny", device=cuda_device,
                           cancel=token, no_p2p=True)
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_device) == base
    assert telemetry.session.SESSIONS.recent()[0].status == "cancelled"
    assert tenancy.summary(cfg)["active"] == 0
    tenancy.reset()


def test_traced_pull_on_card(cuda_device, tmp_path):
    """A traced ``cuda`` pull: the critical path covers >= 90% of
    ``time_to_hbm_s``, its stages sum to the path, and every
    ``hbm.commit`` span lies inside a ``stage.hbm_commit`` span."""
    from zest_tpu_torch import telemetry
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    telemetry.reset_all()
    ckpt = _tiny_gpt2(tmp_path / "ckpt")
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest", push_chunks_per_xorb=2)
    push_checkpoint(cfg_a, "org/tiny", ckpt, notify=False)
    tracer = telemetry.trace.install(None)
    try:
        with PublisherServer(cfg_a) as server:
            res = pull_model(Config(hf_home=tmp_path / "b" / "hf",
                                    cache_dir=tmp_path / "b" / "zest",
                                    endpoint=server.url), "org/tiny",
                             device=cuda_device, no_p2p=True)
        spans = tracer.spans()
    finally:
        telemetry.trace.uninstall()
    cp = res.stats["critical_path"]
    assert cp["path_s"] >= 0.9 * res.stats["time_to_hbm_s"], cp
    assert abs(sum(cp["stages"].values()) - cp["path_s"]) <= 1e-3, cp
    stages = [(s.t0, s.t1) for s in spans if s.name == "stage.hbm_commit"]
    commits = [s for s in spans if s.name == "hbm.commit"]
    assert stages and commits
    for s in commits:
        assert any(a <= s.t0 and s.t1 <= b for a, b in stages), s.name
    telemetry.reset_all()


def test_pool_rush_on_card(cuda_device, tmp_path):
    """The remediation engine's pool rule on ``cuda``: a cold decode
    waiting at its gates while the land sleeps after each flush grows
    ``hbm_pool.gate_stall_s``; the engine's next tick sees it with the
    land in flight and rushes the flushes (``pool_land``), and the rushed
    cold decode's tokens equal a hot decode's."""
    import threading
    import time

    from zest_tpu_torch import telemetry
    from zest_tpu_torch.models import hbm_pool

    telemetry.reset_all()
    assert telemetry.remediate.ensure_started()
    cfg_json, host = _tiny_llama_tensors(4)
    snap = _snapshot(tmp_path / "llama", cfg_json, host)
    pool = hbm_pool.HbmPool(Config(hf_home=tmp_path / "hf",
                                   cache_dir=tmp_path / "zest"), cuda_device)
    pool.group_bytes = 1
    pool.land_delay_s = 0.2
    rush, done = [], threading.Event()

    def ticks():
        while not done.is_set():
            telemetry.timeline.STORE.tick()
            rush.append(pool._rush.is_set())
            time.sleep(0.02)

    ticker = threading.Thread(target=ticks)
    ticker.start()
    try:
        cold, info = pool.generate_for(snap, "org/l", [[1, 2, 3]], 6)
    finally:
        done.set()
        ticker.join()
    try:
        assert info["temp"] == "cold" and info["gate_stall_s"] > 0
        assert any(rush)
        (row,) = [e for e in telemetry.remediate.payload()["recent"]
                  if e["detail"].get("cmd") == "rush"][:1]
        assert row["action"] == "hedge" and row["outcome"] == "success"
        deadline = time.monotonic() + 30
        while pool._landing_count():  # the land's last sleep
            assert time.monotonic() < deadline
            time.sleep(0.01)
        hot, info = pool.generate_for(snap, "org/l", [[1, 2, 3]], 6)
        assert info["temp"] == "hot"
        np.testing.assert_array_equal(cold, hot)
    finally:
        pool.close()
        telemetry.reset_all()


def test_ring_override_on_card(cuda_device, tmp_path):
    """The landing on ``cuda`` reads ``land_ring_bytes`` through the
    engine's tuner: with an override of twice the base the ring's budget
    is doubled and the tree's digest is the CPU landing's; an explicit
    ``ring_bytes`` still wins."""
    from zest_tpu_torch import telemetry
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    telemetry.reset_all()
    ckpt = _tiny_gpt2(tmp_path / "ckpt")
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest", push_chunks_per_xorb=2)
    push_checkpoint(cfg_a, "org/tiny", ckpt, notify=False)
    base = 64 * 1024
    assert telemetry.remediate.ensure_started()
    telemetry.remediate.set_knob_base("land_ring_bytes", base)
    telemetry.remediate.ENGINE._apply_knob("land_ring_bytes", 2 * base, 1,
                                           0.0)
    try:
        with PublisherServer(cfg_a) as server:
            res = pull_model(Config(hf_home=tmp_path / "b" / "hf",
                                    cache_dir=tmp_path / "b" / "zest",
                                    endpoint=server.url,
                                    land_ring_bytes=base), "org/tiny",
                             device=cuda_device, no_p2p=True)
        assert res.stats["hbm"]["ring"]["budget_bytes"] == 2 * base
        assert params_digest(res.params) == params_digest(
            load_checkpoint(ckpt, "cpu"))
        knob = telemetry.remediate.payload()["knobs"]["land_ring_bytes"]
        assert knob["max"] == 8 * base and knob["value"] == 2 * base
    finally:
        telemetry.reset_all()
