"""``zest bench``: the synthetic benchmark suite.

The reference zest's ``bench --synthetic [--json]`` shape: per-bench
iteration loops on a monotonic clock, the median of the repeat windows
(and the fastest window), text or JSON out. The host benches are the
reference's (bencode, BLAKE3 of 64 KiB, SHA-1 info hash, wire framing)
plus the CDC scan, the one-pass chunk-response framer and a loopback DCN
fetch. The device benches run on ``cuda`` (``device=`` takes ``cpu``):
the BLAKE3 chunk kernel (``ops.blake3_cuda``) over 256 chunks of 64 KiB,
the pod round's gather, ring attention and the GPipe pipeline.

:func:`run_synthetic` skips a host bench whose native library cannot be
built, and a DCN bench without loopback sockets. It does not skip a
device bench: without a card, or when one fails, it raises (the JAX
package's suite drops such a bench silently). ``device=False`` runs the
host suite alone.
"""

from __future__ import annotations

import json
import statistics
import time
from dataclasses import dataclass

CHUNK_64K = 64 * 1024


class BenchUnavailable(RuntimeError):
    """The environment cannot run this bench (no loopback sockets): a
    skip, unlike a bench's failure, which propagates."""


@dataclass
class BenchResult:
    name: str
    iters: int
    median_ns: float
    bytes_per_iter: int
    # The fastest repeat window: a neighbour can slow every window of a
    # short bench, and then the median reports the neighbour.
    best_ns: float = 0.0

    @property
    def mb_per_s(self) -> float:
        if self.median_ns <= 0:
            return float("inf")
        return self.bytes_per_iter / (self.median_ns / 1e9) / 1e6

    @property
    def best_mb_per_s(self) -> float | None:
        """None when no best window was recorded."""
        if self.best_ns <= 0:
            return None
        return self.bytes_per_iter / (self.best_ns / 1e9) / 1e6

    def as_dict(self) -> dict:
        out = {
            "name": self.name,
            "iters": self.iters,
            "median_ns": round(self.median_ns, 1),
            "mb_per_s": round(self.mb_per_s, 1),
        }
        if self.best_mb_per_s is not None:
            out["best_mb_per_s"] = round(self.best_mb_per_s, 1)
        return out


def _time_fn(name: str, fn, bytes_per_iter: int, iters: int,
             repeats: int = 5) -> BenchResult:
    fn()  # warm
    medians = []
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            fn()
        medians.append((time.perf_counter_ns() - t0) / iters)
    return BenchResult(name, iters, statistics.median(medians),
                       bytes_per_iter, best_ns=min(medians))


def _time_device(name: str, fn, bytes_per_iter: int, dev,
                 windows: int = 3, iters: int = 1) -> BenchResult:
    """``windows`` windows of ``iters`` calls of ``fn`` after one warm
    call, each window closed by a device synchronize: the median window
    over ``iters``."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    sync()
    medians = []
    for _ in range(windows):
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            fn()
        sync()
        medians.append((time.perf_counter_ns() - t0) / iters)
    return BenchResult(name, iters, statistics.median(medians),
                       bytes_per_iter)


# ── Host benches ──


def bench_bencode(iters: int = 2000) -> list[BenchResult]:
    from zest_tpu_torch.p2p import bencode

    doc = {
        b"m": {b"ut_xet": 3},
        b"p": 6881,
        b"v": b"zest-tpu/" + b"0.1.0",
        b"payload": b"x" * 512,
    }
    encoded = bencode.encode(doc)
    return [
        _time_fn("bencode_encode", lambda: bencode.encode(doc),
                 len(encoded), iters),
        _time_fn("bencode_decode", lambda: bencode.decode(encoded),
                 len(encoded), iters),
    ]


def bench_blake3_host(iters: int = 200) -> BenchResult:
    from zest_tpu_torch.cas import hashing

    data = bytes(range(256)) * (CHUNK_64K // 256)
    return _time_fn("blake3_64kb", lambda: hashing.blake3_hash(data),
                    CHUNK_64K, iters)


def bench_gearhash_cdc(iters: int = 20) -> BenchResult:
    """The CDC boundary scan over 4 MiB of random bytes (the native
    scanner; a failed build raises ``RuntimeError``)."""
    import numpy as np

    from zest_tpu_torch import native
    from zest_tpu_torch.cas import chunking

    native.build()
    data = np.random.default_rng(3).integers(
        0, 256, 4 * 1024 * 1024, dtype=np.uint8).tobytes()
    return _time_fn("gearhash_cdc_4mb", lambda: chunking.cut_points(data),
                    len(data), iters)


def bench_sha1_info_hash(iters: int = 5000) -> BenchResult:
    from zest_tpu_torch.p2p import peer_id

    xorb = bytes(32)
    return _time_fn("sha1_info_hash",
                    lambda: peer_id.compute_info_hash(xorb), 32 + 12, iters)


def bench_wire_frame(iters: int = 5000) -> BenchResult:
    from zest_tpu_torch.p2p import wire

    payload = b"y" * 1024

    def roundtrip():
        framed = wire.encode_message(wire.MessageId.EXTENDED, payload)
        wire.decode_message_header(framed[:4])
    return _time_fn("bt_wire_frame", roundtrip, 1024 + 5, iters)


def bench_wire_frame_native(iters: int = 2000) -> BenchResult:
    """The one-pass CHUNK_RESPONSE framer (``native/wire.cc``) on a
    64 KiB blob, the seeding loop's own work (a failed native build
    raises ``RuntimeError``)."""
    from zest_tpu_torch import native
    from zest_tpu_torch.p2p import bep_xet

    native.build()
    msg = bep_xet.ChunkResponse(1, 0, b"z" * 65536)
    return _time_fn("xet_frame_64kb", lambda: bep_xet.encode_framed(3, msg),
                    65536 + 19, iters)


def bench_dcn_fetch(n_chunks: int = 64, chunk_bytes: int = CHUNK_64K,
                    window: int = 16, repeats: int = 5) -> BenchResult:
    """Loopback DCN chunk-RPC throughput: one ``DcnServer`` serves a
    cached xorb of ``n_chunks`` random chunks, one channel fetches it in
    ``window`` pipelined sub-range requests. Payload bytes over wall time:
    framing, socket, serve loop and cache slice."""
    import pathlib
    import tempfile

    import numpy as np

    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.cas.xorb import XorbBuilder
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.storage import XorbCache
    from zest_tpu_torch.transfer import dcn

    rng = np.random.default_rng(0)
    builder = XorbBuilder()
    for _ in range(n_chunks):
        builder.add_chunk(rng.integers(0, 256, chunk_bytes,
                                       dtype=np.uint8).tobytes())
    blob = builder.serialize_full()
    with tempfile.TemporaryDirectory() as root:
        rootp = pathlib.Path(root)
        cfg = Config(hf_home=rootp / "hf", cache_dir=rootp / "zest",
                     dcn_port=0)
        cache = XorbCache(cfg)
        xh = builder.xorb_hash()
        cache.put(hashing.hash_to_hex(xh), blob)
        server = dcn.DcnServer(cfg, cache)
        try:
            server.start()
        except OSError as exc:
            raise BenchUnavailable(f"loopback unavailable: {exc}") from exc
        ch = None
        try:
            # A failed connect is a skip; an error during the timed fetch
            # is a failure.
            try:
                ch = dcn.DcnChannel("127.0.0.1", server.port)
            except OSError as exc:
                raise BenchUnavailable(
                    f"loopback connect failed: {exc}") from exc
            step = max(1, n_chunks // window)
            wants = [(xh, i, min(i + step, n_chunks))
                     for i in range(0, n_chunks, step)]

            def fetch_all():
                for r in ch.request_many(wants):
                    if not isinstance(r, dcn.DcnResponse):
                        raise RuntimeError(f"DCN bench got {type(r)}")

            return _time_fn("dcn_fetch_pipelined", fetch_all,
                            n_chunks * chunk_bytes, iters=3,
                            repeats=repeats)
        finally:
            if ch is not None:
                ch.close()
            server.shutdown()


# ── Device benches ──


def bench_blake3_device(batch: int = 256, iters: int = 8,
                        device: str = "cuda") -> BenchResult:
    """The BLAKE3 chunk kernel (``ops.blake3_cuda.CudaHasher``) over
    ``batch`` random 64 KiB chunks, ``iters`` launches a window, a
    synchronize closing each of three windows."""
    import numpy as np
    import torch

    from zest_tpu_torch.config import resolve_device
    from zest_tpu_torch.ops.blake3_cuda import CudaHasher

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    host = rng.integers(0, 256, size=(batch, CHUNK_64K), dtype=np.uint8)
    words = torch.from_numpy(host).view(torch.uint32).to(dev)
    lengths = torch.full((batch,), CHUNK_64K, dtype=torch.int32, device=dev)
    hasher = CudaHasher(device=dev)
    return _time_device("blake3_64kb_device",
                        lambda: hasher.hash_device(words, lengths),
                        batch * CHUNK_64K, dev, iters=iters)


def _devices(device: str) -> list:
    """Every CUDA device for ``cuda``, else the one CPU device."""
    from zest_tpu_torch.config import resolve_device
    from zest_tpu_torch.parallel.mesh import pod_mesh

    dev = resolve_device(device)
    return pod_mesh() if dev.type == "cuda" else pod_mesh([dev])


def bench_ici_all_gather(mbytes_per_device: int = 16,
                         device: str = "cuda") -> BenchResult:
    """The pod round's gather and replicate over every device of
    ``device``'s type: one "iteration" moving what reaches a device from
    the others at the measured rate."""
    from zest_tpu_torch.parallel.collectives import all_gather_throughput

    mesh = _devices(device)
    n = len(mesh)
    gbps = all_gather_throughput(mesh, mbytes_per_device=mbytes_per_device)
    moved = mbytes_per_device * 1024 * 1024 * n * max(n - 1, 1)
    ns = moved / (gbps * 1e9) * 1e9 if gbps > 0 else 0.0
    return BenchResult("ici_all_gather", 1, ns, moved)


def bench_ring_attention(t_per_device: int = 1024, heads: int = 8,
                         head_dim: int = 64,
                         device: str = "cuda") -> BenchResult:
    """Causal ring attention (``parallel.ring``) over T = t_per_device ×
    devices tokens of bf16 (1, T, heads, head_dim) q/k/v, one block a
    device of a ``seq`` mesh. Bytes an iteration: the q/k/v operands."""
    import numpy as np
    import torch

    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.parallel.ring import ring_attention

    devices = _devices(device)
    dev, n = devices[0], len(devices)
    T = t_per_device * n
    rng = np.random.default_rng(0)

    def mk():
        return torch.from_numpy(rng.standard_normal(
            (1, T, heads, head_dim))).to(dev, torch.bfloat16)

    q, k, v = mk(), mk(), mk()
    mesh = model_mesh({"seq": n}, devices)
    with torch.no_grad():
        return _time_device(
            "ring_attention",
            lambda: ring_attention(q, k, v, mesh, seq_axis="seq",
                                   causal=True),
            3 * q.nbytes, dev)


def bench_pipeline(layers: int = 8, width: int = 512, rows: int = 2048,
                   device: str = "cuda") -> BenchResult:
    """The GPipe pipeline (``parallel.pipeline``): ``layers`` bf16
    dense+tanh layers a device over ``rows`` activations, microbatched
    twice the stage count. Bytes an iteration: the activations in."""
    import numpy as np
    import torch

    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.parallel.pipeline import pipeline_blocks

    devices = _devices(device)
    dev, n = devices[0], len(devices)
    mesh = model_mesh({"pipe": n}, devices)
    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(
        rng.standard_normal((layers * n, width, width)) * 0.1).to(
            dev, torch.bfloat16)}
    x = torch.from_numpy(rng.standard_normal((rows, width))).to(
        dev, torch.bfloat16)

    def block(x, p):
        return torch.tanh(x @ p["w"]), None

    with torch.no_grad():
        return _time_device(
            "pipeline_gpipe",
            lambda: pipeline_blocks(block, params, x, mesh, 2 * n),
            x.nbytes, dev)


def run_synthetic(device: bool = True) -> list[BenchResult]:
    """The host suite, then (``device``) the device benches on ``cuda``,
    which raise without a card."""
    results = bench_bencode()
    results += [bench_blake3_host(), bench_sha1_info_hash(),
                bench_wire_frame()]
    for bench in (bench_gearhash_cdc, bench_wire_frame_native):
        try:
            results.append(bench())
        except RuntimeError:
            pass  # no native library: the benches above still stand
    try:
        results.append(bench_dcn_fetch())
    except BenchUnavailable:
        pass  # no loopback sockets; a failed fetch still raises
    if device:
        for bench in (bench_blake3_device, bench_ici_all_gather,
                      bench_ring_attention, bench_pipeline):
            results.append(bench())
    return results


def format_results(results: list[BenchResult], as_json: bool) -> str:
    if as_json:
        return json.dumps([r.as_dict() for r in results], indent=2)
    lines = [f"{'bench':24} {'iters':>7} {'median':>14} {'MB/s':>12}"]
    for r in results:
        lines.append(f"{r.name:24} {r.iters:>7} {r.median_ns:>12.0f}ns "
                     f"{r.mb_per_s:>12.1f}")
    return "\n".join(lines)
