#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--steps N]

Drives the port's push → pull → generate slice once, through its entry
points, at the full width of ``openai-community/gpt2`` (12 layers, 768
wide, 50257 vocab; ~124 M f32 parameters, random weights from ``--seed``):

1. build the CUDA BLAKE3 kernel from ``zest_tpu_torch/csrc/blake3.cu``
   and the native host library from ``zest_tpu_torch/native/*.cc``;
2. hold the kernel bit-exact against its plain PyTorch version and the
   native host BLAKE3 on the card (plain and keyed, with garbage past
   each row's length);
3. ``push_checkpoint`` into node A's cache — every minted chunk is
   re-verified by the kernel — then time the kernel and its plain
   version on the largest minted xorb's chunks (the shapes the push gave
   it) against its bound;
4. ``pull_model(device="cuda")`` into a fresh node B through node A's
   loopback publisher endpoint; every xet file must be rebuilt by the
   cache → CDN waterfall (no whole-file fallback), the files must equal
   the pushed ones and the landed tree must sit on ``cuda:0`` with the CPU
   landing's digest;
5. greedy KV-cached decoding at batch 1 and 4 from the landed tree, equal
   to the port's own CPU float32 run.

Every phase is fatal. The last three lines of standard output are the
kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
where ``torch.cuda.is_available()`` is false. Needs one card, no network.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = "openai-community/gpt2"
GPT2_CONFIG = {  # openai-community/gpt2's published config.json
    "model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
    "vocab_size": 50257, "n_positions": 1024, "n_ctx": 1024, "n_embd": 768,
    "n_layer": 12, "n_head": 12, "layer_norm_epsilon": 1e-05,
    "activation_function": "gelu_new", "bos_token_id": 50256,
    "eos_token_id": 50256,
}
KERNEL_LENGTHS = (0, 1, 63, 64, 1023, 1024, 1025, 2049, 65536, 131072)
# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3. Integer rate: 64 INT32
# lanes per SM x 132 SMs x 1.98 GHz boost clock (the same data sheet's
# clock behind its 67 TFLOP/s float32 figure: 128 FP32 lanes x 2 x 132 x
# 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# One compression: 7 rounds x 8 G x 12 u32 instructions + 8 xors for the
# 8 output words. A G as written is 14 ops (6 adds, 4 xors, 4 rotates),
# but each ``a + b + m`` issues as one three-input add (IADD3), so 12 is
# the instruction floor, and the bound, the least time, takes it.
OPS_PER_G = 12
OPS_PER_COMPRESSION = 7 * 8 * OPS_PER_G + 8


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def gpt2_checkpoint(seed: int, cfg: dict) -> dict:
    """HF-named float32 GPT-2 tensors from a numpy seed (LayerNorm
    weights one, biases zero, weights N(0, 0.02))."""
    import torch

    rng = np.random.default_rng(seed)
    E, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]

    def w(*shape, scale=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale)

    t = {"wte.weight": w(V, E), "wpe.weight": w(cfg["n_positions"], E,
                                                 scale=0.01)}
    for i in range(L):
        p = f"h.{i}."
        t[p + "ln_1.weight"] = np.ones(E, np.float32)
        t[p + "ln_1.bias"] = np.zeros(E, np.float32)
        t[p + "attn.c_attn.weight"] = w(E, 3 * E)
        t[p + "attn.c_attn.bias"] = w(3 * E)
        t[p + "attn.c_proj.weight"] = w(E, E)
        t[p + "attn.c_proj.bias"] = w(E)
        t[p + "ln_2.weight"] = np.ones(E, np.float32)
        t[p + "ln_2.bias"] = np.zeros(E, np.float32)
        t[p + "mlp.c_fc.weight"] = w(E, 4 * E)
        t[p + "mlp.c_fc.bias"] = w(4 * E)
        t[p + "mlp.c_proj.weight"] = w(4 * E, E)
        t[p + "mlp.c_proj.bias"] = w(E)
    t["ln_f.weight"] = np.ones(E, np.float32)
    t["ln_f.bias"] = np.zeros(E, np.float32)
    return {k: torch.from_numpy(v) for k, v in t.items()}


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def blake3_work(lengths: np.ndarray) -> tuple[int, int]:
    """``(bytes, compressions)`` the kernel needs for these chunk lengths:
    it reads each row up to its length rounded up to a 64-byte block (at
    least one block), plus a 4-byte length, and writes a 32-byte digest;
    it runs one compression per block plus one per parent node."""
    leaves = np.maximum((lengths + 1023) // 1024, 1)
    blocks = np.maximum((lengths + 63) // 64, 1)
    nbytes = int(blocks.sum()) * 64 + len(lengths) * (4 + 32)
    return nbytes, int(blocks.sum() + (leaves - 1).sum())


def run(args, work: Path) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from zest_tpu_torch import native
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.cas.xorb import XorbReader
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.ops import blake3 as plain
    from zest_tpu_torch.ops import blake3_cuda
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    # ── 1. build ──
    t0 = time.monotonic()
    ptxas = blake3_cuda.build()
    t1 = time.monotonic()
    native.build()
    print(f"phase 1 build: kernel {t1 - t0:.2f} s "
          f"({blake3_cuda.SOURCE.name}, nvcc {' '.join(blake3_cuda.NVCC_FLAGS)}); "
          f"native host library {time.monotonic() - t1:.2f} s (g++)")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    # ── 2. kernel vs plain vs native host BLAKE3, on the card ──
    chunks = [rng.bytes(n) for n in KERNEL_LENGTHS]
    for key in (None, hashing.CHUNK_KEY):
        got = blake3_cuda.CudaHasher(key, dev).hash_batch(chunks)
        want = plain.DeviceHasher(key, dev).hash_batch(chunks)
        host = [native.lib.blake3(c) if key is None
                else native.lib.blake3_keyed(key, c) for c in chunks]
        if got != want or got != host:
            fail(f"kernel digests disagree (keyed={key is not None})")
        words, lengths = plain.stage_batch(chunks, dev)
        raw = words.view(torch.uint8)
        junk = torch.randint(0, 256, raw.shape, device=dev,
                             dtype=torch.uint8)
        past = (torch.arange(raw.shape[1], device=dev)[None, :]
                >= lengths[:, None])
        dirty = torch.where(past, junk, raw).contiguous().view(torch.uint32)
        hasher = blake3_cuda.CudaHasher(key, dev)
        kd = hasher.hash_device(dirty, lengths)
        if not (torch.equal(kd, hasher.hash_device(words, lengths))
                and torch.equal(kd, plain.hash_words(
                    dirty, lengths, hasher.key_words, hasher.base_flags))):
            fail("garbage past a length changed a digest")
    torch.cuda.synchronize()
    print(f"phase 2 kernel == plain == native on {len(chunks)} lengths "
          f"{list(KERNEL_LENGTHS)}, plain and keyed, garbage-tolerant")

    # ── 3. push (the kernel verifies every minted chunk) ──
    ckpt = work / "checkpoint"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(GPT2_CONFIG, indent=2))
    tensors = gpt2_checkpoint(args.seed, GPT2_CONFIG)
    n_params = sum(t.numel() for t in tensors.values())
    write_safetensors(ckpt / "model.safetensors", tensors)
    del tensors
    cfg_a = Config(hf_home=work / "a" / "hf", cache_dir=work / "a" / "zest")
    blake3_cuda.COUNTER.reset()  # counts from here are the main path's
    pushed = push_checkpoint(cfg_a, REPO, ckpt, device="cuda")
    push_chunks = blake3_cuda.COUNTER.chunks
    if blake3_cuda.COUNTER.launches < 1:
        fail("push never launched the BLAKE3 kernel")
    if push_chunks != pushed.minted_chunks:
        fail(f"kernel hashed {push_chunks} chunks, push minted "
             f"{pushed.minted_chunks}")
    print(f"phase 3 push: {n_params:,} params, {pushed.total_bytes:,} bytes "
          f"in {pushed.elapsed_s:.2f} s; {pushed.new_xorbs} xorbs, "
          f"{pushed.minted_chunks} chunks, kernel launches "
          f"{blake3_cuda.COUNTER.launches}")

    # ── 4. pull through node A's loopback publisher ──
    cfg_b = Config(hf_home=work / "b" / "hf", cache_dir=work / "b" / "zest")
    with PublisherServer(cfg_a) as server:
        cfg_b.endpoint = server.url
        pulled = pull_model(cfg_b, REPO, device="cuda")
    st = pulled.stats
    if st["fallback_files"]:
        fail(f"{st['fallback_files']} xet files fell back to a whole-file "
             "download: the cache → CDN reconstruction failed")
    if (st["fetch"]["bytes"]["cache"]
            or st["fetch"]["bytes"]["cdn"] < pushed.new_xorb_bytes):
        fail(f"node B started empty, so all {pushed.new_xorb_bytes:,} "
             f"minted xorb bytes must cross the CDN tier: {st['fetch']}")
    for f in sorted(ckpt.iterdir()):
        if (pulled.snapshot_dir / f.name).read_bytes() != f.read_bytes():
            fail(f"pulled {f.name} differs from the pushed file")
    off = [n for n, t in pulled.params.items() if t.device != dev]
    if off:
        fail(f"{len(off)} tensors not on {dev}: {off[:3]}")
    digest = params_digest(pulled.params)
    if digest != params_digest(load_checkpoint(pulled.snapshot_dir, "cpu")):
        fail("params_digest of the cuda landing != the CPU landing's")
    print(f"phase 4 pull: time_to_hbm_s {st['time_to_hbm_s']} "
          f"(elapsed_s {st['elapsed_s']}, stages {st['stages']}); "
          f"{st['fetch']['bytes']['cdn']:,} bytes in "
          f"{st['fetch']['xorbs']['cdn']} CDN fetches, 0 fallbacks; "
          f"{st['hbm']['tensors']} tensors on {dev}, digest {digest[:16]}")

    # ── 5. greedy decode from the landed tree vs the CPU float32 run ──
    _, gen_cuda = load_generator(pulled.snapshot_dir, device="cuda",
                                 tensors=pulled.params)
    _, gen_cpu = load_generator(pulled.snapshot_dir, device="cpu")
    prompts = rng.integers(0, GPT2_CONFIG["vocab_size"], (4, 8)).tolist()
    for batch in ([prompts[0]], prompts):
        gen_cuda(batch, 2, stop_at_eos=False)  # warm-up (cuBLAS init)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = gen_cuda(batch, args.steps, stop_at_eos=False)
        dt = time.monotonic() - t0
        ref = gen_cpu(batch, args.steps, stop_at_eos=False)
        if not np.array_equal(out, ref):
            fail(f"batch {len(batch)}: cuda tokens != cpu tokens")
        print(f"phase 5 generate batch {len(batch)}: prefill 8 + "
              f"{args.steps} steps in {dt:.3f} s, "
              f"{len(batch) * args.steps / dt:.1f} tokens/s; equal to CPU")
    launches = blake3_cuda.COUNTER.launches  # end of the main path

    # ── kernel timing at the push path's shapes ──
    blob = max((cfg_a.xorb_cache_path(h).read_bytes()
                for h in pushed.xorb_digests), key=len)
    reader = XorbReader(blob)
    decoded = bytearray(sum(int(s) for s in reader.chunk_sizes))
    reader.extract_range_into(0, len(reader), decoded)
    sizes = reader.chunk_sizes.astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    batch = [memoryview(decoded)[offs[i]:offs[i + 1]]
             for i in range(len(sizes))]
    words, lengths = plain.stage_batch(batch, dev)
    hasher = blake3_cuda.CudaHasher(hashing.CHUNK_KEY, dev)
    kernel_out = hasher.hash_device(words, lengths)
    plain_out = plain.hash_words(words, lengths, hasher.key_words,
                                 hasher.base_flags)
    max_err = int((kernel_out.view(torch.int32).long() & 0xFFFFFFFF).sub(
        plain_out.view(torch.int32).long() & 0xFFFFFFFF).abs().max())
    if max_err:
        fail("kernel != plain at the push shapes")
    ms = cuda_ms(lambda: hasher.hash_device(words, lengths), 50)
    plain_ms = cuda_ms(lambda: plain.hash_words(
        words, lengths, hasher.key_words, hasher.base_flags), 3)
    nbytes, n_compressions = blake3_work(sizes)
    ops = n_compressions * OPS_PER_COMPRESSION
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / INT32_OPS_PER_S * 1e3
    print(f"blake3 kernel at push shapes: {len(batch)} chunks, cap "
          f"{words.shape[1] * 4} B, {int(sizes.sum()):,} bytes: {ms:.4f} ms "
          f"({sizes.sum() / ms / 1e6:.1f} GB/s of chunk bytes), plain "
          f"{plain_ms:.2f} ms, bound {max(byte_ms, op_ms):.4f} ms "
          f"(bytes {byte_ms:.4f}: {nbytes:,} B; ops {op_ms:.4f}: "
          f"{n_compressions:,} compressions x {OPS_PER_COMPRESSION}; "
          f"{op_ms / OPS_PER_COMPRESSION * (7 * 8 * 14 + 8):.4f} at 14 "
          f"ops per G)")
    return {"kernels": [{
        "name": "blake3_chunks",
        "route": "cuda",
        "source": "zest_tpu_torch/csrc/blake3.cu",
        "replaces": "zest_tpu/ops/blake3_pallas.py:332",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms > op_ms else "operations",
        "library_ms": None,
    }]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=32)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    work = Path(tempfile.mkdtemp(prefix=".smoke-",
                                 dir=Path(__file__).resolve().parent))
    try:
        record = run(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
