#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--steps N]

Drives the port's main paths once each, through their entry points,
at the full width of ``openai-community/gpt2`` (12 layers, 768 wide, 50257
vocab; ~124 M f32 parameters, random weights from ``--seed``):

1. build the CUDA kernels from ``zest_tpu_torch/csrc/blake3.cu`` (the
   BLAKE3 chunk kernel and the fused regroup → BLAKE3 kernel) and
   ``csrc/bg4.cu`` (the standalone regroup; one nvcc each, side by side)
   and the native host library from ``zest_tpu_torch/native/*.cc``, and
   count the SASS instructions of one BLAKE3 compression (a probe kernel
   around the source's ``compress``, read with ``cuobjdump``): the
   operation bounds count them;
2. hold the BLAKE3 kernel bit-exact against its plain PyTorch version and
   the native host BLAKE3 on the card (plain and keyed, with garbage past
   each row's length), at every leaf count 1–128 and each 32-leaf group
   edge;
   2b. hold the BG4 regroup kernel and the fused kernel bit-exact against
   their plain versions and the native host decode + BLAKE3, at every
   chunk length mod 4, every leaf count 1–128 and each group edge, plain
   and keyed, with garbage in every planar slot past its plane;
3. ``push_checkpoint`` into node A's cache — every minted chunk is
   re-verified by the BLAKE3 kernel;
4. ``pull_model(device="cuda")`` into a fresh node B through node A's
   loopback publisher endpoint. It lands directly: tensors decode from
   the xorb cache into a pinned ring and commit to ``cuda:0`` in layer
   order, embedding and layer 0 first, and the HF-cache files are written
   from the same ring slots. Gates: one copy of the xorbs from the CDN
   (no whole-file fallback), ``hbm.direct`` and ``hbm.streamed``,
   ``0 < time_to_first_layer_s < time_to_hbm_s``, the ring within its
   budget (or the oversized-alone bound), file bytes from the ``tensors``
   lane, the files equal to the pushed ones and the landed tree on
   ``cuda:0`` with the CPU landing's digest;
   4b. the same tensors as a three-shard HF checkpoint (split in layer
   order at 200 MB, as ``save_pretrained(max_shard_size="200MB")`` lays
   it out, with ``model.safetensors.index.json``), pushed as a second repo
   and pulled into a fresh node with a 64 MiB, 4-slot ring: phase 4's
   gates and digest, ring slots reused, every shard warmed;
   4c. phase 4's repo pulled again into node B: every file is complete,
   so the landing stages from disk (``hbm.direct`` false), with phase 4's
   digest;
5. greedy KV-cached decoding at batch 1 and 4 from the landed tree, equal
   to the port's own CPU float32 run;
   5b. the revision hot-swap: node B, holding phase 4's tree on ``cuda:0``,
   subscribes to node A's publisher (``watch_and_swap``); node A pushes
   revision B (A with the last block's MLP weights and the final norm
   redrawn from ``--seed + 1``) with ``notify=True``, and the subscriber
   delta-pulls B over A's tree. Gates: the push's BLAKE3 kernel rows equal
   its minted chunks; the record names B; ``delta_bytes_ratio`` < 0.1 and
   ``0 < fetched_bytes <= changed + stale bytes``; every tensor reused or
   landed (148), the redrawn ones among at most 12 landed, every reused one
   at A's ``data_ptr``; the base dict empty; the peak allocation above its
   level before the pull at most the landed bytes plus one commit group;
   the tree with the digest of B's CPU landing; B's files exact, from the
   cache lane; greedy decode at batch 1 and 4 equal to the CPU's;
6. the cooperative pull: ``COOP_HOSTS`` (4) fresh hosts in threads, each
   with its own cache and DCN server on loopback, run
   ``pull_model(coop=True)`` of revision A (by its sha: phase 5b moved
   ``main`` to B) against node A's publisher, with the point-to-point
   exchange (``coop_collective=False``). Each fetches its
   share from the CDN and receives the rest over DCN, every received whole
   xorb verified on the card (BG4 chunks through the fused kernel); no
   fallbacks, no rejections, ≥ 60% peer-served, one copy of the xorbs from
   the CDN in all, every host landing directly, the files and landed
   digests equal to phase 4's, the
   fused kernel's rows equal to the BG4 chunks the hosts received and no
   standalone regroup launch; then each host's receipt verification is
   timed again without the network, once alone and once with every
   host's verifier running at the same time;
   6c. four fresh hosts the same way with the collective exchange (the
   default ``dcn`` backend): phase 6's gates, and a ``collective`` block
   on every host, a hypercube in 2 phases, not aborted;
   6d. again with ``collective_backend="jax"`` (the device lane) and
   ``coop_topology=(0, 0, 1, 1)``: a hierarchical schedule in 2 phases,
   intra-slice windows through lanes on ``cuda:0`` (``ici_windows`` > 0)
   and both ici and dcn bytes > 0, with phase 6c's other gates;
10. (run after 6d) the pod round: a fresh node runs ``pod_round`` of
   revision A over ``pod_mesh(["cuda:0"] * 4)`` into a
   ``TieredCache(HbmStagingCache(cuda:0), disk)`` under a 256 MiB budget:
   every unit filled, none rejected, ≥ 2 waves, the peak pool within the
   budget or the single-unit bound, the BLAKE3 and fused kernels' rows
   equal to the units' chunks; then a default ``pull_model(device="cuda")``
   reports ``stats["pod"]["skipped"]`` (one card) and lands with 0 CDN
   bytes, files and digest equal to phase 4's; a second fresh node's round
   with one owned unit corrupted in flight rejects it (``verify_rejected``
   1) and the next pull heals it with exactly that unit's CDN bytes;
   ``all_gather_throughput`` over the four slots is printed;
7. ``meta-llama/Llama-3.2-1B`` at its published width and depth
   (``LLAMA_CONFIG``: 1,235,814,400 parameters, 146 bf16 tensors, one
   2,471,628,800-byte ``model.safetensors``, tied embeddings, llama3 rope
   scaling; random weights from ``--seed + 7``): pushed to node A (the
   BLAKE3 kernel's rows equal the minted chunks), pulled onto ``cuda:0``
   by the direct streaming landing (phase 4's gates, files and digest
   exact, the tree bf16), then ``load_generator(tensors=...)`` decodes an
   8-token prompt plus ``--steps`` at batch 1 and 4. Gates: the cached
   path's logits at every position within ``LOGITS_TOL`` of the CPU's
   uncached float32 forward (TF32 off; the error with TF32 on and with
   the tree in bf16 printed beside it, the bf16 one beyond the tolerance);
   greedy tokens, and sampled ones (``SAMPLING``, Gumbel noise drawn once
   on the host and injected on both sides), equal to the CPU float32
   run's, unless the CPU run's top-2 margin where a row first differs is
   below the tolerance; one seed twice on the card gives one draw;
   ``on_token`` sees each generated position once, in order;
8. the swarm peer tier, revision A by its sha (phase 4's repo, every
   tensor at full width and depth): node B, which holds A's xorbs from
   phase 4, seeds its cache as its own process (``python -m
   zest_tpu_torch serve --listen-port P --dcn-port 0 --port 0``: a
   ``BtServer`` and a ``DcnServer`` beside the publisher), and a fresh
   node pulls onto ``cuda:0`` with B as its direct peer.
   8a. a clean seeder. Gates: ``p2p_ratio`` ≥ 0.9 and CDN bytes at most
   10% of one copy of the xorbs; phase 4's landing gates (direct,
   streamed); files and digest equal to phase 4's; no peer failure, no
   corruption, no quarantine; the seeder served chunks; no kernel launch
   on the path (the peer tier verifies on the host, as the JAX package's
   does);
   8b. the seeder restarted with ``ZEST_FAULTS=upload_corrupt:1.0``: every
   upload is corrupt, and a fresh node pulls the same way. Gates: files
   and digest still phase 4's; ``fetch.resilience.corrupt_from_peer`` ≥ 1;
   the seeder quarantined; CDN bytes at most 1.05 × one copy; every
   whole-xorb cache entry of the node hashes back to its key (no corrupt
   blob under a full key);
9. the serving daemon. 9a: an ``HbmPool`` on ``cuda:0`` in this process
   over fresh node pulls. Llama-3.2-1B from phase 7's snapshot: a cold
   generate decodes from the first-layer commit, before the landing ends;
   the pool's digest equals phase 7's landing; greedy and injected-noise
   sampled tokens (bf16, batch 1 and 4) equal phase 7's float32 card
   tokens, unless the float32 decision's margin where a row first
   differs is below twice phase 7's bf16 logits error; an evict gives
   back at least the tree's 2,471,628,800 B of ``memory_allocated``; a
   re-land has the same digest and bit-equal tokens.
   ``mistralai/Mixtral-8x7B-v0.1`` at its published width, its depth cut
   to 1 layer (``MIXTRAL_CONFIG``: 1,713,418,240 bf16 parameters, random
   from ``--seed + 9``) is pushed to node A (kernel rows = minted chunks)
   and pulled files-only; the pool lands only its 608,264,192-byte dense
   core and pages experts through a 3-group LRU (page-ins verified 3 each,
   evictions, peak within the budget, residency < 0.5); its tokens at
   batch 1 equal a float32 family decode on the card whose capacity drops
   nothing (same margin rule, router gaps included), whose logits are
   within ``LOGITS_TOL`` of the CPU's float32 forward at every position.
   9b: ``python -m zest_tpu_torch serve --device cuda`` as its own process
   on a fresh node C whose hub is node A's publisher, with
   ``ZEST_HBM_POOL_BYTES=3221225472``: ``POST /v1/generate`` Llama cold
   (9a's tokens), the same streamed (``token`` events, hot), Mixtral cold
   (evicts Llama; 9a's tokens, residency < 0.5), Llama again (cold, the
   same tokens), GPT-2 by sha (no ``pool`` key; phase 5's card tokens);
   ``/v1/metrics`` has cold and hot TTFT and an eviction, ``/v1/status``
   the ``hbm_pool`` block and the daemon's kernel launches (read before
   the first request and after the last), and SIGTERM ends it with exit
   code 0;

then time each kernel at its path's shapes against its bound, its plain
version and, where one exists, the one PyTorch call that computes the same
function; the fused kernel also beside the two-launch pair it replaced
(the regroup, then the BLAKE3 chunk kernel) in the same run. Every
kernel's launch count is zeroed just before its path runs and read just
after.

Every phase is fatal. The last three lines of standard output are the
kernels' JSON record (with each kernel's launches by path: the serving
pool's (``serve``), the daemon's (``serve_daemon``), the collective's
(``coop_collective``, ``coop_collective_lane``) and the pod round's
(``pod``) among them), the card's name and power limit, and
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
where ``torch.cuda.is_available()`` is false. Needs one card, no network.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from pathlib import Path

import numpy as np

REPO = "openai-community/gpt2"
REPO_SHARDED = REPO + "-sharded"  # phase 4b's second repo
GPT2_CONFIG = {  # openai-community/gpt2's published config.json
    "model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
    "vocab_size": 50257, "n_positions": 1024, "n_ctx": 1024, "n_embd": 768,
    "n_layer": 12, "n_head": 12, "layer_norm_epsilon": 1e-05,
    "activation_function": "gelu_new", "bos_token_id": 50256,
    "eos_token_id": 50256,
}
# Every leaf count 1-128 (1024n - 1 bytes is n leaves), and both sides of
# each 32-leaf group edge: the kernels fold a group in a warp and join a
# chunk's groups across warps.
LEAF_LENGTHS = tuple(1024 * n - 1 for n in range(1, 129)) + tuple(
    min(32768 * k + d, 131072) for k in range(1, 5) for d in (0, 1))
KERNEL_LENGTHS = tuple(sorted(set(
    (0, 1, 63, 64, 1023, 1024, 1025, 2049, 65536, 131072) + LEAF_LENGTHS)))
BG4_LENGTHS = tuple(sorted(set(
    (0, 1, 2, 3, 4, 5, 1023, 1024, 1025, 65535, 65536, 131072)
    + LEAF_LENGTHS)))
COOP_HOSTS = 4
# Phase 10: four slots on cuda:0 (one card), and a pool budget below two
# of GPT-2's ~67 MB units per slot, so the round takes several waves.
POD_SLOTS = 4
POD_BUDGET = 256 * 1024 * 1024
# Phase 5b's revision B: a fine-tune of the last block's MLP and the final
# norm, 4,720,128 of GPT-2's 124,439,808 parameters.
REDRAWN = ("h.11.mlp.c_fc.weight", "h.11.mlp.c_proj.weight", "ln_f.weight",
           "ln_f.bias")
MAX_LANDED = 12
# Phase 7: meta-llama/Llama-3.2-1B's published config.json, full width and
# depth (1,235,814,400 parameters in 146 bf16 tensors, embeddings tied).
LLAMA_REPO = "meta-llama/Llama-3.2-1B"
LLAMA_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": 128001, "head_dim": 64, "hidden_act": "silu",
    "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 8192, "max_position_embeddings": 131072,
    "mlp_bias": False, "model_type": "llama", "num_attention_heads": 32,
    "num_hidden_layers": 16, "num_key_value_heads": 8, "pretraining_tp": 1,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0,
                     "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "rope_theta": 500000.0, "tie_word_embeddings": True,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 128256,
}
LLAMA_TENSORS, LLAMA_PARAMS = 146, 1_235_814_400
# Phase 9: mistralai/Mixtral-8x7B-v0.1's published config.json at its
# width, its depth cut from 32 layers to 1 (the push encodes ~14-20 s a
# GB on the host): 1,713,418,240 bf16 parameters, a 608,264,192-byte
# dense core and eight 352,321,536-byte expert groups.
MIXTRAL_REPO = "mistralai/Mixtral-8x7B-v0.1"
MIXTRAL_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 32768,
    "model_type": "mixtral", "num_attention_heads": 32,
    "num_experts_per_tok": 2, "num_hidden_layers": 1,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "output_router_logits": False, "rms_norm_eps": 1e-05,
    "rope_theta": 1000000.0, "router_aux_loss_coef": 0.02,
    "sliding_window": None, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32000,
}
MIXTRAL_PARAMS = 1_713_418_240
MIXTRAL_DENSE_BYTES, MIXTRAL_EXPERT_BYTES = 608_264_192, 2_818_572_288
MIXTRAL_PAGER_BYTES = 1_056_964_608  # EXPERT_BUDGET_FRACTION: 3 groups
# Phase 9b's pool watermark: each of the two trees fits alone (Llama
# 2,471,628,800 B; Mixtral's core and pager budget 1,665,228,800 B), the
# two together do not.
DAEMON_POOL = 3 << 30
# Phase 7's sampled decode.
SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.9}
# Phase 7's logits gate: the largest |card - CPU| over every position's
# logits, both in float32 (TF32 off). Measured on an H100 (seed 0): 1.57e-5
# in float32 (summation order only), 8.3e-3 with TF32 on, 0.17 with the
# tree in bf16, for logits of standard deviation ~1. The gate sits ~6x
# above the float32 error and ~80x below TF32's, so a TF32 product fails.
LOGITS_TOL = 1e-4
# Phase 4b: save_pretrained(max_shard_size="200MB") (decimal megabytes),
# and a ring that the landing must reuse many times over.
SHARD_BYTES = 200 * 1000 * 1000
TIGHT_RING = {"land_ring_bytes": 64 * 1024 * 1024, "land_ring_slots": 4}
# The header probe of a cooperative pull reads whole chunk frames until
# the safetensors header is complete: at most the header and one more
# chunk (128 KiB), twice over for the frames' own bytes.
MAX_CHUNK_BYTES = 128 * 1024
# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3. Integer rate: 64 INT32
# lanes per SM x 132 SMs x 1.98 GHz boost clock (the same data sheet's
# clock behind its 67 TFLOP/s float32 figure: 128 FP32 lanes x 2 x 132 x
# 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# One compression as the source counts it: 7 rounds x 8 G x 12 u32
# instructions + 8 xors for the 8 output words (a G as written is 14 ops,
# but each ``a + b + m`` issues as one three-input add, IADD3). Printed
# beside the bound; the bound itself counts the compiled instructions.
SOURCE_OPS_PER_COMPRESSION = 7 * 8 * 12 + 8
# What the bound counts instead: the SASS of one compression, from a probe
# kernel built in phase 1 around csrc/blake3.cu's ``compress`` (its inputs
# come from memory, so nothing folds to a constant). Integer adds, logic,
# shifts, permutes and compares issue on the ALU pipe and IMAD on the FMA
# pipe, 64 lanes an SM each, while the schedulers issue 128 lanes an SM a
# clock: a compression takes the longest of the three.
ALU_PIPE = ("IADD3", "LOP3", "SHF", "PRMT", "ISETP", "SEL", "LEA", "IMNMX")
FMA_PIPE = ("IMAD",)
PROBE = """#include "{source}"
extern "C" __global__ void probe_compress(uint32_t* io) {{
  uint32_t cv[8], m[16], out[8];
  for (int i = 0; i < 8; ++i) cv[i] = io[i];
  for (int i = 0; i < 16; ++i) m[i] = io[8 + i];
  compress(cv, m, io[24], io[25], io[26], out);
  for (int i = 0; i < 8; ++i) io[i] = out[i];
}}
"""


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two u32 tensors of one shape, as integers."""
    import torch

    def wide(t):
        return t.view(torch.int32).long() & 0xFFFFFFFF

    return int((wide(a) - wide(b)).abs().max()) if a.numel() else 0


def blake3_work(lengths: np.ndarray) -> tuple[int, int]:
    """``(bytes, compressions)`` the kernel needs for these chunk lengths:
    it reads each row up to its length rounded up to a 64-byte block (at
    least one block), plus a 4-byte length, and writes a 32-byte digest;
    it runs one compression per block plus one per parent node."""
    leaves = np.maximum((lengths + 1023) // 1024, 1)
    blocks = np.maximum((lengths + 63) // 64, 1)
    nbytes = int(blocks.sum()) * 64 + len(lengths) * (4 + 32)
    return nbytes, int(blocks.sum() + (leaves - 1).sum())


def compression_sass(work: Path) -> dict[str, int]:
    """Opcode counts of one compression: the probe kernel around
    csrc/blake3.cu's ``compress``, compiled for sm_90a and read back with
    ``cuobjdump -sass``."""
    from zest_tpu_torch.ops import blake3_cuda, nvcc

    work.mkdir(parents=True, exist_ok=True)
    probe, cubin = work / "probe.cu", work / "probe.cubin"
    probe.write_text(PROBE.format(source=blake3_cuda.SOURCE.as_posix()))
    subprocess.run([nvcc.nvcc(), "-cubin", *nvcc.NVCC_FLAGS[:4], "-o",
                    str(cubin), str(probe)], check=True, capture_output=True)
    tool = Path(nvcc.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    counts: dict[str, int] = {}
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "probe_compress" in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if inside and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def build_all(work: Path) -> tuple[int, int]:
    """Phase 1: both kernel sources and the compression probe (one nvcc
    each, side by side) and the native host library; prints each kernel's
    registers and spills and the probe's SASS. Returns one compression's
    ``(ALU-pipe, FMA-pipe)`` instruction counts."""
    from zest_tpu_torch import native
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda, nvcc

    logs, errors = {}, []

    def build(name, fn):
        t0 = time.monotonic()
        try:
            logs[name] = (fn(), time.monotonic() - t0)
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    jobs = [(m.SOURCE.name, m.build) for m in (blake3_cuda, bg4_cuda)]
    jobs.append(("probe", lambda: compression_sass(work / "probe")))
    threads = [threading.Thread(target=build, args=j) for j in jobs]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    t1 = time.monotonic()
    native.build()
    print(f"phase 1 build: kernels {t1 - t0:.2f} s in parallel "
          f"(nvcc {' '.join(nvcc.NVCC_FLAGS)}); native host library "
          f"{time.monotonic() - t1:.2f} s (g++)")
    sass, _ = logs.pop("probe")
    for name, (ptxas, secs) in sorted(logs.items()):
        print(f"  {name}: {secs:.2f} s")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    alu = sum(sass.get(op, 0) for op in ALU_PIPE)
    fma = sum(sass.get(op, 0) for op in FMA_PIPE)
    if alu < 7 * 8 * 8:  # at least a xor and a rotate per G step
        fail(f"the compression probe's SASS has {alu} ALU instructions: "
             f"{sass}")
    print(f"  SASS of one compression: ALU pipe {alu}, FMA pipe {fma} "
          f"(source {SOURCE_OPS_PER_COMPRESSION}); "
          + ", ".join(f"{k} {v}" for k, v in sorted(sass.items())))
    return alu, fma


def op_ms(alu: int, fma: int) -> float:
    """Least device time of ``alu`` ALU-pipe and ``fma`` FMA-pipe integer
    instructions (lanes): each pipe at 64 lanes an SM a clock, issue at
    128."""
    return max(alu, fma, (alu + fma) / 2) / INT32_OPS_PER_S * 1e3


def bg4_phase(rng, dev) -> None:
    """Phase 2b: the regroup kernel and the fused kernel against their
    plain versions and the native host decode + BLAKE3."""
    import torch

    from zest_tpu_torch import native
    from zest_tpu_torch.cas import compression, hashing
    from zest_tpu_torch.ops import bg4, bg4_cuda
    from zest_tpu_torch.ops.blake3 import digests_to_bytes

    bg4_scheme = compression.Scheme.BG4_LZ4
    chunks = [(rng.standard_normal(-(-n // 4), dtype=np.float32)
               * np.float32(0.02)).tobytes()[:n] for n in BG4_LENGTHS]
    payloads = [compression.compress(c, bg4_scheme) for c in chunks]
    host = [compression.decompress(f, bg4_scheme, len(c))
            for f, c in zip(payloads, chunks)]
    if host != chunks:
        fail("native host BG4 decode does not round-trip")
    planar = [compression.lz4_frame_decompress(f, len(c))
              for f, c in zip(payloads, chunks)]
    words, lengths = bg4.stage_planar(planar, list(BG4_LENGTHS), dev)
    raw = words.view(torch.uint8)
    slot = raw.shape[1] // 4
    keep = torch.zeros(raw.shape, dtype=torch.bool)
    for i, n in enumerate(BG4_LENGTHS):
        for k, size in enumerate(bg4.bg4_plane_sizes(n)):
            keep[i, k * slot:k * slot + size] = True
    junk = torch.randint(0, 256, raw.shape, device=dev, dtype=torch.uint8)
    dirty = torch.where(keep.to(dev), raw, junk).contiguous().view(
        torch.uint32)
    for w in (words, dirty):
        got = bg4_cuda.launch(w)
        if max_abs_err(got, bg4.regroup_words(w)):
            fail("BG4 regroup kernel != plain regroup")
        rows = got.cpu().view(torch.uint8).numpy()
        if any(rows[i, :len(c)].tobytes() != c for i, c in enumerate(host)):
            fail("BG4 regroup kernel != native host decode")
    for key in (None, hashing.CHUNK_KEY):
        v = bg4.FusedBg4Verifier(key, dev)
        want = [native.lib.blake3(c) if key is None
                else native.lib.blake3_keyed(key, c) for c in host]
        for w in (words, dirty):
            got = v.hash_planar_device(w, lengths)
            plain = bg4.fused_regroup_hash(w, lengths, v.key_words,
                                           v.base_flags)
            if max_abs_err(got, plain):
                fail(f"fused kernel != plain fused "
                     f"(keyed={key is not None})")
            if digests_to_bytes(got) != want:
                fail(f"fused kernel != native decode + BLAKE3 "
                     f"(keyed={key is not None})")
    torch.cuda.synchronize()
    print(f"phase 2b bg4 regroup and fused kernel == plain == native decode "
          f"+ BLAKE3 on {len(chunks)} lengths (0-5, every leaf count 1-128, "
          f"the 32-leaf group edges, 64 and 128 KiB), plain and keyed, "
          f"garbage past every plane")


def bg4_chunks_of(blob: bytes) -> tuple[int, int]:
    """``(BG4 chunks, other chunks)`` of a xorb."""
    from zest_tpu_torch.cas.compression import Scheme
    from zest_tpu_torch.cas.xorb import XorbReader

    schemes = XorbReader(blob).chunk_schemes
    bg4 = int((schemes == int(Scheme.BG4_LZ4)).sum())
    return bg4, len(schemes) - bg4


def check_files(label: str, res, ckpt: Path) -> None:
    for f in sorted(ckpt.iterdir()):
        if (res.snapshot_dir / f.name).read_bytes() != f.read_bytes():
            fail(f"{label}: pulled {f.name} differs from the pushed file")


def check_tree(label: str, res, digest: str, dev) -> None:
    from zest_tpu_torch.models.loader import params_digest

    off = [n for n, t in res.params.items() if t.device != dev]
    if off:
        fail(f"{label}: {len(off)} tensors not on {dev}: {off[:3]}")
    if params_digest(res.params) != digest:
        fail(f"{label}: params_digest != the CPU landing's")


def check_direct(label: str, res) -> None:
    """The streaming landing's own gates: direct and streamed, the first
    layer resident before the rest, the ring within its budget (a tensor
    larger than the ring is admitted alone: then within that tensor and
    its slot's 16-byte alignment), and the shards' files written from the
    ring slots."""
    st = res.stats
    hbm = st["hbm"]
    if not (hbm["direct"] and hbm.get("streamed")):
        fail(f"{label}: the landing did not stream from the cache: "
             f"direct {hbm['direct']}, streamed {hbm.get('streamed')}")
    tfl, tth = st.get("time_to_first_layer_s"), st["time_to_hbm_s"]
    if tfl is None or not 0 < tfl < tth:
        fail(f"{label}: time_to_first_layer_s {tfl} vs time_to_hbm_s {tth}")
    ring = hbm["ring"]
    biggest = max(t.numel() * t.element_size() for t in res.params.values())
    bound = max(ring["budget_bytes"], biggest + 15)
    if ring["peak_bytes"] > bound:
        fail(f"{label}: ring peak {ring['peak_bytes']:,} B > {bound:,} B "
             f"(budget {ring['budget_bytes']:,} B)")
    if not st["files_pipeline"]["lane_bytes"].get("tensors"):
        fail(f"{label}: no file was written from the ring slots: "
             f"{st['files_pipeline']}")


def landing_summary(st: dict) -> str:
    stages = st["stages"]
    out = (f"time_to_hbm_s {st['time_to_hbm_s']}, elapsed_s "
           f"{st['elapsed_s']}; stages "
           + ", ".join(f"{k} {stages[k]}" for k in (
               "resolve", "cas_metadata", "fetch", "decode", "first_layer",
               "hbm_commit", "files") if k in stages)
           + f"; files_after_hbm_s {st['files_after_hbm_s']}")
    if "time_to_first_layer_s" in st:
        out = f"time_to_first_layer_s {st['time_to_first_layer_s']}, " + out
    return out


def hf_shards(tensors: dict, max_bytes: int) -> list[dict]:
    """``tensors`` split in their order into shards of at most
    ``max_bytes`` (a larger tensor alone), as ``save_pretrained`` lays
    out a sharded checkpoint."""
    shards, size = [{}], 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        if shards[-1] and size + n > max_bytes:
            shards.append({})
            size = 0
        shards[-1][name] = t
        size += n
    return shards


def write_sharded(root: Path, tensors: dict, config: dict) -> list[str]:
    """A sharded HF checkpoint of ``tensors``: ``model-0000i-of-0000n``
    files plus ``model.safetensors.index.json``. Returns the shard names."""
    from zest_tpu_torch.models.safetensors_io import write_safetensors

    shards = hf_shards(tensors, SHARD_BYTES)
    root.mkdir()
    (root / "config.json").write_text(json.dumps(config, indent=2))
    weight_map, names = {}, []
    for i, shard in enumerate(shards, 1):
        name = f"model-{i:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(root / name, shard)
        weight_map.update(dict.fromkeys(shard, name))
        names.append(name)
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    (root / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map},
        indent=2))
    return names


def pull_phase(work: Path, url: str, cfg_a, ckpt: Path, pushed, dev):
    """Phase 4: the pull into a fresh node B through the direct streaming
    landing. Returns the result, node B's config and the CPU landing's
    digest."""
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.transfer.pull import pull_model

    cfg_b = Config(hf_home=work / "b" / "hf",
                   cache_dir=work / "b" / "zest", endpoint=url)
    pulled = pull_model(cfg_b, REPO, device=dev)
    st = pulled.stats
    if st["fallback_files"]:
        fail(f"{st['fallback_files']} xet files fell back to a "
             "whole-file download: the cache → CDN reconstruction "
             "failed")
    cdn = st["fetch"]["bytes"]["cdn"]
    if not pushed.new_xorb_bytes <= cdn <= 1.05 * pushed.new_xorb_bytes:
        fail(f"node B started empty, so one copy of the "
             f"{pushed.new_xorb_bytes:,} minted xorb bytes must cross "
             f"the CDN tier: {st['fetch']}")
    check_files("phase 4", pulled, ckpt)
    digest = params_digest(load_checkpoint(pulled.snapshot_dir, "cpu"))
    check_tree("phase 4", pulled, digest, dev)
    check_direct("phase 4", pulled)
    print(f"phase 4 pull: {landing_summary(st)}; ring "
          f"{st['hbm']['ring']}; {cdn:,} bytes in "
          f"{st['fetch']['xorbs']['cdn']} CDN fetches, 0 fallbacks; "
          f"files by lane {st['files_pipeline']['lane_bytes']}; "
          f"{st['hbm']['tensors']} tensors on {dev}, digest "
          f"{digest[:16]}")
    return pulled, cfg_b, digest


def sharded_phase(work: Path, url: str, cfg_a, tensors: dict, digest: str,
                  dev) -> int:
    """Phase 4b: the three-shard checkpoint pushed as a second repo, then
    pulled into a fresh node through a tight ring. Returns the push's
    BLAKE3 kernel launches."""
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    ckpt = work / "checkpoint-sharded"
    shards = write_sharded(ckpt, tensors, GPT2_CONFIG)
    if len(shards) != 3:
        fail(f"phase 4b: {len(shards)} shards at {SHARD_BYTES:,} B, not 3")
    for c in (blake3_cuda.COUNTER, bg4_cuda.COUNTER, bg4_cuda.FUSED_COUNTER):
        c.reset()  # counts from here are the sharded push's
    pushed = push_checkpoint(cfg_a, REPO_SHARDED, ckpt, device=dev,
                             notify=False)
    launches = blake3_cuda.COUNTER.launches
    if blake3_cuda.COUNTER.rows != pushed.minted_chunks:
        fail(f"phase 4b: kernel hashed {blake3_cuda.COUNTER.rows} chunks, "
             f"push minted {pushed.minted_chunks}")
    cfg = Config(hf_home=work / "d" / "hf", cache_dir=work / "d" / "zest",
                 endpoint=url, **TIGHT_RING)
    res = pull_model(cfg, REPO_SHARDED, device=dev)
    st = res.stats
    label = "phase 4b"
    if st["fallback_files"]:
        fail(f"{label}: {st['fallback_files']} whole-file fallbacks")
    check_files(label, res, ckpt)
    check_tree(label, res, digest, dev)
    check_direct(label, res)
    ring, warm = st["hbm"]["ring"], st["hbm"]["warm"]
    if ring["buffer_reuses"] <= 0:
        fail(f"{label}: the ring never reused a slot: {ring}")
    if (warm["pipelined_shards"] != len(shards) or warm["failed"]
            or warm.get("prefetch_errors")):
        fail(f"{label}: not every shard was warmed: {warm}")
    print(f"phase 4b sharded pull: {len(shards)} shards "
          f"({', '.join(f'{(ckpt / s).stat().st_size:,} B' for s in shards)}"
          f"; push {pushed.new_xorbs} new xorbs, {pushed.minted_chunks} "
          f"chunks in {pushed.elapsed_s:.2f} s, kernel launches {launches}); "
          f"{landing_summary(st)}; ring {ring}; warm {warm}; digest equal")
    return launches


def resume_phase(cfg_b, digest: str, dev) -> None:
    """Phase 4c: phase 4's repo pulled again into node B. Every file is
    complete, so the landing stages from disk."""
    from zest_tpu_torch.transfer.pull import pull_model

    res = pull_model(cfg_b, REPO, device=dev)
    st = res.stats
    if st["hbm"]["direct"] or st["files_downloaded"]:
        fail(f"phase 4c: direct {st['hbm']['direct']}, "
             f"{st['files_downloaded']} files downloaded: the complete "
             "snapshot must stage from disk")
    check_tree("phase 4c", res, digest, dev)
    print(f"phase 4c resumed pull: {st['files_skipped']} files complete, "
          f"staged from disk; {landing_summary(st)}; digest equal")


def revision_b(tensors: dict, seed: int) -> dict:
    """Phase 5b's revision: ``tensors`` with ``REDRAWN`` drawn again from
    ``seed`` (weights N(0, 0.02), the norm's weight 1 + N(0, 0.02) and its
    bias N(0, 0.02))."""
    import torch

    rng = np.random.default_rng(seed)
    out = dict(tensors)
    for name in REDRAWN:
        shape = tuple(tensors[name].shape)
        v = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        if name == "ln_f.weight":
            v += np.float32(1.0)
        out[name] = torch.from_numpy(v)
    return out


def swap_phase(work: Path, url: str, publisher, cfg_a, cfg_b, pulled,
               sha_a: str, tensors_b: dict, prompts, steps: int,
               tth_a: float, dev) -> int:
    """Phase 5b: node B's watcher delta-pulls and swaps revision B into
    phase 4's tree. Returns the push's BLAKE3 kernel launches."""
    import torch

    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.ops import blake3_cuda
    from zest_tpu_torch.transfer.push import push_checkpoint, watch_and_swap

    ckpt_b = work / "checkpoint-b"
    ckpt_b.mkdir()
    (ckpt_b / "config.json").write_text(json.dumps(GPT2_CONFIG, indent=2))
    write_safetensors(ckpt_b / "model.safetensors", tensors_b)
    # The caller hands A's tree over: nothing else may hold it.
    base = pulled.params
    pulled.params = None
    # Weak references: they tell a reused tensor from a landed one
    # without keeping A's tensors alive.
    refs = {n: weakref.ref(t) for n, t in base.items()}
    ptrs = {n: t.data_ptr() for n, t in base.items()}
    a_bytes = sum(t.numel() * t.element_size() for t in base.values())
    mem: dict = {}
    seen, errors = [], []

    def log(*a, **k):
        msg = " ".join(str(x) for x in a)
        if msg.startswith("watch:"):
            # The pull starts right after this line, in this thread.
            torch.cuda.synchronize(dev)
            mem["before"] = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        print(f"  [node B] {msg}", file=sys.stderr)

    def watch():
        try:
            watch_and_swap(cfg_b, REPO, publisher_url=url, device=dev,
                           base_params=base, base_revision=sha_a,
                           max_events=1, timeout_s=600,
                           on_swap=lambda rec, res: seen.append((rec, res)),
                           log=log)
            mem["peak"] = torch.cuda.max_memory_allocated(dev)
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    watcher = threading.Thread(target=watch, name="phase-5b-watch")
    watcher.start()
    try:
        deadline = time.monotonic() + 60
        while publisher.hub.watchers() < 1:
            if time.monotonic() > deadline or not watcher.is_alive():
                fail("phase 5b: node B never subscribed to the publisher")
            time.sleep(0.01)
        blake3_cuda.COUNTER.reset()  # counts from here are the push's
        pushed = push_checkpoint(cfg_a, REPO, ckpt_b, base_revision=sha_a,
                                 notify=True, notify_url=url, device="cuda")
        launches, rows = (blake3_cuda.COUNTER.launches,
                          blake3_cuda.COUNTER.rows)
    finally:
        watcher.join(timeout=900)
    if errors:
        raise errors[0]
    if watcher.is_alive() or len(seen) != 1:
        fail(f"phase 5b: the watcher swapped {len(seen)} revisions")
    if launches < 1 or rows != pushed.minted_chunks:
        fail(f"phase 5b: the push's kernel hashed {rows} chunks in "
             f"{launches} launches; it minted {pushed.minted_chunks}")
    if not pushed.notified or pushed.notified.get("delivered") != 1:
        fail(f"phase 5b: the push notified {pushed.notified}")
    record, res = seen[0]
    st = res.stats
    if record["revision"] != pushed.revision or pushed.revision == sha_a:
        fail(f"phase 5b: the record names {record['revision']}, the push "
             f"{pushed.revision}")
    d = st.get("delta")
    if not d or not d["delta_bytes_ratio"] < 0.1:
        fail(f"phase 5b: delta {d and {k: v for k, v in d.items() if k != 'files'}}")
    stale = d.get("stale_bytes", 0)
    if not 0 < d["fetched_bytes"] <= d["changed_bytes"] + stale:
        fail(f"phase 5b: fetched {d['fetched_bytes']} B, changed "
             f"{d['changed_bytes']} + stale {stale} B")
    swap = st["hbm"]["swap"]
    params = res.params
    reused = {n for n, t in params.items()
              if n in refs and refs[n]() is t}
    landed = set(params) - reused
    moved = sorted(n for n in reused if params[n].data_ptr() != ptrs[n])
    if moved:
        fail(f"phase 5b: reused tensors off A's data_ptr: {moved}")
    if swap["reused_tensors"] + swap["landed_tensors"] != 148 \
            or len(params) != 148 or len(landed) != swap["landed_tensors"]:
        fail(f"phase 5b: swap {swap}, {len(landed)} tensors moved")
    if not set(REDRAWN) <= landed or len(landed) > MAX_LANDED:
        fail(f"phase 5b: landed {sorted(landed)}")
    if base:
        fail(f"phase 5b: {len(base)} tensors left in the base dict")
    group = min(64 * 1024 * 1024, cfg_b.land_ring_bytes // 4)
    rise = mem["peak"] - mem["before"]
    if rise > swap["landed_bytes"] + group:
        fail(f"phase 5b: the peak allocation rose {rise:,} B, above the "
             f"landed {swap['landed_bytes']:,} B + one group {group:,} B")
    want = params_digest(load_checkpoint(ckpt_b, "cpu"))
    check_tree("phase 5b", res, want, dev)
    check_files("phase 5b", res, ckpt_b)
    lanes = st["files_pipeline"]["lane_bytes"]
    if not lanes.get("copy", 0) + lanes.get("decode", 0):
        fail(f"phase 5b: no file bytes from the cache lane: {lanes}")
    _, gen_cuda = load_generator(res.snapshot_dir, device=dev,
                                 tensors=params)
    _, gen_cpu = load_generator(res.snapshot_dir, device="cpu")
    for batch in ([prompts[0]], prompts):
        out = gen_cuda(batch, steps, stop_at_eos=False)
        if not np.array_equal(out, gen_cpu(batch, steps,
                                           stop_at_eos=False)):
            fail(f"phase 5b: batch {len(batch)}: cuda tokens != cpu tokens")
    reused_bytes = sum(params[n].numel() * params[n].element_size()
                       for n in reused)
    print(f"phase 5b hot-swap: time_to_swap_s {st['time_to_swap_s']} "
          f"(phase 4 time_to_hbm_s {tth_a}), propagation_s "
          f"{record.get('propagation_s')}; push {pushed.new_xorbs} new "
          f"xorbs, {pushed.minted_chunks} chunks in {pushed.elapsed_s:.2f} "
          f"s, kernel launches {launches}; delta_bytes_ratio "
          f"{d['delta_bytes_ratio']}, changed {d['changed_bytes']:,} B, "
          f"fetched {d['fetched_bytes']:,} B, stale {stale:,} B; reused "
          f"{len(reused)} tensors ({reused_bytes:,} B, A {a_bytes:,} B), "
          f"landed {sorted(landed)} ({swap['landed_bytes']:,} B); peak "
          f"allocation +{rise:,} B; {landing_summary(st)}; files by lane "
          f"{lanes}; digest and decode at batch 1 and 4 equal to the CPU's")
    del gen_cuda, gen_cpu, params
    res.params = None
    return launches


def coop_phase(work: Path, url: str, ckpt: Path, pushed, cfg_a,
               digest: str, dev, revision: str, label: str = "phase 6",
               schedule: str | None = None, **cfg_kw) -> dict:
    """Phase 6 (the point-to-point exchange) and, with ``schedule``, 6c
    and 6d (the collective, expected to run that schedule in 2 phases):
    ``COOP_HOSTS`` cooperative pulls of ``revision`` in threads, their
    configs given ``cfg_kw``. Returns the launch counts of the path; the
    counters of the transports the hosts' collectives built are printed
    and, for the device lane, gated."""
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.transfer import collective
    from zest_tpu_torch.transfer.dcn import DcnServer
    from zest_tpu_torch.transfer.pull import pull_model

    n = COOP_HOSTS
    tag = label.split()[-1]
    cfgs = [Config(hf_home=work / f"c{tag}-{i}" / "hf",
                   cache_dir=work / f"c{tag}-{i}" / "zest", endpoint=url,
                   dcn_port=0, **cfg_kw) for i in range(n)]
    # Each host's listener outlives its own pull: the peers still behind
    # it read from it until every host is done.
    servers = [DcnServer(c) for c in cfgs]
    addrs = {i: ("127.0.0.1", srv.start()) for i, srv in enumerate(servers)}
    results, errors = [None] * n, []

    def host(i):
        try:
            results[i] = pull_model(
                cfgs[i], REPO, revision=revision, device=dev, coop=True,
                coop_hosts=n,
                coop_index=i,
                coop_addrs={j: a for j, a in addrs.items() if j != i},
                coop_server=servers[i],
                log=lambda *a, **k: print(f"  [host {i}]", *a,
                                          file=sys.stderr))
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    # Every transport the hosts' collectives build, for their counters.
    made, real_make = [], collective.make_transport

    def make_transport(*a, **k):
        made.append(real_make(*a, **k))
        return made[-1]

    counters = (blake3_cuda.COUNTER, bg4_cuda.COUNTER,
                bg4_cuda.FUSED_COUNTER)
    for c in counters:
        c.reset()  # counts from here are this path's
    threads = [threading.Thread(target=host, args=(i,)) for i in range(n)]
    collective.make_transport = make_transport
    t0 = time.monotonic()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        collective.make_transport = real_make
        for srv in servers:
            srv.shutdown()
    wall = time.monotonic() - t0
    launches = {name: (c.launches, c.rows) for name, c in zip(
        ("blake3_chunks", "bg4_regroup", "bg4_fused_verify"), counters)}
    if errors:
        raise errors[0]

    per_xorb = {h: bg4_chunks_of(cfg_a.xorb_cache_path(h).read_bytes())
                for h in pushed.xorb_digests}
    want_rows = (n - 1) * sum(b for b, _ in per_xorb.values())
    want_rest = (n - 1) * sum(r for _, r in per_xorb.values())
    with open(ckpt / "model.safetensors", "rb") as f:
        header_bytes = 8 + int.from_bytes(f.read(8), "little")
    probe_bound = 2 * (header_bytes + MAX_CHUNK_BYTES)
    cdn_total, probes = 0, []
    lanes = {k: sum(t.counters.get(k, 0) for t in made)
             for k in ("windows", "ici_windows", "ici_lane_bytes",
                       "lane_overflows")}
    for i, res in enumerate(results):
        st = res.stats
        c = st.get("coop")
        if not c or c.get("skipped"):
            fail(f"{label} host {i}: no cooperative round ran: "
                 f"{st.get('coop')}")
        cx = c.get("collective")
        if schedule is None and cx is not None:
            fail(f"{label} host {i}: the collective ran: {cx}")
        if schedule is not None and (
                not cx or (cx["schedule"], cx["phases"]) != (schedule, 2)
                or cx.get("aborted") is not None):
            fail(f"{label} host {i}: collective {cx}, not {schedule} in 2 "
                 "phases, unaborted")
        if cx and cx.get("backend") == "jax" and not (
                cx["link_bytes"]["ici"] > 0 and cx["link_bytes"]["dcn"] > 0):
            fail(f"{label} host {i}: link bytes {cx['link_bytes']}")
        ex = c["exchange"]
        if c["fallbacks"] or ex["verify_rejected"] or not ex["units"]:
            fail(f"{label} host {i}: fallbacks {c['fallbacks']}, rejected "
                 f"{ex['verify_rejected']}, exchanged {ex['units']}")
        if not 0 < ex["wire_bytes"] < ex["unpacked_bytes"]:
            fail(f"{label} host {i}: wire {ex['wire_bytes']} vs unpacked "
                 f"{ex['unpacked_bytes']}")
        if c["peer_served_ratio"] < 0.6 or st["fallback_files"]:
            fail(f"{label} host {i}: peer-served {c['peer_served_ratio']}, "
                 f"fallback_files {st['fallback_files']}")
        coop_cdn = (c["fetch"]["tiers"].get("cdn", 0)
                    + ex.get("fallback_tiers", {}).get("cdn", 0))
        # Outside the round, only the header probe that orders it by
        # layer may reach the CDN; the landing and the files read the
        # cache.
        probe = st["fetch"]["bytes"]["cdn"] - coop_cdn
        if not 0 < probe <= probe_bound:
            fail(f"{label} host {i}: {probe} CDN bytes outside the round (the "
                 f"header probe reads at most {probe_bound})")
        probes.append(probe)
        cdn_total += st["fetch"]["bytes"]["cdn"]
        if not st["hbm"]["direct"]:
            fail(f"{label} host {i}: the landing staged from disk")
        check_files(f"{label} host {i}", res, ckpt)
        check_tree(f"{label} host {i}", res, digest, dev)
    if cdn_total > 1.05 * pushed.new_xorb_bytes:
        fail(f"{label}: {cdn_total:,} CDN bytes over {n} hosts > 1.05 x "
             f"{pushed.new_xorb_bytes:,}")
    fu_launches, fu_rows = launches["bg4_fused_verify"]
    if fu_rows != want_rows or not fu_launches:
        fail(f"{label}: bg4_fused_verify covered {fu_rows} rows in "
             f"{fu_launches} "
             f"launches; the hosts received {want_rows} BG4 chunks")
    if launches["bg4_regroup"][0]:
        fail(f"{label}: the coop path launched the standalone regroup "
             f"{launches['bg4_regroup'][0]} times")
    if launches["blake3_chunks"][1] != want_rest:
        fail(f"{label}: blake3_chunks hashed "
             f"{launches['blake3_chunks'][1]} rows; the "
             f"hosts received {want_rest} chunks of other schemes")
    if schedule is not None and cfg_kw.get("collective_backend") == "jax" \
            and not lanes["ici_windows"]:
        fail(f"{label}: no window crossed the device lane: {lanes}")
    print(f"{label} coop pull ({card_label()}): {n} hosts in {wall:.2f} s "
          f"({', '.join(f'{k}={v}' for k, v in cfg_kw.items()) or 'defaults'}"
          f"); {cdn_total:,} CDN "
          f"bytes in all ({pushed.new_xorb_bytes:,} pushed; header probes "
          f"{probes} B); every host landed directly; "
          f"{want_rows // (n - 1)} BG4 and {want_rest // (n - 1)} other "
          f"chunks in {len(per_xorb)} xorbs, x{n - 1} receivers; launches "
          f"(rows): "
          + ", ".join(f"{k} {v[0]} ({v[1]})" for k, v in launches.items()))
    for i, res in enumerate(results):
        st, c = res.stats, res.stats["coop"]
        ex = c["exchange"]
        print(f"  host {i}: {landing_summary(st)}; coop elapsed_s "
              f"{c['elapsed_s']}, fetched "
              f"{c['fetch']['units']} units "
              f"({c['fetch']['tiers'].get('cdn', 0):,} CDN bytes), "
              f"exchanged {ex['units']} ({ex['wire_bytes']:,} wire / "
              f"{ex['unpacked_bytes']:,} unpacked bytes, {ex['retries']} "
              f"retries, peak in flight {ex['inflight_peak_bytes']:,}), "
              f"fallback {c['fallbacks']} ({ex['fallback_bytes']} bytes), "
              f"peer-served {c['peer_served_ratio']}")
        cx = c.get("collective")
        if cx:
            print(f"    collective: {cx['schedule']} {cx['phases']} phases, "
                  f"walls {cx['phase_wall_s']} s, elapsed {cx['elapsed_s']} "
                  f"s, barrier {cx['barrier_wait_s']} s, windows "
                  f"{cx['windows']} ({cx['retry_windows']} retries), links "
                  f"{cx['link_bytes']}, clock offsets "
                  f"{c.get('clock_offsets')}")
    if schedule is not None:
        print(f"  {label} transports: {lanes}")
    for i in range(n):
        shutil.rmtree(work / f"c{tag}-{i}")
    return {name: v[0] for name, v in launches.items()}


def pod_phase(work: Path, url: str, ckpt: Path, pushed, cfg_a,
              digest: str, dev, revision: str) -> dict:
    """Phase 10: the pod round of ``revision`` over ``POD_SLOTS`` slots on
    ``cuda:0`` into a fresh node's ``TieredCache`` (HBM staging over the
    disk cache), then a default pull that lands from the cache; a second
    fresh node's round with one owned unit corrupted in flight. Returns
    the launch counts of the first round."""
    import torch

    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.parallel import (
        DistributionPlan,
        HbmStagingCache,
        PoolLayout,
        TieredCache,
        all_gather_throughput,
        pod_mesh,
    )
    from zest_tpu_torch.storage import XorbCache
    from zest_tpu_torch.transfer.bridge import XetBridge
    from zest_tpu_torch.transfer.pod import pod_round
    from zest_tpu_torch.transfer.pull import pull_model

    wall0 = time.monotonic()
    mesh = pod_mesh([dev] * POD_SLOTS)
    quiet = lambda *a, **k: print("  [pod]", *a, file=sys.stderr)  # noqa: E731

    def node(name: str, corrupt: str | None = None):
        cfg = Config(hf_home=work / name / "hf",
                     cache_dir=work / name / "zest", endpoint=url,
                     hbm_staging_bytes=POD_BUDGET)
        hbm = HbmStagingCache(cfg.hbm_staging_bytes, device=dev)
        bridge = XetBridge(cfg, cache=TieredCache(XorbCache(cfg), hbm))
        bridge.authenticate(REPO, revision)
        recs = [bridge.get_reconstruction(e.xet_hash)
                for e in HubClient(cfg).list_files(REPO, revision)
                if e.is_xet]
        if corrupt is not None:
            real = bridge.fetch_unit

            def fetch_unit(hash_hex, fi):
                data = real(hash_hex, fi)
                if hash_hex != corrupt:
                    return data
                bad = bytearray(data)
                bad[len(bad) // 2] ^= 0xFF
                return bytes(bad)

            bridge.fetch_unit = fetch_unit
        return cfg, hbm, bridge, recs

    cfg, hbm, bridge, recs = node("p10")
    plan = DistributionPlan.build(recs, POD_SLOTS)
    single = max(PoolLayout.from_plan(DistributionPlan(POD_SLOTS, [a]))
                 .pool_bytes for a in plan.assignments)
    per_xorb = {h: bg4_chunks_of(cfg_a.xorb_cache_path(h).read_bytes())
                for h in pushed.xorb_digests}
    counters = (blake3_cuda.COUNTER, bg4_cuda.COUNTER,
                bg4_cuda.FUSED_COUNTER)
    for c in counters:
        c.reset()  # counts from here are the pod round's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    st = pod_round(bridge, recs, mesh=mesh, log=quiet)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {name: (c.launches, c.rows) for name, c in zip(
        ("blake3_chunks", "bg4_regroup", "bg4_fused_verify"), counters)}
    bridge.close()
    want_bg4 = sum(b for b, _ in per_xorb.values())
    want_rest = sum(r for _, r in per_xorb.values())
    if st.get("skipped") or st["filled"] != st["units"] \
            or st["verify_rejected"]:
        fail(f"phase 10: {st}")
    if st["waves"] < 2 or not (st["pool_bytes"] <= POD_BUDGET
                               or st["pool_bytes"] <= single):
        fail(f"phase 10: {st['waves']} waves, peak pool "
             f"{st['pool_bytes']:,} B over the budget {POD_BUDGET:,} B and "
             f"the single-unit bound {single:,} B")
    if launches["bg4_fused_verify"][1] != want_bg4 \
            or launches["blake3_chunks"][1] != want_rest \
            or launches["bg4_regroup"][0]:
        fail(f"phase 10: launches (rows) {launches}; the units hold "
             f"{want_bg4} BG4 and {want_rest} other chunks")
    gbps = all_gather_throughput(mesh)
    print(f"phase 10 pod round ({card_label()}): {POD_SLOTS} slots on "
          f"{dev}, budget {POD_BUDGET:,} B: {st}; single-unit pool "
          f"{single:,} B; peak allocation +{peak:,} B during the round; HBM "
          f"staging {hbm.summary()}; launches (rows): "
          + ", ".join(f"{k} {v[0]} ({v[1]})" for k, v in launches.items())
          + f"; all_gather_throughput {gbps:.1f} GB/s (64 MiB a slot)")
    del hbm, bridge

    # A default pull: the pre-pass skips on one card, the landing reads
    # the cache the round filled.
    res = pull_model(cfg, REPO, revision=revision, device=dev, log=quiet)
    pst = res.stats
    if pst["fetch"]["bytes"]["cdn"] or not pst.get("pod", {}).get("skipped"):
        fail(f"phase 10: the pull after the round: CDN "
             f"{pst['fetch']['bytes']['cdn']} B, pod {pst.get('pod')}")
    check_files("phase 10", res, ckpt)
    check_tree("phase 10", res, digest, dev)
    print(f"  phase 10 pull after the round: {landing_summary(pst)}; 0 CDN "
          f"bytes; pod {pst['pod']}; files and digest equal to phase 4's")
    del res

    # One owned unit corrupted in flight: rejected at the fill, healed by
    # the next pull from the CDN.
    victim = sorted(a.hash_hex for a in plan.assignments)[0]
    cfg2, hbm2, bridge2, recs2 = node("p10b", corrupt=victim)
    st2 = pod_round(bridge2, recs2, mesh=mesh, log=quiet)
    bridge2.close()
    del hbm2, bridge2
    if st2["verify_rejected"] != 1 or st2["filled"] != st2["units"] - 1:
        fail(f"phase 10: the corrupted unit: {st2}")
    res = pull_model(cfg2, REPO, revision=revision, device=dev, log=quiet)
    victim_bytes = next(a.est_bytes for a in plan.assignments
                        if a.hash_hex == victim)
    if res.stats["fetch"]["bytes"]["cdn"] != victim_bytes:
        fail(f"phase 10: the heal fetched {res.stats['fetch']['bytes']['cdn']}"
             f" CDN bytes, the corrupted unit is {victim_bytes}")
    check_files("phase 10 heal", res, ckpt)
    check_tree("phase 10 heal", res, digest, dev)
    print(f"  phase 10 corrupted unit {victim[:12]}: verify_rejected "
          f"{st2['verify_rejected']}, filled {st2['filled']}/{st2['units']}; "
          f"the next pull healed it with {victim_bytes:,} CDN bytes; digest "
          f"equal; phase wall {time.monotonic() - wall0:.2f} s")
    del res
    shutil.rmtree(work / "p10")
    shutil.rmtree(work / "p10b")
    return {name: v[0] for name, v in launches.items()}


class Seeder:
    """``python -m zest_tpu_torch serve`` over a node's cache, as its own
    process (an in-process seeder would share the puller's interpreter
    lock). ``stop()`` sends SIGTERM, reaps it and returns the
    ``ServerStats`` it prints; a seeder that fails to start, or dies,
    fails the phase."""

    def __init__(self, label: str, cfg, args=(), **env):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            self.port = probe.getsockname()[1]
        child_env = {k: v for k, v in os.environ.items()
                     if k != "ZEST_FAULTS"}
        child_env.update(HF_HOME=str(cfg.hf_home),
                         ZEST_CACHE_DIR=str(cfg.cache_dir), **env)
        self.label = label
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "zest_tpu_torch", "serve",
             "--listen-port", str(self.port), "--dcn-port", "0",
             "--port", "0", *args], cwd=Path(__file__).resolve().parent,
            env=child_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        lines = []
        try:
            deadline = time.monotonic() + 120
            while not any(ln.startswith("publisher endpoint")
                          for ln in lines):
                line = self.proc.stdout.readline()
                if not line or time.monotonic() > deadline:
                    fail(f"{label}: the seeder did not start: "
                         f"{lines} {self.stderr()}")
                lines.append(line.strip())
            if not any(ln.startswith(f"seeding on :{self.port} ")
                       for ln in lines):
                fail(f"{label}: the seeder is not on port {self.port}: "
                     f"{lines}")
            self.url = lines[-1].rsplit(" ", 1)[-1]
        except BaseException:
            self.kill()
            raise

    def stderr(self) -> str:
        self.kill()
        return self.proc.stderr.read()[-2000:]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)

    def stop(self) -> dict:
        if self.proc.poll() is not None:
            fail(f"{self.label}: the seeder died (exit "
                 f"{self.proc.returncode}): {self.proc.stderr.read()[-2000:]}")
        self.proc.terminate()
        try:
            out, err = self.proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            self.kill()
            fail(f"{self.label}: the seeder did not stop on SIGTERM")
        stats = [ln for ln in out.splitlines()
                 if ln.startswith("seeder stats: ")]
        if self.proc.returncode != 0 or not stats:
            fail(f"{self.label}: the seeder exited {self.proc.returncode} "
                 f"without its stats: {err[-2000:]}")
        return json.loads(stats[-1][len("seeder stats: "):])


def swarm_phase(work: Path, url: str, cfg_b, ckpt: Path, pushed,
                digest: str, tth_a: float, tfl_a: float, dev) -> dict:
    """Phase 8: node B seeds its cache in its own process; fresh nodes
    pull revision A onto the card with B as their direct peer, first from
    a clean seeder (8a), then from one whose every upload is corrupt
    (8b). Returns each kernel's launches over both pulls (none expected:
    the peer tier verifies on the host)."""
    from zest_tpu_torch import storage
    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.cas.xorb import XorbReader
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    copy = pushed.new_xorb_bytes
    counters = {"blake3_chunks": blake3_cuda.COUNTER,
                "bg4_regroup": bg4_cuda.COUNTER,
                "bg4_fused_verify": bg4_cuda.FUSED_COUNTER}
    launches = dict.fromkeys(counters, 0)

    def pull_from(label: str, seeder: Seeder, node: str):
        cfg = Config(hf_home=work / node / "hf", cache_dir=work / node /
                     "zest", endpoint=url, listen_port=0)
        swarm = SwarmDownloader(cfg)
        swarm.add_direct_peer("127.0.0.1", seeder.port)
        for c in counters.values():
            c.reset()  # counts from here are this pull's
        try:
            res = pull_model(cfg, REPO, revision=pushed.revision,
                             device=dev, swarm=swarm)
        finally:
            swarm.close()
        for name, c in counters.items():
            launches[name] += c.launches
        check_files(label, res, ckpt)
        check_tree(label, res, digest, dev)
        check_direct(label, res)
        return cfg, res

    wall0 = time.monotonic()
    seeder = Seeder("phase 8a", cfg_b)
    try:
        _, res = pull_from("phase 8a", seeder, "c8")
    finally:
        served = seeder.stop()
    st, sw = res.stats, res.stats["swarm"]
    fetch = st["fetch"]
    if fetch["p2p_ratio"] < 0.9 or fetch["bytes"]["cdn"] > 0.1 * copy:
        fail(f"phase 8a: p2p_ratio {fetch['p2p_ratio']}, CDN "
             f"{fetch['bytes']['cdn']:,} B of a {copy:,} B copy: {fetch}")
    if sw["peer_failures"] or sw["corrupt_from_peer"] or             sw["health"]["quarantine_events"] or             fetch["resilience"]["corrupt_from_peer"]:
        fail(f"phase 8a: a clean seeder failed or was struck: {sw}")
    if served["chunks_served"] <= 0:
        fail(f"phase 8a: the seeder served nothing: {served}")
    print(f"phase 8a swarm pull: {landing_summary(st)}; phase 4's CDN "
          f"pull time_to_hbm_s {tth_a}, time_to_first_layer_s {tfl_a}; "
          f"p2p_ratio {fetch['p2p_ratio']}, {fetch['bytes']['peer']:,} B "
          f"from the peer in {fetch['xorbs']['peer']} fetches, "
          f"{fetch['bytes']['cdn']:,} B from the CDN; seeder served "
          f"{served['chunks_served']} chunks, {served['bytes_served']:,} B; "
          f"swarm {sw['peer_attempts']} attempts, {sw['peer_failures']} "
          f"failures; files and digest equal to phase 4's")
    del res

    seeder = Seeder("phase 8b", cfg_b, ZEST_FAULTS="upload_corrupt:1.0")
    try:
        cfg_d, res = pull_from("phase 8b", seeder, "d8")
    finally:
        served_b = seeder.stop()
    st, sw = res.stats, res.stats["swarm"]
    fetch = st["fetch"]
    if fetch["resilience"]["corrupt_from_peer"] < 1:
        fail(f"phase 8b: no corruption detected: {fetch}")
    if sw["peers_quarantined"] < 1 or sw["health"]["quarantine_events"] < 1:
        fail(f"phase 8b: the corrupting seeder was not quarantined: {sw}")
    if fetch["bytes"]["cdn"] > 1.05 * copy:
        fail(f"phase 8b: CDN {fetch['bytes']['cdn']:,} B > 1.05 x "
             f"{copy:,} B")
    cache = storage.XorbCache(cfg_d)
    full = storage.list_cached_xorbs(cfg_d)
    for key in full:
        if XorbReader(cache.get(key)).xorb_hash() != hashing.hex_to_hash(key):
            fail(f"phase 8b: a corrupt blob is cached under the full key "
                 f"{key[:16]}")
    print(f"phase 8b corrupting seeder: {landing_summary(st)}; "
          f"corrupt_from_peer {fetch['resilience']['corrupt_from_peer']}, "
          f"{sw['peers_quarantined']} quarantine trip(s), peer bytes "
          f"{fetch['bytes']['peer']:,}, CDN {fetch['bytes']['cdn']:,} B "
          f"({fetch['bytes']['cdn'] / copy:.4f} of a copy); seeder served "
          f"{served_b['chunks_served']} corrupt chunks; {len(full)} "
          f"whole-xorb entries all hash to their keys; files and digest "
          f"equal to phase 4's")
    if any(launches.values()):
        fail(f"phase 8: a kernel launched on the peer path: {launches}")
    print(f"phase 8 wall {time.monotonic() - wall0:.2f} s; kernel launches "
          f"on the peer path {launches}")
    del res
    shutil.rmtree(work / "c8")
    shutil.rmtree(work / "d8")
    return launches


def receipt_timing(cfg_a, pushed, dev) -> None:
    """Each coop host's receipt verification without the network: host
    ``i`` verifies, through its own ``make_unit_verifier``, every minted
    xorb ``j`` with ``j % COOP_HOSTS != i`` (the 5-6 whole xorbs a host
    receives in phase 6). Timed host after host, each alone, then with
    every host's verifier in its own thread at once, as in phase 6: this
    parts the verifiers' contention with one another from the exchange's
    and the DCN servers'."""
    from zest_tpu_torch.transfer.pod import make_unit_verifier

    blobs = [(h, cfg_a.xorb_cache_path(h).read_bytes())
             for h in pushed.xorb_digests]
    sets = [[b for j, b in enumerate(blobs) if j % COOP_HOSTS != i]
            for i in range(COOP_HOSTS)]
    verifiers = [make_unit_verifier(device=dev) for _ in range(COOP_HOSTS)]

    errors = []

    def host(i, out):
        t0 = time.perf_counter()
        for h, data in sets[i]:
            if not verifiers[i](h, data):
                errors.append(f"receipt verify rejected minted xorb {h[:12]}")
        out[i] = time.perf_counter() - t0

    host(0, [0.0])  # warm-up
    alone, together = [0.0] * COOP_HOSTS, [0.0] * COOP_HOSTS
    for i in range(COOP_HOSTS):
        host(i, alone)
    threads = [threading.Thread(target=host, args=(i, together))
               for i in range(COOP_HOSTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or not all(together):
        fail(f"receipt timing: {errors or 'a host thread died'}")
    print(f"receipt verify without the network, per host (xorbs "
          f"{[len(s) for s in sets]}): alone "
          f"{[round(x, 3) for x in alone]} s (sum {sum(alone):.3f} s); "
          f"{COOP_HOSTS} hosts at once {[round(x, 3) for x in together]} s "
          f"(wall {wall:.3f} s)")


def time_bg4(cfg_a, pushed, dev, sass: tuple[int, int]) -> list[dict]:
    """Both BG4 kernels at the coop path's shapes: the largest minted
    xorb's BG4 chunks, staged as ``hash_planar_batch`` stages them. The
    fused kernel is timed in turns with the two-launch design it replaced
    (the regroup, then the BLAKE3 chunk kernel on its output). ``sass``
    is one compression's (ALU-pipe, FMA-pipe) instruction counts."""
    import torch

    from zest_tpu_torch.cas.compression import Scheme
    from zest_tpu_torch.cas.hashing import CHUNK_KEY
    from zest_tpu_torch.cas.xorb import XorbReader
    from zest_tpu_torch.ops import bg4, bg4_cuda, blake3_cuda

    blob = max((cfg_a.xorb_cache_path(h).read_bytes()
                for h in pushed.xorb_digests), key=len)
    reader = XorbReader(blob)
    idx = [i for i, s in enumerate(reader.chunk_schemes.tolist())
           if s == int(Scheme.BG4_LZ4)]
    sizes = [int(reader.chunk_sizes[i]) for i in idx]
    t0 = time.perf_counter()
    planar = [reader.extract_chunk_planar(i) for i in idx]
    t1 = time.perf_counter()
    words, lengths = bg4.stage_planar(planar, sizes, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    B, W = words.shape
    cap = 4 * W
    v = bg4.FusedBg4Verifier(CHUNK_KEY, dev)
    kw, bf = v.key_words, v.base_flags

    def library():
        return words.view(torch.uint8).view(B, 4, cap // 4).transpose(
            1, 2).contiguous()

    out = bg4_cuda.launch(words)
    rg_err = max_abs_err(out, bg4.regroup_words(words))
    if rg_err or not torch.equal(out.view(torch.uint8),
                                 library().view(B, cap)):
        fail("regroup kernel != plain / library at the coop shapes")
    def fused():
        return bg4_cuda.launch_fused(words, lengths, kw, bf)

    def pair():
        return blake3_cuda.launch(bg4_cuda.launch(words), lengths, kw, bf)

    got = fused()
    fused_err = max_abs_err(got, bg4.fused_regroup_hash(words, lengths, kw,
                                                        bf))
    if fused_err or not torch.equal(got, pair()):
        fail("fused kernel != plain fused / the two-launch pair at the "
             "coop shapes")
    rg_ms = cuda_ms(lambda: bg4_cuda.launch(words), 50)
    rg_plain = cuda_ms(lambda: bg4.regroup_words(words), 3)
    rg_lib = cuda_ms(library, 50)
    turns = [cuda_ms(fn, 50) for fn in (fused, pair, pair, fused)]
    fu_ms, pair_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    fu_plain = cuda_ms(lambda: bg4.fused_regroup_hash(words, lengths, kw, bf),
                       3)
    # Regroup: it reads and writes each row's capacity once.
    rg_bytes = 2 * B * cap
    rg_bound = rg_bytes / HBM_BYTES_PER_S * 1e3
    # The fused function: its input read once up to each row's
    # length (64-byte blocks, as kernel #1 counts it) and its digests
    # written once; the operations are kernel #1's for these lengths plus
    # eight byte permutes (ALU pipe) per 16 regrouped bytes.
    lens = np.asarray(sizes, dtype=np.int64)
    fu_bytes, n_compressions = blake3_work(lens)
    permutes = 8 * int(((lens + 15) // 16).sum())
    alu, fma = sass
    fu_byte_ms = fu_bytes / HBM_BYTES_PER_S * 1e3
    fu_op_ms = op_ms(n_compressions * alu + permutes, n_compressions * fma)
    fu_src_ops = n_compressions * SOURCE_OPS_PER_COMPRESSION + permutes
    pair_floor = rg_bound + op_ms(n_compressions * alu, n_compressions * fma)
    print(f"bg4 kernels at coop shapes: {B} BG4 chunks of the largest xorb "
          f"({len(reader)} chunks), cap {cap} B, {int(lens.sum()):,} bytes; "
          f"host LZ4 planar decode {1e3 * (t1 - t0):.1f} ms, stage_planar + "
          f"H2D {1e3 * (t2 - t1):.1f} ms")
    print(f"  bg4_regroup {rg_ms:.4f} ms ({rg_bytes / rg_ms / 1e9:.3f} TB/s), "
          f"plain {rg_plain:.2f} ms, library {rg_lib:.4f} ms, bound "
          f"{rg_bound:.4f} ms (bytes: {rg_bytes:,} B)")
    print(f"  two-launch pair (bg4_regroup, then blake3_chunks) "
          f"{turns[1]:.4f} / {turns[2]:.4f} ms, its floor (regroup bytes + "
          f"BLAKE3 ops) {pair_floor:.4f} ms")
    print(f"  bg4_fused_verify (one launch) {turns[0]:.4f} / {turns[3]:.4f} "
          f"ms, {pair_ms / fu_ms:.2f}x faster than the pair; plain "
          f"{fu_plain:.2f} ms, bound {max(fu_byte_ms, fu_op_ms):.4f} ms "
          f"(bytes {fu_byte_ms:.4f}: {fu_bytes:,} B; ops {fu_op_ms:.4f}: "
          f"{n_compressions:,} compressions x ({alu} ALU + {fma} FMA) + "
          f"{permutes:,} permutes; {fu_src_ops / INT32_OPS_PER_S * 1e3:.4f} "
          f"at the source's {SOURCE_OPS_PER_COMPRESSION} per compression)")
    return [
        {"name": "bg4_regroup", "route": "cuda",
         "source": "zest_tpu_torch/csrc/bg4.cu",
         "replaces": "zest_tpu/ops/decode_pallas.py:103",
         "max_abs_err": rg_err, "ms": rg_ms, "plain_ms": rg_plain,
         "bound_ms": rg_bound, "bound_by": "bytes", "library_ms": rg_lib},
        {"name": "bg4_fused_verify", "route": "cuda",
         "source": "zest_tpu_torch/csrc/blake3.cu",
         "replaces": "zest_tpu/ops/decode_pallas.py:124",
         "max_abs_err": fused_err, "ms": fu_ms, "plain_ms": fu_plain,
         "pair_ms": pair_ms, "bound_ms": max(fu_byte_ms, fu_op_ms),
         "bound_by": "bytes" if fu_byte_ms > fu_op_ms else "operations",
         "library_ms": None},
    ]


def llama_checkpoint(seed: int, cfg: dict) -> dict:
    """HF-named bf16 Llama tensors from a numpy seed: every matrix
    N(0, 0.02), the norms 1 + N(0, 0.02), each drawn in float32 and
    rounded to bf16 as the landing's cast rounds (nearest even). Tied
    embeddings: no ``lm_head.weight``."""
    import torch

    from zest_tpu_torch.models.loader import cast_floating

    rng = np.random.default_rng(seed)
    E, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    qE = cfg["num_attention_heads"] * cfg["head_dim"]
    kvE = cfg["num_key_value_heads"] * cfg["head_dim"]

    def w(*shape, one=False):
        v = rng.standard_normal(shape, dtype=np.float32)
        v *= np.float32(0.02)
        if one:
            v += np.float32(1.0)
        return cast_floating(torch.from_numpy(v), torch.bfloat16)

    t = {"model.embed_tokens.weight": w(V, E)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = w(E, one=True)
        t[p + "self_attn.q_proj.weight"] = w(qE, E)
        t[p + "self_attn.k_proj.weight"] = w(kvE, E)
        t[p + "self_attn.v_proj.weight"] = w(kvE, E)
        t[p + "self_attn.o_proj.weight"] = w(E, qE)
        t[p + "post_attention_layernorm.weight"] = w(E, one=True)
        t[p + "mlp.gate_proj.weight"] = w(F, E)
        t[p + "mlp.up_proj.weight"] = w(F, E)
        t[p + "mlp.down_proj.weight"] = w(E, F)
    t["model.norm.weight"] = w(E, one=True)
    return t


def cached_logits(llama, params, cfg, tokens, n0: int):
    """The cached path's logits over token rows (B, T): the prompt's
    prefill window, then one cached step per position, as the decode
    runs them. Returns (B, T - 1, vocab) float32 logits on the card."""
    import torch

    B, T = tokens.shape
    cache = llama.init_kv_cache(cfg, B, T, dtype=params["wte"].dtype,
                                device=tokens.device)
    logits, cache = llama.decode_window(params, cache, tokens[:, :n0], 0,
                                        cfg)
    out = [logits.float()]
    for pos in range(n0, T - 1):
        step, cache = llama.decode_step(params, cache, tokens[:, pos], pos,
                                        cfg)
        out.append(step[:, None].float())
    return torch.cat(out, dim=1)


def tree_map(fn, tree):
    """``fn`` over the leaves of a dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def top2_margin(scores) -> float:
    """The gap between the two largest of a row of scores."""
    top = scores.float().topk(2).values
    return float(top[0] - top[1])


def tokens_agree(label: str, got, want, margin_at, tol: float) -> str:
    """Card tokens ``got`` against the CPU run's ``want`` (B, T): equal,
    or each row's first difference at a position where the CPU run's
    top-2 margin (``margin_at(row, pos)``) is below ``tol``. Returns a
    note for the log."""
    notes = []
    for row, (g, w) in enumerate(zip(np.atleast_2d(got), np.atleast_2d(want))):
        diff = np.nonzero(g != w)[0]
        if diff.size == 0:
            continue
        pos = int(diff[0])
        margin = margin_at(row, pos)
        if not margin < tol:
            fail(f"phase 7 {label}: row {row} differs from the CPU run at "
                 f"position {pos} (CPU top-2 margin {margin:.3e} >= {tol:.1e})")
        notes.append(f"row {row} from position {pos} (CPU top-2 margin "
                     f"{margin:.3e} < {tol:.1e})")
    return "equal" if not notes else "near-tie: " + "; ".join(notes)


def llama_phase(work: Path, url: str, cfg_a, seed: int, steps: int,
                dev) -> dict:
    """Phase 7: Llama-3.2-1B pushed, pulled onto the card through the
    direct streaming landing, and decoded (greedy and sampled, batch 1
    and 4) against the port's own CPU float32 run. Returns the push's
    BLAKE3 kernel launches and what phase 9 holds the pool to: the
    pulled snapshot (node ``l`` stays), its digest, the prompts, the
    card's float32 tokens and their logits, the noise and the bf16
    tree's logits error."""
    import torch

    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models import llama
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.models.sampling import gumbel_noise, sample_scores
    from zest_tpu_torch.ops import blake3_cuda
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    wall0 = time.monotonic()
    ckpt = work / "llama"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(LLAMA_CONFIG, indent=2))
    t0 = time.monotonic()
    tensors = llama_checkpoint(seed + 7, LLAMA_CONFIG)
    n_params = sum(t.numel() for t in tensors.values())
    if len(tensors) != LLAMA_TENSORS or n_params != LLAMA_PARAMS:
        fail(f"phase 7: {len(tensors)} tensors, {n_params:,} parameters")
    write_safetensors(ckpt / "model.safetensors", tensors)
    del tensors
    made_s = time.monotonic() - t0

    # ── push: the kernel re-verifies every minted chunk ──
    blake3_cuda.COUNTER.reset()  # counts from here are the push's
    t0 = time.monotonic()
    pushed = push_checkpoint(cfg_a, LLAMA_REPO, ckpt, device=dev,
                             notify=False)
    push_s = time.monotonic() - t0
    launches = blake3_cuda.COUNTER.launches
    if launches < 1 or blake3_cuda.COUNTER.rows != pushed.minted_chunks:
        fail(f"phase 7: the push's kernel hashed {blake3_cuda.COUNTER.rows} "
             f"chunks in {launches} launches; it minted "
             f"{pushed.minted_chunks}")

    # ── pull onto the card: the direct streaming landing ──
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg_l = Config(hf_home=work / "l" / "hf", cache_dir=work / "l" / "zest",
                   endpoint=url)
    res = pull_model(cfg_l, LLAMA_REPO, device=dev)
    st = res.stats
    if st["fallback_files"]:
        fail(f"phase 7: {st['fallback_files']} whole-file fallbacks")
    check_files("phase 7", res, ckpt)
    host = load_checkpoint(res.snapshot_dir, "cpu")
    digest = params_digest(host)
    check_tree("phase 7", res, digest, dev)
    check_direct("phase 7", res)
    if any(t.dtype != torch.bfloat16 for t in res.params.values()):
        fail("phase 7: the landed tree is not bf16")

    # ── decode: the card's float32 tree against the CPU's ──
    cfg = llama.LlamaConfig.from_hf(LLAMA_CONFIG)
    _, gen = load_generator(res.snapshot_dir, device=dev, tensors=res.params)
    params = llama.params_from_hf(res.params, cfg)  # the logits gate's
    res.params = None  # the landed bf16 tree is not kept
    params_cpu = llama.params_from_hf(host, cfg)
    del host
    rng = np.random.default_rng(seed + 8)
    prompts = rng.integers(0, cfg.vocab_size, (4, 8)).tolist()
    n0, total = 8, 8 + steps
    rates, greedy = {}, {}
    for batch in ([prompts[0]], prompts):
        gen(batch, 2, stop_at_eos=False)  # warm-up
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        out = gen(batch, steps, stop_at_eos=False)
        dt = time.monotonic() - t0
        rates[len(batch)] = len(batch) * steps / dt
        greedy[len(batch)] = np.atleast_2d(out)

    # Logits: every position of the cached path on the card against the
    # CPU's uncached float32 forward over the same rows; beside it the
    # same comparison with TF32 on, and with the tree in bf16.
    errs = {"f32": 0.0, "tf32": 0.0, "bf16": 0.0}
    cpu_logits = {}
    params_bf16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    t0 = time.monotonic()
    for b, rows in greedy.items():
        toks = torch.from_numpy(rows).to(dev)
        want = llama.forward(params_cpu, toks.cpu(), cfg)[:, :total - 1]
        cpu_logits[b] = want
        for mode in errs:
            torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
            try:
                got = cached_logits(llama, params_bf16 if mode == "bf16"
                                    else params, cfg, toks, n0).cpu()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            errs[mode] = max(errs[mode], float((got - want).abs().max()))
    del params_bf16
    cpu_fwd_s = time.monotonic() - t0
    if not errs["f32"] <= LOGITS_TOL:
        fail(f"phase 7: card logits off the CPU's by {errs['f32']:.3e} > "
             f"{LOGITS_TOL:.1e}")
    if not errs["bf16"] > LOGITS_TOL:
        fail(f"phase 7: a bf16 decode passes the logits tolerance "
             f"({errs['bf16']:.3e} <= {LOGITS_TOL:.1e})")

    # Greedy tokens against the CPU float32 run.
    t0 = time.monotonic()
    notes = {}
    for b, rows in greedy.items():
        batch = prompts[:b]
        want = np.atleast_2d(llama.generate_cached(params_cpu, cfg, batch,
                                                   steps).numpy())
        notes[f"greedy b{b}"] = tokens_agree(
            f"greedy batch {b}", rows, want,
            lambda r, pos, b=b: top2_margin(cpu_logits[b][r, pos - 1]),
            LOGITS_TOL)

    # Sampled tokens: Gumbel noise drawn once on the host, injected on
    # both sides; the margin rule on the perturbed scores, whose logits
    # error is the logits' over the temperature.
    noise = gumbel_noise((total - 1, 4, cfg.vocab_size),
                         torch.Generator().manual_seed(seed))
    sampled_tol = LOGITS_TOL / SAMPLING["temperature"]
    sampled = {}
    for b in (1, 4):
        batch = prompts[:b]
        got = sampled[b] = np.atleast_2d(gen(
            batch, steps, stop_at_eos=False, noise=noise[:, :b].to(dev),
            **SAMPLING))
        want = np.atleast_2d(llama.generate_cached(
            params_cpu, cfg, batch, steps, noise=noise[:, :b],
            **SAMPLING).numpy())

        def margin(r, pos, got=got, b=b):
            logits = llama.forward(params_cpu, torch.from_numpy(
                got[r:r + 1, :pos]), cfg)[0, -1]
            return top2_margin(sample_scores(logits, **SAMPLING)
                               + noise[pos - 1, r])

        notes[f"sampled b{b}"] = tokens_agree(f"sampled batch {b}", got,
                                              want, margin, sampled_tol)
    cpu_decode_s = time.monotonic() - t0

    # Phase 9's reference: the card's float32 tokens (held to the CPU
    # above) and the float32 logits along them.
    ref = {"snapshot": res.snapshot_dir, "digest": digest,
           "prompts": prompts, "noise": noise, "bf16_err": errs["bf16"],
           "greedy": greedy, "sampled": sampled, "logits": {}}
    for kind, rows_by_b in (("greedy", greedy), ("sampled", sampled)):
        for b, rows in rows_by_b.items():
            ref["logits"][kind, b] = cached_logits(
                llama, params, cfg, torch.from_numpy(rows).to(dev),
                n0).cpu()

    # Seeded on the card: one seed, one draw; on_token sees each
    # generated position once, in order.
    seen = []
    one = gen(prompts, steps, stop_at_eos=False, seed=seed, **SAMPLING,
              on_token=lambda pos, toks: seen.append((pos, toks.copy())))
    two = gen(prompts, steps, stop_at_eos=False, seed=seed, **SAMPLING)
    if not np.array_equal(one, two):
        fail("phase 7: two card runs with one seed differ")
    if [p for p, _ in seen] != list(range(n0, total)) or any(
            not np.array_equal(one[:, p], t) for p, t in seen):
        fail(f"phase 7: on_token saw positions {[p for p, _ in seen]}")
    peak = torch.cuda.max_memory_allocated(dev)
    del gen, params, params_cpu
    res = None
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()
    bound_ms = (LLAMA_PARAMS * 4 / HBM_BYTES_PER_S) * 1e3
    print(f"phase 7 llama: {LLAMA_REPO} at its published width and depth "
          f"({n_params:,} params, {LLAMA_TENSORS} bf16 tensors, "
          f"{pushed.total_bytes:,} bytes; made in "
          f"{made_s:.2f} s); push_s {push_s:.2f} ({pushed.new_xorbs} xorbs, "
          f"{pushed.minted_chunks} chunks, kernel launches {launches}); "
          f"{landing_summary(st)}; ring {st['hbm']['ring']}; digest equal")
    print(f"  decode: tok/s batch 1 {rates[1]:.1f}, batch 4 {rates[4]:.1f} "
          f"(8 + {steps} steps, greedy; bound at batch 1 "
          f"{bound_ms:.3f} ms/token: the float32 tree read once); "
          f"logits max |card - CPU| f32 {errs['f32']:.3e} (tolerance "
          f"{LOGITS_TOL:.1e}), TF32 {errs['tf32']:.3e}, bf16 tree "
          f"{errs['bf16']:.3e}; tokens vs CPU float32 {notes}; one seed "
          f"twice on the card equal; on_token positions {n0}..{total - 1}")
    print(f"  peak allocation {peak:,} B; CPU forward {cpu_fwd_s:.2f} s, "
          f"CPU decodes {cpu_decode_s:.2f} s; phase wall "
          f"{time.monotonic() - wall0:.2f} s")
    ref["launches"] = launches
    return ref


def mixtral_checkpoint(seed: int, cfg: dict) -> dict:
    """HF-named bf16 Mixtral tensors from a numpy seed, as
    :func:`llama_checkpoint` draws them (untied: ``lm_head.weight``)."""
    import torch

    from zest_tpu_torch.models.loader import cast_floating

    rng = np.random.default_rng(seed)
    E, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    D = E // cfg["num_attention_heads"]
    kvE = cfg["num_key_value_heads"] * D

    def w(*shape, one=False):
        v = rng.standard_normal(shape, dtype=np.float32)
        v *= np.float32(0.02)
        if one:
            v += np.float32(1.0)
        return cast_floating(torch.from_numpy(v), torch.bfloat16)

    t = {"model.embed_tokens.weight": w(V, E)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = w(E, one=True)
        t[p + "self_attn.q_proj.weight"] = w(E, E)
        t[p + "self_attn.k_proj.weight"] = w(kvE, E)
        t[p + "self_attn.v_proj.weight"] = w(kvE, E)
        t[p + "self_attn.o_proj.weight"] = w(E, E)
        t[p + "post_attention_layernorm.weight"] = w(E, one=True)
        t[p + "block_sparse_moe.gate.weight"] = w(cfg["num_local_experts"],
                                                  E)
        for x in range(cfg["num_local_experts"]):
            ep = f"{p}block_sparse_moe.experts.{x}."
            t[ep + "w1.weight"] = w(F, E)
            t[ep + "w2.weight"] = w(E, F)
            t[ep + "w3.weight"] = w(F, E)
    t["model.norm.weight"] = w(E, one=True)
    t["lm_head.weight"] = w(V, E)
    return t


def router_gaps(moe, params, cfg, tokens):
    """The float32 family path's routing margins over token rows (B, T):
    for each token, the smallest gap between a layer's 2nd and 3rd router
    logits (a bf16 error larger than it can swap an expert). Returns
    (B, T) float32 on the host."""
    import torch

    x = params["wte"][tokens]
    gap = torch.full(tokens.shape, float("inf"))
    with torch.inference_mode():
        for i in range(cfg.n_layer):
            lp = moe._layer(params, i)
            h = moe._rms_norm(x, lp["ln_attn"]["g"], cfg.rms_eps)
            x = x + moe._attention(h, lp["attn"], cfg)
            h = moe._rms_norm(x, lp["ln_moe"]["g"], cfg.rms_eps)
            top = (h @ lp["moe"]["router_w"]).float().topk(3).values
            gap = torch.minimum(gap, (top[..., 1] - top[..., 2]).cpu())
            x = x + moe._moe_block(h, lp["moe"], cfg)[0]
    return gap


def sampled_margin(logits, noise, choice: int, temperature: float,
                   top_k: int | None, top_p: float | None) -> float:
    """Twice the smallest max-abs logit error (bisected) under which a
    sampled decision of the float32 path, ``choice``, could change: its
    perturbed top-2 gap can close, or the top-k or nucleus boundary can
    move a token in or out. Scores are ``logits / temperature``; an
    error ``e`` moves a difference of two scores by at most ``2e/T`` and
    a probability by a factor within ``exp(±2e/T)``. Fails where the
    decision flips at no error at all (the gate does not reproduce the
    float32 choice) or only at the bisection floor."""
    s = logits.double().numpy() / temperature
    z = s + noise.double().numpy()
    V = s.size
    order = np.argsort(s, kind="stable")
    asc = s[order]
    k = min(top_k, V) if top_k else V

    def suffix(p):
        return np.concatenate([np.cumsum(p[order][::-1])[::-1], [0.0]])

    def flips(e: float) -> bool:
        d = 2 * e / temperature
        ahead = np.searchsorted(asc, s + d, side="right")  # surely above
        near = np.searchsorted(asc, s - d, side="left")    # maybe above
        maybe, surely = V - ahead < k, V - near - 1 < k
        if not surely[choice]:
            return True
        if top_p is not None and top_p < 1.0:
            r = np.exp(d)
            p = np.exp(s - s.max())
            # Bounds of the top-k-renormalized mass ahead of a token:
            # at least its surely-ahead tokens' share of the maybe-kept
            # set, at most its maybe-ahead tokens' share of the
            # surely-kept set.
            kept = np.where(maybe, p, 0.0)
            q = kept / max(p[surely].sum(), 1e-300)
            maybe &= suffix(kept / kept.sum())[ahead] / r < top_p
            surely &= (suffix(q)[near] - q) * r < top_p
        if not surely[choice]:
            return True
        others = maybe.copy()
        others[choice] = False
        return bool(others.any() and z[others].max() >= z[choice] - d)

    if flips(0.0):
        # The gate does not reproduce the float32 choice from its own
        # logits and noise: no error bound can forgive a difference there.
        fail(f"the float32 choice {choice} is not the gate's pick from the "
             f"recorded logits and noise (top-k {top_k}, top-p {top_p})")
    lo, hi = 0.0, 16.0
    if not flips(hi):
        return 2 * hi
    for _ in range(40):
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if flips(mid) else (mid, hi)
    if hi <= 16.0 / 2 ** 40:
        fail(f"the float32 choice {choice} flips at the bisection floor "
             f"({2 * hi:.3e}): the gate cannot tell it from a tie")
    return 2 * hi


def tokens_near(label: str, got, want, margin_at, tol: float) -> tuple:
    """Pool tokens ``got`` against the float32 path's ``want`` (B, T):
    equal, or each row's first difference where ``margin_at(row, pos)``
    (the float32 run's own margin there) is below ``tol``. Returns
    ``(note, positions compared)``."""
    notes, compared = [], 0
    for row, (g, w) in enumerate(zip(np.atleast_2d(got),
                                     np.atleast_2d(want))):
        diff = np.nonzero(g != w)[0]
        if diff.size == 0:
            compared += len(g)
            continue
        pos = int(diff[0])
        compared += pos + 1
        margin = margin_at(row, pos)
        if not margin < tol:
            fail(f"phase 9 {label}: row {row} differs from the float32 "
                 f"path at position {pos} (its margin {margin:.3e} >= "
                 f"{tol:.3e})")
        notes.append(f"row {row} from position {pos} (margin "
                     f"{margin:.3e} < {tol:.3e})")
    return ("equal" if not notes else "near-tie: " + "; ".join(notes),
            compared)


def pool_phase(work: Path, url: str, cfg_a, ref: dict, seed: int,
               steps: int, dev) -> dict:
    """Phase 9a: an ``HbmPool`` on the card in this process, over fresh
    node pulls: Llama-3.2-1B from phase 7's snapshot (cold, hot, evicted,
    re-landed) and Mixtral-8x7B at its published width, cut to one layer
    (pushed here; dense core landed, experts paged). Returns the pool's
    tokens, the Mixtral push's kernel launches and this path's launches."""
    import dataclasses
    import gc

    import torch

    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models import hbm_pool, moe
    from zest_tpu_torch.models.loader import load_checkpoint
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    wall0 = time.monotonic()
    card = card_label()
    counters = (blake3_cuda.COUNTER, bg4_cuda.COUNTER,
                bg4_cuda.FUSED_COUNTER)
    for c in counters:
        c.reset()  # counts from here are the serving path's
    n0, total = 8, 8 + steps
    prompts = ref["prompts"]
    # A decision flips only where the float32 path's own margin is below
    # twice the bf16 tree's logits error (phase 7's).
    tol = 2 * ref["bf16_err"]
    cfg_p = Config(hf_home=work / "p" / "hf", cache_dir=work / "p" / "zest",
                   endpoint=url)
    pool = hbm_pool.HbmPool(cfg_p, dev)
    snap = ref["snapshot"]
    out = {}

    # ── Llama-3.2-1B: cold (decode from the first-layer commit), hot ──
    t0 = time.monotonic()
    got, info = pool.generate_for(snap, LLAMA_REPO, [prompts[0]], steps,
                                  stop_at_eos=False)
    cold_s = time.monotonic() - t0
    entry = pool._entries[str(Path(snap).resolve())]
    if info["temp"] != "cold" or not info["decode_start_before_land_end"] \
            or not entry.t_first_layer < entry.t_land_end:
        fail(f"phase 9a: llama cold {info}, first layer "
             f"{entry.t_first_layer} land end {entry.t_land_end}")
    land_s = entry.t_land_end - entry.t_land_start
    if pool.digest(snap) != ref["digest"]:
        fail("phase 9a: the pool's llama digest != phase 7's landing")
    if any(t.dtype != torch.bfloat16 for t in entry.params.values()):
        fail("phase 9a: the pool's llama tree is not bf16")
    cold_ids = np.atleast_2d(got)
    notes, compared = {}, 0
    runs = {}
    for kind in ("greedy", "sampled"):
        for b in (1, 4):
            kw = {}
            if kind == "sampled":
                kw = dict(SAMPLING, noise=ref["noise"][:, :b])
            t0 = time.monotonic()
            ids, info_b = pool.generate_for(snap, LLAMA_REPO, prompts[:b],
                                            steps, stop_at_eos=False, **kw)
            runs[kind, b] = (time.monotonic() - t0, info_b)
            ids = np.atleast_2d(ids)
            out["llama", kind, b] = ids
            logits = ref["logits"][kind, b]
            if kind == "greedy":
                def margin(r, pos, logits=logits):
                    return top2_margin(logits[r, pos - 1])
            else:
                def margin(r, pos, logits=logits, b=b):
                    return sampled_margin(
                        logits[r, pos - 1], ref["noise"][pos - 1, r],
                        int(ref["sampled"][b][r, pos]), **SAMPLING)
            notes[kind, b], n = tokens_near(
                f"llama {kind} batch {b}", ids, ref[kind][b], margin, tol)
            compared += n
    if not np.array_equal(cold_ids, out["llama", "greedy", 1]):
        fail("phase 9a: the cold and hot llama runs differ")
    if runs["greedy", 1][1]["temp"] != "hot":
        fail(f"phase 9a: a second request ran {runs['greedy', 1][1]}")

    # ── evict: the memory goes back; a re-land is the same tree ──
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    if not pool.evict(snap):
        fail("phase 9a: the llama tree was not evictable")
    gc.collect()
    freed = before - torch.cuda.memory_allocated(dev)
    if freed < LLAMA_PARAMS * 2:
        fail(f"phase 9a: evict freed {freed:,} B < {LLAMA_PARAMS * 2:,} B")
    t0 = time.monotonic()
    again, info_r = pool.generate_for(snap, LLAMA_REPO, [prompts[0]], steps,
                                      stop_at_eos=False)
    reland_s = time.monotonic() - t0
    if info_r["temp"] != "cold" or pool.digest(snap) != ref["digest"]:
        fail(f"phase 9a: the re-land {info_r} or its digest is off")
    if not np.array_equal(np.atleast_2d(again), cold_ids):
        fail("phase 9a: the re-land's tokens differ from the cold run's")
    out["llama_cold"] = cold_ids
    pool.evict(snap)
    print(f"phase 9a pool llama ({card}): cold ttft {info['ttft_s']} s "
          f"(request {cold_s:.3f} s, land {land_s:.3f} s, first layer "
          f"{entry.t_first_layer - entry.t_land_start:.3f} s, decode from "
          f"the first-layer commit), hot ttft "
          f"{runs['greedy', 1][1]['ttft_s']} s, re-land ttft "
          f"{info_r['ttft_s']} s (request {reland_s:.3f} s); gate_stall_s "
          f"{entry.gate_stall_s:.4f}; tok/s "
          + ", ".join(f"{k} b{b} {b * steps / dt:.1f}"
                      for (k, b), (dt, _) in runs.items())
          + f"; evict freed {freed:,} B; digest = phase 7's before and "
          f"after the re-land; tokens vs the float32 path {notes} "
          f"({compared} positions; a difference is forgiven where the "
          f"float32 decision's margin, twice the logit error that can flip "
          f"it, is below {tol:.4f} = 2 x phase 7's bf16 logits error); "
          f"re-land tokens bit-equal to the cold run's")
    shutil.rmtree(work / "l")

    # ── Mixtral-8x7B, one layer: push, pull, pool (paged experts) ──
    ckpt = work / "mixtral"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(MIXTRAL_CONFIG, indent=2))
    t0 = time.monotonic()
    tensors = mixtral_checkpoint(seed + 9, MIXTRAL_CONFIG)
    n_params = sum(t.numel() for t in tensors.values())
    if n_params != MIXTRAL_PARAMS:
        fail(f"phase 9: {n_params:,} Mixtral parameters")
    write_safetensors(ckpt / "model.safetensors", tensors)
    del tensors
    made_s = time.monotonic() - t0
    serve_launches = [c.launches for c in counters]
    blake3_cuda.COUNTER.reset()
    t0 = time.monotonic()
    pushed = push_checkpoint(cfg_a, MIXTRAL_REPO, ckpt, device=dev,
                             notify=False)
    push_s = time.monotonic() - t0
    push_launches = blake3_cuda.COUNTER.launches
    if push_launches < 1 or blake3_cuda.COUNTER.rows != pushed.minted_chunks:
        fail(f"phase 9: the push's kernel hashed {blake3_cuda.COUNTER.rows}"
             f" chunks; it minted {pushed.minted_chunks}")
    for c in counters:
        c.reset()
    t0 = time.monotonic()
    res = pull_model(cfg_p, MIXTRAL_REPO, device=dev, land=False)
    pull_s = time.monotonic() - t0
    check_files("phase 9a", res, ckpt)
    msnap = res.snapshot_dir
    mcfg = moe.MoEConfig.from_hf(MIXTRAL_CONFIG)
    mprompt = [t % mcfg.vocab_size for t in prompts[0]]
    t0 = time.monotonic()
    mids, minfo = pool.generate_for(msnap, MIXTRAL_REPO, [mprompt],
                                    steps, stop_at_eos=False)
    m_s = time.monotonic() - t0
    mentry = pool._entries[str(Path(msnap).resolve())]
    ex = minfo["experts"]
    group = MIXTRAL_EXPERT_BYTES // 8
    if (mentry.reserved != MIXTRAL_DENSE_BYTES
            or mentry.bytes != MIXTRAL_DENSE_BYTES):
        fail(f"phase 9a: mixtral reserved {mentry.reserved:,}, committed "
             f"{mentry.bytes:,} B")
    if not (ex["page_ins"] > 0 and ex["verified"] == 3 * ex["page_ins"]
            and ex["evictions"] > 0 and ex["residency"] < 0.5
            and ex["peak_bytes"] <= max(ex["budget_bytes"], group)
            and ex["budget_bytes"] == MIXTRAL_PAGER_BYTES
            and ex["total_expert_bytes"] == MIXTRAL_EXPERT_BYTES):
        fail(f"phase 9a: pager {ex}")
    mids = np.atleast_2d(mids)
    dense = mentry.bytes
    # One page-in by its parts: the host read, its BLAKE3, the commit.
    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.models import loader
    from zest_tpu_torch.models.safetensors_io import tensor_bytes

    t0 = time.monotonic()
    page = {leaf: mentry.pager._reader(name)
            for leaf, name in mentry.pager._names(0, 0).items()}
    t1 = time.monotonic()
    for view in page.values():
        hashing.blake3_hash(tensor_bytes(view).tobytes())
    t2 = time.monotonic()
    page = loader.commit_tensors(page, dev)
    page_s = (t1 - t0, t2 - t1, time.monotonic() - t2)
    del page
    out["mixtral"] = mids
    out["mixtral_prompt"] = mprompt

    # The family path: a float32 tree on the card whose capacity drops
    # nothing, held to the CPU's float32 forward at every position.
    fcfg = dataclasses.replace(mcfg, capacity_factor=mcfg.n_experts
                               / mcfg.top_k)
    host = load_checkpoint(msnap, "cpu")
    params = moe.params_from_hf({n: t.to(dev) for n, t in host.items()},
                                fcfg)
    want = np.atleast_2d(moe.generate_cached(params, fcfg, [mprompt],
                                             steps).cpu().numpy())
    toks = torch.from_numpy(want).to(dev)
    cache = moe.init_kv_cache(fcfg, 1, total, device=dev)
    logits, cache = moe.decode_window(params, cache, toks[:, :n0], 0, fcfg)
    parts = [logits.float()]
    for pos in range(n0, total - 1):
        step, cache = moe.decode_step(params, cache, toks[:, pos], pos,
                                      fcfg)
        parts.append(step[:, None].float())
    card_logits = torch.cat(parts, dim=1).cpu()
    gaps = router_gaps(moe, params, fcfg, toks[:, :total - 1])
    del params, cache
    t0 = time.monotonic()
    params_cpu = moe.params_from_hf(host, fcfg)
    del host
    cpu_logits = moe.forward(params_cpu, toks[:, :total - 1].cpu(),
                             fcfg)[0]
    cpu_fwd_s = time.monotonic() - t0
    del params_cpu
    err = float((card_logits - cpu_logits).abs().max())
    if not err <= LOGITS_TOL:
        fail(f"phase 9a: mixtral family logits off the CPU's by {err:.3e} "
             f"> {LOGITS_TOL:.1e}")

    def mmargin(r, pos):
        return min(top2_margin(card_logits[r, pos - 1]),
                   float(gaps[r, :pos].min()))

    mnote, mcompared = tokens_near("mixtral greedy batch 1", mids, want,
                                   mmargin, tol)
    pool.close()
    torch.cuda.empty_cache()
    launches = {name: n + c.launches for name, c, n in zip(
        ("blake3_chunks", "bg4_regroup", "bg4_fused_verify"), counters,
        serve_launches)}
    print(f"phase 9a pool mixtral ({card}): {MIXTRAL_REPO} at its published "
          f"width, 1 of 32 layers ({n_params:,} params, "
          f"{pushed.total_bytes:,} bytes; made in {made_s:.2f} s); push_s "
          f"{push_s:.2f} ({pushed.new_xorbs} xorbs, {pushed.minted_chunks} "
          f"chunks, kernel launches {push_launches}); files-only pull "
          f"{pull_s:.2f} s; cold ttft {minfo['ttft_s']} s (request "
          f"{m_s:.3f} s, "
          f"{(steps - 1) / (m_s - minfo['ttft_s']):.2f} tok/s after "
          f"the first); dense core {dense:,} B committed; one page-in "
          f"(352,321,536 B): read {page_s[0]:.3f} s, BLAKE3 "
          f"{page_s[1]:.3f} s, commit {page_s[2]:.3f} s; pager "
          f"{ex}; tokens vs the float32 family path {mnote} ({mcompared} "
          f"positions, tolerance {tol:.4f}); family logits max |card - "
          f"CPU| {err:.3e} (tolerance {LOGITS_TOL:.1e}; CPU forward "
          f"{cpu_fwd_s:.2f} s); kernel launches on the serving path "
          f"{launches}; phase wall {time.monotonic() - wall0:.2f} s")
    shutil.rmtree(ckpt)
    shutil.rmtree(work / "p")
    out["push_launches"] = push_launches
    out["launches"] = launches
    return out


def sse_post(url: str, body: dict) -> list[tuple[float, dict]]:
    """POST /v1/generate; returns its SSE events, each with the seconds
    from the request to its arrival (the daemon flushes each event as it
    happens)."""
    import urllib.request

    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.monotonic()
    events = []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if line.startswith(b"data: "):
                events.append((time.monotonic() - t0,
                               json.loads(line[len(b"data: "):])))
    return events


def daemon_phase(work: Path, url: str, pool_out: dict, llama_prompt,
                 gpt2_b1, gpt2_sha: str, steps: int) -> dict:
    """Phase 9b: ``python -m zest_tpu_torch serve`` as its own process on
    a fresh node C whose hub is node A's publisher, with a 3 GiB pool:
    five generate requests (Llama cold, streamed hot, Mixtral cold
    evicting Llama, Llama re-landed, GPT-2 on the single-model path),
    then its metrics, status and a SIGTERM. Returns the daemon's kernel
    launches over the five requests, by kernel, from its ``/v1/status``
    before the first and after the last."""
    import urllib.request

    from zest_tpu_torch.config import Config

    wall0 = time.monotonic()
    cfg_c = Config(hf_home=work / "c9" / "hf",
                   cache_dir=work / "c9" / "zest")
    daemon = Seeder("phase 9b", cfg_c, args=("--device", "cuda"),
                    HF_ENDPOINT=url, ZEST_HBM_POOL_BYTES=str(DAEMON_POOL))
    lines = []
    try:
        def kernel_counts() -> dict:
            return json.loads(urllib.request.urlopen(
                daemon.url + "/v1/status", timeout=60).read())["kernels"]

        counts0 = kernel_counts()
        body = {"ids": list(llama_prompt), "steps": steps,
                "stop_at_eos": False}

        def ask(label, repo, stream=False, **extra):
            timed = sse_post(daemon.url, {"repo_id": repo, **body,
                                          "stream": stream, **extra})
            kinds = [e["event"] for _, e in timed]
            want = (["start", "pulled"] + ["token"] * (steps if stream
                                                       else 0) + ["done"])
            if kinds != want:
                fail(f"phase 9b {label}: events {kinds}: {timed[-1]}")
            (_, _), (t_pulled, _), *_, (t_done, done) = timed
            pool = done.get("pool")
            # The decode after its first token (the pool's TTFT runs from
            # the pool call, right after the pull): steps - 1 tokens.
            dt = t_done - t_pulled - (pool["ttft_s"] if pool else 0.0)
            lines.append(f"{label}: pull {t_pulled:.3f} s, "
                         + (f"ttft {pool['ttft_s']} s ({pool['temp']}), "
                            f"gate_stall_s {pool['gate_stall_s']}, "
                            f"{(steps - 1) / dt:.1f} tok/s after the first"
                            if pool else f"load + decode {dt:.3f} s "
                            "(single-model path)")
                         + f", wall {t_done:.3f} s")
            return done

        d1 = ask("1 llama", LLAMA_REPO)
        if d1["pool"]["temp"] != "cold" or \
                d1["ids"] != pool_out["llama_cold"][0].tolist():
            fail(f"phase 9b 1: {d1['pool']}, ids equal to 9a: "
                 f"{d1['ids'] == pool_out['llama_cold'][0].tolist()}")
        d2 = ask("2 llama streamed", LLAMA_REPO, stream=True)
        if d2["pool"]["temp"] != "hot" or d2["ids"] != d1["ids"]:
            fail(f"phase 9b 2: {d2['pool']}")
        d3 = ask("3 mixtral", MIXTRAL_REPO, ids=pool_out["mixtral_prompt"])
        ex = d3["pool"]["experts"]
        resident = json.loads(urllib.request.urlopen(
            daemon.url + "/v1/models", timeout=60).read())["resident"]
        if d3["pool"]["temp"] != "cold" or not ex["residency"] < 0.5 or \
                [r["repo"] for r in resident] != [MIXTRAL_REPO] or \
                d3["ids"] != pool_out["mixtral"][0].tolist():
            fail(f"phase 9b 3: {d3['pool']}, resident {resident}, ids "
                 f"equal to 9a: "
                 f"{d3['ids'] == pool_out['mixtral'][0].tolist()}")
        lines.append(f"  pager {ex}; resident after: "
                     f"{[(r['repo'], r['bytes']) for r in resident]}")
        d4 = ask("4 llama again", LLAMA_REPO)
        if d4["pool"]["temp"] != "cold" or d4["ids"] != d1["ids"]:
            fail(f"phase 9b 4: {d4['pool']}")
        d5 = ask("5 gpt2", REPO, revision=gpt2_sha,
                 ids=list(gpt2_b1[0]))
        if "pool" in d5 or d5["ids"] != list(gpt2_b1[1]):
            fail(f"phase 9b 5: {d5}")
        metrics = urllib.request.urlopen(daemon.url + "/v1/metrics",
                                         timeout=60).read().decode()
        status = json.loads(urllib.request.urlopen(
            daemon.url + "/v1/status", timeout=60).read())
        launches = {name: c["launches"] - counts0[name]["launches"]
                    for name, c in status["kernels"].items()}
        evictions = sum(float(ln.rsplit(" ", 1)[1]) for ln in
                        metrics.splitlines() if ln.startswith(
                            "zest_hbm_pool_evictions_total{"))
        if not ('zest_ttft_seconds_count{temp="cold"}' in metrics
                and 'zest_ttft_seconds_count{temp="hot"}' in metrics
                and evictions >= 1 and "hbm_pool" in status):
            fail(f"phase 9b: metrics/status: evictions {evictions}, "
                 f"{sorted(status)}")
    finally:
        daemon.stop()
    pool = status["hbm_pool"]
    print(f"phase 9b daemon ({card_label()}): 5 requests over HTTP (pool "
          f"watermark "
          f"{DAEMON_POOL:,} B); " + "; ".join(lines)
          + f"; pool evictions {pool['evictions']}, hits {pool['hits']}, "
          f"misses {pool['misses']}, gate_stall_s {pool['gate_stall_s']}; "
          f"kernel launches in the daemon over the five requests "
          f"{launches}; SIGTERM exit 0; phase wall "
          f"{time.monotonic() - wall0:.2f} s")
    shutil.rmtree(work / "c9")
    return launches


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
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.ops import blake3 as plain
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    # ── 1. build ──
    sass = build_all(work)

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
          f"(0-2049, every leaf count 1-128, the 32-leaf group edges), "
          f"plain and keyed, garbage-tolerant")
    bg4_phase(rng, dev)

    # ── 3. push (the kernel verifies every minted chunk) ──
    ckpt = work / "checkpoint"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(GPT2_CONFIG, indent=2))
    tensors = gpt2_checkpoint(args.seed, GPT2_CONFIG)
    n_params = sum(t.numel() for t in tensors.values())
    write_safetensors(ckpt / "model.safetensors", tensors)
    cfg_a = Config(hf_home=work / "a" / "hf", cache_dir=work / "a" / "zest")
    for c in (blake3_cuda.COUNTER, bg4_cuda.COUNTER, bg4_cuda.FUSED_COUNTER):
        c.reset()  # counts from here are the push path's
    pushed = push_checkpoint(cfg_a, REPO, ckpt, device="cuda", notify=False)
    push_launches = blake3_cuda.COUNTER.launches
    if push_launches < 1:
        fail("push never launched the BLAKE3 kernel")
    if blake3_cuda.COUNTER.rows != pushed.minted_chunks:
        fail(f"kernel hashed {blake3_cuda.COUNTER.rows} chunks, push minted "
             f"{pushed.minted_chunks}")
    print(f"phase 3 push: {n_params:,} params, {pushed.total_bytes:,} bytes "
          f"in {pushed.elapsed_s:.2f} s; {pushed.new_xorbs} xorbs, "
          f"{pushed.minted_chunks} chunks, kernel launches {push_launches}")

    publisher = PublisherServer(cfg_a).start()
    try:
        # ── 4. pull through node A's loopback publisher: the direct
        # streaming landing ──
        pulled, cfg_b, digest = pull_phase(work, publisher.url, cfg_a, ckpt,
                                           pushed, dev)
        tth_a = pulled.stats["time_to_hbm_s"]
        tfl_a = pulled.stats["time_to_first_layer_s"]

        # ── 4b. the same tensors as a three-shard checkpoint, tight ring ──
        sharded_launches = sharded_phase(work, publisher.url, cfg_a, tensors,
                                         digest, dev)
        tensors_b = revision_b(tensors, args.seed + 1)
        del tensors
        shutil.rmtree(work / "d")
        # ── 4c. phase 4's repo again: complete files stage from disk ──
        resume_phase(cfg_b, digest, dev)

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
            if len(batch) == 1:
                gpt2_b1 = (batch[0], out[0].tolist())  # for phase 9b
            print(f"phase 5 generate batch {len(batch)}: prefill 8 + "
                  f"{args.steps} steps in {dt:.3f} s, "
                  f"{len(batch) * args.steps / dt:.1f} tokens/s; equal to "
                  "CPU")
        del gen_cuda, gen_cpu  # node B's tree is the swap's base now

        # ── 5b. the revision hot-swap into phase 4's tree ──
        delta_launches = swap_phase(
            work, publisher.url, publisher, cfg_a, cfg_b, pulled,
            pushed.revision, tensors_b, prompts, args.steps,
            pulled.stats["time_to_hbm_s"], dev)
        del pulled, tensors_b  # free phase 4/5's trees
        shutil.rmtree(work / "b" / "hf")  # phase 8 seeds B's xorb cache
        torch.cuda.empty_cache()

        # ── 6. cooperative pull of revision A across in-process hosts:
        # the point-to-point exchange, then the collective over the wire
        # (6c) and through the device lane (6d) ──
        coop_launches = coop_phase(work, publisher.url, ckpt, pushed,
                                   cfg_a, digest, dev, pushed.revision,
                                   coop_collective=False)
        collective_launches = coop_phase(
            work, publisher.url, ckpt, pushed, cfg_a, digest, dev,
            pushed.revision, label="phase 6c", schedule="hypercube")
        lane_launches = coop_phase(
            work, publisher.url, ckpt, pushed, cfg_a, digest, dev,
            pushed.revision, label="phase 6d", schedule="hierarchical",
            collective_backend="jax", coop_topology=(0, 0, 1, 1))
        torch.cuda.empty_cache()  # phase 4's and 6's trees are gone

        # ── 10. the pod round over four slots on cuda:0 ──
        pod_launches = pod_phase(work, publisher.url, ckpt, pushed, cfg_a,
                                 digest, dev, pushed.revision)
        torch.cuda.empty_cache()

        # ── 7. Llama-3.2-1B: push → pull → cached, sampled decode ──
        llama_ref = llama_phase(work, publisher.url, cfg_a, args.seed,
                                args.steps, dev)

        # ── 8. the swarm: node B seeds, fresh nodes pull from it ──
        swarm_launches = swarm_phase(work, publisher.url, cfg_b, ckpt,
                                     pushed, digest, tth_a, tfl_a, dev)

        # ── 9. the serving pool in-process, then the daemon over HTTP ──
        pool_out = pool_phase(work, publisher.url, cfg_a, llama_ref,
                              args.seed, args.steps, dev)
        daemon_launches = daemon_phase(
            work, publisher.url, pool_out, llama_ref["prompts"][0], gpt2_b1,
            pushed.revision, args.steps)
    finally:
        publisher.close()
    receipt_timing(cfg_a, pushed, dev)

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
    max_err = max_abs_err(kernel_out, plain_out)
    if max_err:
        fail("kernel != plain at the push shapes")
    ms = cuda_ms(lambda: hasher.hash_device(words, lengths), 50)
    plain_ms = cuda_ms(lambda: plain.hash_words(
        words, lengths, hasher.key_words, hasher.base_flags), 3)
    nbytes, n_compressions = blake3_work(sizes)
    alu, fma = sass
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = op_ms(n_compressions * alu, n_compressions * fma)
    src_ms = (n_compressions * SOURCE_OPS_PER_COMPRESSION
              / INT32_OPS_PER_S * 1e3)
    print(f"blake3 kernel at push shapes: {len(batch)} chunks, cap "
          f"{words.shape[1] * 4} B, {int(sizes.sum()):,} bytes: {ms:.4f} ms "
          f"({sizes.sum() / ms / 1e6:.1f} GB/s of chunk bytes), plain "
          f"{plain_ms:.2f} ms, bound {max(byte_ms, ops_ms):.4f} ms "
          f"(bytes {byte_ms:.4f}: {nbytes:,} B; ops {ops_ms:.4f}: "
          f"{n_compressions:,} compressions x ({alu} ALU + {fma} FMA); "
          f"{src_ms:.4f} at the source's {SOURCE_OPS_PER_COMPRESSION} per "
          f"compression)")
    kernels = [{
        "name": "blake3_chunks",
        "route": "cuda",
        "source": "zest_tpu_torch/csrc/blake3.cu",
        "replaces": "zest_tpu/ops/blake3_pallas.py:332",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, ops_ms),
        "bound_by": "bytes" if byte_ms > ops_ms else "operations",
        "library_ms": None,
    }] + time_bg4(cfg_a, pushed, dev, sass)
    by_path = {"blake3_chunks": {"push": push_launches,
                                 "push_sharded": sharded_launches,
                                 "push_delta": delta_launches,
                                 "push_llama": llama_ref["launches"],
                                 "push_mixtral": pool_out["push_launches"],
                                 "serve": pool_out["launches"][
                                     "blake3_chunks"],
                                 "serve_daemon": daemon_launches[
                                     "blake3_chunks"],
                                 "coop": coop_launches["blake3_chunks"],
                                 "coop_collective": collective_launches[
                                     "blake3_chunks"],
                                 "coop_collective_lane": lane_launches[
                                     "blake3_chunks"],
                                 "pod": pod_launches["blake3_chunks"],
                                 "swarm": swarm_launches["blake3_chunks"]}}
    for k in kernels:
        paths = by_path.get(k["name"], {"coop": coop_launches[k["name"]],
                                        "coop_collective":
                                            collective_launches[k["name"]],
                                        "coop_collective_lane":
                                            lane_launches[k["name"]],
                                        "pod": pod_launches[k["name"]],
                                        "swarm": swarm_launches[k["name"]],
                                        "serve": pool_out["launches"][
                                            k["name"]],
                                        "serve_daemon": daemon_launches[
                                            k["name"]]})
        k["launches"] = sum(paths.values())
        k["launches_by_path"] = paths
    return {"kernels": kernels}


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
    card = card_label()
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
