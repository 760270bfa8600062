"""The scale benches: GB-scale pulls, delta pulls, cooperative and
collective exchanges, swarms, tenants, the serving pool, MTTR under
faults, and the fleet-scale topology model.

Every bench builds its checkpoint with :func:`llama_checkpoint_files`
(real Llama-8B tensor names and geometry — 4096 hidden, 14336 FFN, 8 KV
heads of 128, vocab 32000, bf16 — ``scale`` dividing every dimension)
and serves it from the loopback hub of ``bench_hub``, so nothing leaves
the host. Each returns a dict: its artifact, with the JAX package's keys
and, where it has them, its pass/fail ``gates``. Pulls land on
``device`` (``cuda`` unless the caller passes ``cpu``); a bench writes
no file unless it is given ``out_path``.

Stages of a pull (``transfer.pull.StageClock``): ``resolve`` (revision
and file list), ``cas_metadata`` (auth, reconstructions, headers),
``fetch`` (ranged xorb GETs, decompress, BLAKE3 verify, cache write),
``hbm_commit`` (verified cache to device tensors) and ``files`` (the
HF-cache files). ``files`` and ``hbm_commit`` overlap: each stage's time
is the union of its intervals, ``stages_busy`` its thread-seconds, and
``time_to_hbm_s`` the pull's own wall clock to the last tensor landed.

Between runs :func:`_settle_page_cache` syncs; with
``ZEST_BENCH_DROP_CACHES=1`` it also drops the clean page cache through
``/proc/sys/vm/drop_caches`` (root only; it falls back to the warm mode)
and the artifact records which mode it got.
"""

from __future__ import annotations

import gc
import json
import pathlib
import statistics
import tempfile
import time

import numpy as np

__all__ = ["llama_checkpoint_files", "mutate_tensors", "bench_gb_pull",
           "bench_coop_pull", "bench_collective_transports",
           "bench_delta_pull", "bench_swarm", "bench_mttr",
           "bench_tenants", "bench_fleet", "bench_serve_pool"]


def mutate_tensors(tensors: dict, fraction: float, seed: int = 1) -> None:
    """Flip ~``fraction`` of the checkpoint's bytes in place: the seeded
    "revision B" of a checkpoint. Seeded contiguous runs of a seeded
    subset of tensors (about four when the budget allows) are XORed with
    bytes in [1, 255], so every touched byte changes and the CDC damage
    stays proportional to the fraction. Takes torch tensors or numpy
    arrays; the same seed flips the same bytes as the JAX package's."""
    import torch

    def flat_bytes(t):
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        return t.reshape(-1).view(torch.uint8)

    total = sum(int(t.nbytes) for t in tensors.values())
    budget = max(1, int(total * fraction))
    rng = np.random.default_rng([int(seed), 0xDE17A])
    names = list(tensors)
    per = max(1, budget // 4)
    for k in rng.permutation(len(names)):
        if budget <= 0:
            break
        flat = flat_bytes(tensors[names[k]])
        take = min(flat.numel(), per, budget) or 1
        start = int(rng.integers(0, flat.numel() - take + 1))
        flat[start:start + take] ^= torch.from_numpy(
            rng.integers(1, 256, take, dtype=np.uint8))
        budget -= take


# Llama-8B geometry (Llama-3-8B's widths; the vocab cut so that the
# embedding does not dominate a checkpoint of a few layers).
_HIDDEN = 4096
_FFN = 14336
_HEAD_DIM = 128
_N_HEADS = 32
_N_KV = 8
_VOCAB = 32000
_BF16 = 2  # bytes a parameter


def _layer_bytes(hidden: int, ffn: int, kv_dim: int) -> int:
    return _BF16 * (
        2 * hidden * hidden      # q_proj, o_proj
        + 2 * hidden * kv_dim    # k_proj, v_proj
        + 3 * hidden * ffn       # gate, up, down
        + 2 * hidden             # the two RMSNorm weights
    )


def _edge_bytes(hidden: int, vocab: int) -> int:
    return _BF16 * (2 * vocab * hidden + hidden)  # embed, head, norm


_LAYER_BYTES = _layer_bytes(_HIDDEN, _FFN, _N_KV * _HEAD_DIM)
_EDGE_BYTES = _edge_bytes(_HIDDEN, _VOCAB)


def llama_layers(gb: float, scale: int = 1) -> int:
    """The layer count :func:`llama_checkpoint_files` gives ``gb``."""
    hidden, ffn = _HIDDEN // scale, _FFN // scale
    kv_dim = (_N_KV * _HEAD_DIM) // scale
    return max(1, int(np.ceil(
        (gb * 1e9 - _edge_bytes(hidden, _VOCAB // scale))
        / _layer_bytes(hidden, ffn, kv_dim))))


def llama_tensor_bytes(gb: float, scale: int = 1) -> int:
    """The tensor bytes (headers excluded) of that checkpoint."""
    hidden, ffn = _HIDDEN // scale, _FFN // scale
    kv_dim = (_N_KV * _HEAD_DIM) // scale
    return (_edge_bytes(hidden, _VOCAB // scale)
            + llama_layers(gb, scale) * _layer_bytes(hidden, ffn, kv_dim))


def llama_checkpoint_files(gb: float, seed: int = 0,
                           shard_bytes: int = 700 * 1024 * 1024,
                           scale: int = 1,
                           smooth: bool = False,
                           mutate_fraction: float | None = None,
                           mutate_seed: int = 1) -> dict[str, bytes]:
    """A synthetic Llama checkpoint of ~``gb`` GB as HF repo files
    ({path: bytes}): config.json and ``model-xxxxx-of-xxxxx.safetensors``
    shards of at most ``shard_bytes``, HF tensor names, bf16.

    The default weights are uniform random bit patterns (incompressible,
    the transfer's worst case); ``smooth`` draws N(0, 0.02) instead, the
    compressible shape of trained weights that BG4's byte planes exploit.
    ``scale`` divides every dimension (at scale 1 one layer is ~436 MB).
    ``mutate_fraction`` derives revision B of the same checkpoint (see
    :func:`mutate_tensors`, seeded by ``mutate_seed``). For a seed the
    bytes equal the JAX package's."""
    import torch

    from zest_tpu_torch.models.safetensors_io import write_safetensors

    hidden, ffn = _HIDDEN // scale, _FFN // scale
    vocab = _VOCAB // scale
    kv_dim = (_N_KV * _HEAD_DIM) // scale
    n_layer = llama_layers(gb, scale)
    rng = np.random.default_rng(seed)

    def t(*shape):
        n = int(np.prod(shape))
        if smooth:
            # float32 → bf16 rounds to nearest even, as ml_dtypes does.
            x = torch.from_numpy(
                rng.normal(0.0, 0.02, n).astype(np.float32))
            return x.to(torch.bfloat16).reshape(shape)
        return torch.from_numpy(rng.integers(
            0, 1 << 16, n, dtype=np.uint16)).view(torch.bfloat16).reshape(
                shape)

    tensors: dict = {"model.embed_tokens.weight": t(vocab, hidden)}
    for i in range(n_layer):
        p = f"model.layers.{i}"
        tensors[f"{p}.self_attn.q_proj.weight"] = t(hidden, hidden)
        tensors[f"{p}.self_attn.k_proj.weight"] = t(kv_dim, hidden)
        tensors[f"{p}.self_attn.v_proj.weight"] = t(kv_dim, hidden)
        tensors[f"{p}.self_attn.o_proj.weight"] = t(hidden, hidden)
        tensors[f"{p}.mlp.gate_proj.weight"] = t(ffn, hidden)
        tensors[f"{p}.mlp.up_proj.weight"] = t(ffn, hidden)
        tensors[f"{p}.mlp.down_proj.weight"] = t(hidden, ffn)
        tensors[f"{p}.input_layernorm.weight"] = t(hidden)
        tensors[f"{p}.post_attention_layernorm.weight"] = t(hidden)
    tensors["model.norm.weight"] = t(hidden)
    tensors["lm_head.weight"] = t(vocab, hidden)
    if mutate_fraction:
        mutate_tensors(tensors, mutate_fraction, seed=mutate_seed)

    config = {
        "model_type": "llama",
        "architectures": ["LlamaForCausalLM"],
        "hidden_size": hidden,
        "intermediate_size": ffn,
        "num_attention_heads": _N_HEADS // scale,
        "num_key_value_heads": max(1, _N_KV // min(scale, _N_KV)),
        "num_hidden_layers": n_layer,
        "vocab_size": vocab,
        "max_position_embeddings": 8192,
        "rms_norm_eps": 1e-5,
        "rope_theta": 500000.0,
        "torch_dtype": "bfloat16",
    }

    # Tensors into safetensors files of at most shard_bytes, in order.
    shards: list[dict] = [{}]
    size = 0
    for name, arr in tensors.items():
        if size and size + arr.nbytes > shard_bytes:
            shards.append({})
            size = 0
        shards[-1][name] = arr
        size += arr.nbytes

    files: dict[str, bytes] = {"config.json": json.dumps(config).encode()}
    n = len(shards)
    with tempfile.TemporaryDirectory() as tmp:
        for i, shard in enumerate(shards, 1):
            name = (f"model-{i:05d}-of-{n:05d}.safetensors"
                    if n > 1 else "model.safetensors")
            p = pathlib.Path(tmp) / "shard.safetensors"
            write_safetensors(p, shard)
            files[name] = p.read_bytes()
    return files


def _quiet(*_a, **_k) -> None:
    pass


def _settle_page_cache(drop: bool) -> str:
    """``sync()`` so the previous run's writeback drains outside the next
    timed window; with ``drop`` also empty the clean page cache (root
    only). Returns the mode reached: ``"cold"`` or ``"warm"``."""
    import os

    try:
        os.sync()
    except (AttributeError, OSError):
        pass
    if not drop:
        return "warm"
    try:
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("1")
        return "cold"
    except OSError:
        return "warm"


def bench_gb_pull(gb: float = 2.0, runs: int = 3,
                  chunks_per_xorb: int = 512, scale: int = 2,
                  budget_s: float | None = None,
                  drop_caches: bool | None = None,
                  device: str = "cuda") -> dict:
    """``runs`` cold pulls of a ~``gb`` GB checkpoint onto ``device``:
    per-stage medians and the relative spread of ``time_to_hbm_s``
    (above 0.20 the artifact says ``"stable": false``).

    The hub and the checkpoint are built once; every run gets fresh
    cache and HF dirs. An untimed warm-up pull goes first (a process's
    first pull pays one-off costs) unless the build took half the budget.
    ``budget_s`` bounds the whole bench: once one timed run has landed,
    the loop stops rather than overrun (``"runs"`` says how many ran);
    the checkpoint is never cut. ``scale=2`` keeps the byte total with
    real depth (~14 layers at 2 GB); the geometry is in the artifact.
    ``drop_caches`` (default ``ZEST_BENCH_DROP_CACHES=1``) asks for
    cold page-cache runs; ``"page_cache"`` records what they got."""
    import os

    from zest_tpu_torch.bench_hub import FixtureHub, FixtureRepo
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.transfer.pull import pull_model

    if drop_caches is None:
        drop_caches = os.environ.get("ZEST_BENCH_DROP_CACHES") == "1"

    t_bench0 = t0 = time.perf_counter()
    files = llama_checkpoint_files(gb, scale=scale)
    total = sum(len(b) for b in files.values())
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    repo = FixtureRepo("bench/llama-geometry", files,
                       chunks_per_xorb=chunks_per_xorb)
    t_encode = time.perf_counter() - t0
    n_xorbs = len(repo.xorbs)
    gc.collect()

    def over_budget(frac: float = 1.0) -> bool:
        return (budget_s is not None
                and time.perf_counter() - t_bench0 > budget_s * frac)

    warmup_runs = 0 if over_budget(0.5) else 1
    results = []
    page_cache_modes: list[str] = []
    with FixtureHub(repo) as hub:
        for run_i in range(runs + warmup_runs):
            if results and over_budget():
                break
            page_cache_modes.append(_settle_page_cache(drop_caches))
            with tempfile.TemporaryDirectory() as root:
                rootp = pathlib.Path(root)
                cfg = Config(hf_home=rootp / "hf",
                             cache_dir=rootp / "zest",
                             hf_token="hf_test", endpoint=hub.url)
                t0 = time.perf_counter()
                res = pull_model(cfg, "bench/llama-geometry",
                                 device=device, no_p2p=True, log=_quiet)
                wall = time.perf_counter() - t0
                hbm = res.stats.get("hbm") or {}
                if "error" in hbm:
                    raise RuntimeError(f"HBM commit failed: {hbm['error']}")
                is_warmup = run_i < warmup_runs
                if is_warmup and over_budget():
                    # The budget ran out during the warm-up: it becomes
                    # the one recorded run.
                    warmup_runs = 0
                    is_warmup = False
                if not is_warmup:
                    results.append({
                        "wall_s": wall,
                        "stages": res.stats.get("stages", {}),
                        "stages_busy": res.stats.get("stages_busy", {}),
                        "time_to_hbm_s": res.stats.get("time_to_hbm_s"),
                        "time_to_first_layer_s": res.stats.get(
                            "time_to_first_layer_s"),
                        "ring": hbm.get("ring"),
                        "files_hbm_span_s": res.stats.get(
                            "files_hbm_span_s"),
                        "files_after_hbm_s": res.stats.get(
                            "files_after_hbm_s"),
                        "lane_bytes": (res.stats.get("files_pipeline")
                                       or {}).get("lane_bytes"),
                        "hbm_gbps": hbm.get("gbps"),
                        "direct": hbm.get("direct"),
                    })
                res.params = None  # free the device before the next run
                del res
                gc.collect()

    # time_to_hbm is the pull's own clock to the last tensor landed; the
    # stage sum stands in only for a pull that never landed.
    hbm_stages = ("resolve", "cas_metadata", "fetch", "hbm_commit")
    hbm_times = [
        r["time_to_hbm_s"] if r.get("time_to_hbm_s") is not None
        else sum(r["stages"].get(s, 0.0) for s in hbm_stages)
        for r in results
    ]
    walls = [r["wall_s"] for r in results]
    med_hbm = statistics.median(hbm_times)
    spread = ((max(hbm_times) - min(hbm_times)) / med_hbm
              if med_hbm else 0.0)
    stage_names = sorted({k for r in results for k in r["stages"]})
    stages = {}
    for name in stage_names:
        vals = [r["stages"].get(name, 0.0) for r in results]
        busies = [r["stages_busy"].get(name, 0.0) for r in results]
        med = statistics.median(vals)
        # The median of the per-run rates, not the total over the median.
        rates = [total / v / 1e9 for v in vals if v > 0.05]
        stages[name] = {
            "s": round(med, 3),
            "busy_s": round(statistics.median(busies), 3),
            "gbps": round(statistics.median(rates), 3) if rates else None,
            "spread": round((max(vals) - min(vals)) / med, 3)
            if med > 0.05 else None,
        }
    # The overlap: busy(files) + busy(hbm_commit) above their joint span
    # means the two stages ran at once; overlap_s is what that saved.
    busy_sums, span_vals = [], []
    for r in results:
        fb = r["stages_busy"].get("files", 0.0)
        hb = r["stages_busy"].get("hbm_commit", 0.0)
        span = r.get("files_hbm_span_s")
        if span is None:
            span = (r["stages"].get("files", 0.0)
                    + r["stages"].get("hbm_commit", 0.0))
        busy_sums.append(fb + hb)
        span_vals.append(span)
    med_busy = statistics.median(busy_sums)
    med_span = statistics.median(span_vals)
    geom = ("llama-8B-shapes" if scale == 1
            else f"llama-8B-shapes/{scale}")
    after_vals = [r["files_after_hbm_s"] for r in results
                  if r.get("files_after_hbm_s") is not None]
    fl_vals = [r["time_to_first_layer_s"] for r in results
               if r.get("time_to_first_layer_s") is not None]
    rings = [r["ring"] for r in results if r.get("ring")]
    timed_modes = page_cache_modes[-len(results):]
    return {
        "checkpoint_gb": round(total / 1e9, 3),
        "geometry": f"{geom} bf16",
        "runs": len(results),
        "time_to_hbm_s": round(med_hbm, 3),
        "time_to_hbm_runs_s": [round(t, 3) for t in hbm_times],
        **({"time_to_first_layer_s": round(statistics.median(fl_vals), 3),
            "time_to_first_layer_runs_s": [round(t, 3) for t in fl_vals],
            "first_layer_ratio": round(
                statistics.median(fl_vals) / med_hbm, 3)
            if med_hbm else None,
            "ring": rings[-1]} if fl_vals else {}),
        "total_pull_s": round(statistics.median(walls), 3),
        # Files-stage wall after the tensors were resident: paid by the
        # whole pull, not by time_to_hbm_s.
        "files_after_hbm_s": round(statistics.median(after_vals), 3)
        if after_vals else None,
        "page_cache": ("cold" if timed_modes
                       and all(m == "cold" for m in timed_modes)
                       else "warm"),
        "pull_gbps": round(total / med_hbm / 1e9, 3),
        "spread": round(spread, 3),
        "stable": spread <= 0.20 and len(results) >= 2,
        "stages": stages,
        "overlap": {
            "files_hbm_busy_s": round(med_busy, 3),
            "files_hbm_span_s": round(med_span, 3),
            "overlap_s": round(max(0.0, med_busy - med_span), 3),
            "overlapped": med_busy > med_span + 0.05,
        },
        "hbm_gbps": statistics.median(
            [r["hbm_gbps"] for r in results if r["hbm_gbps"]] or [0]),
        "direct": all(r["direct"] for r in results),
        "xorbs": n_xorbs,
        "warmup_skipped": warmup_runs == 0,
        "fixture_gen_s": round(t_gen, 1),
        "fixture_encode_s": round(t_encode, 1),
    }


def bench_delta_pull(gb: float = 2.0, runs: int = 3,
                     chunks_per_xorb: int = 512, scale: int = 2,
                     mutate_fraction: float = 0.01,
                     budget_s: float | None = None,
                     device: str = "cuda") -> dict:
    """A delta pull against a cold pull. Each run pulls revision A cold
    (the baseline ``time_to_hbm_s``), then revision B (A with
    ``mutate_fraction`` of its bytes changed) into the same cache,
    hot-swapping the resident tree of A. Headlines: ``delta_bytes_ratio``
    (the fraction fetched over the network), ``time_to_swap_s`` against
    the cold median, and ``digest_identical`` (the swapped tree against a
    cold pull of B, checked once: it costs a third pull)."""
    from zest_tpu_torch.bench_hub import FixtureHub, FixtureRepo
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.loader import params_digest
    from zest_tpu_torch.transfer.pull import pull_model

    t_bench0 = time.perf_counter()
    files_a = llama_checkpoint_files(gb, scale=scale)
    files_b = llama_checkpoint_files(gb, scale=scale,
                                     mutate_fraction=mutate_fraction)
    total = sum(len(b) for b in files_b.values())
    repo = FixtureRepo("bench/delta-llama", files_a,
                       chunks_per_xorb=chunks_per_xorb)
    sha_a = repo.commit_sha
    sha_b = repo.add_revision(files_b)
    gc.collect()

    cold_s: list[float] = []
    swap_s: list[float] = []
    ratios: list[float] = []
    fetched: list[int] = []
    reused_tensors: list[int] = []
    digest_identical = None
    with FixtureHub(repo) as hub:
        for run_i in range(runs):
            if run_i and budget_s is not None \
                    and time.perf_counter() - t_bench0 > budget_s:
                break
            _settle_page_cache(False)
            with tempfile.TemporaryDirectory() as root:
                rootp = pathlib.Path(root)
                cfg = Config(hf_home=rootp / "hf",
                             cache_dir=rootp / "zest",
                             hf_token="hf_test", endpoint=hub.url)
                res_a = pull_model(cfg, "bench/delta-llama",
                                   revision=sha_a, device=device,
                                   no_p2p=True, log=_quiet)
                cold_s.append(res_a.stats["time_to_hbm_s"])
                _settle_page_cache(False)
                res_b = pull_model(cfg, "bench/delta-llama",
                                   revision=sha_b, device=device,
                                   no_p2p=True, base_params=res_a.params,
                                   base_revision=sha_a, log=_quiet)
                d = res_b.stats.get("delta") or {}
                swap_s.append(res_b.stats.get("time_to_swap_s")
                              or res_b.stats["time_to_hbm_s"])
                ratios.append(d.get("fetched_ratio",
                                    d.get("delta_bytes_ratio", 1.0)))
                fetched.append(d.get("fetched_bytes", 0))
                reused_tensors.append(
                    (d.get("tensors") or {}).get("reused", 0))
                if digest_identical is None:
                    dig_swap = params_digest(res_b.params)
                    with tempfile.TemporaryDirectory() as root2:
                        r2 = pathlib.Path(root2)
                        cfg2 = Config(hf_home=r2 / "hf",
                                      cache_dir=r2 / "zest",
                                      hf_token="hf_test",
                                      endpoint=hub.url)
                        res_cold = pull_model(cfg2, "bench/delta-llama",
                                              revision=sha_b,
                                              device=device, no_p2p=True,
                                              log=_quiet)
                        digest_identical = (
                            params_digest(res_cold.params) == dig_swap)
                        res_cold.params = None
                res_a.params = None
                res_b.params = None
                del res_a, res_b
                gc.collect()

    med_cold = statistics.median(cold_s)
    med_swap = statistics.median(swap_s)
    return {
        "checkpoint_gb": round(total / 1e9, 3),
        "mutate_fraction": mutate_fraction,
        "runs": len(swap_s),
        "cold_time_to_hbm_s": round(med_cold, 3),
        "time_to_swap_s": round(med_swap, 3),
        "time_to_swap_runs_s": [round(t, 3) for t in swap_s],
        "speedup_vs_cold": round(med_cold / med_swap, 2)
        if med_swap else None,
        "swap_ratio": round(med_swap / med_cold, 3) if med_cold else None,
        "delta_bytes_ratio": round(statistics.median(ratios), 4),
        "fetched_bytes": int(statistics.median(fetched)),
        "tensors_reused": int(statistics.median(reused_tensors)),
        "digest_identical": digest_identical,
    }


def bench_coop_pull(gb: float = 0.064, n_hosts: int = 8,
                    shaped_bps: int | None = None,
                    chunks_per_xorb: int = 16, scale: int = 8,
                    dcn_rtt_s: float = 0.0,
                    dcn_bps: int | None = None,
                    topology: str | None = None,
                    device: str = "cuda") -> dict:
    """A cooperative pull across ``n_hosts`` in-process hosts (own cache,
    bridge and DCN server each, on loopback) against every host pulling
    alone, then the collective against the point-to-point exchange.

    - ``baseline``: each host fetches every unit from the CDN;
    - ``coop``: each host fetches its ~1/N plan share, the collective
      exchange moves the rest as compressed frames; received whole xorbs
      are verified on ``device``;
    - ``exchange``: with each host's share warmed first (so the wall is
      the exchange's) the point-to-point exchange and the collective run
      the same redistribution over DCN servers shaped to ``dcn_bps`` and
      ``dcn_rtt_s`` a request window.

    ``shaped_bps`` paces the hub's CDN for all hosts together.
    ``topology`` (``ZEST_COOP_TOPOLOGY``'s grammar) classes the links
    ici or dcn: shaping then applies to cross-slice links only. The
    ``wire`` block holds the compressed bytes that crossed the exchange
    against their unpacked size."""
    import threading

    from zest_tpu_torch.bench_hub import FixtureHub, FixtureRepo
    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.config import Config, parse_topology
    from zest_tpu_torch.transfer.bridge import XetBridge
    from zest_tpu_torch.transfer.coop import CoopPlan, coop_round
    from zest_tpu_torch.transfer.dcn import DcnServer
    from zest_tpu_torch.transfer.federated import warm_units_parallel

    repo_id = "bench/coop-llama"
    files = llama_checkpoint_files(gb, scale=scale, smooth=True,
                                   shard_bytes=32 * 1024 * 1024)
    total = sum(len(b) for b in files.values())
    repo = FixtureRepo(repo_id, files, chunks_per_xorb=chunks_per_xorb)
    topo = parse_topology(topology) if topology else None

    def make_host(root: pathlib.Path, tag: str, i: int,
                  collective: bool = True):
        cfg = Config(hf_home=root / f"{tag}{i}/hf",
                     cache_dir=root / f"{tag}{i}/zest",
                     hf_token="hf_test", endpoint=hub.url, dcn_port=0,
                     coop_collective=collective, coop_topology=topo)
        bridge = XetBridge(cfg)
        bridge.authenticate(repo_id)
        recs = [bridge.get_reconstruction(e.xet_hash)
                for e in HubClient(cfg).list_files(repo_id) if e.is_xet]
        return bridge, recs

    out: dict = {
        "model_bytes": total,
        "hosts": n_hosts,
        "chunks_per_xorb": chunks_per_xorb,
        "cdn_bps": shaped_bps,
        "dcn_shaping": {"rtt_s": dcn_rtt_s, "bps": dcn_bps},
        "topology": topology,
    }
    errors: list[str] = []

    def coop_leg(rootp, tag, collective, prewarm):
        """One round over n_hosts: (wall, per-host walls, per-host
        stats). ``prewarm`` fetches each host's own share first."""
        hosts = [make_host(rootp, tag, i, collective=collective)
                 for i in range(n_hosts)]
        servers, addrs = [], {}
        for i, (bridge, _recs) in enumerate(hosts):
            s = DcnServer(bridge.cfg, bridge.cache, rate_bps=dcn_bps or 0,
                          window_rtt_s=dcn_rtt_s, shape_slices=topo,
                          shape_host=i)
            addrs[i] = ("127.0.0.1", s.start())
            servers.append(s)
        if prewarm:
            def warm(i):
                bridge, recs = hosts[i]
                plan = CoopPlan.build(recs, n_hosts)
                warm_units_parallel(bridge, recs, units=plan.for_host(i))
            ws = [threading.Thread(target=warm, args=(i,))
                  for i in range(n_hosts)]
            for t in ws:
                t.start()
            for t in ws:
                t.join()
        results: list[dict | None] = [None] * n_hosts
        walls = [0.0] * n_hosts

        def run(i):
            bridge, recs = hosts[i]
            t0 = time.perf_counter()
            try:
                results[i] = coop_round(bridge, recs, i, n_hosts, addrs,
                                        device=device, server=servers[i])
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(f"{tag} host {i}: {exc}")
            walls[i] = time.perf_counter() - t0

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_hosts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        for s in servers:
            s.shutdown()
        for b, _r in hosts:
            b.close()
        return wall, walls, results

    def summarize(wall, results):
        done = [r for r in results if r]
        ratios = sorted(r["peer_served_ratio"] for r in done) or [0.0]
        wire = sum(r["exchange"]["wire_bytes"] for r in done)
        unpacked = sum(r["exchange"]["unpacked_bytes"] for r in done)
        cx = [r.get("collective") for r in done if r.get("collective")]
        block = {
            "wall_s": round(wall, 3),
            "hosts_completed": len(done),
            "peer_served_ratio": ratios[len(ratios) // 2],
            "peer_served_ratio_min": ratios[0],
            "cdn_bytes": sum(
                r["fetch"]["tiers"].get("cdn", 0)
                + r["exchange"].get("fallback_tiers", {}).get("cdn", 0)
                for r in done),
            "fallbacks": sum(r["fallbacks"] for r in done),
            "plan_skew": done[0]["plan"]["skew"] if done else None,
            "wire": {
                "dcn_bytes": wire,
                "unpacked_bytes": unpacked,
                # Below 1.0: compressed frames crossed, not tensors.
                "compressed_ratio": round(wire / unpacked, 4)
                if unpacked else None,
            },
            "gbps_per_host": round(total / wall / 1e9, 4)
            if wall > 0 else None,
        }
        if cx:
            block["collective"] = {
                "schedule": cx[0]["schedule"],
                "phases": cx[0]["phases"],
                "windows": sum(c["windows"] for c in cx),
                "retry_windows": sum(c["retry_windows"] for c in cx),
                "unit_round_trips": sum(c["unit_round_trips"]
                                        for c in cx),
                "matrix_skew": cx[0]["matrix_skew"],
                "link_bytes": {
                    lk: sum(c["link_bytes"].get(lk, 0) for c in cx)
                    for lk in ("ici", "dcn")},
                "barrier_wait_s": round(
                    sum(c["barrier_wait_s"] for c in cx), 3),
                "aborts": sum(1 for c in cx if c.get("aborted")),
            }
        return block

    with FixtureHub(repo, throttle_bps=shaped_bps) as hub, \
            tempfile.TemporaryDirectory() as root:
        rootp = pathlib.Path(root)

        # Baseline: every host pulls everything from the CDN.
        hosts = [make_host(rootp, "base", i) for i in range(n_hosts)]
        walls = [0.0] * n_hosts

        def base_run(i):
            bridge, recs = hosts[i]
            t0 = time.perf_counter()
            try:
                warm_units_parallel(bridge, recs)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(f"baseline host {i}: {exc}")
            walls[i] = time.perf_counter() - t0

        t0 = time.perf_counter()
        threads = [threading.Thread(target=base_run, args=(i,))
                   for i in range(n_hosts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        base_wall = time.perf_counter() - t0
        out["baseline"] = {
            "wall_s": round(base_wall, 3),
            "per_host_wall_s": [round(w, 3) for w in walls],
            "cdn_bytes": sum(b.stats.bytes_from_cdn for b, _r in hosts),
            "gbps_per_host": round(total / base_wall / 1e9, 4),
        }
        for b, _r in hosts:
            b.close()

        coop_wall, _cw, coop_results = coop_leg(rootp, "coop",
                                                collective=True,
                                                prewarm=False)
        out["coop"] = summarize(coop_wall, coop_results)
        out["speedup"] = (round(base_wall / coop_wall, 2)
                          if coop_wall > 0 else None)

        # The exchange race: shares warmed, the DCN shaped.
        p2p_wall, p2p_walls, p2p_results = coop_leg(
            rootp, "xp2p", collective=False, prewarm=True)
        col_wall, col_walls, col_results = coop_leg(
            rootp, "xcol", collective=True, prewarm=True)
        out["exchange"] = {
            "p2p": summarize(p2p_wall, p2p_results),
            "collective": summarize(col_wall, col_results),
            "p2p_wall_s": round(p2p_wall, 3),
            "collective_wall_s": round(col_wall, 3),
            "p2p_host_wall_max_s": round(max(p2p_walls), 3),
            "collective_host_wall_max_s": round(max(col_walls), 3),
            "collective_speedup": round(p2p_wall / col_wall, 2)
            if col_wall > 0 else None,
        }
    if errors:
        out["errors"] = errors
    return out


def bench_collective_transports(mb: float = 24.0, n_hosts: int = 8,
                                chunks_per_xorb: int = 4,
                                dcn_bps: int = 1_000_000,
                                dcn_rtt_s: float = 0.004,
                                topology: str = "0,0,0,0,1,1,1,1",
                                preadv_repeats: int = 5,
                                device: str = "cuda") -> dict:
    """One redistribution over a two-slice exchange of ``n_hosts`` (each
    host's share warmed, so a leg's wall is the exchange; cross-slice
    links shaped to ``dcn_bps`` / ``dcn_rtt_s``, intra-slice ones not),
    three ways:

    - ``wire``: ``collective_backend="dcn"``, the pooled DCN channels,
      byte-exact;
    - ``split``: ``collective_backend="jax"`` over the registered
      loopback fabric: intra-slice phases take the device lane on
      ``device``, cross-slice ones the shaped wire; byte-exact;
    - ``lossy``: ``collective_lossy="dcn"``: cross-slice BG4 float
      payloads quantize to the ZQLS int8 tier and land in the staging
      overlay only, never the xorb cache.

    The payload is three float32 N(0, 1) shards and one incompressible
    blob. A byte-exact leg rebuilds every file on every host from that
    host's cache alone (no bridge, so nothing heals from the CDN). The
    ``preadv`` block reads the stored blob through ``CachedFileReader``
    with its preadv lane on and off (min of N walls, bytes compared)."""
    import hashlib
    import threading

    from zest_tpu_torch.bench_hub import FixtureHub, FixtureRepo
    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.config import Config, parse_topology
    from zest_tpu_torch.models.direct import CachedFileReader
    from zest_tpu_torch.transfer import lossy as lossy_mod
    from zest_tpu_torch.transfer import transport
    from zest_tpu_torch.transfer.bridge import XetBridge
    from zest_tpu_torch.transfer.coop import CoopPlan, coop_round
    from zest_tpu_torch.transfer.dcn import DcnServer
    from zest_tpu_torch.transfer.federated import warm_units_parallel

    repo_id = "bench/transport-split"
    rng = np.random.default_rng(20)
    shard_vals = max(1, int(mb * 1e6) // 3 // 4)
    files = {f"shard{i}.f32.bin":
             rng.standard_normal(shard_vals).astype("<f4").tobytes()
             for i in range(3)}
    files["blob.bin"] = rng.bytes(8 * 1024 * 1024)
    total = sum(len(b) for b in files.values())
    source_sha = {k: hashlib.sha256(v).hexdigest()
                  for k, v in files.items()}
    repo = FixtureRepo(repo_id, files, chunks_per_xorb=chunks_per_xorb)
    topo = parse_topology(topology)
    errors: list[str] = []

    out: dict = {
        "model_bytes": total,
        "hosts": n_hosts,
        "topology": topology,
        "chunks_per_xorb": chunks_per_xorb,
        "dcn_shaping": {"bps": dcn_bps, "rtt_s": dcn_rtt_s},
    }

    def make_host(hub, root: pathlib.Path, tag: str, i: int,
                  backend: str, lossy_tier: str):
        cfg = Config(hf_home=root / f"{tag}{i}/hf",
                     cache_dir=root / f"{tag}{i}/zest",
                     hf_token="hf_test", endpoint=hub.url, dcn_port=0,
                     coop_collective=True, coop_topology=topo,
                     collective_backend=backend,
                     collective_lossy=lossy_tier)
        bridge = XetBridge(cfg)
        bridge.authenticate(repo_id)
        recs = {e.path: bridge.get_reconstruction(e.xet_hash)
                for e in HubClient(cfg).list_files(repo_id) if e.is_xet}
        return bridge, recs

    def leg(hub, rootp: pathlib.Path, tag: str, backend: str,
            lossy_tier: str, fabric: bool) -> dict:
        transport.reset_loopback()
        hosts = [make_host(hub, rootp, tag, i, backend, lossy_tier)
                 for i in range(n_hosts)]
        servers, addrs = [], {}
        for i, (bridge, _recs) in enumerate(hosts):
            s = DcnServer(bridge.cfg, bridge.cache, rate_bps=dcn_bps,
                          window_rtt_s=dcn_rtt_s, shape_slices=topo,
                          shape_host=i)
            addrs[i] = ("127.0.0.1", s.start())
            servers.append(s)
        if fabric:
            for i, (bridge, _recs) in enumerate(hosts):
                transport.register_loopback(addrs[i], bridge.cfg,
                                            bridge.cache)

        def warm(i):
            bridge, recs = hosts[i]
            rl = list(recs.values())
            plan = CoopPlan.build(rl, n_hosts)
            warm_units_parallel(bridge, rl, units=plan.for_host(i))

        ws = [threading.Thread(target=warm, args=(i,))
              for i in range(n_hosts)]
        for t in ws:
            t.start()
        for t in ws:
            t.join()

        results: list[dict | None] = [None] * n_hosts
        walls = [0.0] * n_hosts

        def run(i):
            bridge, recs = hosts[i]
            t0 = time.perf_counter()
            try:
                results[i] = coop_round(bridge, list(recs.values()), i,
                                        n_hosts, addrs, device=device,
                                        server=servers[i])
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(f"{tag} host {i}: {exc}")
            walls[i] = time.perf_counter() - t0

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_hosts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0

        digest_ok = None
        if lossy_tier == "0":
            digest_ok = True
            for i, (bridge, recs) in enumerate(hosts):
                for path, rec in recs.items():
                    try:
                        reader = CachedFileReader(bridge.cache, rec)
                        sha = hashlib.sha256(
                            reader.read(0, reader.size)).hexdigest()
                    except Exception as exc:  # noqa: BLE001
                        digest_ok = False
                        errors.append(
                            f"{tag} host {i}: {path} unreadable: {exc}")
                        continue
                    if sha != source_sha[path]:
                        digest_ok = False
                        errors.append(
                            f"{tag} host {i}: digest mismatch on {path}")
        staged_units = sum(lossy_mod.staging_for(b.cfg.cache_dir).units()
                           for b, _r in hosts)
        staged_bytes = sum(
            lossy_mod.staging_for(b.cfg.cache_dir).total_bytes()
            for b, _r in hosts)
        for s in servers:
            s.shutdown()
        for b, _r in hosts:
            b.close()
        transport.reset_loopback()

        done = [r for r in results if r]
        ratios = sorted(r["peer_served_ratio"] for r in done) or [0.0]
        cx = [r.get("collective") for r in done if r.get("collective")]
        saved = [r["exchange"].get("bits_saved_ratio") for r in done
                 if r["exchange"].get("bits_saved_ratio") is not None]
        block = {
            "backend": backend,
            "lossy": lossy_tier,
            "wall_s": round(wall, 3),
            "host_wall_max_s": round(max(walls), 3),
            "hosts_completed": len(done),
            "peer_served_ratio": ratios[len(ratios) // 2],
            "peer_served_ratio_min": ratios[0],
            "fallbacks": sum(r["fallbacks"] for r in done),
            "aborts": sum(1 for c in cx if c.get("aborted")),
            "exchange": {
                "wire_bytes": sum(r["exchange"]["wire_bytes"]
                                  for r in done),
                "unpacked_bytes": sum(r["exchange"]["unpacked_bytes"]
                                      for r in done),
                "lossy_bytes": sum(r["exchange"].get("lossy_bytes", 0)
                                   for r in done),
                "bits_saved_ratio": (round(sorted(saved)[len(saved) // 2],
                                           4) if saved else None),
            },
            "link_bytes": {lk: sum(c["link_bytes"].get(lk, 0) for c in cx)
                           for lk in ("ici", "dcn")},
            "staging": {"units": staged_units, "bytes": staged_bytes},
        }
        if digest_ok is not None:
            block["digest_identical"] = digest_ok
        return block

    with FixtureHub(repo) as hub, tempfile.TemporaryDirectory() as root:
        rootp = pathlib.Path(root)
        wire = leg(hub, rootp, "wire", "dcn", "0", fabric=False)
        split = leg(hub, rootp, "split", "jax", "0", fabric=True)
        lossy = leg(hub, rootp, "lossy", "dcn", "dcn", fabric=False)

        # preadv: one warmed host reads the stored blob whole through
        # both lanes; a fresh reader each time, the first read untimed.
        pb, precs = make_host(hub, rootp, "pre", 0, "dcn", "0")
        warm_units_parallel(pb, list(precs.values()))
        blob_rec = precs["blob.bin"]

        def read_once(use_preadv: bool):
            r = CachedFileReader(pb.cache, blob_rec, use_preadv=use_preadv)
            t0 = time.perf_counter()
            data = r.read(0, r.size)
            return time.perf_counter() - t0, data, r.preadv_stats

        read_once(False)
        on_t, off_t = [], []
        identity = True
        stats_on = {"terms": 0, "bytes": 0, "syscalls": 0}
        for _ in range(preadv_repeats):
            dt, data, stats_on = read_once(True)
            on_t.append(dt)
            identity &= (hashlib.sha256(data).hexdigest()
                         == source_sha["blob.bin"])
            dt, data, _st = read_once(False)
            off_t.append(dt)
            identity &= (hashlib.sha256(data).hexdigest()
                         == source_sha["blob.bin"])
        pb.close()
        preadv = {
            "on_s": round(min(on_t), 5),
            "off_s": round(min(off_t), 5),
            "speedup": (round(min(off_t) / min(on_t), 3)
                        if min(on_t) > 0 else None),
            "terms": stats_on["terms"],
            "bytes": stats_on["bytes"],
            "syscalls": stats_on["syscalls"],
            "identity": identity,
        }
    lossy_mod.reset_stagings()

    out["legs"] = {"wire": wire, "split": split, "lossy": lossy}
    speedup = (round(wire["wall_s"] / lossy["wall_s"], 3)
               if lossy["wall_s"] > 0 else None)
    out["lossy"] = {
        "speedup_vs_wire": speedup,
        "lossy_bytes": lossy["exchange"]["lossy_bytes"],
        "bits_saved_ratio": lossy["exchange"]["bits_saved_ratio"],
        "peer_served_ratio_delta": round(
            abs(wire["peer_served_ratio"] - lossy["peer_served_ratio"]), 4),
        "staging_units": lossy["staging"]["units"],
    }
    out["preadv"] = preadv
    gates = {
        "digest_identical": bool(wire.get("digest_identical")
                                 and split.get("digest_identical")),
        "lossy_speedup_ge_1.2": bool(speedup and speedup >= 1.2),
        "lossy_bytes_positive": lossy["exchange"]["lossy_bytes"] > 0,
        "lossy_cache_untouched": lossy["staging"]["units"] > 0,
        "peer_served_ratio_equal":
            out["lossy"]["peer_served_ratio_delta"] <= 0.05,
        "no_aborts": (wire["aborts"] + split["aborts"]
                      + lossy["aborts"]) == 0,
        "no_fallbacks": (wire["fallbacks"] + split["fallbacks"]
                         + lossy["fallbacks"]) == 0,
        "split_used_ici_lane": split["link_bytes"]["ici"] > 0,
        "preadv_identity": preadv["identity"],
        "preadv_engaged": preadv["terms"] > 0,
    }
    gates["all_ok"] = all(gates.values()) and not errors
    out["gates"] = gates
    if errors:
        out["errors"] = errors
    return out


def _mismatched_bytes(got: bytes, want: bytes) -> int:
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def bench_swarm(gb: float = 0.064, m_pullers: int = 4, k_seeders: int = 4,
                fault_spec: str | None = None, fault_seed: int = 1337,
                shaped_bps: int | None = None,
                seed_rate_bps: int | None = None,
                seed_peer_bps: int | None = None,
                seed_slots: int | None = None,
                chunks_per_xorb: int = 16, scale: int = 8,
                device: str = "cuda") -> dict:
    """``m_pullers`` concurrent pulls against ``k_seeders`` always-on
    seeders under an injected ``ZEST_FAULTS`` matrix and shaped links.

    1. Warm (unshaped, unmeasured): each seeder pulls the checkpoint from
       the CDN once, files only.
    2. Measured: the CDN behind one ``shaped_bps`` bucket, each seeder
       serving through the upload policy (``seed_rate_bps``,
       ``seed_peer_bps``, ``seed_slots``), the faults armed, the pullers
       racing files-only pulls (``device`` is resolved, nothing lands)
       with every seeder a direct peer (the order rotated per puller).

    Reported: the swarm's ``peer_served_ratio``, p50/p99 pull wall, the
    upload skew (max/mean served bytes a seeder), the corrupt bytes
    admitted (every pulled file compared with its source: must be 0),
    corruption detections and the faults that fired."""
    import threading

    from zest_tpu_torch import faults
    from zest_tpu_torch.bench_hub import FixtureHub, FixtureRepo
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.p2p.health import PROVENANCE
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.server import BtServer
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    repo_id = "bench/swarm-llama"
    files = llama_checkpoint_files(gb, scale=scale, smooth=True,
                                   shard_bytes=16 * 1024 * 1024)
    total = sum(len(b) for b in files.values())
    repo = FixtureRepo(repo_id, files, chunks_per_xorb=chunks_per_xorb)

    out: dict = {
        "model_bytes": total,
        "pullers": m_pullers,
        "seeders": k_seeders,
        "cdn_bps": shaped_bps,
        "seed_rate_bps": seed_rate_bps,
        "seed_peer_bps": seed_peer_bps,
        "faults": fault_spec,
        "fault_seed": fault_seed if fault_spec else None,
    }
    with tempfile.TemporaryDirectory() as root:
        rootp = pathlib.Path(root)

        def seeder_cfg(i: int) -> Config:
            cfg = Config(hf_home=rootp / f"seed{i}/hf",
                         cache_dir=rootp / f"seed{i}/zest",
                         hf_token="hf_test", endpoint="unused",
                         listen_port=0)
            if seed_rate_bps:
                cfg.seed_rate_bps = seed_rate_bps
            if seed_peer_bps:
                cfg.seed_peer_bps = seed_peer_bps
            if seed_slots:
                cfg.seed_slots = seed_slots
            return cfg

        scfgs = [seeder_cfg(i) for i in range(k_seeders)]
        with FixtureHub(repo) as warm_hub:
            for cfg in scfgs:
                cfg.endpoint = warm_hub.url
                pull_model(cfg, repo_id, device=device, land=False,
                           no_p2p=True, log=_quiet)

        servers = [BtServer(cfg) for cfg in scfgs]
        ports = [s.start() for s in servers]
        PROVENANCE.reset()
        faults.install(fault_spec, fault_seed)
        walls: list[float] = [0.0] * m_pullers
        stats: list[dict | None] = [None] * m_pullers
        corrupt_admitted = [0] * m_pullers
        errors: list[str] = []

        try:
            with FixtureHub(repo, throttle_bps=shaped_bps) as hub:
                def pull_run(i: int) -> None:
                    cfg = Config(hf_home=rootp / f"pull{i}/hf",
                                 cache_dir=rootp / f"pull{i}/zest",
                                 hf_token="hf_test", endpoint=hub.url)
                    swarm = SwarmDownloader(cfg)
                    for j in range(k_seeders):
                        swarm.add_direct_peer("127.0.0.1",
                                              ports[(i + j) % k_seeders])
                    t0 = time.perf_counter()
                    try:
                        res = pull_model(cfg, repo_id, device=device,
                                         land=False, swarm=swarm,
                                         log=_quiet)
                        walls[i] = time.perf_counter() - t0
                        stats[i] = res.stats
                        for name, want in files.items():
                            got = (res.snapshot_dir / name).read_bytes()
                            if got != want:
                                corrupt_admitted[i] += _mismatched_bytes(
                                    got, want)
                    except Exception as exc:  # noqa: BLE001 - reported
                        errors.append(f"puller {i}: {exc}")
                    finally:
                        swarm.close()

                threads = [threading.Thread(target=pull_run, args=(i,))
                           for i in range(m_pullers)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                swarm_wall = time.perf_counter() - t0
            fired = faults.counters()
        finally:
            faults.install(None)
            for s in servers:
                s.shutdown()

        seeder_stats = [s.get_stats() for s in servers]
        seeder_bytes = [s.bytes_served for s in seeder_stats]
        done = [s for s in stats if s]
        peer = sum(s["fetch"]["bytes"].get("peer", 0) for s in done)
        cdn = sum(s["fetch"]["bytes"].get("cdn", 0) for s in done)
        ok_walls = sorted(w for w, s in zip(walls, stats) if s)
        mean_served = (sum(seeder_bytes) / len(seeder_bytes)
                       if seeder_bytes else 0)
        out.update({
            "swarm_wall_s": round(swarm_wall, 3),
            "pulls_completed": len(done),
            "peer_served_ratio": (round(peer / (peer + cdn), 4)
                                  if peer + cdn else None),
            "pull_latency_s": {
                "p50": round(ok_walls[len(ok_walls) // 2], 3)
                if ok_walls else None,
                "p99": round(ok_walls[min(len(ok_walls) - 1,
                                          int(len(ok_walls) * 0.99))], 3)
                if ok_walls else None,
            },
            "upload_fairness": {
                "per_seeder_bytes": seeder_bytes,
                "skew": (round(max(seeder_bytes) / mean_served, 3)
                         if mean_served else None),
            },
            "corrupt_bytes_admitted": sum(corrupt_admitted),
            # The swarm's counter alone: the bridge counts the same events.
            "corrupt_detected": sum(
                s.get("swarm", {}).get("corrupt_from_peer", 0)
                for s in done),
            "choke_events": sum(s.choke_events for s in seeder_stats),
            "uploads_expired": sum(s.uploads_expired
                                   for s in seeder_stats),
            "refused_quarantined": sum(s.refused_quarantined
                                       for s in seeder_stats),
            "faults_fired": dict(sorted(fired.items())),
        })
        if seed_rate_bps and ok_walls:
            out["upload_fairness"]["observed_bps"] = [
                round(b / swarm_wall) for b in seeder_bytes]
        if errors:
            out["errors"] = errors
    return out


def bench_mttr(gb: float = 0.02, runs: int = 2,
               chunks_per_xorb: int = 8, scale: int = 8,
               window_s: float = 0.6, hz: float = 20.0,
               stall_s: float = 6.0,
               corrupt_seed_bps: int = 1_000_000,
               dcn_chunks_per_xorb: int = 32,
               fault_seed: int = 1337,
               dcn_fault_seed: int = 9,
               device: str = "cuda") -> dict:
    """Detection-to-recovery time under injected faults with the
    remediation engine on, against the same faults ridden out with it off
    (``ZEST_REMEDIATE=0``: the same detector, no actions). Each fault
    class runs both arms over ``runs`` cold files-only pulls (``device``
    resolved, nothing lands):

    - ``seeder_stall``: every seeder stalls ``stall_s`` an upload, below
      the io timeout; the policy's stall anomaly arms the hedge, so later
      waves race the CDN;
    - ``seeder_choke_flap``: spurious chokes (reported, not gated: the
      waterfall already falls through at full speed);
    - ``cdn_503``: origin 5xx bursts on a pull with no peers (reported:
      retries are the remedy in both arms);
    - ``upload_corrupt``: the one seeder serves flipped bytes with
      ``ZEST_PEER_STRIKES=99``, so the hands-off registry never
      quarantines it; the policy demotes it on strike evidence;
    - ``dcn_reset``: a two-host collective round (receipts verified on
      ``device``) whose partner owns half the plan with an empty cache,
      the channel reset a few rounds in; ``ZEST_REMEDIATE_PATIENCE=1``
      aborts at the first straggler;
    - ``control``: a healthy swarm: the policy arm must execute nothing.

    MTTR is the last byte's time minus the detection time: the first
    ``anomaly`` event, else the first ``fault_fired`` event. ``gates``:
    three classes or more at half the hands-off MTTR or less, no corrupt
    byte admitted, every fault fired in the hands-off arm, every executed
    action with before/after series, the control clean."""
    import contextlib
    import os

    from zest_tpu_torch import faults, telemetry
    from zest_tpu_torch.bench_hub import FixtureHub, FixtureRepo
    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.p2p.health import PROVENANCE
    from zest_tpu_torch.telemetry import recorder
    from zest_tpu_torch.telemetry import remediate as remediate_mod
    from zest_tpu_torch.telemetry import timeline as timeline_mod
    from zest_tpu_torch.transfer import bridge as bridge_mod
    from zest_tpu_torch.transfer.bridge import XetBridge
    from zest_tpu_torch.transfer.coop import coop_round
    from zest_tpu_torch.transfer.dcn import DcnServer
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.server import BtServer
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    # The armed hedge's peer head start stays under the anomaly window,
    # so the evidence pause neither re-arms the stall nor dominates the
    # policy arm's cost.
    saved_wait = bridge_mod._HEDGE_EVIDENCE_WAIT_S
    bridge_mod._HEDGE_EVIDENCE_WAIT_S = min(saved_wait, window_s / 2.0)
    files = llama_checkpoint_files(gb, scale=scale, smooth=True,
                                   shard_bytes=8 * 1024 * 1024)
    total = sum(len(b) for b in files.values())

    @contextlib.contextmanager
    def _env(overlay: dict[str, str]):
        saved = {k: os.environ.get(k) for k in overlay}
        os.environ.update(overlay)
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def _measure(fault_spec, seed, extra_env, policy_on, run_fn):
        """One arm of one run. The environment is set before reset_all,
        so the rebuilt store and engine read it; the injector is
        installed per run, so both arms see the same trial sequence."""
        overlay = {
            "ZEST_TIMELINE_HZ": str(hz),
            "ZEST_ANOMALY_WINDOW_S": str(window_s),
            "ZEST_REMEDIATE": "1" if policy_on else "0",
            **(extra_env or {}),
        }
        with _env(overlay):
            telemetry.reset_all()
            faults.install(fault_spec, seed)
            try:
                t0 = time.time()
                extra = run_fn()
                t1 = time.time()
                fired = dict(faults.counters())
            finally:
                faults.install(None)
            events = recorder.tail()
        anomaly_ts = [e["t"] for e in events if e.get("kind") == "anomaly"]
        fault_ts = [e["t"] for e in events
                    if e.get("kind") == "fault_fired"]
        rems = [e for e in events if e.get("kind") == "remediation"]
        detect = (min(anomaly_ts) if anomaly_ts
                  else min(fault_ts) if fault_ts else t0)
        return {
            "wall_s": t1 - t0,
            "mttr_s": max(0.0, t1 - detect),
            "detect_lag_s": max(0.0, detect - t0),
            "detected": bool(anomaly_ts),
            "faults_fired": fired,
            "remediations": [
                {"action": e.get("action"),
                 "outcome": e.get("outcome"),
                 "has_series": isinstance(e.get("before"), dict)
                 and isinstance(e.get("after"), dict)}
                for e in rems],
            **extra,
        }

    def swarm_case(name, spec, k_seeders, extra_env=None, seed_bps=None,
                   seed=fault_seed, no_p2p=False, cfg_overrides=None):
        """K seeders warmed once (no faults), then both arms × runs of one
        cold pull against them and the hub."""
        repo_id = f"bench/mttr-{name}"
        repo = FixtureRepo(repo_id, dict(files),
                           chunks_per_xorb=chunks_per_xorb)
        with tempfile.TemporaryDirectory() as root:
            rootp = pathlib.Path(root)
            scfgs = []
            for i in range(k_seeders):
                cfg = Config(hf_home=rootp / f"seed{i}/hf",
                             cache_dir=rootp / f"seed{i}/zest",
                             hf_token="hf_test", endpoint="unused",
                             listen_port=0)
                if seed_bps:
                    cfg.seed_rate_bps = seed_bps
                scfgs.append(cfg)
            with FixtureHub(repo) as warm_hub:
                for cfg in scfgs:
                    cfg.endpoint = warm_hub.url
                    pull_model(cfg, repo_id, device=device, land=False,
                               no_p2p=True, log=_quiet)
            servers = [BtServer(cfg) for cfg in scfgs]
            ports = [s.start() for s in servers]
            try:
                with FixtureHub(repo) as hub:
                    def one_pull(tag):
                        PROVENANCE.reset()
                        cfg = Config(hf_home=rootp / f"{tag}/hf",
                                     cache_dir=rootp / f"{tag}/zest",
                                     hf_token="hf_test", endpoint=hub.url)
                        for k, v in (cfg_overrides or {}).items():
                            setattr(cfg, k, v)
                        swarm = None
                        if not no_p2p:
                            swarm = SwarmDownloader(cfg)
                            for p in ports:
                                swarm.add_direct_peer("127.0.0.1", p)
                        try:
                            res = pull_model(cfg, repo_id, device=device,
                                             land=False, swarm=swarm,
                                             no_p2p=no_p2p, log=_quiet)
                            bad = 0
                            for fname, want in files.items():
                                got = (res.snapshot_dir
                                       / fname).read_bytes()
                                if got != want:
                                    bad += _mismatched_bytes(got, want)
                            fb = res.stats["fetch"]["bytes"]
                            return {"corrupt_bytes_admitted": bad,
                                    "peer_bytes": fb.get("peer", 0),
                                    "cdn_bytes": fb.get("cdn", 0)}
                        finally:
                            if swarm is not None:
                                swarm.close()

                    arms = {}
                    for arm, on in (("hands_off", False),
                                    ("policy_on", True)):
                        arms[arm] = [
                            _measure(spec, seed, extra_env, on,
                                     lambda r=r, a=arm: one_pull(f"{a}{r}"))
                            for r in range(runs)]
                    return arms
            finally:
                for s in servers:
                    s.shutdown()

    def coop_case(spec, seed, extra_env):
        """A two-host collective round whose host 1 serves an empty cache,
        so host 0's round ends by the abort policy."""
        repo_id = "bench/mttr-dcn_reset"
        repo = FixtureRepo(repo_id, dict(files),
                           chunks_per_xorb=dcn_chunks_per_xorb)
        with FixtureHub(repo) as hub, \
                tempfile.TemporaryDirectory() as root:
            rootp = pathlib.Path(root)

            def one_round(tag):
                def mk(i):
                    cfg = Config(hf_home=rootp / f"{tag}h{i}/hf",
                                 cache_dir=rootp / f"{tag}h{i}/zest",
                                 hf_token="hf_test", endpoint=hub.url,
                                 dcn_port=0, coop_collective=True)
                    b = XetBridge(cfg)
                    b.authenticate(repo_id)
                    return b
                b0, b1 = mk(0), mk(1)
                s1 = DcnServer(b1.cfg, b1.cache)
                port1 = s1.start()
                try:
                    recs = [b0.get_reconstruction(e.xet_hash)
                            for e in HubClient(b0.cfg).list_files(repo_id)
                            if e.is_xet]
                    # A bare round has no pull to start the observer: the
                    # sampler in both arms, the engine when it is on.
                    timeline_mod.ensure_started()
                    remediate_mod.ensure_started()
                    coop_round(b0, recs, 0, 2, {1: ("127.0.0.1", port1)},
                               device=device)
                    bad = 0
                    out_f = rootp / f"{tag}.check"
                    for e in HubClient(b0.cfg).list_files(repo_id):
                        if not e.is_xet:
                            continue
                        b0.reconstruct_to_file(e.xet_hash, out_f)
                        got = out_f.read_bytes()
                        want = files[e.path]
                        if got != want:
                            bad += _mismatched_bytes(got, want)
                    st = b0.stats
                    return {"corrupt_bytes_admitted": bad,
                            "peer_bytes": getattr(st, "bytes_from_peer", 0),
                            "cdn_bytes": getattr(st, "bytes_from_cdn", 0)}
                finally:
                    s1.shutdown()
                    b0.close()
                    b1.close()

            arms = {}
            for arm, on in (("hands_off", False), ("policy_on", True)):
                arms[arm] = [
                    _measure(spec, seed, extra_env, on,
                             lambda r=r, a=arm: one_round(f"{a}{r}"))
                    for r in range(runs)]
            return arms

    def _agg(rs):
        ms = sorted(r["mttr_s"] for r in rs)
        peer = sum(r.get("peer_bytes", 0) for r in rs)
        cdn = sum(r.get("cdn_bytes", 0) for r in rs)
        fired: dict[str, int] = {}
        for r in rs:
            for k, v in r["faults_fired"].items():
                fired[k] = fired.get(k, 0) + v
        actions: dict[str, int] = {}
        series_ok = True
        for r in rs:
            for e in r["remediations"]:
                k = f'{e["action"]}:{e["outcome"]}'
                actions[k] = actions.get(k, 0) + 1
                if not e["has_series"]:
                    series_ok = False
        return {
            "runs": len(rs),
            "mttr_s": {"p50": round(ms[len(ms) // 2], 3),
                       "p99": round(ms[-1], 3)},
            "detect_lag_s": round(
                sorted(r["detect_lag_s"] for r in rs)[len(rs) // 2], 3),
            "detected_runs": sum(1 for r in rs if r["detected"]),
            "wall_s": round(sorted(r["wall_s"] for r in rs)[len(rs) // 2],
                            3),
            "peer_served_ratio": (round(peer / (peer + cdn), 4)
                                  if peer + cdn else None),
            "corrupt_bytes_admitted": sum(r["corrupt_bytes_admitted"]
                                          for r in rs),
            "faults_fired": fired,
            "actions": dict(sorted(actions.items())),
            "remediations_have_series": series_ok,
        }

    cases = [
        # A narrow pipe: the unhedged first wave costs one stall a slot.
        ("seeder_stall", {"kind": "swarm",
                          "spec": f"seeder_stall:1.0@{stall_s}",
                          "cfg_overrides": {"max_concurrent_downloads": 4},
                          "k": 2}),
        ("seeder_choke_flap", {"kind": "swarm",
                               "spec": "seeder_choke_flap:0.6", "k": 2}),
        ("cdn_503", {"kind": "swarm", "spec": "cdn_503:0.3", "k": 0,
                     "no_p2p": True}),
        # A narrow pipe: wide concurrency would hide the shaped seeder
        # behind the loopback CDN.
        ("upload_corrupt", {"kind": "swarm", "spec": "upload_corrupt:1.0",
                            "k": 1, "seed_bps": corrupt_seed_bps,
                            "cfg_overrides":
                                {"max_concurrent_downloads": 4},
                            "env": {"ZEST_PEER_STRIKES": "99"}}),
        ("dcn_reset", {"kind": "coop", "spec": "dcn_reset:0.05",
                       "seed": dcn_fault_seed,
                       "env": {"ZEST_REMEDIATE_PATIENCE": "1"}}),
        ("control", {"kind": "swarm", "spec": None, "k": 2}),
    ]
    out: dict = {"model_bytes": total, "runs": runs, "window_s": window_s,
                 "hz": hz, "cases": {}}
    try:
        for name, c in cases:
            if c["kind"] == "coop":
                arms = coop_case(c["spec"], c.get("seed", fault_seed),
                                 c.get("env"))
            else:
                arms = swarm_case(name, c["spec"], c["k"],
                                  extra_env=c.get("env"),
                                  seed_bps=c.get("seed_bps"),
                                  seed=c.get("seed", fault_seed),
                                  no_p2p=c.get("no_p2p", False),
                                  cfg_overrides=c.get("cfg_overrides"))
            ho, po = _agg(arms["hands_off"]), _agg(arms["policy_on"])
            ratio = (round(po["mttr_s"]["p50"] / ho["mttr_s"]["p50"], 3)
                     if ho["mttr_s"]["p50"] > 0 else None)
            out["cases"][name] = {
                "fault_spec": c["spec"],
                "hands_off": ho,
                "policy_on": po,
                "mttr_ratio": ratio,
                "win": bool(name != "control" and ratio is not None
                            and ratio <= 0.5),
            }
    finally:
        bridge_mod._HEDGE_EVIDENCE_WAIT_S = saved_wait
        telemetry.reset_all()  # the default store and engine again

    fault_cases = [n for n, _ in cases if n != "control"]
    wins = [n for n in fault_cases if out["cases"][n]["win"]]
    corrupt = sum(out["cases"][n][arm]["corrupt_bytes_admitted"]
                  for n, _ in cases for arm in ("hands_off", "policy_on"))
    ctl = out["cases"]["control"]
    ctl_exec = sum(v for k, v in ctl["policy_on"]["actions"].items()
                   if k.endswith(":success") or k.endswith(":failed"))
    out["gates"] = {
        "classes_at_half": wins,
        "classes_at_half_ok": len(wins) >= 3,
        "corrupt_bytes_admitted": corrupt,
        "all_faults_fired": all(
            out["cases"][n]["hands_off"]["faults_fired"].get(n, 0) > 0
            for n in fault_cases),
        "remediations_have_series": all(
            out["cases"][n]["policy_on"]["remediations_have_series"]
            for n in fault_cases),
        "control_actions_executed": ctl_exec,
        "peer_ratio_ok": (
            (ctl["policy_on"]["peer_served_ratio"] or 0.0)
            >= (ctl["hands_off"]["peer_served_ratio"] or 0.0) - 0.05),
    }
    return out


def bench_fleet(fleet_sizes: tuple[int, ...] = (256, 512, 1024),
                pod_size: int = 64, model_gb: float = 8.0,
                n_units: int = 4096,
                ici_bps: float = 12.5e9, dcn_bps: float = 3.1e9,
                pod_wan_bps: float = 625e6, cdn_bps: float = 1.25e9,
                ici_rtt_s: float = 0.0001, dcn_rtt_s: float = 0.001,
                wan_rtt_s: float = 0.05, cdn_rtt_s: float = 0.08,
                hbm_bps: float = 50e9,
                gossip_keys: int = 64,
                out_path: str | None = None) -> dict:
    """A fleet-scale topology model: ``fleet_sizes`` hosts in
    ``pod_size``-host pods over a three-level link matrix (ICI < DCN <
    WAN < CDN). The decisions are the real components' — ``CoopPlan``
    over synthetic units, ``CollectiveSchedule`` (the flat hypercube
    against the federated three-stage schedule, gateways from
    ``elect_gateways``) and live ``GossipNode``s on a ``LoopbackMesh`` —
    and only the clock is modelled. Nothing here touches a device.

    The clock: a pull phase of host ``h`` from partner ``p`` ends at
    ``max(t[h], t[p]) + rtt + bytes / bps`` of the link their physical
    placement gives (for the flat schedule too, which does not know about
    pods). A pod's WAN uplink is shared by its hosts: inbound WAN bytes
    over its rate are a floor on the pod's completion. The CDN is one
    shared origin: the 1/N plan fetch takes ``model_bytes / cdn_bps``.

    Per fleet size: the peer-served ratio, CDN egress per host, p99 time
    to HBM of both schedules and their ratio, WAN bytes a pod, gossip
    convergence (sweeps to full coverage against ``2·ceil(log2 N)``,
    digest memory against its cap) and a cold pod's join (every
    warm-held xorb routed to the nearest warm pod over WAN, none to the
    CDN). The pass/fail criteria are under ``gates``."""
    import math

    from zest_tpu_torch.cas.reconstruction import ChunkRange, FetchInfo
    from zest_tpu_torch.transfer.collective import (CollectiveSchedule,
                                                    elect_gateways)
    from zest_tpu_torch.transfer.coop import CoopPlan
    from zest_tpu_torch.transfer.gossip import (DEFAULT_MAX_ENTRIES,
                                                GossipNode, LoopbackMesh)

    model_bytes = int(model_gb * 1e9)
    unit_bytes = model_bytes // n_units

    def phys(a: int, b: int, topo, pods) -> tuple[str, float, float]:
        """(link class, rtt, bps a flow) from the physical placement."""
        if pods[a] != pods[b]:
            return "wan", wan_rtt_s, pod_wan_bps
        if topo[a] != topo[b]:
            return "dcn", dcn_rtt_s, dcn_bps
        return "ici", ici_rtt_s, ici_bps

    def walk(scheds: dict, t0: float, bb: dict, topo, pods,
             gateways=None):
        """Every host's schedule relaxed in order. The hypercube and the
        federated stages A and B are pairwise lockstep (a partner's
        partner is the host); stage C is a binomial tree walked in
        broadcast order. Returns (completion per host, WAN bytes into
        each pod, bytes per link class)."""
        t = {h: t0 for h in scheds}
        wan_in: dict[int, int] = {}
        link_bytes = {"ici": 0, "dcn": 0, "wan": 0}

        def step(h: int, ph, prev, count_wan: bool = True) -> None:
            nbytes = sum(bb[o] for o in ph.owners)
            link, rtt, bps = phys(h, ph.partner, topo, pods)
            link_bytes[link] += nbytes
            if count_wan and link == "wan":
                wan_in[pods[h]] = wan_in.get(pods[h], 0) + nbytes
            t[h] = max(prev[h], prev[ph.partner]) + rtt + nbytes / bps

        kinds = {s.kind for s in scheds.values()}
        if kinds == {"hypercube"}:
            for k in range(len(next(iter(scheds.values())).phases)):
                prev = dict(t)
                for h, s in scheds.items():
                    step(h, s.phases[k], prev)
        elif kinds == {"federated"}:
            pod_ids = sorted({pods[h] for h in scheds})
            members = {p: sorted(h for h in scheds if pods[h] == p)
                       for p in pod_ids}
            k_a = max(0, len(members[pod_ids[0]]).bit_length() - 1)
            k_b = max(0, len(pod_ids).bit_length() - 1)
            # Stage A: lockstep within each pod.
            for k in range(k_a):
                prev = dict(t)
                for h, s in scheds.items():
                    step(h, s.phases[k], prev, count_wan=False)
            # Stage B: lockstep over the gateways.
            for k in range(k_b):
                prev = dict(t)
                for gw in gateways.values():
                    step(gw, scheds[gw].phases[k_a + k], prev)
            # Stage C: the broadcast, parents first (the gateway-first
            # member order is the broadcast order).
            for p in pod_ids:
                gw = gateways[p]
                for h in [m for m in members[p] if m != gw]:
                    step(h, scheds[h].phases[k_a], t)
        else:
            raise ValueError(f"unexpected schedule kinds {kinds}")
        return t, wan_in, link_bytes

    out: dict = {
        "bench": "fleet",
        "pod_size": pod_size,
        "model_bytes": model_bytes,
        "units": n_units,
        "links": {
            "ici": {"bps": ici_bps, "rtt_s": ici_rtt_s},
            "dcn": {"bps": dcn_bps, "rtt_s": dcn_rtt_s},
            "wan": {"bps": pod_wan_bps, "rtt_s": wan_rtt_s,
                    "shared": "per-pod uplink"},
            "cdn": {"bps": cdn_bps, "rtt_s": cdn_rtt_s,
                    "shared": "one origin"},
        },
        "fleets": {},
    }
    fleets = out["fleets"]

    for n in fleet_sizes:
        n_pods = n // pod_size
        pods = tuple(h // pod_size for h in range(n))
        # Two ICI slices a pod: the full three-level matrix.
        topo = tuple(2 * (h // pod_size) + (h % pod_size >= pod_size // 2)
                     for h in range(n))
        units = [(f"{i:08x}",
                  FetchInfo(url=f"sim://u{i}", url_range_start=0,
                            url_range_end=unit_bytes,
                            range=ChunkRange(0, 1)))
                 for i in range(n_units)]
        plan = CoopPlan.build([], n, units=units)
        bb = plan.bytes_per_host()
        gateways = elect_gateways(plan, pods)

        # Stage 1: the 1/N fetch from the one shared origin.
        fetch_wall = model_bytes / cdn_bps + cdn_rtt_s

        # Stage 2: the pod-blind hypercube against the federated one.
        flat = {h: CollectiveSchedule.build(plan, h, (0,) * n)
                for h in plan.alive}
        fed = {h: CollectiveSchedule.build(plan, h, topo, pods=pods)
               for h in plan.alive}
        results = {}
        for tag, scheds in (("flat", flat), ("federated", fed)):
            t, wan_in, link_bytes = walk(
                scheds, fetch_wall, bb, topo, pods,
                gateways=gateways if tag == "federated" else None)
            floor = {p: fetch_wall + b / pod_wan_bps
                     for p, b in wan_in.items()}
            done = sorted(max(t[h], floor.get(pods[h], 0.0))
                          + model_bytes / hbm_bps for h in plan.alive)
            results[tag] = {
                "schedule": next(iter(scheds.values())).kind,
                "phases_max": max(len(s.phases) for s in scheds.values()),
                "p50_time_to_hbm_s": round(done[len(done) // 2], 3),
                "p99_time_to_hbm_s": round(
                    done[min(n - 1, int(0.99 * (n - 1)))], 3),
                "wan_bytes_total": sum(wan_in.values()),
                "wan_bytes_per_pod_max": max(wan_in.values(), default=0),
                "link_bytes": link_bytes,
            }
        speedup = (results["flat"]["p99_time_to_hbm_s"]
                   / results["federated"]["p99_time_to_hbm_s"])

        # Stage 3: the gossip spread (the clock here is sweeps).
        book = {h: ("sim", 7000 + h) for h in range(n)}
        mesh = LoopbackMesh()
        nodes = [GossipNode(h, n, book, topology=topo, pods=pods)
                 for h in range(n)]
        for node in nodes:
            mesh.register(node)
        # Key j announced by one host, pods round-robin: a sparse index.
        keys = [bytes.fromhex(f"{j:064x}") for j in range(gossip_keys)]
        for j in range(gossip_keys):
            holder = (j % n_pods) * pod_size + (j // n_pods) % pod_size
            nodes[holder].announce(keys[j], 6881)
        bound = 2 * math.ceil(math.log2(n))
        sweeps = 0
        while sweeps < bound:
            sweeps += 1
            for node in nodes:
                node.tick(mesh)
            if all(node.who_has(k) for node in nodes for k in keys):
                break
        converged = all(node.who_has(k) for node in nodes for k in keys)
        gossip_block = {
            "fanout": nodes[0].fanout(),
            "sweeps_to_converge": sweeps,
            "sweep_bound": bound,
            "converged": converged,
            "entries_max": max(len(node.digest) for node in nodes),
            "digest_memory_bytes_max": max(node.digest.memory_bytes()
                                           for node in nodes),
            "digest_max_entries": DEFAULT_MAX_ENTRIES,
            "bytes_out_total": sum(node.bytes_out for node in nodes),
        }

        # A cold pod joins: pod_size fresh hosts learn the index by
        # anti-entropy and route each warm-held xorb to the nearest
        # holder, over WAN, never to the origin.
        n2 = n + pod_size
        pods2 = pods + (n_pods,) * pod_size
        topo2 = topo + tuple(2 * n_pods + (i >= pod_size // 2)
                             for i in range(pod_size))
        book2 = dict(book)
        book2.update({n + i: ("sim", 7000 + n + i)
                      for i in range(pod_size)})
        cold = [GossipNode(n + i, n2, book2, topology=topo2, pods=pods2)
                for i in range(pod_size)]
        for node in cold:
            mesh.register(node)
        cold_sweeps = 0
        while cold_sweeps < bound:
            cold_sweeps += 1
            for node in cold:
                node.tick(mesh)
            if all(node.who_has(k) for node in cold for k in keys):
                break
        key_bytes = model_bytes // gossip_keys
        cold_cdn = cold_peer = 0
        wan_routed = True
        for node in cold:
            for k in keys:
                holders = node.who_has(k)
                if holders:
                    cold_peer += key_bytes
                    link, _rtt, _bps = phys(node.host_index, holders[0],
                                            topo2, pods2)
                    wan_routed &= link == "wan"
                else:
                    cold_cdn += key_bytes
        cold_block = {
            "hosts": pod_size,
            "sweeps_to_index": cold_sweeps,
            "warm_served_bytes": cold_peer,
            "cdn_bytes_for_warm_held": cold_cdn,
            "nearest_link": "wan" if wan_routed else "mixed",
            "pull_s_est": round(model_bytes / pod_wan_bps + wan_rtt_s, 3),
        }

        # The byte ledger: peer-served ratio and CDN egress.
        peer_bytes = (sum(results["federated"]["link_bytes"].values())
                      + cold_peer)
        cdn_total = model_bytes + cold_cdn
        fleets[str(n)] = {
            "hosts": n,
            "pods": n_pods,
            "gateways": len(gateways),
            "plan_skew": round(plan.skew(), 4),
            "fetch_wall_s": round(fetch_wall, 3),
            "peer_served_ratio": round(
                peer_bytes / (peer_bytes + cdn_total), 4),
            "peer_bytes": peer_bytes,
            "cdn_egress_bytes": cdn_total,
            "cdn_egress_bytes_per_host": cdn_total // n,
            "flat": results["flat"],
            "federated": results["federated"],
            "federated_speedup": round(speedup, 2),
            "gossip": gossip_block,
            "cold_pod": cold_block,
        }

    sizes = [str(s) for s in fleet_sizes]
    ratios = [fleets[s]["peer_served_ratio"] for s in sizes]
    egress = [fleets[s]["cdn_egress_bytes_per_host"] for s in sizes]
    out["gates"] = {
        "peer_served_ratio_min": min(ratios),
        "peer_served_ratio_ge_0.90": min(ratios) >= 0.90,
        "peer_served_flat_pm_0.03": max(ratios) - min(ratios) <= 0.03,
        "cdn_egress_per_host_decreasing": all(
            a > b for a, b in zip(egress, egress[1:])),
        "federated_speedup_min": min(fleets[s]["federated_speedup"]
                                     for s in sizes),
        "federated_speedup_ge_1.3": all(
            fleets[s]["federated_speedup"] >= 1.3 for s in sizes),
        "gossip_converged_within_bound": all(
            fleets[s]["gossip"]["converged"]
            and (fleets[s]["gossip"]["sweeps_to_converge"]
                 <= fleets[s]["gossip"]["sweep_bound"])
            for s in sizes),
        "digest_memory_bounded": all(
            fleets[s]["gossip"]["entries_max"]
            <= fleets[s]["gossip"]["digest_max_entries"] for s in sizes),
        "cold_pod_zero_cdn_for_warm": all(
            fleets[s]["cold_pod"]["cdn_bytes_for_warm_held"] == 0
            for s in sizes),
    }
    out["gates"]["all_ok"] = all(v for v in out["gates"].values()
                                 if isinstance(v, bool))
    if out_path:
        pathlib.Path(out_path).write_text(json.dumps(out, indent=2) + "\n")
    return out


def bench_tenants(gb: float = 0.064, k_tenants: int = 6,
                  n_models: int = 2, max_pulls: int = 4,
                  fault_spec: str | None = "cdn_503:0.15,peer_timeout:0.1",
                  fault_seed: int = 1337,
                  shaped_bps: int | None = 24_000_000,
                  disk_pressure: bool = True,
                  kill_tenant: bool = True,
                  chunks_per_xorb: int = 16, scale: int = 8,
                  shard_bytes: int = 16 * 1024 * 1024,
                  out_path: str | None = None,
                  device: str = "cuda") -> dict:
    """``k_tenants`` concurrent files-only pulls (``device`` resolved,
    nothing lands) through one process's shared pools
    (``transfer.tenancy``), under faults and a shaped CDN.

    1. Solo: each revision pulled alone into a fresh cache, the digests
       every concurrent pull must reproduce.
    2. Saturation: the tenants pull ``n_models`` overlapping revisions
       (B dedups against A) into one cache, ``max_pulls`` admitted at
       once, the faults armed, the CDN shaped, and (``kill_tenant``) one
       tenant cancelled mid-pull.
    3. Disk pressure (``disk_pressure``): revision A pulled, every cache
       entry it made pinned, B pulled with the high watermark below the
       working set, then an eviction pass with the pins live: every
       pinned entry must survive on disk and B land digest-identical.

    ``gates``: duplicate fetches (CDN fetches above the distinct units)
    at most 2%, no corrupt byte in a survivor, the cancelled tenant the
    only one to end other than ``ok`` (and ``cancelled``), no pinned
    entry evicted."""
    import hashlib
    import shutil
    import threading

    from zest_tpu_torch import faults, telemetry
    from zest_tpu_torch.bench_hub import FixtureHub, FixtureRepo
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.telemetry import session as session_mod
    from zest_tpu_torch.transfer import tenancy
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.tenancy import CancelToken, PullCancelled

    repo_id = "bench/tenants-llama"
    t_gen = time.perf_counter()
    base = llama_checkpoint_files(gb, scale=scale, shard_bytes=shard_bytes)
    repo = FixtureRepo(repo_id, base, chunks_per_xorb=chunks_per_xorb)
    revs = [repo.latest_sha]
    for m in range(1, n_models):
        rev_files = llama_checkpoint_files(
            gb, scale=scale, shard_bytes=shard_bytes,
            mutate_fraction=0.02, mutate_seed=m)
        revs.append(repo.add_revision(rev_files))
    total = sum(len(b) for b in base.values())
    t_gen = time.perf_counter() - t_gen

    def digests(snapshot_dir) -> dict:
        return {str(f.relative_to(snapshot_dir)):
                hashlib.sha256(f.read_bytes()).hexdigest()
                for f in sorted(pathlib.Path(snapshot_dir).rglob("*"))
                if f.is_file()}

    def pull(cfg, rev, **kw):
        return pull_model(cfg, repo_id, revision=rev, device=device,
                          land=False, no_p2p=True, log=_quiet, **kw)

    out: dict = {
        "bench": "tenants",
        "model_bytes": total,
        "k_tenants": k_tenants,
        "n_models": n_models,
        "max_pulls": max_pulls,
        "cdn_bps": shaped_bps,
        "faults": fault_spec,
        "chunks_per_xorb": chunks_per_xorb,
        "fixture_gen_s": round(t_gen, 1),
    }
    faults.install(None)  # the solo phase runs clean
    tenancy.reset()
    with FixtureHub(repo, throttle_bps=shaped_bps) as hub, \
            tempfile.TemporaryDirectory() as root:
        rootp = pathlib.Path(root)

        # ── 1. solo references ──
        solo_digests: dict[str, dict] = {}
        solo_walls: list[float] = []
        for i, rev in enumerate(revs):
            cfg = Config(hf_home=rootp / f"solo{i}/hf",
                         cache_dir=rootp / f"solo{i}/zest",
                         hf_token="hf_test", endpoint=hub.url)
            t0 = time.perf_counter()
            res = pull(cfg, rev)
            solo_walls.append(time.perf_counter() - t0)
            solo_digests[rev] = digests(res.snapshot_dir)
            shutil.rmtree(rootp / f"solo{i}", ignore_errors=True)
        out["solo"] = {"wall_s": [round(w, 3) for w in solo_walls]}

        # ── 2. saturation ──
        tenancy.reset()
        hub.requests_seen.clear()
        hub.xorb_fetches.clear()
        cfg = Config(hf_home=rootp / "shared/hf",
                     cache_dir=rootp / "shared/zest",
                     hf_token="hf_test", endpoint=hub.url,
                     tenant_max_pulls=max_pulls,
                     tenant_queue=max(4, 2 * k_tenants))
        if fault_spec:
            faults.install(fault_spec, fault_seed)

        def cdn_xorbs_total() -> int:
            """Successful CDN fetches counted by the bridges: a fetch
            that fails on the client and is retried reaches the hub
            twice but succeeds once."""
            for m in telemetry.REGISTRY.metrics():
                if m.name == "zest_fetch_xorbs_total":
                    return int(sum(v for labels, v in m.samples()
                                   if labels.get("source") == "cdn"))
            return 0

        cdn_before = cdn_xorbs_total()
        walls: dict[int, float] = {}
        statuses: dict[int, str] = {}
        kill_idx = k_tenants - 1 if kill_tenant else None
        kill_token = CancelToken()
        barrier = threading.Barrier(k_tenants + (1 if kill_tenant else 0))

        def tenant_run(i: int) -> None:
            rev = revs[i % len(revs)]
            barrier.wait()
            t0 = time.perf_counter()
            try:
                pull(cfg, rev, tenant=f"tenant-{i}",
                     cancel=kill_token if i == kill_idx else None)
                statuses[i] = "ok"
            except PullCancelled:
                statuses[i] = "cancelled"
            except Exception as exc:  # noqa: BLE001 - in the artifact
                statuses[i] = f"error: {exc}"
            walls[i] = time.perf_counter() - t0

        def killer() -> None:
            barrier.wait()
            # Mid-pull: 40% of the solo median (a concurrent pull is
            # only slower).
            time.sleep(max(0.3,
                           0.4 * sorted(solo_walls)[len(solo_walls) // 2]))
            kill_token.cancel("bench tenant kill")

        threads = [threading.Thread(target=tenant_run, args=(i,))
                   for i in range(k_tenants)]
        if kill_tenant:
            threads.append(threading.Thread(target=killer))
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        sat_wall = time.perf_counter() - t0
        faults.install(None)

        # Successful CDN fetches against the distinct (xorb, range) units
        # the hub served: anything above one a unit is a duplicate.
        fetches = list(hub.xorb_fetches)
        distinct = len(set(fetches))
        cdn_ok = cdn_xorbs_total() - cdn_before
        dup_ratio = (max(0, cdn_ok - distinct) / distinct
                     if distinct else 0.0)

        ok_idx = [i for i, s in statuses.items() if s == "ok"]
        survivor_digests_ok = all(
            digests(cfg.model_snapshot_dir(repo_id, revs[i % len(revs)]))
            == solo_digests[revs[i % len(revs)]] for i in ok_idx)
        ok_walls = sorted(walls[i] for i in ok_idx)

        def pctl(p: float) -> float | None:
            if not ok_walls:
                return None
            k = min(len(ok_walls) - 1, int(round(p * (len(ok_walls) - 1))))
            return round(ok_walls[k], 3)

        summary = tenancy.state(cfg).summary()
        sessions = [s.snapshot() for s in session_mod.SESSIONS.recent()]
        killed_status = (statuses.get(kill_idx) if kill_idx is not None
                         else None)
        out["saturation"] = {
            "wall_s": round(sat_wall, 3),
            "per_tenant_wall_s": {str(i): round(w, 3)
                                  for i, w in sorted(walls.items())},
            "statuses": {str(i): s for i, s in sorted(statuses.items())},
            "p50_pull_s": pctl(0.50),
            "p99_pull_s": pctl(0.99),
            "aggregate_gbps": round(total * len(ok_idx) / sat_wall / 1e9,
                                    4) if sat_wall else None,
            "cdn_fetches": cdn_ok,
            "cdn_request_arrivals": len(fetches),
            "distinct_units": distinct,
            "dedupe": summary["dedupe"],
            "admission": {k: summary[k] for k in
                          ("max_pulls", "admitted_total",
                           "rejected_total")},
            "eviction": summary["eviction"],
            "terminal_statuses": sorted(
                {s["id"]: s["status"] for s in sessions}.values()),
        }

        # ── 3. eviction under disk pressure, with pins live ──
        pressure: dict | None = None
        if disk_pressure and len(revs) >= 2:
            tenancy.reset()
            rev_a, rev_b = revs[0], revs[1]
            press_status: dict[str, str] = {}
            pcfg = Config(hf_home=rootp / "press/hf",
                          cache_dir=rootp / "press/zest",
                          hf_token="hf_test", endpoint=hub.url,
                          tenant_max_pulls=max_pulls)
            t0 = time.perf_counter()
            pull(pcfg, rev_a, tenant="press-a")
            cache_root = pcfg.xorb_cache_dir()
            pinned_entries = [p for sub in cache_root.iterdir()
                              for p in sub.iterdir()
                              if not p.name.startswith(".tmp-")]
            pinned_hashes = {p.name.split(".", 1)[0]
                             for p in pinned_entries}
            a_usage = sum(p.stat().st_size for p in pinned_entries)

            tenancy.reset()
            pcfg2 = Config(hf_home=pcfg.hf_home, cache_dir=pcfg.cache_dir,
                           hf_token="hf_test", endpoint=hub.url,
                           tenant_max_pulls=max_pulls,
                           tenant_disk_high=int(a_usage * 0.9),
                           tenant_disk_low=int(a_usage * 0.5))
            pst = tenancy.state(pcfg2)
            pst.pins.pin("bench-hold", pinned_hashes)
            try:
                pull(pcfg2, rev_b, tenant="press-b")
                press_status["b"] = "ok"
            except Exception as exc:  # noqa: BLE001
                press_status["b"] = f"error: {exc}"
            # The daemon's watermark pass with the hold live (force: B's
            # admission just ran one).
            pst.evictor.maybe_evict(force=True)
            pev = pst.evictor.summary()
            survived = [p for p in pinned_entries if p.exists()]
            press_digests_ok = (
                press_status.get("b") == "ok"
                and digests(pcfg2.model_snapshot_dir(repo_id, rev_b))
                == solo_digests[rev_b])
            pst.pins.release("bench-hold")
            pressure = {
                "wall_s": round(time.perf_counter() - t0, 3),
                "statuses": press_status,
                "pinned_entries": len(pinned_entries),
                "pinned_survived_on_disk": len(survived),
                "eviction": pev,
                "digests_identical": press_digests_ok,
            }
            out["pressure"] = pressure

        out["gates"] = {
            "duplicate_fetch_ratio": round(dup_ratio, 4),
            "duplicate_fetch_ratio_ok": dup_ratio <= 0.02,
            "zero_corrupt": survivor_digests_ok
            and (pressure is None or pressure["digests_identical"]),
            "killed_isolated": (
                kill_idx is None
                or (killed_status == "cancelled"
                    and all(statuses[i] == "ok"
                            for i in statuses if i != kill_idx))),
            "pinned_never_evicted": (
                pressure is None
                or (pressure["pinned_survived_on_disk"]
                    == pressure["pinned_entries"]
                    and pressure["eviction"]["pinned_survivals"] > 0
                    and pressure["digests_identical"])),
        }
        out["gates"]["all_ok"] = all(
            v for k, v in out["gates"].items()
            if k.endswith("_ok") or k in ("zero_corrupt", "killed_isolated",
                                          "pinned_never_evicted"))
    tenancy.reset()
    telemetry.record("bench_tenants_done", gates_ok=out["gates"]["all_ok"])
    if out_path:
        pathlib.Path(out_path).write_text(json.dumps(out, indent=2) + "\n")
    return out


def bench_serve_pool(gb: float = 0.02, runs: int = 3, scale: int = 8,
                     throttle_mbps: float = 200.0,
                     chunks_per_xorb: int = 64, steps: int = 8,
                     budget_s: float | None = None,
                     device: str = "cuda") -> dict:
    """The serving pool's scale-to-zero on ``device``: model A was served,
    evicted under pressure, and is asked for again.

    - Baseline: a cold files-only pull over a ``throttle_mbps`` link and
      the family generator's first token (``full_cold_serve_s``, from the
      request to the first token; ``pull_s`` its network share).
    - Pool: A re-landed from its local snapshot, the decode gated layer
      by layer so its first token overlaps the landing's tail
      (``ttft_cold_s``, the pool's own clock).

    Each run also checks that a pinned A survives B's admission under a
    one-byte-slack budget and that the re-landed tree's ``params_digest``
    equals the first landing's; one MoE serve records the expert pager's
    residency. ``gates``: ``ttft_cold_ratio`` at most 0.5, the digest,
    the pin, the residency under 0.5."""
    from zest_tpu_torch.bench_hub import (FixtureHub, FixtureRepo,
                                          mixtral_checkpoint_files)
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models import hbm_pool
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.transfer.pull import pull_model

    t_bench0 = time.perf_counter()
    files_a = llama_checkpoint_files(gb, seed=0, scale=scale,
                                     shard_bytes=8 << 20)
    files_b = llama_checkpoint_files(gb, seed=1, scale=scale,
                                     shard_bytes=8 << 20)
    total = sum(len(b) for b in files_a.values())
    repo_a = FixtureRepo("bench/serve-a", files_a,
                         chunks_per_xorb=chunks_per_xorb)
    repo_b = FixtureRepo("bench/serve-b", files_b,
                         chunks_per_xorb=chunks_per_xorb)
    repo_moe = FixtureRepo("bench/serve-moe", mixtral_checkpoint_files(),
                           chunks_per_xorb=chunks_per_xorb)
    gc.collect()

    def files_pull(cfg, repo: str):
        return pull_model(cfg, repo, device=device, land=False,
                          no_p2p=True, log=_quiet)

    prompt = [1, 2, 3]
    full_cold: list[float] = []
    pull_s: list[float] = []
    ttft_cold: list[float] = []
    ttft_hot: list[float] = []
    stalls: list[float] = []
    overlap: list[bool] = []
    digest_ok: bool | None = None
    pinned_ok: bool | None = None
    moe: dict | None = None
    with FixtureHub(repo_a, repo_b, repo_moe,
                    throttle_bps=int(throttle_mbps * 1e6 / 8)) as hub:
        for run_i in range(runs):
            if run_i and budget_s is not None \
                    and time.perf_counter() - t_bench0 > budget_s:
                break
            _settle_page_cache(False)
            with tempfile.TemporaryDirectory() as root:
                rootp = pathlib.Path(root)
                cfg = Config(hf_home=rootp / "hf",
                             cache_dir=rootp / "zest",
                             hf_token="hf_test", endpoint=hub.url)

                # Baseline: a cold serve, request to first token.
                t0 = time.perf_counter()
                res_a = files_pull(cfg, "bench/serve-a")
                pull_s.append(time.perf_counter() - t0)
                snap_a = res_a.snapshot_dir
                first: dict = {}
                _mt, family = load_generator(snap_a, device=device)
                family(prompt, steps,
                       on_token=lambda _p, _t: first.setdefault(
                           "t", time.perf_counter()))
                full_cold.append(first["t"] - t0)

                pool = hbm_pool.HbmPool(cfg, device=device)
                try:
                    # Residency first (untimed), then the pinned tree
                    # through B's admission.
                    pool.generate_for(snap_a, "bench/serve-a", prompt,
                                      steps)
                    d0 = pool.digest(snap_a)
                    res_b = files_pull(cfg, "bench/serve-b")
                    entry_a, _hot = pool.acquire(snap_a, "bench/serve-a")
                    pool.budget = entry_a.reserved + 1
                    pool.generate_for(res_b.snapshot_dir, "bench/serve-b",
                                      prompt, 2)
                    ok = (entry_a.state == "resident"
                          and pool.pinned_survivals > 0)
                    pinned_ok = ok if pinned_ok is None \
                        else (pinned_ok and ok)
                    pool.release(entry_a)

                    # A scaled to zero, then the measured re-land.
                    pool.budget = cfg.hbm_pool_bytes
                    pool.evict(snap_a, "scale_to_zero")
                    _o, info_c = pool.generate_for(
                        snap_a, "bench/serve-a", prompt, steps)
                    ttft_cold.append(info_c["ttft_s"])
                    stalls.append(info_c["gate_stall_s"])
                    overlap.append(info_c["decode_start_before_land_end"])
                    ok = bool(d0) and pool.digest(snap_a) == d0
                    digest_ok = ok if digest_ok is None \
                        else (digest_ok and ok)
                    _o, info_h = pool.generate_for(
                        snap_a, "bench/serve-a", prompt, steps)
                    ttft_hot.append(info_h["ttft_s"])
                    if moe is None:
                        res_m = files_pull(cfg, "bench/serve-moe")
                        _o, info_m = pool.generate_for(
                            res_m.snapshot_dir, "bench/serve-moe",
                            prompt, 4)
                        moe = info_m["experts"]
                finally:
                    pool.close()
                del res_a
                gc.collect()

    med_full = statistics.median(full_cold)
    med_cold = statistics.median(ttft_cold)
    ratio = (med_cold / med_full) if med_full else None
    expert_res = (moe or {}).get("residency")
    gates = {
        "ttft_cold_ratio_max": 0.5,
        "ttft_cold_ratio": round(ratio, 4) if ratio is not None else None,
        "ttft_ok": bool(ratio is not None and ratio <= 0.5),
        "digest_identical": bool(digest_ok),
        "pinned_never_evicted": bool(pinned_ok),
        "expert_residency_max": 0.5,
        "expert_residency": expert_res,
        "experts_ok": bool(expert_res is not None and expert_res < 0.5
                           and (moe or {}).get("verified", 0) > 0),
    }
    gates["all_ok"] = (gates["ttft_ok"] and gates["digest_identical"]
                       and gates["pinned_never_evicted"]
                       and gates["experts_ok"])
    return {
        "bench": "serve_pool",
        "checkpoint_gb": round(total / 1e9, 3),
        "throttle_mbps": throttle_mbps,
        "runs": len(ttft_cold),
        "steps": steps,
        "full_cold_serve_s": round(med_full, 3),
        "full_cold_serve_runs_s": [round(t, 3) for t in full_cold],
        "pull_s": round(statistics.median(pull_s), 3),
        "ttft_cold_s": round(med_cold, 3),
        "ttft_cold_runs_s": [round(t, 3) for t in ttft_cold],
        "ttft_hot_s": round(statistics.median(ttft_hot), 4),
        "gate_stall_s": round(statistics.median(stalls), 3),
        "decode_start_before_land_end": all(overlap),
        "moe_experts": moe,
        "gates": gates,
    }
