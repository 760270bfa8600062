"""Device memory as a managed multi-model serving pool.

The counterpart of ``zest_tpu/models/hbm_pool.py`` on one card:

* A process-wide :class:`HbmPool` holds several resident model trees as
  flat HF name → tensor dicts (what a landing commits, so
  ``loader.params_digest`` compares a pool landing with a pull's),
  byte-accounted against the ``ZEST_HBM_POOL_BYTES`` watermark.
* Pinning protects the tree that is decoding; LRU eviction drops cold
  unpinned trees (their tensors released; the snapshot stays on disk),
  never a pinned one.
* A generate against an evicted (or new) model re-lands it from the
  local snapshot in layer order (``registry.order_names``) on a thread of
  its own, and decoding starts at first-layer commit: the gated decoders
  below run each layer as soon as its tensors are resident.
* A Mixtral entry lands only its dense core; expert tensors page in on
  demand per routed token through :class:`ExpertPager`, an expert LRU
  whose every page-in is BLAKE3-checked against the digest pinned at
  first read.

A commit group's names are published to the gates only after
``loader.commit_tensors`` returned, and it returns once its copy has
completed on the host's side (the stream is synchronized), so a decode on
any thread or stream never reads a tensor whose bytes are still in
flight. A tree's memory goes back when its last reference does: eviction,
an aborted landing and the pager's LRU drop every reference they hold,
and a failed landing keeps its exception without its traceback (whose
frames would hold the committed tensors).

Metrics: ``zest_hbm_pool_bytes{state}``,
``zest_hbm_pool_evictions_total{reason}``, ``zest_ttft_seconds{temp}``,
``zest_hbm_pool_expert_pages_total{outcome}`` and, with
``ZEST_SLO_TTFT_S``, ``zest_slo_breaches_total{slo="ttft"}`` and the
session table's ``ttft`` SLO burn; flight
events ``pool_land``, ``pool_land_done``, ``pool_land_error``,
``pool_evict``, ``pool_swap``, ``slo_breach``. Timeline series
``hbm_pool.{resident_bytes,pinned_bytes,models,gate_stall_s,evictions,
landing}`` and the remediation targets ``pool_land`` (``rush``: every
layer boundary flushes while a gate stalls) and ``pool_shed`` (drop the
coldest unpinned tree when evictions grow).

``ZEST_HBM_POOL=0`` removes the pool (:func:`pool` returns None): the
daemon then serves every model on the single-model path.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import numpy as np
import torch

from zest_tpu_torch import telemetry
from zest_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from zest_tpu_torch.transfer import tenancy

# Families the gated decoders below cover; gpt2 (and unknown types) take
# the single-model path in api.http_api.
POOL_FAMILIES = ("llama", "mistral", "qwen2", "mixtral")

# Re-land commit group: tensors accumulate to about this many bytes
# before one batched commit, cut only at layer boundaries so a gate never
# opens on half a layer.
DEFAULT_GROUP_BYTES = 64 << 20

# The expert LRU's budget as a fraction of the checkpoint's expert bytes.
EXPERT_BUDGET_FRACTION = 0.375

_M_POOL_BYTES = telemetry.gauge(
    "zest_hbm_pool_bytes",
    "HBM bytes held by the serving pool, by pin state", ("state",))
_M_POOL_EVICTIONS = telemetry.counter(
    "zest_hbm_pool_evictions_total",
    "Model trees evicted from the HBM pool", ("reason",))
_M_TTFT = telemetry.histogram(
    "zest_ttft_seconds",
    "Time from /v1/generate arrival to first generated token",
    ("temp",),
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0, 120.0))
_M_EXPERT_PAGES = telemetry.counter(
    "zest_hbm_pool_expert_pages_total",
    "Expert-tensor page events in the MoE pager", ("outcome",))
_M_SLO_BREACHES = telemetry.counter(
    "zest_slo_breaches_total",
    "Pulls that breached an armed SLO budget (ZEST_SLO_TTHBM_S / "
    "ZEST_SLO_TTFL_S)", ("slo",))

_EMBED = "model.embed_tokens.weight"
_NORM = "model.norm.weight"
_HEAD = "lm_head.weight"


# ── Checkpoint topology helpers ──


def _snapshot_cfg(snapshot_dir: str | Path) -> dict:
    return json.loads((Path(snapshot_dir) / "config.json").read_text())


def snapshot_meta(snapshot_dir: str | Path) -> tuple[str | None, tuple]:
    """``(model_type, eos_ids)`` from a snapshot's config.json, for routing
    a request (pool or single-model path) before touching the pool;
    ``(None, ())`` when the snapshot has no readable config."""
    try:
        cfg_json = _snapshot_cfg(snapshot_dir)
    except (OSError, json.JSONDecodeError):
        return None, ()
    from zest_tpu_torch.models.generate import eos_token_ids

    return cfg_json.get("model_type"), eos_token_ids(cfg_json)


def _is_expert_name(name: str) -> bool:
    from zest_tpu_torch.models.moe import expert_of_tensor

    return expert_of_tensor(name) is not None


_ATTN = ("input_layernorm.weight", "self_attn.q_proj.weight",
         "self_attn.k_proj.weight", "self_attn.v_proj.weight",
         "self_attn.o_proj.weight", "post_attention_layernorm.weight")


def _require(names: list[str], present: frozenset[str]) -> list[str]:
    missing = [n for n in names if n not in present]
    if missing:
        raise ValueError(f"checkpoint missing {missing[:3]}")
    return names


def _llama_layer_names(i: int, present: frozenset[str]) -> list[str]:
    pre = f"model.layers.{i}."
    names = [pre + n for n in _ATTN + (
        "mlp.gate_proj.weight", "mlp.up_proj.weight",
        "mlp.down_proj.weight")]
    # Optional biases (Qwen2 q/k/v, attention_bias o): gate on what the
    # checkpoint ships, or the gate would wait on a tensor never landing.
    names += [pre + opt for opt in (
        "self_attn.q_proj.bias", "self_attn.k_proj.bias",
        "self_attn.v_proj.bias", "self_attn.o_proj.bias")
        if pre + opt in present]
    return _require(names, present)


def _moe_layer_names(i: int, present: frozenset[str]) -> list[str]:
    pre = f"model.layers.{i}."
    return _require([pre + n for n in _ATTN + (
        "block_sparse_moe.gate.weight",)], present)


# ── Gated flat decoders ──
#
# The family modules decode over stacked trees, which do not exist
# mid-landing. These run the same math over the flat HF-orientation dict
# the landing commits, layer by layer, each layer waiting on its gate.
# HF stores Linear weights [out, in]; a layer view hands the family
# code transposed views (``x @ W.T``), so the tree is never copied.


def _llama_layer_step(cfg, lp: dict, x, ck, cv, pos: int):
    """One Llama-family layer over (B, S, E) at ``pos``, its (B, T, KV,
    D) caches written in place."""
    from zest_tpu_torch.models import llama

    h = llama._rms_norm(x, lp["ln1"], cfg.rms_eps)
    x = x + llama._attention_cached(h, lp, cfg, ck, cv, pos)
    h = llama._rms_norm(x, lp["ln2"], cfg.rms_eps)
    return x + llama._mlp(h, lp)


def _llama_head(cfg, x_last, norm_g, head_w):
    """Final norm and unembedding; HF ``lm_head`` and the embedding are
    both [vocab, E], so tied and untied checkpoints share it."""
    from zest_tpu_torch.models.llama import _rms_norm

    return _rms_norm(x_last, norm_g, cfg.rms_eps) @ head_w.T


def _moe_attn_step(cfg, lp: dict, x, ck, cv, pos: int):
    """A Mixtral layer's attention half: returns the residual stream and
    the normed input of its expert FFN."""
    from zest_tpu_torch.models import moe

    h = moe._rms_norm(x, lp["ln1"], cfg.rms_eps)
    x = x + moe._attention_cached(h, lp, cfg, ck, cv, pos)
    return x, moe._rms_norm(x, lp["ln2"], cfg.rms_eps)


def _moe_router(cfg, flat, gate_w):
    """``moe._moe_block``'s routing: float32 logits → softmax → top-k →
    gates renormalized over the selected mass. Returns (gates, indices)."""
    from zest_tpu_torch.models.moe import _route

    _, gate_vals, gate_idx = _route(flat, gate_w.T, cfg)
    return gate_vals, gate_idx


def _expert_ffn(h, w1, w3, w2):
    """One expert's SwiGLU over (N, E) tokens, HF [out, in] weights."""
    return (torch.nn.functional.silu(h @ w1.T) * (h @ w3.T)) @ w2.T


_moe_head = _llama_head


# ── Expert pager ──


class ExpertPager:
    """Lazy (layer, expert) → device pager with an LRU inside a byte
    budget.

    Expert tensors stay on disk until a router selects the expert; a
    page-in reads its three SwiGLU tensors (``reader(name)`` → a CPU
    tensor), checks each against the BLAKE3 digest pinned at its first
    read (a flip on disk between page-ins is refused, not served) and
    commits the group to ``device``. The LRU evicts whole groups, oldest
    first, before admitting one; a single group over the budget is still
    served."""

    def __init__(self, reader, budget_bytes: int, device=DEFAULT_DEVICE):
        self._reader = reader
        self.device = resolve_device(device)
        self.budget_bytes = int(budget_bytes)
        self._lru: dict[tuple[int, int], dict] = {}  # insertion = LRU
        self._sizes: dict[tuple[int, int], int] = {}
        self._digests: dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.bytes = 0
        self.peak_bytes = 0
        self.total_expert_bytes = 0
        self.page_ins = 0
        self.hits = 0
        self.evictions = 0
        self.verified = 0

    @staticmethod
    def _names(layer: int, expert: int) -> dict[str, str]:
        pre = f"model.layers.{layer}.block_sparse_moe.experts.{expert}."
        return {leaf: pre + leaf + ".weight" for leaf in ("w1", "w3", "w2")}

    def get(self, layer: int, expert: int) -> dict:
        key = (layer, expert)
        with self._lock:
            grp = self._lru.get(key)
            if grp is not None:
                self._lru[key] = self._lru.pop(key)  # to the MRU end
                self.hits += 1
                _M_EXPERT_PAGES.inc(outcome="hit")
                return grp
        # Page-in outside the lock; a duplicate race costs one redundant
        # read, never a wrong result.
        from zest_tpu_torch.cas import hashing
        from zest_tpu_torch.models import loader
        from zest_tpu_torch.models.safetensors_io import tensor_bytes

        host, size = {}, 0
        for leaf, name in self._names(layer, expert).items():
            view = self._reader(name)
            digest = hashing.blake3_hash(tensor_bytes(view).tobytes())
            with self._lock:
                pinned = self._digests.setdefault(name, digest)
                if digest == pinned:
                    self.verified += 1
            if digest != pinned:
                _M_EXPERT_PAGES.inc(outcome="corrupt")
                raise RuntimeError(
                    f"expert tensor {name} changed on disk since its "
                    "digest was pinned — refusing to serve it")
            host[leaf] = view
            size += view.numel() * view.element_size()
        grp = loader.commit_tensors(host, self.device)
        del host
        with self._lock:
            raced = self._lru.get(key)
            if raced is not None:
                return raced
            while self._lru and self.bytes + size > self.budget_bytes:
                old = next(iter(self._lru))
                del self._lru[old]
                self.bytes -= self._sizes.pop(old)
                self.evictions += 1
                _M_EXPERT_PAGES.inc(outcome="evict")
            self._lru[key] = grp
            self._sizes[key] = size
            self.bytes += size
            self.peak_bytes = max(self.peak_bytes, self.bytes)
            self.page_ins += 1
            _M_EXPERT_PAGES.inc(outcome="miss")
        return grp

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._sizes.clear()
            self.bytes = 0

    def stats(self) -> dict:
        return {
            "budget_bytes": self.budget_bytes,
            "bytes": self.bytes,
            "peak_bytes": self.peak_bytes,
            "total_expert_bytes": self.total_expert_bytes,
            "residency": (self.peak_bytes / self.total_expert_bytes
                          if self.total_expert_bytes else 0.0),
            "page_ins": self.page_ins,
            "hits": self.hits,
            "evictions": self.evictions,
            "verified": self.verified,
        }


# ── Pool entries ──


class PoolEntry:
    """One model tree in the pool. ``params`` and ``committed`` mutate in
    place (the gated decoder captures the entry, so an evict → re-land
    cycle is visible through the same objects)."""

    def __init__(self, key: str, repo: str, model_type: str,
                 cfg_json: dict):
        self.key = key
        self.repo = repo
        self.model_type = model_type
        self.cfg_json = cfg_json
        self.state = "new"          # new|landing|resident|evicted|error
        self.params: dict[str, torch.Tensor] = {}
        self.committed: set[str] = set()
        self.cond = threading.Condition()
        self.bytes = 0              # committed dense-core bytes
        self.reserved = 0           # expected full dense-core bytes
        self.pins = 0
        self.last_use = time.monotonic()
        self.expected: frozenset[str] = frozenset()
        self.first_layer: frozenset[str] = frozenset()
        self.where: dict[str, Path] = {}   # tensor name → home shard
        self.dtype: torch.dtype | None = None   # the landed embedding's
        self.land_error: Exception | None = None
        self.pager: ExpertPager | None = None
        self.generate = None        # built once, survives evictions
        self.lands = 0
        self.gate_stall_s = 0.0
        self.t_land_start: float | None = None
        self.t_first_layer: float | None = None
        self.t_land_end: float | None = None
        self.t_decode_start: float | None = None

    @property
    def hbm_bytes(self) -> int:
        pager = self.pager.bytes if self.pager is not None else 0
        if self.state in ("landing", "resident"):
            # A landing entry counts its whole reservation, so admission
            # pressure is computed against where the land is headed.
            return max(self.bytes, self.reserved) + pager
        return pager

    def wait_for(self, names) -> float:
        """Block until every name is committed; returns the seconds
        stalled."""
        need = set(names)
        if need <= self.committed:
            return 0.0
        t0 = time.perf_counter()
        with self.cond:
            while not need <= self.committed:
                if self.state == "error":
                    raise PoolLandError(
                        f"landing {self.repo} failed") from self.land_error
                if self.state == "evicted":
                    raise RuntimeError(
                        f"{self.repo} was evicted mid-decode — the pin "
                        "that should prevent this is missing")
                self.cond.wait(timeout=0.5)
        stall = time.perf_counter() - t0
        with self.cond:
            self.gate_stall_s += stall
        return stall

    def summary_row(self) -> dict:
        row = {
            "repo": self.repo,
            "model_type": self.model_type,
            "state": self.state,
            "bytes": self.hbm_bytes,
            "pins": self.pins,
            "lands": self.lands,
            "gate_stall_s": round(self.gate_stall_s, 3),
            "idle_s": round(time.monotonic() - self.last_use, 1),
        }
        if self.pager is not None:
            row["experts"] = self.pager.stats()
        return row


# ── The pool ──


class HbmPool:
    """Process-wide managed device pool on ``device``; construct via
    :func:`pool`. The pool stays on one device: it does not read
    ``cfg.mesh``, and a ``mesh`` raises ``MeshUnsupported``."""

    def __init__(self, cfg, device=DEFAULT_DEVICE, mesh=None):
        if mesh is not None:
            from zest_tpu_torch.parallel.sharding import MeshUnsupported

            raise MeshUnsupported(
                "the serving pool holds its trees on one device; a "
                "sharded pool is not ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.budget = int(getattr(cfg, "hbm_pool_bytes", 0))
        self.group_bytes = DEFAULT_GROUP_BYTES
        self.land_delay_s = 0.0     # test hook: sleep between flushes
        self._lock = threading.RLock()
        self._entries: dict[str, PoolEntry] = {}
        # Every layer boundary flushes while set (the remediation
        # engine's pool_land "rush"; cleared when no land is in flight).
        self._rush = threading.Event()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.pinned_survivals = 0
        self._register_hooks()

    # ── wiring ──

    def _register_hooks(self) -> None:
        # Kept so that close() takes back exactly these: a newer pool's
        # registrations under the same names stay.
        self._probes = {
            "hbm_pool.resident_bytes": lambda: float(self.used_bytes()),
            "hbm_pool.pinned_bytes": lambda: float(self.pinned_bytes()),
            "hbm_pool.models": lambda: float(len(self.resident())),
            "hbm_pool.gate_stall_s": self._total_stall_s,
            "hbm_pool.evictions": lambda: float(self.evictions),
            "hbm_pool.landing": lambda: float(self._landing_count()),
        }
        # Bound methods taken once: the unregister checks identity.
        self._targets = {"pool_shed": self._shed_cmd,
                         "pool_land": self._land_cmd}
        for name, fn in self._probes.items():
            telemetry.timeline.register_probe(name, fn)
        for name, fn in self._targets.items():
            telemetry.remediate.register_target(name, fn)

    def _unregister_hooks(self) -> None:
        for name, fn in self._probes.items():
            telemetry.timeline.unregister_probe(name, fn)
        for name, fn in self._targets.items():
            telemetry.remediate.unregister_target(name, fn)

    def _shed_cmd(self, cmd: str) -> bool:
        """Remediation target: pool thrash drops the coldest unpinned
        resident tree."""
        return self.shed_coldest(reason="shed") is not None

    def _land_cmd(self, cmd: str) -> bool:
        """Remediation target: ``rush`` makes every layer boundary
        flush at once instead of batching to ``group_bytes``, trading
        commit batching for gate latency."""
        if cmd == "rush":
            self._rush.set()
            return True
        return False

    # ── accounting ──

    def used_bytes(self) -> int:
        with self._lock:
            return sum(e.hbm_bytes for e in self._entries.values())

    def pinned_bytes(self) -> int:
        with self._lock:
            return sum(e.hbm_bytes for e in self._entries.values()
                       if e.pins > 0)

    def _total_stall_s(self) -> float:
        with self._lock:
            return sum(e.gate_stall_s for e in self._entries.values())

    def _landing_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values()
                       if e.state == "landing")

    def _update_gauges(self) -> None:
        pinned = self.pinned_bytes()
        _M_POOL_BYTES.set(float(pinned), state="pinned")
        _M_POOL_BYTES.set(float(self.used_bytes() - pinned),
                          state="resident")

    # ── admission / eviction ──

    @staticmethod
    def supports(model_type: str | None) -> bool:
        return (model_type or "") in POOL_FAMILIES

    def acquire(self, snapshot_dir: str | Path,
                repo: str | None = None) -> tuple[PoolEntry, bool]:
        """Pin (and if needed admit and re-land) the model at
        ``snapshot_dir``. Returns ``(entry, hot)``: ``hot`` is True when
        the tree was wholly resident before this call. The caller must
        :meth:`release` the entry when its decode is done."""
        key = str(Path(snapshot_dir).resolve())
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                cfg_json = _snapshot_cfg(key)
                model_type = cfg_json.get("model_type") or ""
                if not self.supports(model_type):
                    raise ValueError(
                        f"model_type {model_type!r} is not pool-served "
                        f"(families: {', '.join(POOL_FAMILIES)})")
                entry = PoolEntry(key, repo or Path(key).name,
                                  model_type, cfg_json)
                self._entries[key] = entry
            hot = entry.state == "resident"
            if hot:
                self.hits += 1
            else:
                self.misses += 1
            entry.pins += 1
            entry.last_use = time.monotonic()
            if entry.state in ("new", "evicted", "error"):
                try:
                    self._start_land(entry)
                except Exception:
                    entry.pins -= 1
                    raise
            self._update_gauges()
        return entry, hot

    def release(self, entry: PoolEntry) -> None:
        with self._lock:
            entry.pins = max(0, entry.pins - 1)
            entry.last_use = time.monotonic()
            self._update_gauges()

    def shed_coldest(self, reason: str = "shed") -> str | None:
        """Evict the least recently used unpinned resident tree; returns
        its repo, or None when nothing is evictable."""
        with self._lock:
            victims = [e for e in self._entries.values()
                       if e.state == "resident" and e.pins == 0]
            if not victims:
                return None
            victim = min(victims, key=lambda e: e.last_use)
            self._evict_entry(victim, reason)
            return victim.repo

    def _evict_for(self, need: int) -> None:
        """LRU-evict unpinned resident trees until ``need`` more bytes
        fit under the watermark. Pinned (and landing) trees survive, even
        if the pool then stays over budget."""
        if not self.budget:
            return
        while self.used_bytes() + need > self.budget:
            victims = [e for e in self._entries.values()
                       if e.state == "resident" and e.pins == 0]
            if not victims:
                if any(e.pins > 0 for e in self._entries.values()
                       if e.state in ("resident", "landing")):
                    self.pinned_survivals += 1
                break
            self._evict_entry(min(victims, key=lambda e: e.last_use),
                              "pressure")

    def _evict_entry(self, entry: PoolEntry, reason: str) -> None:
        with entry.cond:
            entry.params.clear()   # the tensors' last references
            entry.committed.clear()
            entry.bytes = 0
            entry.state = "evicted"
            entry.cond.notify_all()
        if entry.pager is not None:
            entry.pager.clear()
        self.evictions += 1
        _M_POOL_EVICTIONS.inc(reason=reason)
        telemetry.record("pool_evict", repo=entry.repo, reason=reason)
        self._update_gauges()

    def swap_to(self, old_snapshot_dir: str | Path | None,
                new_snapshot_dir: str | Path,
                repo: str | None = None,
                wait: bool = True) -> tuple[PoolEntry, float]:
        """Hot-swap a revision: land the new snapshot pinned, wait until
        it is resident, then evict the old one (a pinned old tree
        survives until the next pass). Land before evict, so the pool
        never holds no revision of the repo. Returns ``(entry, swap_s)``;
        the entry stays pinned until the caller :meth:`release`\\ s it."""
        t0 = time.perf_counter()
        entry, hot = self.acquire(new_snapshot_dir, repo)
        if wait and not hot:
            with entry.cond:
                while entry.state == "landing":
                    entry.cond.wait(timeout=0.5)
            if entry.state != "resident":
                self.release(entry)
                raise PoolLandError(
                    f"landing {entry.repo} failed") from entry.land_error
        if old_snapshot_dir is not None:
            old_key = str(Path(old_snapshot_dir).resolve())
            if old_key != entry.key:
                self.evict(old_key, reason="superseded")
        swap_s = time.perf_counter() - t0
        telemetry.record("pool_swap", repo=entry.repo,
                         swap_s=round(swap_s, 4))
        return entry, swap_s

    def evict(self, snapshot_dir: str | Path,
              reason: str = "manual") -> bool:
        key = str(Path(snapshot_dir).resolve())
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.state != "resident":
                return False
            if entry.pins > 0:
                self.pinned_survivals += 1
                return False
            self._evict_entry(entry, reason)
            return True

    # ── landing ──

    def _start_land(self, entry: PoolEntry) -> None:
        """Begin a re-land (the caller holds the pool lock)."""
        from zest_tpu_torch.models import registry
        from zest_tpu_torch.models.loader import snapshot_files
        from zest_tpu_torch.models.safetensors_io import SafetensorsFile

        entry.state = "landing"
        entry.land_error = None
        entry.t_land_start = time.perf_counter()
        entry.t_first_layer = None
        entry.t_land_end = None
        entry.lands += 1

        files = snapshot_files(entry.key)
        if not files:
            entry.state = "error"
            entry.land_error = FileNotFoundError(
                f"no .safetensors under {entry.key}")
            raise entry.land_error

        # Header-only pass: name → home file, sizes, the expert split.
        where: dict[str, Path] = {}
        sizes: dict[str, int] = {}
        for path in files:
            with SafetensorsFile(path) as sf:
                for name in sf.names():
                    where[name] = path
                    sizes[name] = sf.header.tensors[name].nbytes
                    if name == _EMBED:
                        entry.dtype = sf.header.tensors[name].torch_dtype
        paging = registry.is_expert_sharded(entry.model_type)
        expected = frozenset(
            n for n in where if not (paging and _is_expert_name(n)))
        entry.expected = expected
        entry.where = dict(where)
        entry.reserved = sum(sizes[n] for n in expected)
        entry.first_layer = registry.first_layer_names(expected)

        if paging and entry.pager is None:
            def reader(name: str, _where=dict(where)):
                with SafetensorsFile(_where[name]) as sf:
                    return sf.tensor(name).clone()  # the map closes

            expert_total = sum(sizes[n] for n in where if n not in expected)
            entry.pager = ExpertPager(
                reader, int(expert_total * EXPERT_BUDGET_FRACTION),
                self.device)
            entry.pager.total_expert_bytes = expert_total

        # Make room before bytes move: the landing entry's reservation is
        # in used_bytes() already. A paging entry also makes room for its
        # pager's budget (the JAX package counts the pager only once
        # pages are in, so the watermark can be overrun by it).
        headroom = (entry.pager.budget_bytes - entry.pager.bytes
                    if entry.pager is not None else 0)
        self._evict_for(headroom)
        telemetry.record("pool_land", repo=entry.repo,
                         bytes=entry.reserved, land=entry.lands)
        t = threading.Thread(target=self._land, args=(entry,),
                             name=f"hbm-pool-land-{entry.repo}",
                             daemon=True)
        # The land thread holds its own pin: pressure from a concurrent
        # admission can never evict a tree mid-land.
        entry.pins += 1
        t.start()

    def _land(self, entry: PoolEntry) -> None:
        from zest_tpu_torch.models import loader, registry
        from zest_tpu_torch.models.safetensors_io import SafetensorsFile

        handles: dict[Path, SafetensorsFile] = {}
        landed = False

        def flush(batch: dict) -> None:
            if not batch:
                return
            # Returns once the copy is complete (see the module
            # docstring): only then are the names published.
            committed = loader.commit_tensors(batch, self.device)
            size = sum(t.numel() * t.element_size()
                       for t in committed.values())
            with entry.cond:
                if entry.state != "landing":
                    raise _LandAbandoned
                entry.params.update(committed)
                entry.committed |= set(committed)
                entry.bytes += size
                if (entry.t_first_layer is None
                        and entry.first_layer <= entry.committed):
                    entry.t_first_layer = time.perf_counter()
                entry.cond.notify_all()
            if self.land_delay_s:
                time.sleep(self.land_delay_s)

        try:
            with telemetry.span("hbm_pool.land", repo=entry.repo):
                batch: dict[str, torch.Tensor] = {}
                batch_bytes = 0
                last_prio: tuple | None = None
                for name in registry.order_names(entry.expected):
                    prio = registry.layer_priority(name)
                    at_boundary = last_prio is not None and prio != last_prio
                    if batch and at_boundary and (
                            batch_bytes >= self.group_bytes
                            or self._rush.is_set()):
                        flush(batch)
                        batch, batch_bytes = {}, 0
                    last_prio = prio
                    path = entry.where[name]
                    if path not in handles:
                        handles[path] = SafetensorsFile(path)
                    view = handles[path].tensor(name)
                    batch[name] = view
                    batch_bytes += view.numel() * view.element_size()
                flush(batch)
                batch = {}
            landed = True
        except _LandAbandoned:
            pass  # evicted mid-land (the pool closed): nothing to keep
        except Exception as exc:  # noqa: BLE001 - recorded, raised at gates
            # Release every tensor this landing committed; the exception
            # is kept without its traceback, whose frames hold them too.
            batch = {}
            with entry.cond:
                entry.params.clear()
                entry.committed.clear()
                entry.bytes = 0
                entry.land_error = exc.with_traceback(None)
                entry.state = "error"
                entry.cond.notify_all()
            telemetry.record("pool_land_error", repo=entry.repo,
                             error=str(exc))
        finally:
            for sf in handles.values():
                sf.close()
            with self._lock:
                # The land's pin drops, and the rush clears, before the
                # tree is published resident: whoever sees it resident
                # sees its landing over.
                entry.pins = max(0, entry.pins - 1)
                landed = landed and entry.state == "landing"
                if self._landing_count() == int(landed):
                    self._rush.clear()
                if landed:
                    with entry.cond:
                        entry.t_land_end = time.perf_counter()
                        entry.state = "resident"
                        entry.cond.notify_all()
                self._update_gauges()
        if landed:
            telemetry.record(
                "pool_land_done", repo=entry.repo,
                wall_s=round(entry.t_land_end - entry.t_land_start, 3),
                first_layer_s=round(
                    (entry.t_first_layer or entry.t_land_end)
                    - entry.t_land_start, 3))

    # ── decoding ──

    def generate_for(self, snapshot_dir: str | Path, repo: str,
                     prompt_ids, steps: int, *, temperature: float = 0.0,
                     top_k: int | None = None, top_p: float | None = None,
                     seed: int = 0, stop_at_eos: bool = True,
                     on_token=None, noise: torch.Tensor | None = None):
        """Serve one generate through the pool: pin → (re-)land → gated
        decode from first-layer commit → release. Returns ``(tokens,
        info)`` with the request's temperature and TTFT facts."""
        t_req = time.perf_counter()
        entry, hot = self.acquire(snapshot_dir, repo)
        try:
            if entry.generate is None:
                entry.generate = _build_gated_generate(entry, self.device)
            first: dict[str, float] = {}

            def tap(pos, tokens):
                if "t" not in first:
                    first["t"] = time.perf_counter()
                if on_token is not None:
                    on_token(pos, tokens)

            out = entry.generate(
                prompt_ids, steps, temperature=temperature, top_k=top_k,
                top_p=top_p, seed=seed, stop_at_eos=stop_at_eos,
                on_token=tap, noise=noise)
            ttft = first.get("t", time.perf_counter()) - t_req
            temp = "hot" if hot else "cold"
            _M_TTFT.observe(ttft, temp=temp)
            land_end = entry.t_land_end
            info = {
                "temp": temp,
                "ttft_s": round(ttft, 4),
                "gate_stall_s": round(entry.gate_stall_s, 4),
                "decode_start_before_land_end": bool(
                    entry.t_decode_start is not None
                    and (land_end is None
                         or entry.t_decode_start < land_end)),
            }
            if entry.pager is not None:
                info["experts"] = entry.pager.stats()
            self._check_ttft_slo(repo, ttft, temp)
            return out, info
        finally:
            self.release(entry)

    def _check_ttft_slo(self, repo: str, ttft: float, temp: str) -> None:
        """``ZEST_SLO_TTFT_S`` arms a time-to-first-token budget. Every
        armed check is booked on the session table's SLO burn (the ``ttft``
        row of ``/v1/pulls``' ``slo`` block); a breach also bumps
        ``zest_slo_breaches_total{slo="ttft"}`` and records an
        ``slo_breach`` event."""
        budget = getattr(self.cfg, "slo_ttft_s", None)
        if not budget:
            return
        breached = ttft > budget
        telemetry.session.SESSIONS.note_slo("ttft", breached)
        if breached:
            _M_SLO_BREACHES.inc(slo="ttft")
            telemetry.record("slo_breach", slo="ttft", repo=repo,
                             budget_s=budget, actual_s=round(ttft, 4),
                             session=None, blamed_stage=temp)

    # ── introspection ──

    def digest(self, snapshot_dir: str | Path) -> str | None:
        """``loader.params_digest`` over a resident tree (None when not
        resident). Reads every byte back: verification, not the hot
        path."""
        from zest_tpu_torch.models.loader import params_digest

        key = str(Path(snapshot_dir).resolve())
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.state != "resident":
                return None
            entry.pins += 1
        try:
            return params_digest(entry.params)
        finally:
            self.release(entry)

    def resident(self) -> list[dict]:
        with self._lock:
            return [e.summary_row() for e in self._entries.values()
                    if e.state in ("landing", "resident")]

    def summary(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "budget_bytes": self.budget,
                "used_bytes": self.used_bytes(),
                "pinned_bytes": self.pinned_bytes(),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "pinned_survivals": self.pinned_survivals,
                "gate_stall_s": round(self._total_stall_s(), 3),
                "rush": self._rush.is_set(),
                "models": [e.summary_row()
                           for e in self._entries.values()],
            }

    def close(self) -> None:
        with self._lock:
            for entry in list(self._entries.values()):
                if entry.state in ("resident", "landing"):
                    self._evict_entry(entry, "reset")
                # Leaving the pool for good: the tree's xorbs lose their
                # pin and are ordinary eviction candidates again (an
                # evicted entry keeps it: a re-land reads the snapshot).
                tenancy.release_tree(self.cfg, entry.repo)
            self._entries.clear()
        self._unregister_hooks()


class PoolLandError(RuntimeError):
    """A pool landing failed; its ``__cause__`` is the landing's error."""


class _LandAbandoned(Exception):
    """The entry was evicted while its landing ran."""


# ── Gated generate builders ──


def _build_gated_generate(entry: PoolEntry, device):
    if entry.model_type == "mixtral":
        return _build_moe_generate(entry, device)
    return _build_llama_generate(entry, device)


def _decode(entry: PoolEntry, cfg, device, forward, prompt_ids, steps: int,
            temperature: float, top_k, top_p, seed: int, stop_at_eos: bool,
            on_token, noise):
    """The gated decode of both families: ``sampling.cached_decode_loop``
    over ``forward(tokens, pos, caches)``, which waits on each layer's
    gate and returns the (B, vocab) float32 logits of the window's last
    position. The loop validates, seeds and samples, so a seed or an
    injected noise gives the family path's tokens."""
    from zest_tpu_torch.models.generate import eos_token_ids, trim_at_eos
    from zest_tpu_torch.models.sampling import cached_decode_loop

    def init_kv_cache(cfg, B, total, dtype, device):
        # The first-layer gate: decoding starts here, later layers
        # possibly still landing.
        entry.wait_for(entry.first_layer)
        if entry.t_decode_start is None:
            entry.t_decode_start = time.perf_counter()
        shape = (B, total, cfg.n_kv_head, cfg.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
                for _ in range(cfg.n_layer)]

    def prefill_step(params, caches, tokens, pos, cfg, last_only=True):
        return forward(tokens, pos, caches)[:, None, :], caches

    def decode_step(params, caches, tokens, pos, cfg):
        return forward(tokens[:, None], pos, caches), caches

    # The loop reads only the device and the dtype off its params: the
    # landed dtype, from the header, before the embedding commits.
    view = {"wte": torch.empty(0, dtype=entry.dtype, device=device)}
    eos = eos_token_ids(entry.cfg_json) if stop_at_eos else None
    out = cached_decode_loop(
        init_kv_cache, decode_step, view, cfg, prompt_ids, steps,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        noise=noise, eos_id=eos, on_token=on_token,
        prefill_step=prefill_step).cpu().numpy()
    if eos is not None:
        out = trim_at_eos(out, np.shape(prompt_ids)[-1], eos)
    return out


def _build_llama_generate(entry: PoolEntry, device):
    from zest_tpu_torch.models.generate import eos_token_ids
    from zest_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.from_hf(entry.cfg_json)

    def layer_view(i: int) -> dict:
        pre = f"model.layers.{i}."
        P = entry.params
        lp = {
            "ln1": P[pre + "input_layernorm.weight"],
            "q_w": P[pre + "self_attn.q_proj.weight"].T,
            "k_w": P[pre + "self_attn.k_proj.weight"].T,
            "v_w": P[pre + "self_attn.v_proj.weight"].T,
            "o_w": P[pre + "self_attn.o_proj.weight"].T,
            "ln2": P[pre + "post_attention_layernorm.weight"],
            "gate_w": P[pre + "mlp.gate_proj.weight"].T,
            "up_w": P[pre + "mlp.up_proj.weight"].T,
            "down_w": P[pre + "mlp.down_proj.weight"].T,
        }
        for leaf, opt in (("q_b", "self_attn.q_proj.bias"),
                          ("k_b", "self_attn.k_proj.bias"),
                          ("v_b", "self_attn.v_proj.bias"),
                          ("o_b", "self_attn.o_proj.bias")):
            if pre + opt in P:
                lp[leaf] = P[pre + opt]
        return lp

    @torch.inference_mode()
    def generate(prompt_ids, steps, temperature=0.0, top_k=None, top_p=None,
                 seed=0, stop_at_eos=True, on_token=None, noise=None):
        present = frozenset(entry.expected)
        layer_names = [_llama_layer_names(i, present)
                       for i in range(cfg.n_layer)]
        tied = _HEAD not in present
        tail = {_NORM} | (set() if tied else {_HEAD})

        def forward(tokens, pos, caches):
            x = entry.params[_EMBED][tokens]
            for i, (ck, cv) in enumerate(caches):
                entry.wait_for(layer_names[i])
                x = _llama_layer_step(cfg, layer_view(i), x, ck, cv, pos)
            entry.wait_for(tail)
            hw = entry.params[_EMBED if tied else _HEAD]
            return _llama_head(cfg, x[:, -1, :], entry.params[_NORM],
                               hw).float()

        return _decode(entry, cfg, device, forward, prompt_ids, steps,
                       temperature, top_k, top_p, seed, stop_at_eos,
                       on_token, noise)

    generate.eos_ids = eos_token_ids(entry.cfg_json)
    return generate


def _build_moe_generate(entry: PoolEntry, device):
    from zest_tpu_torch.models.generate import eos_token_ids
    from zest_tpu_torch.models.moe import MoEConfig

    cfg = MoEConfig.from_hf(entry.cfg_json)

    def layer_view(i: int) -> dict:
        pre = f"model.layers.{i}."
        P = entry.params
        return {
            "ln1": P[pre + "input_layernorm.weight"],
            "q_w": P[pre + "self_attn.q_proj.weight"].T,
            "k_w": P[pre + "self_attn.k_proj.weight"].T,
            "v_w": P[pre + "self_attn.v_proj.weight"].T,
            "o_w": P[pre + "self_attn.o_proj.weight"].T,
            "ln2": P[pre + "post_attention_layernorm.weight"],
        }

    def moe_ffn(h2, layer: int):
        """The routed expert FFN over (B, S, E) with lazy paging: routing
        on the host (one sync a layer), then only the selected experts
        page in, accumulated in ascending expert index. Every token is
        routed (no capacity)."""
        B, S, E = h2.shape
        flat = h2.reshape(B * S, E)
        gate_w = entry.params[
            f"model.layers.{layer}.block_sparse_moe.gate.weight"]
        gate_vals, gate_idx = _moe_router(cfg, flat, gate_w)
        gv = gate_vals.cpu().numpy()            # (N, k) float32
        gi = gate_idx.cpu().numpy()             # (N, k)
        out = torch.zeros_like(flat)
        for e in sorted(set(gi.flatten().tolist())):
            weights = torch.from_numpy((gv * (gi == e)).sum(axis=-1))
            grp = entry.pager.get(layer, e)
            ffn = _expert_ffn(flat, grp["w1"], grp["w3"], grp["w2"])
            out = out + weights.to(flat.device, flat.dtype)[:, None] * ffn
        return out.reshape(B, S, E)

    @torch.inference_mode()
    def generate(prompt_ids, steps, temperature=0.0, top_k=None, top_p=None,
                 seed=0, stop_at_eos=True, on_token=None, noise=None):
        present = frozenset(entry.expected)
        layer_names = [_moe_layer_names(i, present)
                       for i in range(cfg.n_layer)]
        tail = {_NORM, _HEAD}

        def forward(tokens, pos, caches):
            x = entry.params[_EMBED][tokens]
            for i, (ck, cv) in enumerate(caches):
                entry.wait_for(layer_names[i])
                x, h2 = _moe_attn_step(cfg, layer_view(i), x, ck, cv, pos)
                x = x + moe_ffn(h2, i)
            entry.wait_for(tail)
            return _moe_head(cfg, x[:, -1, :], entry.params[_NORM],
                             entry.params[_HEAD]).float()

        return _decode(entry, cfg, device, forward, prompt_ids, steps,
                       temperature, top_k, top_p, seed, stop_at_eos,
                       on_token, noise)

    generate.eos_ids = eos_token_ids(entry.cfg_json)
    return generate


# ── Module-level singleton ──

_POOL: HbmPool | None = None
_POOL_LOCK = threading.Lock()


def pool(cfg, device=DEFAULT_DEVICE) -> HbmPool | None:
    """The process pool on ``device`` (created by the first call), or None
    when ``ZEST_HBM_POOL=0``: with no pool, serving takes the
    single-model path. A pool already living on another device raises
    ``ValueError``."""
    global _POOL
    if not getattr(cfg, "hbm_pool_enabled", False):
        return None
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = HbmPool(cfg, device)
            return _POOL
        want = torch.device(DEFAULT_DEVICE if device is None else device)
        if want.type != _POOL.device.type or (
                want.index is not None and want.index != _POOL.device.index):
            raise ValueError(f"the serving pool lives on {_POOL.device}, "
                             f"not {device}")
        return _POOL


def reset() -> None:
    """Tear down the singleton (tests): evict everything."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is not None:
            _POOL.close()
        _POOL = None
