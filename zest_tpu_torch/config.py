"""Configuration: cache layout, token, endpoint, ports and device.

The subset of ``zest_tpu/config.py`` that the port reads, with the same
environment names (``HF_HOME``, ``ZEST_CACHE_DIR``, ``HF_TOKEN``,
``HF_ENDPOINT``, ``ZEST_HTTP_PORT``, ``ZEST_DCN_PORT``,
``ZEST_MAX_CONCURRENT``, ``ZEST_PUSH_CHUNKS_PER_XORB``, ``ZEST_COOP``,
``ZEST_COOP_HOSTS``, ``ZEST_COOP_INDEX``, ``ZEST_COOP_ADDRS``,
``ZEST_COOP_INFLIGHT``, the collective exchange's ``ZEST_COOP_COLLECTIVE``,
``ZEST_COOP_TOPOLOGY``, ``ZEST_COOP_PODS``, ``ZEST_COLLECTIVE_BACKEND`` and
``ZEST_COLLECTIVE_LOSSY``, the pod round's ``ZEST_TPU_HBM_STAGING``, and the
landing's ``ZEST_DECODE_WORKERS``,
``ZEST_DECODE_CACHE``, ``ZEST_LAND_AHEAD``, ``ZEST_LAND_STREAM``,
``ZEST_LAND_RING_BYTES``, ``ZEST_LAND_RING_SLOTS``, ``ZEST_FILES_ASYNC``,
``ZEST_FILES_WORKERS``, ``ZEST_PULL_INFLIGHT`` and ``ZEST_TPU_DTYPE``,
the delta pull's ``ZEST_DELTA``, the watch fan-out's ``ZEST_WATCH``, and
the peer tier's ``ZEST_LISTEN_PORT``, ``ZEST_MAX_PEERS``,
``ZEST_SEED_RATE_BPS``, ``ZEST_SEED_PEER_BPS``, ``ZEST_SEED_SLOTS``,
``ZEST_SEED_DEADLINE_S``, ``ZEST_SEED_DRAIN_S`` and
``ZEST_PULL_DEADLINE_S``, and the serving pool's ``ZEST_HBM_POOL``,
``ZEST_HBM_POOL_BYTES`` and ``ZEST_SLO_TTFT_S``, the pull service's
``ZEST_TENANCY``, ``ZEST_TENANT_MAX_PULLS``, ``ZEST_TENANT_QUEUE``,
``ZEST_TENANT_INFLIGHT``, ``ZEST_TENANT_DISK_HIGH``,
``ZEST_TENANT_DISK_LOW`` and ``ZEST_TENANT``, the pull SLOs'
``ZEST_SLO_TTHBM_S`` and ``ZEST_SLO_TTFL_S`` (the session table reads its
ring size, ``ZEST_SESSIONS_RECENT``, itself), and the landing mesh's
``ZEST_TPU_MESH``, ``ZEST_TPU_COORDINATOR``, ``ZEST_TPU_PROCESS_ID`` and
``ZEST_TPU_NUM_PROCESSES``, and the live timeline's and the
self-healing engine's ``ZEST_TIMELINE``, ``ZEST_TIMELINE_HZ``,
``ZEST_ANOMALY_WINDOW_S``, ``ZEST_REMEDIATE``,
``ZEST_REMEDIATE_ACTIONS``, ``ZEST_REMEDIATE_DRY``,
``ZEST_REMEDIATE_RATE_S`` and ``ZEST_REMEDIATE_BURST``),
the same defaults and the same HF cache layout, so a tree pulled by either
package reads the same on disk.

:func:`resolve_device` is the one place the port turns a device name into
a ``torch.device``: entry points run on ``cuda`` unless the caller asks
for ``cpu``, and asking for ``cuda`` where there is none raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from pathlib import Path

from zest_tpu_torch.telemetry.remediate import ACTIONS as REMEDIATE_ACTIONS
from zest_tpu_torch.telemetry.state import _OFF_VALUES as _TELEMETRY_OFF_VALUES
from zest_tpu_torch.telemetry.timeline import (
    DEFAULT_HZ as DEFAULT_TIMELINE_HZ,
    DEFAULT_WINDOW_S as DEFAULT_ANOMALY_WINDOW_S,
)

DEFAULT_LISTEN_PORT = 6881          # BT seeding listener
DEFAULT_HTTP_PORT = 9847            # localhost REST / publisher endpoint
DEFAULT_DCN_PORT = 6991             # host-to-host chunk RPC listener
DEFAULT_HBM_STAGING_BYTES = 2 << 30  # the pod round's per-wave pool budget
DEFAULT_COOP_INFLIGHT_BYTES = 1 << 30
DEFAULT_MAX_CONCURRENT_DOWNLOADS = 16
DEFAULT_MAX_PEERS = 50              # peer connection-pool cap
# Seeding-tier upload policy (transfer/server.py): SEED_SLOTS reciprocal
# unchoke slots (+1 optimistic) bound concurrent uploads; a response must
# finish within SEED_DEADLINE_S; shutdown drains in-flight uploads for
# up to SEED_DRAIN_S. Rates are bytes/s, 0 = unshaped.
DEFAULT_SEED_SLOTS = 8
DEFAULT_SEED_DEADLINE_S = 30.0
DEFAULT_SEED_DRAIN_S = 5.0
DEFAULT_DEVICE = "cuda"
DEFAULT_PULL_INFLIGHT_BYTES = 2 << 30  # in-flight file-write byte budget
# Decode parallelism (ZEST_DECODE_WORKERS): 0 = auto, 1 = serial; sizes
# the term-decode pool and the native batch decoder's threads.
DEFAULT_DECODE_WORKERS = 0
DEFAULT_LAND_DECODE_AHEAD = 1       # shards decoded ahead of the commit
# Parsed cache-entry reader LRU of the landing's decode (ZEST_DECODE_CACHE,
# bytes; 0 disables): one ~unit-sized entry serves many terms.
DEFAULT_DECODE_CACHE_BYTES = 192 * 1024 * 1024
# Write-behind handoff (ZEST_FILES_ASYNC): 1 never blocks the landing (a
# full byte budget declines to the post-landing file lane); 0 blocks.
DEFAULT_FILES_ASYNC = True
DEFAULT_FILES_WORKERS = 0           # file writers at once; 0 = auto
# Streaming landing (ZEST_LAND_STREAM, strictly 0 or 1): tensors decode
# into a ring of reusable pinned host slots and commit in layer order;
# 0 lands shard by shard. The ring holds ZEST_LAND_RING_BYTES in at most
# ZEST_LAND_RING_SLOTS slots; a tensor larger than the ring is admitted
# alone.
DEFAULT_LAND_STREAM = True
DEFAULT_LAND_RING_BYTES = 512 * 1024 * 1024
DEFAULT_LAND_RING_SLOTS = 64
# Delta pulls (ZEST_DELTA, strictly 0 or 1): a pull of revision B over a
# locally evidenced revision A fetches only changed chunks and, with a
# resident tree, swaps it in place; 0 runs every pull in full and writes
# no revision manifest.
DEFAULT_DELTA = True
# The serving pool (models/hbm_pool.py; ZEST_HBM_POOL, strictly 0 or 1):
# with 1 the daemon's /v1/generate serves Llama-family and Mixtral models
# from a process-wide pool of resident trees held under the
# ZEST_HBM_POOL_BYTES watermark (0 = unbounded); 0 serves every model on
# the single-model path. ZEST_SLO_TTFT_S arms a time-to-first-token
# budget (unset or 0: unarmed).
DEFAULT_HBM_POOL = True
DEFAULT_HBM_POOL_BYTES = 2 << 30
# The multi-tenant pull service (transfer/tenancy.py): singleflight fetch
# dedupe, fair admission and xorb-cache eviction shared by every pull of
# the process. ZEST_TENANCY=0 (strictly 0 or 1) runs every pull on its
# own. ZEST_TENANT_MAX_PULLS bounds admitted pulls, ZEST_TENANT_QUEUE the
# parked ones (beyond it a pull is rejected with a retry-after: HTTP
# 429); ZEST_TENANT_INFLIGHT is the in-flight file-write byte budget
# every admitted pull draws from, on top of its own ZEST_PULL_INFLIGHT.
# ZEST_TENANT_DISK_HIGH / ZEST_TENANT_DISK_LOW are the xorb cache's byte
# watermarks: above HIGH, unpinned entries are evicted oldest-read first
# down to LOW (0 = unarmed; LOW defaults to 80% of HIGH). ZEST_TENANT
# labels this process' pull sessions.
DEFAULT_TENANCY = True
DEFAULT_TENANT_MAX_PULLS = 4
DEFAULT_TENANT_QUEUE = 16
DEFAULT_TENANT_INFLIGHT_BYTES = 4 << 30

COLLECTIVE_BACKENDS = ("dcn", "jax", "loopback")
COLLECTIVE_LOSSY_MODES = ("0", "dcn", "wan")

_REPO_RE = re.compile(r"^[\w.\-]+/[\w.\-]+$")


def resolve_device(device: str | None = DEFAULT_DEVICE):
    """``"cuda"`` (the default) or ``"cpu"`` → ``torch.device``.

    No silent fallback: ``cuda`` on a machine without a usable card
    raises ``RuntimeError``."""
    import torch

    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device()
                            if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def _expand(p: str) -> Path:
    return Path(os.path.expanduser(p))


def _nonneg_int(env: dict[str, str], name: str, default: int) -> int:
    raw = env.get(name)
    if raw is None or not raw.strip():
        return default
    value = int(raw)
    if value < 0:
        raise ValueError(f"{name} must be >= 0, got {value}")
    return value


def _strict_nonneg_int(env: dict[str, str], name: str,
                       default: int = 0, floor: int = 0) -> int:
    """Integer knob where a value below ``floor`` raises instead of being
    clamped: a sign-slipped ``ZEST_SEED_RATE_BPS=-25000000`` silently
    meaning "unshaped" would pass every test while uplinks saturate."""
    raw = env.get(name)
    if raw is None or not raw.strip():
        return default
    v = int(raw)
    if v < floor:
        raise ValueError(f"{name} must be an integer >= {floor}, "
                         f"got {raw!r}")
    return v


def _strict_pos_float(env: dict[str, str], name: str,
                      default: float, floor: float = 0.0) -> float:
    """Float knob; values below ``floor`` (or non-finite) raise."""
    raw = env.get(name)
    if raw is None or not raw.strip():
        return default
    v = float(raw)
    if v < floor or not math.isfinite(v):
        raise ValueError(f"{name} must be a finite value >= {floor}, "
                         f"got {raw!r}")
    return v


def _opt_pos_float(env: dict[str, str], name: str) -> float | None:
    """Optional positive float knob: unset, empty or 0 = unarmed (None);
    a malformed or negative value raises (a mistyped budget must not
    silently disarm it)."""
    raw = env.get(name)
    if raw is None or not raw.strip():
        return None
    v = float(raw)
    if v < 0 or not math.isfinite(v):
        raise ValueError(f"{name} must be a finite value >= 0 "
                         f"(0 = unarmed), got {raw!r}")
    return v if v > 0 else None


def _parse_remediate_actions(spec: str) -> tuple[str, ...] | None:
    """The ``ZEST_REMEDIATE_ACTIONS`` enable mask, strictly: empty or
    ``all`` is every action (None); otherwise each name must be a known
    action, since a typo would silently disarm a remediation the
    operator thinks is armed. (The engine's own ``parse_actions`` stays
    lenient: a typo must not crash a pull.)"""
    spec = (spec or "").strip().lower()
    if not spec or spec == "all":
        return None
    names = tuple(p.strip() for p in spec.split(",") if p.strip())
    bad = sorted(set(names) - set(REMEDIATE_ACTIONS))
    if bad:
        raise ValueError(
            f"ZEST_REMEDIATE_ACTIONS names unknown action(s) {bad}; "
            f"valid: {', '.join(REMEDIATE_ACTIONS)}")
    return names


def _strict_bool(name: str, value: str) -> bool:
    """``"0"`` or ``"1"``; anything else raises, so a typo can never
    leave a rollback knob silently on."""
    v = value.strip()
    if v not in ("0", "1"):
        raise ValueError(f"{name} must be 0 or 1, got {value!r}")
    return v == "1"


def _strict_choice(env: dict[str, str], name: str, default: str,
                   choices: tuple[str, ...]) -> str:
    """An enumerated knob: unset or empty is ``default``; anything outside
    ``choices`` raises (a mistyped backend must not fall back quietly)."""
    raw = env.get(name)
    if raw is None or not raw.strip():
        return default
    v = raw.strip()
    if v not in choices:
        raise ValueError(
            f"{name} must be one of {'|'.join(choices)}, got {raw!r}")
    return v


def parse_topology(spec: str) -> tuple[int, ...]:
    """``"0,0,1,1"`` -> ``(0, 0, 1, 1)``: the slice id per coop host index
    (``ZEST_COOP_TOPOLOGY``; ``transfer/collective.py`` classes each
    exchange link ici or dcn from it). Malformed or negative entries
    raise: a dropped host would misclass every one of its links."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part.isdigit():
            raise ValueError(
                f"bad ZEST_COOP_TOPOLOGY entry {part!r} "
                "(want comma-separated slice ids, e.g. 0,0,1,1)")
        out.append(int(part))
    if not out:
        raise ValueError("ZEST_COOP_TOPOLOGY is empty")
    return tuple(out)


def _opt_topology(env: dict[str, str], name: str) -> tuple[int, ...] | None:
    raw = env.get(name, "")
    return parse_topology(raw) if raw.strip() else None


def parse_host_addr(spec: str) -> tuple[int, tuple[str, int]]:
    """``"2=hostB:6991"`` -> ``(2, ("hostB", 6991))``."""
    idx, sep, addr = spec.strip().partition("=")
    host, _, port = addr.rpartition(":")
    if not (sep and idx.strip().isdigit() and host and port.isdigit()):
        raise ValueError(f"bad host-addr entry: {spec!r} "
                         "(want IDX=HOST:PORT)")
    return int(idx), (host, int(port))


def _parse_coop_addrs(spec: str) -> dict[int, tuple[str, int]]:
    """``"0=hostA:6991,1=hostB:6991"`` -> {0: ("hostA", 6991), ...}."""
    out: dict[int, tuple[str, int]] = {}
    for part in spec.split(","):
        if part.strip():
            idx, addr = parse_host_addr(part)
            out[idx] = addr
    return out


@dataclasses.dataclass
class MeshConfig:
    """The landing mesh of this process (``parallel/mesh.py``): the
    coordinator address, this process's index and the process count (for
    ``torch.distributed``), and the named mesh axes a pull lands its tree
    over, e.g. ``{"data": 2, "model": 4}``. Parsed as the JAX package
    parses it, with the same errors on bad input."""

    coordinator: str | None = None       # "host:port"
    process_id: int = 0
    num_processes: int = 1
    # Named mesh axes, in order: earlier axes are the slower dimension.
    mesh_axes: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @staticmethod
    def from_env(env: dict[str, str]) -> "MeshConfig":
        axes: dict[str, int] = {}
        spec = env.get("ZEST_TPU_MESH", "")
        # Format: "data=2,model=4" (axis order is significant).
        if spec:
            for part in spec.split(","):
                name, _, n = part.partition("=")
                axes[name.strip()] = int(n)
        return MeshConfig(
            coordinator=env.get("ZEST_TPU_COORDINATOR") or None,
            process_id=int(env.get("ZEST_TPU_PROCESS_ID", "0")),
            num_processes=int(env.get("ZEST_TPU_NUM_PROCESSES", "1")),
            mesh_axes=axes,
        )


@dataclasses.dataclass
class Config:
    """Resolved runtime configuration. Build with :meth:`Config.load` so
    environment overrides apply; construct directly in tests."""

    hf_home: Path
    cache_dir: Path                      # zest-private cache root
    hf_token: str | None = None
    http_port: int = DEFAULT_HTTP_PORT
    dcn_port: int = DEFAULT_DCN_PORT
    max_concurrent_downloads: int = DEFAULT_MAX_CONCURRENT_DOWNLOADS
    # Caps chunks packed per minted xorb (0 = format caps only).
    push_chunks_per_xorb: int = 0
    endpoint: str = "https://huggingface.co"
    # Cooperative pull (transfer/coop.py). ``coop_pull`` is tri-state:
    # True/False force it on/off (ZEST_COOP=1/0), None = on when more
    # than one host is known. ``coop_addrs`` maps host index -> (host,
    # dcn_port) (ZEST_COOP_ADDRS="0=h:p,1=h:p").
    coop_pull: bool | None = None
    coop_hosts: int | None = None
    coop_index: int | None = None
    coop_addrs: dict[int, tuple[str, int]] = dataclasses.field(
        default_factory=dict)
    coop_inflight_bytes: int = DEFAULT_COOP_INFLIGHT_BYTES
    # The collective exchange (transfer/collective.py). ``coop_collective``
    # (ZEST_COOP_COLLECTIVE, strict 0/1) runs it before the point-to-point
    # exchange, which 0 alone restores; ``coop_topology`` and
    # ``coop_pods`` are the slice and pod id per coop host (None: one
    # flat slice, one pod); ``collective_backend`` (dcn|jax|loopback)
    # picks how its phase windows move ("jax" is the device-lane
    # transport, the JAX package's name kept so a node's environment
    # carries across). ``collective_lossy`` (ZEST_COLLECTIVE_LOSSY,
    # 0|dcn|wan) arms the quantized tier (transfer/lossy.py) on the named
    # link classes ("dcn" covers wan too); lossy payloads land in the
    # staging overlay only, never in the xorb cache.
    coop_collective: bool = True
    coop_topology: tuple[int, ...] | None = None
    coop_pods: tuple[int, ...] | None = None
    collective_backend: str = "dcn"
    collective_lossy: str = "0"
    # Fleet gossip (transfer/gossip.py): ``gossip_enabled`` (ZEST_GOSSIP,
    # strict 0/1) is the rollback knob — 0 builds no node anywhere, so
    # tracker/DHT announce and the stats schema stay as without gossip;
    # ``gossip_fanout`` peers per anti-entropy tick (ZEST_GOSSIP_FANOUT,
    # 0 = auto, ceil(log2 N)); ``gossip_max_entries`` bounds the digest
    # (ZEST_GOSSIP_MAX, >= 1); ``gossip_interval_s`` is the daemon's
    # tick cadence (ZEST_GOSSIP_INTERVAL_S, >= 0.05).
    gossip_enabled: bool = True
    gossip_fanout: int = 0
    gossip_max_entries: int = 65536
    gossip_interval_s: float = 5.0
    # Pod observability (telemetry.fleet): the other hosts' daemon HTTP
    # endpoints, ``ZEST_POD_PEERS="1=hostB:9847,2=hostC:9847"`` (the coop
    # address grammar), scraped for ``/v1/metrics?scope=pod`` and by
    # ``zest trace --coop``; ``pod_scrape_workers`` bounds the one shared
    # scrape pool (ZEST_POD_SCRAPE_WORKERS).
    pod_peers: dict[int, tuple[str, int]] = dataclasses.field(
        default_factory=dict)
    pod_scrape_workers: int = 8
    # The pod round (transfer/pod.py): each wave's staged pool fits this
    # many bytes (ZEST_TPU_HBM_STAGING; 0 = one wave).
    hbm_staging_bytes: int = DEFAULT_HBM_STAGING_BYTES
    # The landing (models/loader.py, models/direct.py) and the file
    # pipeline (transfer/pull.py).
    pull_inflight_bytes: int = DEFAULT_PULL_INFLIGHT_BYTES
    decode_workers: int = DEFAULT_DECODE_WORKERS
    land_decode_ahead: int = DEFAULT_LAND_DECODE_AHEAD
    decode_cache_bytes: int = DEFAULT_DECODE_CACHE_BYTES
    land_stream: bool = DEFAULT_LAND_STREAM
    land_ring_bytes: int = DEFAULT_LAND_RING_BYTES
    land_ring_slots: int = DEFAULT_LAND_RING_SLOTS
    files_async: bool = DEFAULT_FILES_ASYNC
    files_workers: int = DEFAULT_FILES_WORKERS
    # Floating tensors land in this dtype (bf16, f16, f32; None keeps the
    # checkpoint's). The variable keeps the JAX package's name.
    land_dtype: str | None = None
    # Delta pulls (see DEFAULT_DELTA above).
    delta_pull: bool = DEFAULT_DELTA
    # ``POST /v1/watch`` and the ``/v1/push`` fan-out of the publisher
    # (ZEST_WATCH, strict 0/1): 0 answers watch with 404 and notifies no
    # one; pushes still publish.
    watch_enabled: bool = True
    # The peer tier: the BT seeding listener (``serve --listen-port``; the
    # port a pull advertises in its handshake), the swarm's connection
    # pool cap, and the seeding server's upload policy (see
    # DEFAULT_SEED_* above).
    listen_port: int = DEFAULT_LISTEN_PORT
    max_peers: int = DEFAULT_MAX_PEERS
    seed_rate_bps: int = 0
    seed_peer_bps: int = 0
    seed_slots: int = DEFAULT_SEED_SLOTS
    seed_request_deadline_s: float = DEFAULT_SEED_DEADLINE_S
    seed_drain_s: float = DEFAULT_SEED_DRAIN_S
    # Per-pull wall-clock budget in seconds (ZEST_PULL_DEADLINE_S;
    # None/0 = off). When armed, every tier's timeouts and retry sleeps
    # are capped by the remaining budget and the bridge hedges slow peer
    # fetches against the CDN.
    pull_deadline_s: float | None = None
    # The serving pool (see DEFAULT_HBM_POOL above).
    hbm_pool_enabled: bool = DEFAULT_HBM_POOL
    hbm_pool_bytes: int = DEFAULT_HBM_POOL_BYTES
    slo_ttft_s: float | None = None
    # The pull service (see DEFAULT_TENANCY above).
    tenancy_enabled: bool = DEFAULT_TENANCY
    tenant_max_pulls: int = DEFAULT_TENANT_MAX_PULLS
    tenant_queue: int = DEFAULT_TENANT_QUEUE
    tenant_inflight_bytes: int = DEFAULT_TENANT_INFLIGHT_BYTES
    tenant_disk_high: int = 0
    tenant_disk_low: int = 0
    # The tenant label of this process' pull sessions (an API request's
    # ``tenant`` overrides it per pull), and the pull SLO budgets in
    # seconds: time to HBM and time to the first layer (None = unarmed).
    tenant: str | None = None
    slo_tthbm_s: float | None = None
    slo_ttfl_s: float | None = None
    # Live timelines and the self-healing engine: the sampler and the
    # engine read the environment themselves (leniently), and nothing
    # reads these fields; they give a strict check when the config loads.
    # The rate and window parse strictly here (a daemon started with a
    # mistyped sampling rate fails loud), as does the action mask (None =
    # every action).
    timeline_enabled: bool = True
    timeline_hz: float = DEFAULT_TIMELINE_HZ
    anomaly_window_s: float = DEFAULT_ANOMALY_WINDOW_S
    remediate_enabled: bool = True
    remediate_actions: tuple[str, ...] | None = None
    remediate_dry_run: bool = False
    remediate_rate_s: float = 10.0
    remediate_burst: int = 3
    # The landing mesh (ZEST_TPU_MESH and the process topology).
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def __post_init__(self) -> None:
        if self.collective_backend not in COLLECTIVE_BACKENDS:
            raise ValueError(
                f"collective_backend must be one of "
                f"{'|'.join(COLLECTIVE_BACKENDS)}, got "
                f"{self.collective_backend!r}")
        if self.collective_lossy not in COLLECTIVE_LOSSY_MODES:
            raise ValueError(
                f"collective_lossy must be one of "
                f"{'|'.join(COLLECTIVE_LOSSY_MODES)}, got "
                f"{self.collective_lossy!r}")

    @staticmethod
    def load(env: dict[str, str] | None = None) -> "Config":
        """Resolve config from the environment. Token order: ``HF_TOKEN``,
        then ``$HF_HOME/token``."""
        env = dict(os.environ) if env is None else env
        hf_home = _expand(env.get("HF_HOME", "~/.cache/huggingface"))
        token = env.get("HF_TOKEN") or None
        if not token:
            try:
                token = (hf_home / "token").read_text().strip() or None
            except OSError:
                token = None
        # The eviction watermarks are checked against each other, not
        # clamped: LOW >= HIGH would make every pass free nothing, and LOW
        # without HIGH silently leaves eviction unarmed.
        disk_high = _strict_nonneg_int(env, "ZEST_TENANT_DISK_HIGH")
        disk_low = _strict_nonneg_int(env, "ZEST_TENANT_DISK_LOW")
        if disk_low and not disk_high:
            raise ValueError(
                "ZEST_TENANT_DISK_LOW is set but ZEST_TENANT_DISK_HIGH "
                "is not: eviction arms on HIGH — a LOW alone would "
                "silently do nothing")
        if disk_high and disk_low >= disk_high:
            raise ValueError(
                f"ZEST_TENANT_DISK_LOW ({disk_low}) must be below "
                f"ZEST_TENANT_DISK_HIGH ({disk_high}): an inverted "
                "pair would trigger eviction passes that free nothing")
        return Config(
            hf_home=hf_home,
            cache_dir=_expand(env.get("ZEST_CACHE_DIR", "~/.cache/zest")),
            hf_token=token,
            http_port=_nonneg_int(env, "ZEST_HTTP_PORT", DEFAULT_HTTP_PORT),
            dcn_port=_nonneg_int(env, "ZEST_DCN_PORT", DEFAULT_DCN_PORT),
            max_concurrent_downloads=max(1, _nonneg_int(
                env, "ZEST_MAX_CONCURRENT",
                DEFAULT_MAX_CONCURRENT_DOWNLOADS)),
            push_chunks_per_xorb=_nonneg_int(
                env, "ZEST_PUSH_CHUNKS_PER_XORB", 0),
            endpoint=env.get("HF_ENDPOINT", "https://huggingface.co"),
            coop_pull={"1": True, "0": False}.get(
                env.get("ZEST_COOP", "").strip()),
            coop_hosts=(int(env["ZEST_COOP_HOSTS"])
                        if env.get("ZEST_COOP_HOSTS") else None),
            coop_index=(int(env["ZEST_COOP_INDEX"])
                        if env.get("ZEST_COOP_INDEX") else None),
            coop_addrs=_parse_coop_addrs(env.get("ZEST_COOP_ADDRS", "")),
            coop_inflight_bytes=max(1, int(
                env.get("ZEST_COOP_INFLIGHT")
                or DEFAULT_COOP_INFLIGHT_BYTES)),
            coop_collective=_strict_bool(
                "ZEST_COOP_COLLECTIVE",
                env.get("ZEST_COOP_COLLECTIVE", "1")),
            coop_topology=_opt_topology(env, "ZEST_COOP_TOPOLOGY"),
            coop_pods=_opt_topology(env, "ZEST_COOP_PODS"),
            collective_backend=_strict_choice(
                env, "ZEST_COLLECTIVE_BACKEND", "dcn", COLLECTIVE_BACKENDS),
            collective_lossy=_strict_choice(
                env, "ZEST_COLLECTIVE_LOSSY", "0", COLLECTIVE_LOSSY_MODES),
            gossip_enabled=_strict_bool(
                "ZEST_GOSSIP", env.get("ZEST_GOSSIP", "1")),
            gossip_fanout=_strict_nonneg_int(env, "ZEST_GOSSIP_FANOUT"),
            gossip_max_entries=_strict_nonneg_int(
                env, "ZEST_GOSSIP_MAX", default=65536, floor=1),
            gossip_interval_s=_strict_pos_float(
                env, "ZEST_GOSSIP_INTERVAL_S", 5.0, floor=0.05),
            pod_peers=_parse_coop_addrs(env.get("ZEST_POD_PEERS", "")),
            pod_scrape_workers=_strict_nonneg_int(
                env, "ZEST_POD_SCRAPE_WORKERS", default=8, floor=1),
            hbm_staging_bytes=_nonneg_int(
                env, "ZEST_TPU_HBM_STAGING", DEFAULT_HBM_STAGING_BYTES),
            pull_inflight_bytes=max(1, int(
                env.get("ZEST_PULL_INFLIGHT", DEFAULT_PULL_INFLIGHT_BYTES))),
            decode_workers=max(0, int(
                env.get("ZEST_DECODE_WORKERS", DEFAULT_DECODE_WORKERS))),
            land_decode_ahead=max(0, int(
                env.get("ZEST_LAND_AHEAD", DEFAULT_LAND_DECODE_AHEAD))),
            decode_cache_bytes=max(0, int(
                env.get("ZEST_DECODE_CACHE", DEFAULT_DECODE_CACHE_BYTES))),
            land_stream=_strict_bool(
                "ZEST_LAND_STREAM",
                env.get("ZEST_LAND_STREAM",
                        "1" if DEFAULT_LAND_STREAM else "0")),
            land_ring_bytes=max(1, int(
                env.get("ZEST_LAND_RING_BYTES", DEFAULT_LAND_RING_BYTES))),
            land_ring_slots=max(1, int(
                env.get("ZEST_LAND_RING_SLOTS", DEFAULT_LAND_RING_SLOTS))),
            files_async=env.get(
                "ZEST_FILES_ASYNC",
                "1" if DEFAULT_FILES_ASYNC else "0").strip() != "0",
            files_workers=max(0, int(
                env.get("ZEST_FILES_WORKERS", DEFAULT_FILES_WORKERS))),
            land_dtype=env.get("ZEST_TPU_DTYPE") or None,
            # Strict like ZEST_LAND_STREAM: a typo must never leave the
            # rollback knob silently on.
            delta_pull=_strict_bool(
                "ZEST_DELTA",
                env.get("ZEST_DELTA", "1" if DEFAULT_DELTA else "0")),
            watch_enabled=_strict_bool("ZEST_WATCH",
                                       env.get("ZEST_WATCH", "1")),
            listen_port=int(env.get("ZEST_LISTEN_PORT",
                                    DEFAULT_LISTEN_PORT)),
            max_peers=int(env.get("ZEST_MAX_PEERS", DEFAULT_MAX_PEERS)),
            # Malformed AND negative values raise: a sign-slipped rate
            # silently meaning "unshaped" would pass every test.
            seed_rate_bps=_strict_nonneg_int(env, "ZEST_SEED_RATE_BPS"),
            seed_peer_bps=_strict_nonneg_int(env, "ZEST_SEED_PEER_BPS"),
            seed_slots=_strict_nonneg_int(
                env, "ZEST_SEED_SLOTS", DEFAULT_SEED_SLOTS, floor=1),
            seed_request_deadline_s=_strict_pos_float(
                env, "ZEST_SEED_DEADLINE_S", DEFAULT_SEED_DEADLINE_S,
                floor=0.1),
            seed_drain_s=_strict_pos_float(
                env, "ZEST_SEED_DRAIN_S", DEFAULT_SEED_DRAIN_S),
            pull_deadline_s=(
                float(env["ZEST_PULL_DEADLINE_S"])
                if float(env.get("ZEST_PULL_DEADLINE_S") or 0) > 0
                else None),
            # Strict: ZEST_HBM_POOL is the pool's rollback knob, and a
            # sign-slipped watermark must not mean "unbounded".
            hbm_pool_enabled=_strict_bool(
                "ZEST_HBM_POOL",
                env.get("ZEST_HBM_POOL", "1" if DEFAULT_HBM_POOL else "0")),
            hbm_pool_bytes=_strict_nonneg_int(
                env, "ZEST_HBM_POOL_BYTES", DEFAULT_HBM_POOL_BYTES),
            slo_ttft_s=_opt_pos_float(env, "ZEST_SLO_TTFT_S"),
            # Strict: ZEST_TENANCY is the pull service's rollback knob,
            # and a sign-slipped budget must not mean tiny or unbounded.
            tenancy_enabled=_strict_bool(
                "ZEST_TENANCY",
                env.get("ZEST_TENANCY", "1" if DEFAULT_TENANCY else "0")),
            tenant_max_pulls=_strict_nonneg_int(
                env, "ZEST_TENANT_MAX_PULLS", DEFAULT_TENANT_MAX_PULLS,
                floor=1),
            tenant_queue=_strict_nonneg_int(
                env, "ZEST_TENANT_QUEUE", DEFAULT_TENANT_QUEUE),
            tenant_inflight_bytes=_strict_nonneg_int(
                env, "ZEST_TENANT_INFLIGHT",
                DEFAULT_TENANT_INFLIGHT_BYTES, floor=1),
            tenant_disk_high=disk_high,
            tenant_disk_low=disk_low,
            tenant=env.get("ZEST_TENANT") or None,
            slo_tthbm_s=_opt_pos_float(env, "ZEST_SLO_TTHBM_S"),
            slo_ttfl_s=_opt_pos_float(env, "ZEST_SLO_TTFL_S"),
            timeline_enabled=env.get("ZEST_TIMELINE", "").strip().lower()
            not in _TELEMETRY_OFF_VALUES,
            timeline_hz=_strict_pos_float(
                env, "ZEST_TIMELINE_HZ", DEFAULT_TIMELINE_HZ, floor=0.01),
            anomaly_window_s=_strict_pos_float(
                env, "ZEST_ANOMALY_WINDOW_S", DEFAULT_ANOMALY_WINDOW_S,
                floor=0.05),
            remediate_enabled=env.get("ZEST_REMEDIATE", "").strip().lower()
            not in _TELEMETRY_OFF_VALUES,
            remediate_actions=_parse_remediate_actions(
                env.get("ZEST_REMEDIATE_ACTIONS", "")),
            remediate_dry_run=env.get(
                "ZEST_REMEDIATE_DRY", "").strip().lower()
            in ("1", "true", "yes", "on"),
            remediate_rate_s=_strict_pos_float(
                env, "ZEST_REMEDIATE_RATE_S", 10.0, floor=0.01),
            remediate_burst=_strict_nonneg_int(
                env, "ZEST_REMEDIATE_BURST", default=3, floor=1),
            mesh=MeshConfig.from_env(env),
        )

    # ── HF cache layout ──

    def hub_dir(self) -> Path:
        return self.hf_home / "hub"

    def model_cache_dir(self, repo_id: str) -> Path:
        """``hub/models--{org}--{name}``."""
        if not _REPO_RE.match(repo_id):
            raise ValueError(f"invalid repo id: {repo_id!r}")
        return self.hub_dir() / ("models--" + repo_id.replace("/", "--"))

    def model_snapshot_dir(self, repo_id: str, commit_sha: str) -> Path:
        return self.model_cache_dir(repo_id) / "snapshots" / commit_sha

    def model_refs_dir(self, repo_id: str) -> Path:
        return self.model_cache_dir(repo_id) / "refs"

    def xorb_cache_dir(self) -> Path:
        return self.cache_dir / "xorbs"

    def xorb_cache_path(self, hash_hex: str) -> Path:
        """``xorbs/{2-char prefix}/{hash}``."""
        return self.xorb_cache_dir() / hash_hex[:2] / hash_hex

    def http_port_file(self) -> Path:
        """Where a ``serve`` daemon records the HTTP port it bound (its
        ``http_port`` may be 0, "bind ephemeral")."""
        return self.cache_dir / "zest.http_port"

    def effective_http_port(self) -> int:
        """The daemon's HTTP port: a concrete ``http_port`` wins; with 0
        the port the daemon recorded, else 0."""
        if self.http_port != 0:
            return self.http_port
        try:
            return int(self.http_port_file().read_text().strip())
        except (OSError, ValueError):
            return self.http_port

    def chunk_cache_path(self, hash_hex: str) -> Path:
        """``chunks/{2-char prefix}/{hash}``."""
        return self.cache_dir / "chunks" / hash_hex[:2] / hash_hex
