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
``ZEST_HBM_POOL_BYTES`` and ``ZEST_SLO_TTFT_S``),
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

COLLECTIVE_BACKENDS = ("dcn", "jax", "loopback")

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
    # carries across). ``collective_lossy`` must stay "0": the lossy tier
    # (transfer/lossy.py) is not ported.
    coop_collective: bool = True
    coop_topology: tuple[int, ...] | None = None
    coop_pods: tuple[int, ...] | None = None
    collective_backend: str = "dcn"
    collective_lossy: str = "0"
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

    def __post_init__(self) -> None:
        if self.collective_backend not in COLLECTIVE_BACKENDS:
            raise ValueError(
                f"collective_backend must be one of "
                f"{'|'.join(COLLECTIVE_BACKENDS)}, got "
                f"{self.collective_backend!r}")
        if self.collective_lossy != "0":
            raise ValueError(
                f"collective_lossy={self.collective_lossy!r}: the lossy "
                "tier (transfer/lossy.py) is not ported; only '0' "
                "(byte-exact) runs")

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
            # The JAX package's values parse; __post_init__ refuses the
            # lossy ones.
            collective_lossy=_strict_choice(
                env, "ZEST_COLLECTIVE_LOSSY", "0", ("0", "dcn", "wan")),
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
