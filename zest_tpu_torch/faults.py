"""Deterministic fault injection for the fetch path (the chaos harness).

The port's copy of ``zest_tpu/faults.py``, with its process-registry
counter (``zest_faults_fired_total``) and ``fault_fired`` flight-recorder
event. The resilience
layer (adaptive timeouts, retries, hedging, peer health scoring) is only
trustworthy if its failure handling is *provoked* on demand,
reproducibly. This registry injects failures at fixed points in the
waterfall — peer connect/IO, swarm chunk data, CDN GETs, DCN channels,
the seeding server — from one env-configurable spec:

    ZEST_FAULTS="peer_timeout:0.1,chunk_corrupt:0.05,cdn_503:0.2"
    ZEST_FAULTS_SEED=1337

A seeder in its own process (``python -m zest_tpu_torch serve``) is
configured through that environment.

Spec grammar: comma-separated ``name:prob[@arg[@arg...]]``. ``prob`` is
the firing probability in [0, 1]. Args are fault-specific and
position-free: an arg that parses as a float is the fault's numeric
parameter (e.g. ``peer_slow:1.0@2.5`` sleeps 2.5 s), any other arg is a
*scope filter* — the fault only fires at sites whose key (``host:port``
for peer-scoped faults) contains it (``chunk_corrupt:1.0@127.0.0.1:7001``
corrupts only that peer's chunks).

Registered fault names (injection sites):

==================  =====================================================
``peer_timeout``    ``BtPeer.connect`` raises ``TimeoutError`` pre-dial;
                    also fired per exchange window in the cooperative
                    round (transfer.coop — a silent owner host)
``peer_slow``       ``BtPeer.request_chunk`` sleeps *arg* seconds (1.0)
``chunk_corrupt``   swarm flips a byte in a successful peer response
``cdn_503``         ``CasClient`` GET observes an injected 503
``cdn_reset``       ``CasClient`` GET raises a connection reset
``dcn_reset``       ``DcnChannel.send_request`` dies mid-channel
``seeder_stall``    ``BtServer._respond`` sleeps *arg* seconds (2.0)
                    mid-upload — the per-request deadline must free the
                    slot WITHOUT blaming the reader (the server
                    stalled); pullers that time out on a leased peer
                    strike it as ``seed_stall``
``seeder_choke_flap``  ``_ChokeBook.slot`` reports a spurious one-query
                    choke — the requester's swarm must move on without
                    a strike and the pull must still complete
``upload_corrupt``  ``BtServer._respond`` flips a byte in the served
                    payload — the puller's verify tiers must reject it
                    (corrupt-bytes-admitted stays 0) and heal via CDN
==================  =====================================================

Determinism: each fault keeps a monotonically increasing trial counter;
trial ``n`` fires iff ``blake2b(seed:name:n)`` maps below ``prob``. The
firing *sequence* for a fault is therefore a pure function of
``(seed, name)`` — independent of wall clock, of other faults' traffic,
and of thread interleaving *across* faults (threads racing the same
fault draw disjoint trials from the same fixed sequence). Chaos tests
pin the seed, so a failure replays exactly.

Zero-cost when disabled: ``fire()`` is one global load and a ``None``
check — no parsing, no hashing, no locks on the hot path.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

from zest_tpu_torch import telemetry

ENV_SPEC = "ZEST_FAULTS"
ENV_SEED = "ZEST_FAULTS_SEED"

# Fired faults also land in the process registry, so a chaos run can
# assert from /v1/metrics that the fault really fired.
_M_FIRED = telemetry.counter(
    "zest_faults_fired_total", "Injected faults fired, by fault name",
    ("fault",))


class FaultSpecError(ValueError):
    """Malformed ZEST_FAULTS spec (fail loud: a typo silently disabling
    the chaos matrix would pass every test for the wrong reason)."""


class FaultSpec:
    """One parsed ``name:prob[@arg...]`` clause."""

    __slots__ = ("name", "prob", "args")

    def __init__(self, name: str, prob: float, args: tuple[str, ...] = ()):
        if not name:
            raise FaultSpecError("empty fault name")
        if not 0.0 <= prob <= 1.0:
            raise FaultSpecError(f"{name}: probability {prob} not in [0,1]")
        self.name = name
        self.prob = prob
        self.args = args

    def float_arg(self, default: float) -> float:
        """First numeric arg, or ``default``."""
        for a in self.args:
            try:
                return float(a)
            except ValueError:
                continue
        return default

    def scope(self) -> str | None:
        """First non-numeric arg: the site-key filter, if any."""
        for a in self.args:
            try:
                float(a)
            except ValueError:
                return a
        return None


def parse_spec(spec: str) -> dict[str, FaultSpec]:
    out: dict[str, FaultSpec] = {}
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        name, sep, rest = clause.partition(":")
        if not sep:
            raise FaultSpecError(f"clause {clause!r} missing ':prob'")
        parts = rest.split("@")
        try:
            prob = float(parts[0])
        except ValueError as exc:
            raise FaultSpecError(
                f"clause {clause!r}: bad probability {parts[0]!r}"
            ) from exc
        out[name.strip()] = FaultSpec(
            name.strip(), prob, tuple(p for p in parts[1:] if p)
        )
    return out


class FaultInjector:
    """Seeded registry; ``roll`` is the one decision point."""

    def __init__(self, specs: dict[str, FaultSpec], seed: int = 0):
        self.specs = specs
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._trials: dict[str, int] = {}
        self.fired: dict[str, int] = {}

    def _fires(self, name: str, trial: int, prob: float) -> bool:
        digest = hashlib.blake2b(
            f"{self.seed}:{name}:{trial}".encode(), digest_size=8
        ).digest()
        return int.from_bytes(digest, "big") / 2.0**64 < prob

    def roll(self, name: str, key: str | None = None) -> FaultSpec | None:
        """One trial of fault ``name`` at site ``key``; the spec when it
        fires, else None. Scoped faults never fire (and never consume a
        trial) at sites that don't match their filter."""
        spec = self.specs.get(name)
        if spec is None or spec.prob <= 0.0:
            return None
        scope = spec.scope()
        if scope is not None and (key is None or scope not in key):
            return None
        with self._lock:
            trial = self._trials.get(name, 0)
            self._trials[name] = trial + 1
        if not self._fires(name, trial, spec.prob):
            return None
        with self._lock:
            self.fired[name] = self.fired.get(name, 0) + 1
        _M_FIRED.inc(fault=name)
        # The fault's place in the event order, for triage.
        telemetry.record("fault_fired", fault=name, key=key)
        return spec

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self.fired)


# ── Module-level switchboard (lazy env parse, test override) ──

_lock = threading.Lock()
_injector: FaultInjector | None = None
_resolved = False


def install(spec: str | None, seed: int | None = None) -> FaultInjector | None:
    """Install an injector directly (tests); ``spec=None`` disables. A
    malformed clause raises :class:`FaultSpecError`."""
    global _injector, _resolved
    with _lock:
        _resolved = True
        if spec is None:
            _injector = None
        else:
            _injector = FaultInjector(
                parse_spec(spec), seed if seed is not None else 0
            )
        return _injector


def reset() -> None:
    """Back to the unresolved state: the next ``fire`` re-reads the env."""
    global _injector, _resolved
    with _lock:
        _injector = None
        _resolved = False


def active() -> FaultInjector | None:
    global _injector, _resolved
    if _resolved:
        return _injector
    with _lock:
        if not _resolved:
            spec = os.environ.get(ENV_SPEC)
            if spec:
                _injector = FaultInjector(
                    parse_spec(spec), int(os.environ.get(ENV_SEED, "0"))
                )
            _resolved = True
    return _injector


def fire(name: str, key: str | None = None) -> FaultSpec | None:
    """The hot-path hook: None when injection is disabled (the common
    case — one global read), else one deterministic trial."""
    inj = _injector
    if inj is None:
        if _resolved:
            return None
        inj = active()
        if inj is None:
            return None
    return inj.roll(name, key)


def sleep_if(name: str, key: str | None = None,
             default_s: float = 1.0) -> float:
    """Fire ``name``; on hit, sleep its numeric arg (or ``default_s``).
    Returns the seconds slept (0.0 = no fire)."""
    spec = fire(name, key)
    if spec is None:
        return 0.0
    delay = max(0.0, spec.float_arg(default_s))
    if delay:
        time.sleep(delay)
    return delay


def corrupt(data: bytes) -> bytes:
    """Deterministically corrupt a payload: XOR one mid-blob byte.

    The flip position is a pure function of the blob length, so a given
    fetch corrupts identically across runs. Empty blobs pass through."""
    if not data:
        return data
    pos = len(data) // 2
    out = bytearray(data)
    out[pos] ^= 0xFF
    return bytes(out)


def counters() -> dict[str, int]:
    inj = _injector
    return inj.counters() if inj is not None else {}
