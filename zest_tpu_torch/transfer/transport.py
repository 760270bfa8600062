"""Exchange transports: how the collective's phase windows move.

The counterpart of ``zest_tpu/transfer/transport.py``. The collective
(``transfer/collective.py``) derives its phases from the shared plan and
executes them against the :class:`ExchangeTransport` protocol: open a
tagged window, send the phase's wants to a partner, get the replies in
order, report clock offsets and wire-tag counters, and signal a dead
partner by raising ``ConnectionError``/``TimeoutError``/``OSError``.

- :class:`DcnWireTransport`: the pooled ``DcnChannel`` path (``dcn``, the
  default). With byte-exact knobs its calls into the pool take exactly
  the point-to-point exchange's arguments.
- :class:`DeviceLaneTransport` (``jax``, the JAX package's name for its
  ICI backend, kept so a node's environment carries across): intra-slice
  (ICI-class) windows pack their replies into a fixed-width uint8 lane,
  one pinned tensor that goes to the transport's device and back; the
  lane width is a pure function of the shared plan (the largest unit plus
  4 KiB, rounded up to 64 KiB), and a reply wider than the lane passes on
  the host and counts in ``lane_overflows``. Cross-slice phases go to the
  wire transport.
- :class:`LoopbackTransport` (``loopback``): in-process serving against a
  registered fabric of ``(cfg, cache)`` per address, with no sockets,
  still honouring the ``dcn_reset`` fault and the tagged windows.

An unknown backend raises :class:`TransportUnavailable` before any wire
traffic; the collective turns it into ``CollectiveUnavailable`` and the
round takes the point-to-point exchange.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from zest_tpu_torch import faults, telemetry
from zest_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from zest_tpu_torch.transfer.dcn import (
    FLAG_LOSSY_OK,
    FLAG_QUANT_OK,
    DcnNotFound,
    DcnResponse,
    serve_chunk_range,
)

LINK_ICI = "ici"


class TransportUnavailable(RuntimeError):
    """The configured backend cannot run here: raised before any wire
    traffic, so the caller can take the point-to-point exchange."""


def _request_flags(lossy_ok: bool, quant_ok: bool) -> int:
    return ((FLAG_LOSSY_OK if lossy_ok else 0)
            | (FLAG_QUANT_OK if quant_ok else 0))


def _new_counters(**extra) -> dict:
    return {"windows": 0, "requests": 0, "tagged_windows": 0,
            "untagged_windows": 0, **extra}


class ExchangeTransport:
    """The protocol the phase planner runs against. ``request_window``
    returns one ``DcnResponse``/``DcnNotFound`` per want, in order."""

    name = "?"

    def window_tag(self) -> int:
        raise NotImplementedError

    def request_window(self, partner: int, addr: tuple[str, int],
                       wants: list[tuple[bytes, int, int]], *,
                       timeout: float, tag: int, link: str = "dcn",
                       lossy_ok: bool = False,
                       quant_ok: bool = False) -> list:
        raise NotImplementedError

    @property
    def counters(self) -> dict:
        raise NotImplementedError

    def clock_offsets(self) -> dict:
        return {}

    def _count(self, wants, tag: int) -> None:
        with self._lock:
            self._counters["windows"] += 1
            self._counters["requests"] += len(wants)
            self._counters["tagged_windows" if tag
                           else "untagged_windows"] += 1


class DcnWireTransport(ExchangeTransport):
    """The pooled ``DcnChannel`` path."""

    name = "dcn"

    def __init__(self, pool) -> None:
        self.pool = pool

    def window_tag(self) -> int:
        return self.pool.window_tag()

    @property
    def counters(self) -> dict:
        return self.pool.counters

    def clock_offsets(self) -> dict:
        return self.pool.clock_offsets()

    def request_window(self, partner, addr, wants, *, timeout, tag,
                       link="dcn", lossy_ok=False, quant_ok=False):
        host, port = addr
        flags = _request_flags(lossy_ok, quant_ok)
        if flags:
            return self.pool.request_many(host, port, wants,
                                          timeout=timeout, tag=tag,
                                          flags=flags)
        # The point-to-point exchange's call shape, argument for argument.
        return self.pool.request_many(host, port, wants, timeout=timeout,
                                      tag=tag)


# ── The in-process loopback fabric: each simulated host's (cfg, cache)
# under its advertised address. ──

_FABRIC: dict[tuple[str, int], tuple] = {}
_FABRIC_LOCK = threading.Lock()


def register_loopback(addr: tuple[str, int], cfg, cache) -> None:
    with _FABRIC_LOCK:
        _FABRIC[(str(addr[0]), int(addr[1]))] = (cfg, cache)


def fabric_entry(addr: tuple[str, int]):
    with _FABRIC_LOCK:
        return _FABRIC.get((str(addr[0]), int(addr[1])))


def reset_loopback() -> None:
    """Drop every fabric registration (tests)."""
    with _FABRIC_LOCK:
        _FABRIC.clear()


class _TagAlloc:
    """Nonzero u16 window tags, as ``DcnPool`` allocates them."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0

    def alloc(self) -> int:
        with self._lock:
            self._next = (self._next % 0xFFFF) + 1
            return self._next


def _serve_window(entry, wants, flags: int) -> list:
    """Answer one window against a fabric entry with the socket server's
    ``serve_chunk_range``, so every backend serves alike."""
    cfg, cache = entry
    out = []
    for i, (chunk_hash, start, end) in enumerate(wants):
        found = serve_chunk_range(cfg, cache, chunk_hash, start, end, flags)
        if found is None:
            out.append(DcnNotFound(i, chunk_hash))
        else:
            offset, blob, resp_flags = found
            out.append(DcnResponse(i, offset, blob, resp_flags))
    return out


def _fire_reset(addr) -> None:
    if faults.fire("dcn_reset", key=f"{addr[0]}:{addr[1]}"):
        raise ConnectionError("injected dcn_reset")


class LoopbackTransport(ExchangeTransport):
    """Zero-socket exchange against the registered fabric."""

    name = "loopback"

    def __init__(self) -> None:
        self._counters = _new_counters()
        self._lock = threading.Lock()
        self._tags = _TagAlloc()

    def window_tag(self) -> int:
        return self._tags.alloc()

    @property
    def counters(self) -> dict:
        return self._counters

    def request_window(self, partner, addr, wants, *, timeout, tag,
                       link="dcn", lossy_ok=False, quant_ok=False):
        _fire_reset(addr)
        entry = fabric_entry(addr)
        if entry is None:
            raise ConnectionError(
                f"no loopback fabric entry for {addr[0]}:{addr[1]}")
        self._count(wants, tag)
        with telemetry.span("collective.loopback", requests=len(wants),
                            link=link) as sp:
            replies = _serve_window(entry, wants,
                                    _request_flags(lossy_ok, quant_ok))
            sp.add_bytes(sum(len(r.data) for r in replies
                             if isinstance(r, DcnResponse)))
        return replies


# Lanes quantize to 64 KiB so small differences in unit size never change
# the lane's shape, plus slack for frame headers over the plan's estimate.
_LANE_QUANTUM = 64 * 1024
_LANE_SLACK = 4096


def lane_width(plan) -> int:
    """The lane of ``plan``: its largest unit plus the slack, rounded up
    to the quantum (one quantum without a plan)."""
    if plan is None:
        return _LANE_QUANTUM
    biggest = max((fi.url_range_end - fi.url_range_start
                   for _key, fi in plan.units), default=0)
    return -(-(biggest + _LANE_SLACK) // _LANE_QUANTUM) * _LANE_QUANTUM


class DeviceLaneTransport(ExchangeTransport):
    """Intra-slice windows through uint8 lanes on ``device`` (``cuda``
    unless the caller passes ``cpu``); the payloads come from the
    loopback fabric when the partner is registered there, else from the
    wire. Other links go to the wire transport untouched."""

    name = "jax"

    def __init__(self, pool, plan=None, device=DEFAULT_DEVICE) -> None:
        self._wire = DcnWireTransport(pool)
        self.device = resolve_device(device)
        self.lane_bytes = lane_width(plan)
        self._counters = _new_counters(ici_windows=0, ici_lane_bytes=0,
                                       lane_overflows=0)
        self._lock = threading.Lock()

    def window_tag(self) -> int:
        return self._wire.window_tag()

    @property
    def counters(self) -> dict:
        return self._counters

    def clock_offsets(self) -> dict:
        return self._wire.clock_offsets()

    def request_window(self, partner, addr, wants, *, timeout, tag,
                       link="dcn", lossy_ok=False, quant_ok=False):
        self._count(wants, tag)
        if link != LINK_ICI:
            return self._wire.request_window(
                partner, addr, wants, timeout=timeout, tag=tag, link=link,
                lossy_ok=lossy_ok, quant_ok=quant_ok)
        _fire_reset(addr)
        entry = fabric_entry(addr)
        if entry is not None:
            replies = _serve_window(entry, wants,
                                    _request_flags(lossy_ok, quant_ok))
        else:
            replies = self._wire.request_window(
                partner, addr, wants, timeout=timeout, tag=tag, link=link,
                lossy_ok=lossy_ok, quant_ok=quant_ok)
        with self._lock:
            self._counters["ici_windows"] += 1
        return self._lane_trip(replies)

    def _lane_trip(self, replies: list) -> list:
        """Every reply that fits a lane crosses to the device and back in
        one pinned ``(rows, lane_bytes)`` tensor."""
        rows = [i for i, r in enumerate(replies)
                if isinstance(r, DcnResponse)
                and 0 < len(r.data) <= self.lane_bytes]
        overflow = sum(1 for r in replies if isinstance(r, DcnResponse)
                       and len(r.data) > self.lane_bytes)
        if overflow:
            with self._lock:
                self._counters["lane_overflows"] += overflow
        if not rows:
            return replies
        with telemetry.span("collective.lane", rows=len(rows),
                            lane_bytes=self.lane_bytes) as sp:
            lanes = torch.zeros((len(rows), self.lane_bytes),
                                dtype=torch.uint8,
                                pin_memory=self.device.type == "cuda")
            view = lanes.numpy()
            for j, i in enumerate(rows):
                data = replies[i].data
                view[j, :len(data)] = np.frombuffer(data, dtype=np.uint8)
            moved = lanes.to(self.device).cpu().numpy()
            sp.add_bytes(lanes.numel())
        with self._lock:
            self._counters["ici_lane_bytes"] += lanes.numel()
        out = list(replies)
        for j, i in enumerate(rows):
            r = replies[i]
            out[i] = DcnResponse(r.request_id, r.chunk_offset,
                                 moved[j, :len(r.data)].tobytes(), r.flags)
        return out


def make_transport(backend: str | None, pool, plan=None,
                   device=DEFAULT_DEVICE) -> ExchangeTransport:
    """The configured backend over the round's ``DcnPool`` (the wire and
    device-lane backends share its channels, tags and counters). ``plan``
    sizes the device lane, which runs on ``device``."""
    if backend in (None, "", "dcn"):
        return DcnWireTransport(pool)
    if backend == "loopback":
        return LoopbackTransport()
    if backend == "jax":
        return DeviceLaneTransport(pool, plan=plan, device=device)
    raise TransportUnavailable(f"unknown collective backend {backend!r}")
