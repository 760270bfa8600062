"""Checkpoint landing: safetensors → tensors in device memory.

The counterpart of ``zest_tpu/models/loader.py``: tensors land on one
device, or, given a named slot mesh (``parallel/mesh.model_mesh``), as
:class:`~zest_tpu_torch.parallel.sharding.ShardedTensor`s laid out by
the family's shard rules: an ordered list of ``(name regex, P)`` pairs,
first match wins, a rule that does not fit the mesh or the shape falling
back to sharding the largest evenly divisible dim over the mesh's last
axis (:func:`spec_for`). A sharded commit copies each group's bytes once
to each distinct device and cuts every slot's shard there into its own
allocation. Two landings:

- **Disk staging** (:func:`stage_snapshot_to_hbm`): read a pulled
  snapshot's files and commit each with :func:`commit_tensors`, one
  pinned, batched host→device copy per file.
- **Direct** (:func:`stage_cached_to_hbm`): land straight from the cached
  xorb units, with no file read. Streaming (the default) decodes runs of
  tensors into a :class:`HostRing` of reusable pinned slots, in layer
  order, and commits groups of them from the slots themselves on a side
  stream: one device buffer per group, one asynchronous copy per slot
  span, the landed tensors typed views of the buffer. A slot goes back to
  the ring only after its group's CUDA event has completed. With
  streaming off, whole shards decode one ahead of the commit.

Both direct landings take a **hot-swap** (``preloaded`` / ``swap_from``),
on one device or over a mesh: tensors a delta plan proved unchanged from
the resident base revision enter the new tree as the very same tensors
(or ``ShardedTensor``s, every shard in place), and each superseded base
tensor leaves the base dict once its replacement's copy is done.

Every copy moves raw bytes, so NaN payloads and sub-word float bits land
unchanged; a landing ``dtype`` casts only floating tensors, on the host,
never int or bool ones (:func:`cast_floating`).
"""

from __future__ import annotations

import contextlib
import gc
import re
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from queue import Empty, SimpleQueue

import torch

from zest_tpu_torch import telemetry
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.config import (
    DEFAULT_DEVICE,
    DEFAULT_LAND_DECODE_AHEAD,
    DEFAULT_LAND_RING_BYTES,
    DEFAULT_LAND_RING_SLOTS,
    DEFAULT_LAND_STREAM,
    resolve_device,
)
from zest_tpu_torch.models.direct import (
    StreamingShardReader,
    land_tensors,
    typed_view,
)
from zest_tpu_torch.models.registry import first_layer_names, order_names
from zest_tpu_torch.models.safetensors_io import SafetensorsFile, tensor_bytes
from zest_tpu_torch.parallel.sharding import (
    P,
    ShardedTensor,
    shard_index,
    shard_tensor,
)

_ALIGN = 16

ShardRules = list[tuple[str, P]]


_M_COMMIT_BYTES = telemetry.counter(
    "zest_hbm_commit_bytes_total", "Bytes committed host→HBM")
_M_COMMIT_TENSORS = telemetry.counter(
    "zest_hbm_commit_tensors_total", "Tensors committed host→HBM")
_M_RING_STALLS = telemetry.counter(
    "zest_land_ring_stalls_total",
    "Streaming-landing ring acquisitions that had to wait for capacity")


def infer_spec(shape: tuple[int, ...], mesh, axis: str) -> P:
    """Default policy: shard the largest dim divisible by the axis size."""
    n = int(mesh.shape[axis])
    if n <= 1 or not shape:
        return P()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % n == 0 and shape[i] >= n:
            spec = [None] * len(shape)
            spec[i] = axis
            return P(*spec)
    return P()


def _spec_fits(shape: tuple[int, ...], mesh, spec: P) -> bool:
    """A rule's spec is usable when every axis it names is in the mesh and
    divides its dim: rules are written against a family's own mesh, and on
    another one (Mixtral's on a mesh without ``expert``) the landing
    degrades to :func:`infer_spec` instead of failing."""
    if len(spec) > len(shape):
        return False
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        for ax in axes if isinstance(axes, tuple) else (axes,):
            if ax not in mesh.shape:
                return False
            if dim % int(mesh.shape[ax]):
                return False
            dim //= int(mesh.shape[ax])
    return True


def spec_for(name: str, shape: tuple[int, ...], mesh,
             rules: ShardRules | None = None,
             default_axis: str | None = None) -> P:
    """The spec ``name`` lands under: the first matching rule if it fits,
    else :func:`infer_spec` over ``default_axis`` (the mesh's last)."""
    for pattern, spec in rules or []:
        if re.search(pattern, name):
            if _spec_fits(shape, mesh, spec):
                return spec
            break  # first match wins; unusable → generic fallback
    axis = default_axis or mesh.axis_names[-1]
    return infer_spec(shape, mesh, axis)


def land_tensor(t: torch.Tensor, mesh, spec: P) -> ShardedTensor:
    """One tensor laid out over ``mesh`` under ``spec``. With several
    processes each process holds the whole tensor and keeps its slots'
    shards."""
    return shard_tensor(t, mesh, spec)


def snapshot_files(snapshot_dir: str | Path) -> list[Path]:
    return sorted(Path(snapshot_dir).glob("*.safetensors"))


_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f16": torch.float16, "float16": torch.float16,
           "f32": torch.float32, "float32": torch.float32}


def resolve_dtype(name: str | None) -> torch.dtype | None:
    """Landing-dtype name (``Config.land_dtype``) → torch dtype; None
    keeps each tensor's own."""
    if name is None:
        return None
    try:
        return _DTYPES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown landing dtype {name!r} (supported: "
                         f"{', '.join(sorted(_DTYPES))})") from None


def cast_floating(t: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``t`` in ``dtype`` when it is floating (int and bool tensors are
    never cast), on the host. A float32 → bfloat16 cast rounds to nearest
    even and turns every NaN into the quiet NaN of its sign (``0x7FC0`` /
    ``0xFFC0``), as the JAX package's ``ml_dtypes`` cast does; torch's own
    cast writes ``0xFFFF`` for any NaN."""
    if dtype is None or not t.dtype.is_floating_point or t.dtype == dtype:
        return t
    out = t.to(dtype)
    if t.dtype == torch.float32 and dtype == torch.bfloat16:
        nan = torch.isnan(t)
        if bool(nan.any()):
            quiet = torch.where(torch.signbit(t[nan]),
                                torch.tensor(-64, dtype=torch.int16),
                                torch.tensor(0x7FC0, dtype=torch.int16))
            out.view(torch.int16)[nan] = quiet
    return out


def commit_tensors(host: dict[str, torch.Tensor], device=DEFAULT_DEVICE,
                   dtype: torch.dtype | None = None, mesh=None,
                   rules: ShardRules | None = None) -> dict:
    """Land a name→CPU-tensor dict on ``device`` in one batched copy:
    every tensor's bytes packed into one pinned staging buffer (each
    16-byte aligned), one transfer, typed views of the device buffer.
    ``dtype`` casts floating tensors on the host first. Caller order is
    kept.

    With a ``mesh`` (``device`` is then unused) every tensor lands as a
    :class:`ShardedTensor` under :func:`spec_for`: the batch is copied
    once to each distinct device of the mesh, and each slot's shard is cut
    from it into its own allocation. Runs in an ``hbm.commit`` span."""
    nbytes = sum(t.numel() * t.element_size() for t in host.values())
    with telemetry.span("hbm.commit", tensors=len(host), bytes=nbytes):
        out = (_commit_sharded(host, mesh, rules, dtype) if mesh is not None
               else _commit_tensors(host, device, dtype))
    _M_COMMIT_BYTES.inc(nbytes)
    _M_COMMIT_TENSORS.inc(len(host))
    return out


def _commit_tensors(host: dict[str, torch.Tensor], device,
                    dtype: torch.dtype | None) -> dict:
    dev = resolve_device(device)
    host = {n: cast_floating(t, dtype) for n, t in host.items()}
    offsets, total = {}, 0
    for name, t in host.items():
        offsets[name] = total
        total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    staging = torch.empty(total, dtype=torch.uint8,
                          pin_memory=dev.type == "cuda")
    packed = staging.numpy()
    for name, t in host.items():
        raw = tensor_bytes(t)
        packed[offsets[name]:offsets[name] + raw.nbytes] = raw
    landed = (staging.to(dev, non_blocking=True) if dev.type == "cuda"
              else staging)
    out = {}
    for name, t in host.items():
        n = t.numel() * t.element_size()
        piece = landed[offsets[name]:offsets[name] + n]
        out[name] = piece.view(t.dtype).reshape(t.shape)
    if dev.type == "cuda":
        # The pinned staging buffer must outlive the async copy.
        torch.cuda.current_stream(dev).synchronize()
    return out


def _cut_shards(full: dict[str, torch.Tensor], specs: dict, mesh,
                slots: list[int], shards: dict) -> None:
    """Each slot's shard of every tensor of ``full`` (landed on the slots'
    device), cloned into its own allocation."""
    for name, t in full.items():
        for slot in slots:
            piece = t[shard_index(tuple(t.shape), mesh, specs[name], slot)]
            shards[name][slot] = piece.clone(
                memory_format=torch.contiguous_format)


def _by_device(mesh) -> dict[torch.device, list[int]]:
    out: dict[torch.device, list[int]] = {}
    for slot in mesh.local_slots():
        out.setdefault(mesh.device_of(slot), []).append(slot)
    return out


def _commit_sharded(host: dict, mesh, rules, dtype) -> dict:
    host = {n: cast_floating(t, dtype) for n, t in host.items()}
    specs = {n: spec_for(n, tuple(t.shape), mesh, rules)
             for n, t in host.items()}
    shards: dict[str, dict] = {n: {} for n in host}
    for dev, slots in _by_device(mesh).items():
        if dev.type == "cpu":
            _cut_shards(host, specs, mesh, slots, shards)
            continue
        landed = commit_tensors(host, dev)
        _cut_shards(landed, specs, mesh, slots, shards)
        del landed
    return {n: ShardedTensor(shards[n], t.shape, t.dtype, specs[n], mesh)
            for n, t in host.items()}


def load_checkpoint(snapshot_dir: str | Path, device=DEFAULT_DEVICE,
                    dtype: torch.dtype | None = None, mesh=None,
                    rules: ShardRules | None = None) -> dict:
    """All tensors of a snapshot as a flat name→tensor dict on ``device``
    (or sharded over ``mesh`` by ``rules``), one batched commit per
    safetensors file."""
    out: dict = {}
    for path in snapshot_files(snapshot_dir):
        with SafetensorsFile(path) as sf:
            host = {name: sf.tensor(name) for name in sf.names()}
            out.update(commit_tensors(host, device, dtype, mesh=mesh,
                                      rules=rules))
            del host
    return out


def params_digest(params: dict) -> str:
    """Order-independent BLAKE3 digest of a landed tree: name, dtype,
    shape and raw bytes of every tensor, fetched back to the host. A
    :class:`ShardedTensor` hashes its global bytes, so a sharded landing's
    digest equals the unsharded one's.

    Hashes dtype and shape in numpy's spelling (``float32``, ``(768,)``),
    so it equals the JAX package's ``params_digest`` of the same tensors."""
    leaves = []
    for name in sorted(params):
        t = params[name]
        if isinstance(t, ShardedTensor):
            t = t.full("cpu")
        dtype_name = str(t.dtype).removeprefix("torch.")
        leaves.append(hashing.blake3_hash(
            name.encode() + b"\x00" + dtype_name.encode()
            + b"\x00" + repr(tuple(t.shape)).encode() + b"\x00"
            + tensor_bytes(t).tobytes()))
    return hashing.blake3_hash(b"".join(leaves)).hex()


def _commit_stats(params: dict, dt: float, direct: bool = False,
                  mesh=None) -> dict:
    total = sum(int(t.nbytes) for t in params.values())
    return {
        "tensors": len(params),
        "bytes": total,
        "elapsed_s": round(dt, 3),
        "gbps": round(total / dt / 1e9, 3) if dt > 0 else 0.0,
        "sharded": mesh is not None,
        "direct": direct,
    }


def _sync(dev, mesh) -> None:
    """Wait for every copy onto the landing's devices."""
    for d in (mesh.distinct_devices() if mesh is not None else [dev]):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def stage_snapshot_to_hbm(snapshot_dir: str | Path, device=DEFAULT_DEVICE,
                          dtype: torch.dtype | None = None, mesh=None,
                          rules: ShardRules | None = None
                          ) -> tuple[dict, dict]:
    """Disk-path commit of a pulled snapshot into device memory (sharded
    over ``mesh`` by ``rules`` when given).

    Returns ``(params, stats)``; ``stats`` is the block reported under
    the pull's ``stats["hbm"]`` (tensors, bytes, wall time, host→device
    GB/s). The name keeps the JAX package's: "hbm" is the card's memory."""
    dev = None if mesh is not None else resolve_device(device)
    t0 = time.monotonic()
    params = load_checkpoint(snapshot_dir, dev, dtype, mesh=mesh,
                             rules=rules)
    _sync(dev, mesh)
    return params, _commit_stats(params, time.monotonic() - t0, mesh=mesh)


@contextlib.contextmanager
def _gc_frozen():
    """Suspend cyclic GC over the landing (a collection mid-commit walks
    every live object at an arbitrary point). Afterwards one collection
    of the youngest generation, which holds exactly the objects the
    landing made (nothing is promoted while collection is off): a full
    collection here walks the whole heap on the time-to-device path."""
    was_enabled = gc.isenabled()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()
        gc.unfreeze()
        gc.collect(0)


class RingClosed(RuntimeError):
    """The ring was torn down (consumer error) while a producer waited."""


class _RingSlot:
    """One staging buffer in flight: decode writes it, the device copy
    reads it, and the write-behind file sink may read it too. Reference
    counted; it returns to the ring when every consumer is done.
    ``tensor`` is the slot's uint8 tensor and ``view`` its numpy view."""

    __slots__ = ("ring", "buffer", "tensor", "view", "acct", "refs",
                 "detached")

    def __init__(self, ring: "HostRing", buffer: torch.Tensor, nbytes: int):
        self.ring = ring
        self.buffer = buffer
        self.tensor = buffer[:nbytes]
        self.view = self.tensor.numpy()
        self.acct = buffer.numel()   # capacity bytes charged to the ring
        self.refs = 1
        self.detached = False

    def addref(self) -> "_RingSlot":
        with self.ring._cv:
            self.refs += 1
        return self

    def detach(self) -> None:
        """Move this slot's bytes out of the ring's accounting (the file
        sink keeps them past the commit, under its own byte budget). The
        buffer rejoins the pool on its last release if the budget has
        room then: a pull that writes its files still reuses the slots
        its earlier shards' files are done with."""
        with self.ring._cv:
            if not self.detached:
                self.detached = True
                self.ring._in_use_bytes -= self.acct
                self.ring._in_use -= 1
                self.ring._cv.notify_all()

    def release(self) -> None:
        self.ring._unref(self)


class HostRing:
    """Fixed-capacity pool of reusable host staging buffers.

    ``acquire(n)`` admits a slot while the bytes in flight stay within
    ``budget_bytes`` and the slots within ``max_slots``, else waits (a
    counted stall) until the consumer releases one. A slot larger than
    the whole budget is admitted alone once nothing else is in flight.
    Released buffers are kept (smallest adequate fit first) while ``in
    use + free ≤ budget``. ``pin`` page-locks the buffers, so the device
    copy reads them asynchronously.

    ``reuse=False`` makes every slot single-use: needed where the landed
    tensors alias the slot (the CPU landing), so a reused buffer would
    rewrite landed parameters."""

    def __init__(self, budget_bytes: int, max_slots: int,
                 reuse: bool = True, pin: bool = False):
        self.budget_bytes = max(1, int(budget_bytes))
        self.max_slots = max(1, int(max_slots))
        self.reuse = bool(reuse)
        self.pin = bool(pin)
        self._cv = threading.Condition()
        self._free: list[torch.Tensor] = []
        self._free_bytes = 0
        self._in_use = 0
        self._in_use_bytes = 0
        self._closed = False
        self._waiting = False
        self.peak_bytes = 0
        self.stalls = 0
        self.stall_s = 0.0
        self.oversized = 0
        self.allocs = 0
        self.reuses = 0
        self.detached = 0
        # The timeline's ring gauges: the newest ring is the one sampled
        # (register_probe replaces), and close() unregisters it. The
        # bound methods are taken once, because each attribute access
        # makes a new object and the unregister checks identity.
        self._probe_in_use = self._probe_in_use_bytes
        self._probe_stall_count = self._probe_stalls
        telemetry.timeline.register_probe(
            "ring.in_use_bytes", self._probe_in_use)
        telemetry.timeline.register_probe(
            "ring.stalls", self._probe_stall_count)

    def _probe_in_use_bytes(self) -> int:
        with self._cv:
            return self._in_use_bytes

    def _probe_stalls(self) -> int:
        with self._cv:
            return self.stalls

    def _trim_free_locked(self, incoming: int) -> None:
        while self._free and (self._in_use_bytes + self._free_bytes
                              + incoming > self.budget_bytes):
            self._free_bytes -= self._free.pop().numel()

    def acquire(self, nbytes: int, block: bool = True) -> _RingSlot | None:
        """Admit a slot of ``nbytes``; with ``block=False`` return None
        instead of waiting (no stall counted)."""
        nbytes = max(0, int(nbytes))
        stalled_at = None
        with self._cv:
            try:
                while True:
                    if self._closed:
                        raise RingClosed("landing ring closed")
                    if self._in_use == 0:
                        break  # oversized-alone admission
                    if (self._in_use < self.max_slots
                            and self._in_use_bytes + nbytes
                            <= self.budget_bytes):
                        break
                    if not block:
                        return None
                    if stalled_at is None:
                        stalled_at = time.monotonic()
                        self.stalls += 1
                        _M_RING_STALLS.inc()
                        telemetry.record(
                            "ring_stall", bytes=nbytes,
                            in_use_bytes=self._in_use_bytes,
                            slots=self._in_use)
                    # Seen by the consumer (producer_waiting): a stalled
                    # producer may need slots its half-built group pins.
                    self._waiting = True
                    self._cv.wait(0.05)
            finally:
                self._waiting = False
            if stalled_at is not None:
                self.stall_s += time.monotonic() - stalled_at
            if nbytes > self.budget_bytes:
                self.oversized += 1
            # The smallest free buffer that fits, if its capacity also
            # keeps the budget.
            best = None
            for i, b in enumerate(self._free):
                if b.numel() >= nbytes and (
                        best is None
                        or b.numel() < self._free[best].numel()):
                    best = i
            buf = None
            if best is not None:
                cand = self._free[best]
                if (self._in_use == 0 or self._in_use_bytes + cand.numel()
                        <= self.budget_bytes):
                    buf = self._free.pop(best)
                    self._free_bytes -= buf.numel()
                    self.reuses += 1
            if buf is None:
                self._trim_free_locked(nbytes)
                buf = torch.empty(nbytes, dtype=torch.uint8,
                                  pin_memory=self.pin)
                self.allocs += 1
            self._in_use += 1
            self._in_use_bytes += buf.numel()
            self.peak_bytes = max(self.peak_bytes, self._in_use_bytes)
            return _RingSlot(self, buf, nbytes)

    def _unref(self, slot: _RingSlot) -> None:
        with self._cv:
            slot.refs -= 1
            if slot.refs > 0:
                return
            if slot.detached:
                # Its accounting was surrendered at detach; the buffer
                # rejoins the pool once the file sink is done with it.
                self.detached += 1
            else:
                self._in_use -= 1
                self._in_use_bytes -= slot.acct
            if (self.reuse and not self._closed
                    and self._in_use_bytes + self._free_bytes + slot.acct
                    <= self.budget_bytes):
                self._free.append(slot.buffer)
                self._free_bytes += slot.acct
            self._cv.notify_all()

    @property
    def producer_waiting(self) -> bool:
        """True while a producer is parked inside :meth:`acquire`."""
        with self._cv:
            return self._waiting

    def close(self) -> None:
        """Wake any waiter with :class:`RingClosed` (the consumer's error
        path, a pull's cancel) and drop the free buffers."""
        telemetry.timeline.unregister_probe(
            "ring.in_use_bytes", self._probe_in_use)
        telemetry.timeline.unregister_probe(
            "ring.stalls", self._probe_stall_count)
        with self._cv:
            self._closed = True
            self._free.clear()
            self._free_bytes = 0
            self._cv.notify_all()

    def summary(self) -> dict:
        with self._cv:
            return {
                "budget_bytes": self.budget_bytes,
                "slots": self.max_slots,
                "peak_bytes": self.peak_bytes,
                "stalls": self.stalls,
                "stall_s": round(self.stall_s, 4),
                "buffers_allocated": self.allocs,
                "buffer_reuses": self.reuses,
                "oversized": self.oversized,
                "detached": self.detached,
            }


# A streaming commit group flushes at this many bytes (or a quarter of the
# ring's slots): batched copies without a commit per tensor.
_STREAM_COMMIT_BYTES = 64 * 1024 * 1024


class _DeviceCommit:
    """The streaming landing's commit into device memory.

    :meth:`commit` lands one group of ``(name, info, slot, lo, hi)``
    items (the tensor's raw bytes are ``slot.tensor[lo:hi]``) and returns
    ``(landed, done)``: the landed name→tensor dict and an event to wait
    on before the group's slots may be reused (None when nothing is in
    flight). On ``cuda`` it allocates one device buffer for the group and
    copies each slot span (or each host-cast tensor) into it on a side
    stream that waits for the current stream first; on ``cpu`` the landed
    tensors are typed views of the slots themselves."""

    def __init__(self, dev: torch.device, dtype: torch.dtype | None):
        self.dev = dev
        self.dtype = dtype
        self.side = (torch.cuda.Stream(dev) if dev.type == "cuda"
                     else None)

    def _casts(self, info) -> bool:
        return (self.dtype is not None and info.torch_dtype.is_floating_point
                and info.torch_dtype != self.dtype)

    def commit(self, items) -> tuple[dict[str, torch.Tensor], object]:
        if self.side is None:
            return {name: cast_floating(typed_view(slot.tensor[lo:hi], info),
                                        self.dtype)
                    for name, info, slot, lo, hi in items}, None
        # Device layout: a slot span keeps its offsets mod 16 (slot index
        # i is file offset o + i with o ≡ 0 mod 16), a cast tensor starts
        # 16-aligned.
        spans: dict[int, list] = {}      # id(slot) -> [slot, lo, hi]
        casts = []                       # (name, host tensor)
        for name, info, slot, lo, hi in items:
            if self._casts(info):
                casts.append((name, cast_floating(
                    typed_view(slot.tensor[lo:hi], info), self.dtype)))
                continue
            span = spans.setdefault(id(slot), [slot, lo, hi])
            span[1], span[2] = min(span[1], lo), max(span[2], hi)
        cursor, placed = 0, {}
        for key, (slot, lo, hi) in spans.items():
            off = -(-cursor // _ALIGN) * _ALIGN + lo % _ALIGN
            placed[key] = off
            cursor = off + hi - lo
        cast_at = []
        for _name, t in casts:
            off = -(-cursor // _ALIGN) * _ALIGN
            cast_at.append(off)
            cursor = off + t.numel() * t.element_size()
        buf = torch.empty(cursor, dtype=torch.uint8, device=self.dev)
        self.side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(self.side):
            for key, (slot, lo, hi) in spans.items():
                off = placed[key]
                buf[off:off + hi - lo].copy_(slot.tensor[lo:hi],
                                             non_blocking=True)
            for (_name, t), off in zip(casts, cast_at):
                raw = t.reshape(-1).view(torch.uint8)
                buf[off:off + raw.numel()].copy_(raw, non_blocking=True)
        buf.record_stream(self.side)
        done = torch.cuda.Event()
        done.record(self.side)
        landed = {}
        for name, info, slot, lo, hi in items:
            if self._casts(info):
                continue
            off = placed[id(slot)] + lo - spans[id(slot)][1]
            landed[name] = typed_view(buf[off:off + hi - lo], info)
        for (name, t), off in zip(casts, cast_at):
            n = t.numel() * t.element_size()
            landed[name] = buf[off:off + n].view(t.dtype).reshape(t.shape)
        # The host-cast tensors stay referenced by the event's holder
        # until the copies are done.
        return landed, (done, [t for _n, t in casts])

    def finish(self) -> None:
        """Order the current stream after every copy (callers then read
        the landed tensors on it with no further sync)."""
        if self.side is not None:
            torch.cuda.current_stream(self.dev).wait_stream(self.side)

    def synchronize(self) -> None:
        """Wait for every copy in flight (the error path)."""
        if self.side is not None:
            self.side.synchronize()


class _Events(list):
    """The copy events of one group over several devices."""

    def synchronize(self) -> None:
        for e in self:
            e.synchronize()


class _ShardedCommit:
    """The streaming landing's commit over a mesh: each group lands once
    on each distinct device through that device's :class:`_DeviceCommit`,
    and every slot's shard is cut from it into its own allocation on the
    same side stream, so the group buffer is garbage once the cuts are
    queued. ``commit`` returns the name→:class:`ShardedTensor` dict and the
    group's events."""

    def __init__(self, mesh, rules, dtype: torch.dtype | None):
        self.mesh = mesh
        self.rules = rules
        self.slots = _by_device(mesh)
        self.commits = {d: _DeviceCommit(d, dtype) for d in self.slots}

    def commit(self, items) -> tuple[dict, object]:
        shards: dict[str, dict] = {}
        meta: dict[str, tuple] = {}
        events, keep = _Events(), []
        for dev, slots in self.slots.items():
            c = self.commits[dev]
            landed, done = c.commit(items)
            cut = []
            for name, t in landed.items():
                if name not in meta:
                    meta[name] = (t.shape, t.dtype, spec_for(
                        name, tuple(t.shape), self.mesh, self.rules))
                spec = meta[name][2]
                for slot in slots:
                    piece = t[shard_index(tuple(t.shape), self.mesh, spec,
                                          slot)]
                    out = torch.empty(piece.shape, dtype=piece.dtype,
                                      device=dev)
                    shards.setdefault(name, {})[slot] = out
                    cut.append((out, piece))
            if c.side is None:
                for out, piece in cut:
                    out.copy_(piece)
                continue
            with torch.cuda.stream(c.side):
                for out, piece in cut:
                    out.copy_(piece)
                    out.record_stream(c.side)
            event = torch.cuda.Event()
            event.record(c.side)
            events.append(event)
            keep.append(done[1])
        tree = {n: ShardedTensor(shards[n], *meta[n][:2], meta[n][2],
                                 self.mesh) for n in meta}
        return tree, ((events, keep) if events else None)

    def finish(self) -> None:
        for c in self.commits.values():
            c.finish()

    def synchronize(self) -> None:
        for c in self.commits.values():
            c.synchronize()


def _stage_streaming(bridge, recs_with_headers, dev, dtype, prefetch_next,
                     decode_workers, clock, ring_bytes: int,
                     ring_slots: int, tensor_gate=None, on_first_layer=None,
                     stream_file_sink=None, preloaded=None, swap_from=None,
                     mesh=None, rules=None, cancel=None) -> tuple[dict, dict]:
    """The ring scheduler: decode of run N+k overlaps the device copy of
    run N, in layer order. See :func:`stage_cached_to_hbm`.

    Three threads take part: the producer decoding into ring slots, this
    (consumer) thread queueing each group's copies on the side stream,
    and whatever fills the cache behind ``tensor_gate``. Any error, and a
    fired ``cancel`` token, ends the landing the same way: the landing's
    abort event wakes the gate, :meth:`HostRing.close` wakes a producer
    parked on the ring, the producer is joined, every copy in flight is
    waited on before its slot goes back (a pinned buffer reused under a
    live copy would corrupt the tree), and every group committed so far
    is dropped."""
    t0 = time.monotonic()
    preloaded = preloaded or {}
    # On the CPU the landed tensors alias their slots: no slot is reused.
    ring = HostRing(ring_bytes, ring_slots, reuse=dev.type == "cuda",
                    pin=dev.type == "cuda")
    committer = (_ShardedCommit(mesh, rules, dtype) if mesh is not None
                 else _DeviceCommit(dev, dtype))
    group_bytes = max(1, min(_STREAM_COMMIT_BYTES, ring.budget_bytes // 4))
    group_count = max(1, ring.max_slots // 4)
    # Over every tensor, preloaded ones included: "first layer resident"
    # is about what a forward pass can touch, not what this landing moved.
    all_names = frozenset(
        name for _r, h in recs_with_headers for name in h.tensors)
    first_set = first_layer_names(all_names)
    # Eager flushing only pays when the first-layer set is a proper
    # subset; otherwise "first layer" is the whole landing anyway.
    eager = bool(first_set) and first_set < all_names
    q: SimpleQueue = SimpleQueue()
    abort = threading.Event()
    done_marker, cancelled_marker = object(), object()

    def shard_runs(header):
        """File-contiguous tensors in landing order, cut at the commit
        group's size and at the first-layer set's edge."""
        runs: list[list[str]] = []
        run_lo = run_hi = None
        prev_name = None
        for name in order_names(header.tensors):
            if name in preloaded:
                # Reused from the base revision: no gate, no decode, no
                # copy. The gap it leaves cuts the run.
                continue
            lo, hi = header.tensors[name].file_range(header.data_start)
            if (runs and lo == run_hi and hi - run_lo <= group_bytes
                    and not (prev_name in first_set
                             and name not in first_set)):
                runs[-1].append(name)
                run_hi = hi
            else:
                runs.append([name])
                run_lo, run_hi = lo, hi
            prev_name = name
        return runs

    def decode_run(sr, slot, lo, hi, run):
        with clock("decode") if clock is not None else contextlib.nullcontext():
            sr.decode_range_into(
                lo, hi, memoryview(slot.view[lo % _ALIGN:]),
                label=(f"{run[0]}+{len(run) - 1}" if len(run) > 1
                       else run[0]))
        if clock is not None:
            clock.note_bytes("decode", hi - lo)

    def produce():
        try:
            for i, (rec, header) in enumerate(recs_with_headers):
                if abort.is_set():
                    return
                if prefetch_next is not None:
                    prefetch_next(i)
                # Lossy staged units are device-only: the overlay is on
                # only when no file sink shares the decoded bytes.
                sr = StreamingShardReader(bridge.cache, rec, header,
                                          bridge=bridge,
                                          workers=decode_workers,
                                          allow_lossy=stream_file_sink is None)
                sink = (stream_file_sink(i)
                        if stream_file_sink is not None else None)
                try:
                    for run in shard_runs(header):
                        if abort.is_set():
                            return
                        if tensor_gate is not None:
                            for name in run:
                                tensor_gate(i, name, abort)
                        if abort.is_set():
                            return
                        spans = [header.tensors[n].file_range(
                            header.data_start) for n in run]
                        lo, hi = spans[0][0], spans[-1][1]
                        # The slot keeps the file's alignment mod 16, so
                        # the typed views of it are aligned as the file's.
                        origin = lo - lo % _ALIGN
                        slot = ring.acquire(hi - origin)
                        try:
                            decode_run(sr, slot, lo, hi, run)
                        except BaseException:
                            slot.release()
                            raise
                        # One slot, len(run) consumers: the consumer
                        # releases once per tensor.
                        for _ in range(len(run) - 1):
                            slot.addref()
                        for name, (t_lo, t_hi) in zip(run, spans):
                            info = header.tensors[name]
                            a, b = t_lo - origin, t_hi - origin
                            if sink is not None:
                                sink.offer(name, info, slot.view[a:b], slot)
                            q.put((name, info, slot, a, b))
                finally:
                    sr.close()
                    if sink is not None:
                        sink.done_decoding()
            q.put(done_marker)
        except BaseException as exc:  # noqa: BLE001 - consumer re-raises
            q.put(exc)

    params: dict[str, torch.Tensor] = dict(preloaded)
    committed_names: set[str] = set(preloaded)
    fired = not first_set or first_set <= committed_names
    if fired and first_set and preloaded and on_first_layer is not None:
        # The whole first-layer set was reused: it is resident now.
        on_first_layer()
    batch: list = []
    batch_bytes = 0
    batch_slot_ids: set[int] = set()
    pending: deque = deque()

    def drain_one():
        nonlocal fired
        done, slots, names = pending.popleft()
        if done is not None:
            done[0].synchronize()
        for s in slots:
            s.release()
        committed_names.update(names)
        if swap_from:
            # The replacements are resident: drop the superseded base
            # tensors now, so the card holds about one tree, not two.
            for n in names:
                swap_from.pop(n, None)
        if not fired and first_set <= committed_names:
            fired = True
            if on_first_layer is not None:
                on_first_layer()

    def flush():
        nonlocal batch, batch_bytes
        if not batch:
            return
        # One rule for every landing, hot-swap included: the JAX package
        # coalesces small tensors on its swap path to amortize the XLA
        # compiles of its splitter, and a torch commit compiles nothing.
        # Preloaded tensors never reach a commit. The span covers queueing
        # the group's copies; the copies run on the side stream, and the
        # wait for them is in drain_one.
        nbytes = sum(it[4] - it[3] for it in batch)
        with telemetry.span("hbm.commit", tensors=len(batch), bytes=nbytes):
            landed, done = committer.commit(batch)
        _M_COMMIT_BYTES.inc(nbytes)
        _M_COMMIT_TENSORS.inc(len(batch))
        params.update(landed)
        pending.append((done, [it[2] for it in batch],
                        [it[0] for it in batch]))
        batch, batch_bytes = [], 0
        batch_slot_ids.clear()
        # Keep one committed group in flight (its copy drains while the
        # next decodes); older ones give their slots back.
        while len(pending) > 1:
            drain_one()

    def consume():
        nonlocal batch_bytes
        while True:
            try:
                item = q.get_nowait()
            except Empty:
                # Queue dry: recycle committed groups, then flush the
                # half-built group when the producer stalls on the ring,
                # after a 0.25 s quiet gap, or at once until the
                # first-layer set is in.
                while pending:
                    drain_one()
                waited = 0.0
                while True:
                    if batch and ((eager and not fired)
                                  or ring.producer_waiting
                                  or waited >= 0.25):
                        flush()
                        while pending:
                            drain_one()
                    try:
                        item = q.get(timeout=0.05 if batch else None)
                        break
                    except Empty:
                        waited += 0.05
            if item is done_marker:
                break
            if item is cancelled_marker:
                cancel.check()
            if isinstance(item, BaseException):
                raise item
            batch.append(item)
            batch_bytes += item[4] - item[3]
            batch_slot_ids.add(id(item[2]))
            # Distinct slots bound how many ring buffers a group pins (a
            # run's tensors share one).
            if (batch_bytes >= group_bytes
                    or len(batch_slot_ids) >= group_count):
                flush()
        flush()
        while pending:
            drain_one()

    def on_cancel():
        # The token ends the landing as an error does. The marker goes in
        # first, so that the consumer raises the cancel, not the
        # producer's RingClosed.
        q.put(cancelled_marker)
        abort.set()
        ring.close()

    untie = cancel.on_cancel(on_cancel) if cancel is not None else None
    with _gc_frozen():
        try:
            # The with-exit joins the producer, on success and on error.
            with ThreadPoolExecutor(
                    1, thread_name_prefix="zest-land-stream") as staging:
                staging.submit(produce)
                try:
                    consume()
                except BaseException:
                    abort.set()
                    ring.close()
                    raise
        except BaseException:
            # The producer is gone, so the queue holds every slot it
            # still had. No slot goes back while a copy may still read
            # it, and the groups committed so far are dropped.
            committer.synchronize()
            while pending:
                for s in pending.popleft()[1]:
                    s.release()
            for it in batch:
                it[2].release()
            batch.clear()
            while True:
                try:
                    item = q.get_nowait()
                except Empty:
                    break
                if isinstance(item, tuple):
                    item[2].release()
            params.clear()
            raise
        finally:
            if untie is not None:
                untie()
            # Ended either way: the free buffers go, and with them the
            # timeline's ring probes (the JAX package closes the ring on
            # an error only, and its probes hold the last ring's buffers
            # until the next ring replaces them).
            ring.close()
        committer.finish()
        dt = time.monotonic() - t0
    stats = _commit_stats(params, dt, direct=True, mesh=mesh)
    stats["decode_ahead"] = True
    stats["streamed"] = True
    stats["ring"] = ring.summary()
    if preloaded or swap_from is not None:
        # A consumed base tree is a swap even when nothing was reused.
        stats["swap"] = _swap_stats(preloaded, params)
    return params, stats


def _swap_stats(preloaded: dict, params: dict) -> dict:
    """The hot-swap block under ``stats["hbm"]["swap"]``: what was reused
    as it was and what was landed."""
    reused_bytes = sum(int(t.nbytes) for t in preloaded.values())
    return {
        "reused_tensors": len(preloaded),
        "reused_bytes": reused_bytes,
        "landed_tensors": len(params) - len(preloaded),
        "landed_bytes": sum(int(t.nbytes) for t in params.values())
        - reused_bytes,
    }


def stage_cached_to_hbm(bridge, recs_with_headers, device=DEFAULT_DEVICE,
                        dtype: torch.dtype | None = None,
                        prefetch_next=None, decode_ahead: int | None = None,
                        decode_workers: int | None = None,
                        on_host_ready=None, clock=None,
                        stream: bool | None = None,
                        ring_bytes: int | None = None,
                        ring_slots: int | None = None, tensor_gate=None,
                        on_first_layer=None, stream_file_sink=None,
                        preloaded=None, swap_from=None, mesh=None,
                        rules: ShardRules | None = None, cancel=None
                        ) -> tuple[dict, dict]:
    """Direct landing: tensors straight from cached xorb units onto
    ``device``, with no file read.

    ``recs_with_headers`` is ``[(Reconstruction, SafetensorsHeader)]``,
    one per safetensors file. Units missing from the cache come through
    ``bridge``'s waterfall. ``prefetch_next(i)`` runs before shard ``i``
    lands (the pull's warm fetch). ``decode_workers`` sizes the decode
    pool. Knobs left None come from ``bridge.cfg``. ``clock`` (a
    ``transfer.pull.StageClock``) records the decode under ``"decode"``
    with its bytes.

    **Streaming** (``stream``, default ``Config.land_stream``; needs
    ``decode_ahead`` and no ``on_host_ready``): runs of tensors decode into
    a :class:`HostRing` (``ring_bytes`` / ``ring_slots``) in layer order
    and commit in groups from the slots. ``tensor_gate(i, name, abort)``
    blocks until tensor ``name``'s units are cached (``abort``, a
    ``threading.Event``, is the landing's abort); ``on_first_layer()``
    fires once, when the embedding and the first layer are resident (their
    copies done); ``stream_file_sink(i)`` returns shard ``i``'s
    write-behind consumer or None, whose ``offer(name, info, raw, slot)``
    may keep slot references (addref + detach).

    **Shard by shard** (``stream`` off): shard ``i + 1`` decodes while
    shard ``i`` commits (``decode_ahead``). ``on_host_ready(i, host)``
    fires when shard ``i``'s CPU tensors are decoded, before its commit;
    it may keep them.

    **Hot-swap** (both modes): ``preloaded`` maps names to tensors
    already resident on ``device`` whose bytes a delta plan proved
    unchanged; they skip the gate, the decode and the copy, and enter the
    returned tree as the same objects (never through
    :func:`commit_tensors` or a cast). ``swap_from``, the base revision's
    dict, is consumed in place: each changed tensor's superseded entry is
    popped once its replacement's copy is done (the group's CUDA event in
    streaming, the shard's commit otherwise), never earlier. The caller
    hands its tree over: a popped tensor's memory returns to the caching
    allocator only when nothing else refers to it (a ``PullResult``, a
    generator, the caller's own names) and, since a landed tensor is a
    view of its commit group's buffer, when every tensor of that buffer is
    gone. ``stats["swap"]`` records the split.

    **Mesh** (both modes): with ``mesh`` every tensor lands as a
    :class:`ShardedTensor` under :func:`spec_for` with ``rules``
    (``device`` is then unused). A hot-swap over a mesh takes
    ``preloaded`` ``ShardedTensor``s of that layout; a superseded base
    entry, all its shards, leaves ``swap_from`` once the event of the
    group that replaced it has completed on every device, and
    ``stats["swap"]`` counts each tensor by its global bytes.

    **Cancel** (both modes): ``cancel``, a pull's
    ``transfer.tenancy.CancelToken``, sets the streaming landing's abort
    (:meth:`CancelToken.on_cancel`) or is checked between shards; once it
    fires the landing raises ``PullCancelled`` with
    nothing left behind: no thread parked on the ring, every copy in
    flight waited on before its pinned slot goes back, and every tensor
    committed so far dropped (the allocations return once the caller lets
    go of the exception). An error ends the landing the same way.

    Returns ``(params, stats)``, ``stats["direct"]`` true. On ``cuda`` the
    current stream is ordered after every copy when this returns.
    """
    dev = (resolve_device(device) if mesh is None
           else mesh.distinct_devices()[0])
    cfg = getattr(bridge, "cfg", None)
    if decode_ahead is None:
        decode_ahead = getattr(cfg, "land_decode_ahead",
                               DEFAULT_LAND_DECODE_AHEAD)
    if decode_workers is None:
        decode_workers = getattr(cfg, "decode_workers", None)
    if stream is None:
        stream = getattr(cfg, "land_stream", DEFAULT_LAND_STREAM)
    if ring_bytes is None:
        ring_bytes = getattr(cfg, "land_ring_bytes", DEFAULT_LAND_RING_BYTES)
        # The remediation engine's ring tuner may hold an override within
        # [base, min(8 x base, 4 GiB)]; an explicit ring_bytes wins, and
        # with ZEST_REMEDIATE=0 there is none.
        telemetry.remediate.set_knob_base("land_ring_bytes", ring_bytes)
        override = telemetry.remediate.knob_override("land_ring_bytes")
        if override:
            ring_bytes = override
    if ring_slots is None:
        ring_slots = getattr(cfg, "land_ring_slots", DEFAULT_LAND_RING_SLOTS)
    if (stream and decode_ahead and on_host_ready is None
            and recs_with_headers):
        return _stage_streaming(
            bridge, recs_with_headers, dev, dtype, prefetch_next,
            decode_workers, clock, ring_bytes, ring_slots,
            tensor_gate=tensor_gate, on_first_layer=on_first_layer,
            stream_file_sink=stream_file_sink, preloaded=preloaded,
            swap_from=swap_from, mesh=mesh, rules=rules, cancel=cancel)

    t0 = time.monotonic()
    preloaded = preloaded or {}
    params: dict[str, torch.Tensor] = dict(preloaded)
    n = len(recs_with_headers)
    predicate = None
    if preloaded:
        # Only changed tensors decode.
        def predicate(name, _skip=frozenset(preloaded)):
            return name not in _skip

    def decode(i: int) -> dict:
        if cancel is not None:
            cancel.check()
        if prefetch_next is not None:
            prefetch_next(i)
        rec, header = recs_with_headers[i]
        with clock("decode") if clock is not None else contextlib.nullcontext():
            host = land_tensors(bridge.cache, rec, header,
                                predicate=predicate, bridge=bridge,
                                workers=decode_workers,
                                allow_lossy=on_host_ready is None)
        if clock is not None:
            clock.note_bytes("decode", sum(
                t.numel() * t.element_size() for t in host.values()))
        if on_host_ready is not None:
            on_host_ready(i, host)
        return host

    def commit(host: dict) -> None:
        if cancel is not None:
            cancel.check()
        if not host:
            return
        # commit_tensors returns with its copy done on the current stream.
        params.update(commit_tensors(host, dev, dtype, mesh=mesh,
                                     rules=rules))
        if swap_from:
            for name in host:
                swap_from.pop(name, None)

    pipelined = bool(decode_ahead) and n > 1
    with _gc_frozen():
        try:
            if pipelined:
                with ThreadPoolExecutor(
                        1, thread_name_prefix="zest-land-decode") as staging:
                    pending = staging.submit(decode, 0)
                    for i in range(n):
                        host = pending.result()
                        if i + 1 < n:
                            pending = staging.submit(decode, i + 1)
                        commit(host)
                        del host
            else:
                for i in range(n):
                    commit(decode(i))
        except BaseException:
            params.clear()  # the shards committed so far are dropped
            raise
        for d in (mesh.distinct_devices() if mesh is not None else [dev]):
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()
        dt = time.monotonic() - t0
    stats = _commit_stats(params, dt, direct=True, mesh=mesh)
    stats["decode_ahead"] = pipelined
    if preloaded or swap_from is not None:
        stats["swap"] = _swap_stats(preloaded, params)
    return params, stats
