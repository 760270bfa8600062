"""The device trace of a ``--trace 1`` run.

:class:`Tracer` runs ``torch.profiler`` (CPU and CUDA activity) over the
measured window, or over its first ``limit_s`` seconds where the traffic
file says so (a decode loop launches too many kernels to keep them all).
The harness marks what the host is doing with annotations of its own
(``portbench:<what>``); :func:`reduce` turns the events into the device's
busy seconds (the union of every kernel, copy and set on the card), the
length of the traced window, the ten device operations that took most
time, and the ten longest idle gaps, each named by the annotation the
host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
import time

MARK = "portbench:"
# A kernel's name is cut to this many characters in the breakdown (a
# template instantiation's full name runs to a kilobyte).
NAME_CHARS = 120


def mark(what: str):
    """An annotation the trace can name an idle gap by."""
    import torch

    return torch.profiler.record_function(MARK + what)


class Tracer:
    """Profile from :meth:`start` until :meth:`stop`, or until ``limit_s``
    has passed when :meth:`poll` is called (the harness polls between
    steps and from the loop that waits for clients)."""

    def __init__(self, limit_s: float | None = None):
        self.limit_s = limit_s
        self.prof = None
        self.summary: dict | None = None
        self._window = None
        self._t0 = 0.0

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._window = mark("window")
        self._window.__enter__()
        self._t0 = time.perf_counter()

    def poll(self) -> None:
        if (self.prof is not None and self.limit_s is not None
                and time.perf_counter() - self._t0 >= self.limit_s):
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        host_s = time.perf_counter() - self._t0
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self.summary = reduce(prof.events(), host_s)


def maybe(tracer: Tracer | None, what: str):
    return mark(what) if tracer is not None else contextlib.nullcontext()


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(a, b) for a, b in out]


def reduce(events, host_s: float | None = None) -> dict:
    """Busy seconds, window seconds and the breakdown from profiler
    events (``time_range`` in microseconds, ``device_type`` CUDA for
    what ran on the card). ``host_s``, the window's length by the host's
    clock, rescales the profiler's clock where the two disagree (a
    virtual machine's TSC can be read at the wrong rate)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window = None
    marks: list[tuple[float, float, str]] = []
    dev: list[tuple[float, float, str]] = []
    for e in events:
        name = e.name
        lo, hi = float(e.time_range.start), float(e.time_range.end)
        if name.startswith(MARK):
            if e.device_type == cuda:
                continue  # the annotation mirrored on the device timeline
            if name == MARK + "window":
                window = (lo, hi)
            else:
                marks.append((lo, hi, name[len(MARK):]))
        elif e.device_type == cuda and hi > lo:
            dev.append((lo, hi, name[:NAME_CHARS]))
    if window is None:
        return {"busy_s": 0.0, "window_s": 0.0, "step_busy_s": 0.0,
                "step_s": 0.0, "device_ops": [], "idle_gaps": []}
    w0, w1 = window
    us = (host_s / (w1 - w0)) if host_s and w1 > w0 else 1e-6
    clipped = [(max(lo, w0), min(hi, w1), n) for lo, hi, n in dev
               if hi > w0 and lo < w1]
    busy = _union([(lo, hi) for lo, hi, _ in clipped])
    by_name: dict[str, float] = {}
    for lo, hi, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (hi - lo)
    gaps, prev = [], w0
    for lo, hi in busy + [(w1, w1)]:
        if lo > prev:
            gaps.append((prev, lo))
        prev = max(prev, hi)

    def host_was(t: float) -> str:
        inner = [(hi - lo, n) for lo, hi, n in marks if lo <= t <= hi]
        return min(inner)[1] if inner else "window"

    # The steps alone: what the program kept the card busy with, without
    # the harness's judging between steps.
    steps = _union([(lo, hi) for lo, hi, n in marks
                    if n.startswith("step")])
    step_busy = sum(max(0.0, min(hi, shi) - max(lo, slo))
                    for lo, hi in busy for slo, shi in steps)
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": sum(hi - lo for lo, hi in busy) * us,
        "step_busy_s": step_busy * us,
        "step_s": sum(hi - lo for lo, hi in steps) * us,
        "window_s": (w1 - w0) * us,
        "clock_scale": us * 1e6,
        "device_ops": [[n, s * us] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[host_was((lo + hi) / 2), (hi - lo) * us]
                      for lo, hi in gaps[:10]],
    }
