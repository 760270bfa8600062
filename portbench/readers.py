"""What the per-layer readers share. A reader (``metrics/<name>.py``)
takes the run's :class:`~portbench.cells.Record` and returns a number,
or None when the run has nothing for it to read."""

from __future__ import annotations

from portbench.flops import H2D_PEAK_BYTES_S, PEAK_FLOPS


def mean(xs) -> float | None:
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def stage_mean(rec, *stages: str) -> float | None:
    """The mean over the steps of the program's stage walls (its own
    ``stats["stages"]``, the union of each stage's intervals), summed
    over ``stages``; None when no step ran any of them."""
    vals = []
    for s in rec.steps:
        st = s["stats"].get("stages") or {}
        if any(n in st for n in stages):
            vals.append(sum(st.get(n, 0.0) for n in stages))
    return mean(vals)


def stat_mean(rec, key: str) -> float | None:
    """The mean over the steps of a top-level stat of the program."""
    return mean(s["stats"].get(key) for s in rec.steps)


def h2d_share(rec) -> float | None:
    """Landed bytes at the host link's published peak over the step's
    host-clock time to the landing's end, in percent, the mean over the
    steps."""
    vals = []
    for s in rec.steps:
        hbm = s["stats"].get("hbm") or {}
        swap = hbm.get("swap") or {}
        landed = swap.get("landed_bytes", hbm.get("bytes"))
        if landed:
            vals.append(100.0 * landed / H2D_PEAK_BYTES_S / s["hbm_s"])
    return mean(vals)


def idle_share(rec) -> float | None:
    """The share of the traced time with nothing on the card, in percent:
    over the steps' own intervals where the cell has steps, else over the
    traced window."""
    t = rec.trace
    if not t:
        return None
    if t.get("step_s"):
        return 100.0 * (1.0 - t["step_busy_s"] / t["step_s"])
    if t.get("window_s"):
        return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
    return None


def mfu(rec, dtype: str) -> float | None:
    if not rec.window_flops or not rec.seconds:
        return None
    return 100.0 * rec.window_flops / rec.seconds / PEAK_FLOPS[dtype]
