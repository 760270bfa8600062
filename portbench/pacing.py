"""Step pacing and the disk-write budget of a run.

A paced cell makes a fixed number of steps, started evenly through the
window (step ``k`` at ``k * seconds / steps``), and never lets two
overlap: a step due while the previous one runs starts when it ends, and
the run records how late it started. The number is fixed by what a run
may write: every landing and every swap writes the checkpoint's whole
snapshot file, so what the set-up wrote, as counted, and ``steps`` files
more must fit under the traffic's cap.

What a run wrote is counted from the files themselves
(:func:`file_states`, :func:`written`): every file under the run's work
directory that is new, or has another inode or size, since the last
count, at its size. The program writes every file to a temporary name
and renames it into place, so a written file always has a new inode; a
read freshens a cache entry's modification time (its LRU order) and
writes no data, so that time is not compared. (``/proc/self/io``'s
``write_bytes`` reads 0 on a network file system.)
"""

from __future__ import annotations

import os
from pathlib import Path

GIB = 1 << 30


def schedule(t0: float, seconds: float, steps: int) -> list[float]:
    """The due time of every step of a paced window starting at ``t0``."""
    return [t0 + k * seconds / steps for k in range(steps)]


def max_steps(file_bytes: int, cap_bytes: int, setup_bytes: int) -> int:
    """The most paced steps, each writing ``file_bytes``, that fit under
    ``cap_bytes`` once the set-up has written ``setup_bytes``."""
    return max(0, (cap_bytes - setup_bytes) // file_bytes)


def file_states(root: Path) -> dict[str, tuple[int, int]]:
    """Every file under ``root`` with its inode and size."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            try:
                st = os.stat(path, follow_symlinks=False)
            except OSError:
                continue
            out[path] = (st.st_ino, st.st_size)
    return out


def written(before: dict, after: dict) -> int:
    """The bytes of the files that are new, or have another inode or
    size, from ``before`` to ``after``. A file written and removed
    between the two is not seen, so a count is taken before anything is
    removed."""
    return sum(st[1] for path, st in after.items() if before.get(path) != st)


def present(states: dict) -> dict:
    """``states`` without the files that are gone, so that a file written
    later where one was removed counts as new even if it reuses the
    removed file's inode."""
    return {p: st for p, st in states.items() if os.path.lexists(p)}
