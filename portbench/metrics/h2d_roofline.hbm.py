"""Host link: the landed bytes at PCIe Gen5 x16's published 64 GB/s a
direction over the step's host-clock time to the landing's end, in
percent."""

from portbench.readers import h2d_share


def read(rec):
    return h2d_share(rec)
