"""transfer.pull resolve + cas_metadata: the mean over the steps of the
program's two stage walls of a hot-swap."""

from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "resolve", "cas_metadata")
