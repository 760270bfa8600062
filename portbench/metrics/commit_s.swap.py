"""models.loader commit of a hot-swap: the mean over the steps of the
program's hbm_commit stage wall."""

from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "hbm_commit")
