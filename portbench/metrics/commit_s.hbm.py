"""models.loader commit: the mean over the steps of the program's
hbm_commit stage wall of a landing (the decode runs inside it on the
direct landing)."""

from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "hbm_commit")
