"""models.direct decode into the HostRing: the mean over the steps of
the program's decode stage wall."""

from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "decode")
