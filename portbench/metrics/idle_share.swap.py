"""Device: the share of the traced steps (of the traced window where the
cell has no steps) with no kernel, copy or set on the card, from
torch.profiler, in percent."""

from portbench.readers import idle_share


def read(rec):
    return idle_share(rec)
