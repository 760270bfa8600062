"""models.hbm_pool + models.llama + models.sampling: the model FLOPs of
every token produced inside the window (prefill and decode, causal
attention over the positions each token attends to) over the window,
against the H100's published dense peak for bfloat16, the dtype the
pool computes in, in percent."""

from portbench.readers import mfu


def read(rec):
    return mfu(rec, "bfloat16")
