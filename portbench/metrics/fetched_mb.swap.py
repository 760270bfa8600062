"""transfer.delta + transfer.bridge: the mean over the steps of the
bytes a swap fetched over the network (the program's
delta.fetched_bytes), in MB."""

from portbench.readers import mean


def read(rec):
    v = mean([(s["stats"].get("delta") or {}).get("fetched_bytes")
                 for s in rec.steps if s["stats"].get("delta")])
    return None if v is None else v / 1e6

