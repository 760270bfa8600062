"""models.hbm_pool: the pool's own ttft_s, the mean over every request
whose first token came inside the window."""


def read(rec):
    t0 = rec.window_start
    t1 = t0 + rec.seconds
    vals = [r["ttft_s"] for r in rec.requests
            if r.get("times") and t0 <= r["times"][0] <= t1]
    return sum(vals) / len(vals) if vals else None
