"""Share of the traced rounds in which no kernel, copy or set ran on the
card (`torch.profiler`'s device timeline)."""


def read(rec):
    p = rec["profile"]
    if p is None or p["window_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
