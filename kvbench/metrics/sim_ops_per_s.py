"""The paper's metric: the window's ops over the busy time the busiest
simulated device (StorageSim, paper Table 1) accrued in the window."""


def read(rec):
    c = rec["counters"]
    if c is None or c["busiest_s"] <= 0:
        return None
    return rec["ops"] / c["busiest_s"]
