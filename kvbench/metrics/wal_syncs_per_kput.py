"""Group commits of every shard's write-ahead log in the window, a
thousand puts; None where the engine counts none (`wal_syncs`)."""


def read(rec):
    c = rec["counters"]
    if c is None or not rec["puts"] or "wal_syncs" not in c["stats"]:
        return None
    return c["stats"]["wal_syncs"] / rec["puts"] * 1000
