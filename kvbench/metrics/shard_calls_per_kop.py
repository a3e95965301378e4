"""Engine `multi_get` and `put_many` calls the shard router made in the
window, a thousand ops: the per-call fixed cost that sharding
multiplies; None where the engine counts none (`shard_calls`)."""


def read(rec):
    c = rec["counters"]
    if c is None or not rec["ops"] or "shard_calls" not in c["stats"]:
        return None
    return c["stats"]["shard_calls"] / rec["ops"] * 1000
