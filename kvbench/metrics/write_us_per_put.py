"""Host microseconds inside the engine's `put_many` calls over the
window, a put (flushes, compactions, promotion installs and WAL group
commits run inline there)."""


def read(rec):
    if not rec["puts"]:
        return None
    return rec["spans"]["put_many"] / rec["puts"] * 1e6
