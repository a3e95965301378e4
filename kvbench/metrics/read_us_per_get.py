"""Host microseconds inside the engine's `multi_get` calls over the
window, a get."""


def read(rec):
    if not rec["gets"]:
        return None
    return rec["spans"]["multi_get"] / rec["gets"] * 1e6
