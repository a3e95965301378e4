"""Bytes the simulated devices (FD and SD) were written in the window
over the user bytes put (key and value of each put)."""


def read(rec):
    c = rec["counters"]
    if c is None or not rec["puts"]:
        return None
    return c["write_bytes"] / (rec["puts"]
                               * (rec["key_bytes"] + rec["value_len"]))
