"""Share of the window's gets the engine served without the slow
device (memtables, FD levels, promotion cache), by its `Stats`."""


def read(rec):
    c = rec["counters"]
    if c is None or not c["stats"]["gets"]:
        return None
    s = c["stats"]
    return (s["served_mem"] + s["served_fd"] + s["served_pc"]) / s["gets"]
