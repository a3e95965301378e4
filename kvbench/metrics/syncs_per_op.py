"""Host syncs an op, counted by CUDA's sync debug mode over the counted
rounds."""


def read(rec):
    s = rec["syncs"]
    if s is None or not s["ops"]:
        return None
    return s["count"] / s["ops"]
