"""The system under test: the port's HotRAP engine (`repro_torch.core`),
built and loaded as a configuration file says, and read through its
own counters.

Only `multi_get`, `put_many` and, in a durable configuration (a WAL),
the engine's `recover` are driven; everything else here reads counters
the engine keeps (`Stats`, `StorageSim`).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def build(config: dict, seed: int, device: str):
    """The engine a configuration file describes, on `device`."""
    from repro_torch.core import LSMConfig, ShardConfig, baselines
    eng = config["engine"]
    cfg = LSMConfig(**eng["lsm"])
    if eng.get("shards") is None:
        return baselines.make_system(eng["system"], cfg, seed=seed,
                                     device=device)
    return baselines.make_sharded_system(
        eng["system"], cfg, ShardConfig(**eng["shards"]), seed=seed,
        device=device)


# keys a `put_many` of the load
LOAD_BLOCK = 65536


def load(db, keys: np.ndarray, value_len: int, wal: bool) -> None:
    """Put every key once, in the given order, and flush: in blocks of
    `LOAD_BLOCK` keys, or key by key as `repro_torch.core.runner.load_db`
    does where the engine keeps a WAL (its group commits differ under
    batches, so a batched load would leave another durable state)."""
    if wal:
        for k in keys.tolist():
            db.put(k, value_len)
    else:
        for i in range(0, len(keys), LOAD_BLOCK):
            db.put_many(keys[i:i + LOAD_BLOCK], value_len)
    db.flush_all()


def _storages(db) -> list:
    sts = getattr(db, "storages", None)
    return list(sts) if sts else [db.storage]


def counters(db) -> dict:
    """The engine's own counters at this moment: its `Stats`, each
    simulated device's busy seconds and the bytes written to the
    simulated devices; None for a store that keeps none (the
    control)."""
    if not hasattr(db, "stats"):
        return None
    busy = {}
    write_bytes = 0
    for st in _storages(db):
        for t, d in st.dev.items():
            busy[(id(st), t)] = d.busy
            write_bytes += d.write_bytes
    return {"stats": dataclasses.asdict(db.stats), "busy": busy,
            "write_bytes": write_bytes}


def delta(a: dict, b: dict) -> dict:
    """What the counters moved by from snapshot `a` to snapshot `b`."""
    return {
        "stats": {k: b["stats"][k] - a["stats"][k] for k in b["stats"]},
        "busiest_s": max(v - a["busy"].get(k, 0.0)
                         for k, v in b["busy"].items()),
        "write_bytes": b["write_bytes"] - a["write_bytes"],
    }


def crash_recover(db):
    """Crash the engine where it stands and recover it from its durable
    half (its WALs and manifests) alone."""
    return type(db).recover(db)
