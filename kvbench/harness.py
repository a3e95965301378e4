"""One run of one cell: set-up, the measured window, the traced rounds,
the comparison with the plain reference, and the result line.

Everything a cell needs is found by name from the root `BENCHMARK.json`:
its configuration file (`configs/`), its traffic mix
(`traffic/<name>.json`) and its per-layer metric readers
(`metrics/<name>.py`, each a `read(rec) -> float | None`).  `run.py` is
the command line; tests drive `run_cell` on the CPU at small sizes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from . import engine, profile, ycsb
from .reference.store import PlainStore, readback_mismatches, shard_of

# Every comparison is exact: a get's (seq, vlen), a put's seq, a key
# read back.  Counts of mismatches, each held to 0.
LIMITS = {"get_mismatches": 0, "put_mismatches": 0,
          "readback_mismatches": 0}
# rounds traced by the profiler, then counted by CUDA's sync debug mode
PROFILED_ROUNDS = 24
SYNC_ROUNDS = 24
# keys drawn from the seed and read back after the window
READBACK_SAMPLE = 8192
# the window ends at its deadline, but never before this many rounds
MIN_WINDOW_ROUNDS = 1


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def resolve(root: Path, name: str) -> dict:
    """A cell of `root/BENCHMARK.json` with its configuration, traffic
    mix and per-layer metric readers, found by name."""
    bench = _json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name])]
    readers = {}
    for m in layer:
        spec = importlib.util.spec_from_file_location(
            f"kvbench_metric_{m['name']}",
            root / "kvbench" / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[m["name"]] = (mod.read, m["unit"])
    return {"cell": cell, "config": _json(root / cfg["file"]),
            "traffic": _json(root / "kvbench" / "traffic"
                             / f"{cell['traffic']}.json"),
            "end_to_end": e2e, "readers": readers}


@dataclasses.dataclass
class Log:
    """Every round the store was sent and what it answered (each get's
    (seq, vlen) as two arrays, each put's seq), with the host time of
    each part."""
    rounds: list = dataclasses.field(default_factory=list)
    gets: list = dataclasses.field(default_factory=list)
    acks: list = dataclasses.field(default_factory=list)
    t_get: list = dataclasses.field(default_factory=list)
    t_put: list = dataclasses.field(default_factory=list)


def _pairs(got: list) -> tuple[np.ndarray, np.ndarray]:
    """A `multi_get` answer as (seq, vlen) arrays, (0, 0) for None."""
    s = np.fromiter((r[0] if r is not None else 0 for r in got),
                    np.int64, len(got))
    v = np.fromiter((r[1] if r is not None else 0 for r in got),
                    np.int64, len(got))
    return s, v


_NO_ACKS = np.zeros(0, dtype=np.int64)


def run_round(db, stream: ycsb.Stream, log: Log, value_len: int,
              traced: bool = False) -> None:
    """Draw one round, then send its reads as one `multi_get` and its
    writes as one `put_many`."""
    with profile.span("gen", traced):
        rnd = stream.next()
    t1 = time.perf_counter()
    with profile.span("multi_get", traced):
        got = db.multi_get(rnd.reads) if len(rnd.reads) else []
    t2 = time.perf_counter()
    with profile.span("put_many", traced):
        acks = (db.put_many(rnd.writes, value_len) if len(rnd.writes)
                else _NO_ACKS)
    t3 = time.perf_counter()
    log.rounds.append(rnd)
    # as arrays at once: millions of answer tuples held by the log would
    # slow every full collection of the garbage collector in the window
    log.gets.append(_pairs(got))
    log.acks.append(acks)
    log.t_get.append(t2 - t1)
    log.t_put.append(t3 - t2)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def check(db, log: Log, load_keys: np.ndarray, config: dict, seed: int,
          first: int, round_ops: int, n_inserted_top: int) -> tuple:
    """The run against the plain reference: ({name: count}, failed ops
    from round `first` on).  The reference replays the load and every
    round, works out each seq itself and judges every get's answer and
    every put's seq; then a sample of keys drawn from the seed (and, in
    a durable configuration, every key among each shard's newest
    writes) is read back, after a crash and recovery where the
    configuration promises durability."""
    vlen = config["value_len"]
    ref = PlainStore()
    ref.put_many(load_keys, vlen)
    get_bad = put_bad = failed = 0
    for i, (rnd, got, acks) in enumerate(zip(log.rounds, log.gets,
                                             log.acks)):
        want_s, want_v = ref.multi_get(rnd.reads)
        got_s, got_v = got
        g = (int(((got_s != want_s) | (got_v != want_v)).sum())
             if len(got_s) == len(want_s) else len(want_s))
        want_a = ref.put_many(rnd.writes, vlen)
        acks = np.asarray(acks, dtype=np.int64)
        p = (int((acks != want_a).sum()) if len(acks) == len(want_a)
             else len(want_a))
        get_bad += g
        put_bad += p
        if i >= first:
            failed += g + p
    durability = config["guarantees"].get("durability")
    rng = np.random.default_rng([seed, 1])
    sample = rng.integers(0, n_inserted_top, size=READBACK_SAMPLE)
    if durability is not None:
        wk, _, _ = ref.write_log()
        lost_max = int(durability["group_commit_records"]) - 1
        tail = [mine[max(len(mine) - lost_max, 0):] for mine in
                (wk[shard_of(wk, durability) == sh]
                 for sh in range(int(durability["n_shards"])))]
        sample = np.concatenate([sample, *tail])
        db = engine.crash_recover(db)
    got_s = np.zeros(len(sample), np.int64)
    got_v = np.zeros(len(sample), np.int64)
    for a in range(0, len(sample), round_ops):
        got_s[a:a + round_ops], got_v[a:a + round_ops] = _pairs(
            db.multi_get(sample[a:a + round_ops]))
    rb = readback_mismatches(ref, sample, got_s, got_v, durability)
    return ({"get_mismatches": get_bad, "put_mismatches": put_bad,
             "readback_mismatches": rb}, failed)


@contextlib.contextmanager
def _no_collections():
    """No pause of the garbage collector inside: the objects made so far
    are frozen out of every later collection, and collection is off."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def _p95_ms(lat: np.ndarray, ops: np.ndarray) -> float:
    """95th percentile of every op's latency, an op's latency being its
    round's."""
    return float(np.percentile(np.repeat(lat, ops), 95)) * 1e3


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             system=None, overrides: dict | None = None) -> dict:
    """One run of cell `name`: the result line as a dict.  `system`
    replaces `engine.build` (the control); `overrides` replace keys of
    the configuration and traffic files (tests at small sizes)."""
    t0 = time.perf_counter() if t0 is None else t0
    found = resolve(root, name)
    config = {**found["config"], **(overrides or {}).get("config", {})}
    traffic = {**found["traffic"], **(overrides or {}).get("traffic", {})}
    n_keys, vlen = int(config["n_keys"]), int(config["value_len"])
    round_ops = int(traffic["round_ops"])
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    phases = {"start": time.perf_counter() - t0}
    db = (system or engine.build)(config, seed, device)
    load_keys = ycsb.load_keys(n_keys, seed)
    t = time.perf_counter()
    engine.load(db, load_keys, vlen, bool(config["engine"]["lsm"]["wal"]))
    _sync(device)
    phases["load"] = time.perf_counter() - t
    stream = ycsb.Stream(traffic, n_keys, seed)
    log = Log()
    t = time.perf_counter()
    for _ in range(math.ceil(int(traffic["warmup_ops"]) / round_ops)):
        run_round(db, stream, log, vlen)
    _sync(device)
    phases["warmup"] = time.perf_counter() - t
    first = len(log.rounds)
    c0 = engine.counters(db)
    with _no_collections():
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            run_round(db, stream, log, vlen)
            if (time.perf_counter() >= deadline
                    and len(log.rounds) - first >= MIN_WINDOW_ROUNDS):
                break
        _sync(device)
        t_end = time.perf_counter()
    c1 = engine.counters(db)
    w = slice(first, len(log.rounds))
    lat = np.asarray(log.t_get[w]) + np.asarray(log.t_put[w])
    ops = np.array([len(r.reads) + len(r.writes) for r in log.rounds[w]])
    gets = sum(len(r.reads) for r in log.rounds[w])
    puts = sum(len(r.writes) for r in log.rounds[w])
    out: dict = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name() if cuda
                            else "cpu"),
                   "count": 1}
    if not trace:
        values = {"ops_per_s": float(ops.sum()) / (t_end - t_start),
                  "p95_op_ms": _p95_ms(lat, ops),
                  "setup_s": t_start - t0}
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in found["end_to_end"]}
    else:
        prof_sum = None
        if cuda:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(profile.TRACED):
                    for _ in range(PROFILED_ROUNDS):
                        run_round(db, stream, log, vlen, traced=True)
                    _sync(device)
            prof_sum = profile.summarize(prof)
            del prof
        syncs = None
        if cuda:
            from .syncs import count_syncs
            r0 = len(log.rounds)

            def rounds():
                for _ in range(SYNC_ROUNDS):
                    run_round(db, stream, log, vlen)
                _sync(device)
            _, n_syncs = count_syncs(rounds)
            syncs = {"count": n_syncs,
                     "ops": sum(len(r.reads) + len(r.writes)
                                for r in log.rounds[r0:])}
        d = engine.delta(c0, c1) if c0 is not None else None
        rec = {"ops": int(ops.sum()), "gets": gets, "puts": puts,
               "value_len": vlen, "key_bytes": int(config["key_bytes"]),
               "spans": {"multi_get": float(np.sum(log.t_get[w])),
                         "put_many": float(np.sum(log.t_put[w]))},
               "counters": d,
               "profile": prof_sum, "syncs": syncs}
        metrics = {}
        for mname, (read, unit) in found["readers"].items():
            v = read(rec)
            if v is not None:
                metrics[mname] = {"value": float(v), "unit": unit}
        if prof_sum is not None:
            device_info["busy_s"] = prof_sum["busy_s"]
            device_info["window_s"] = prof_sum["window_s"]
            out["breakdown"] = prof_sum["breakdown"]
    device_info["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated()) if cuda else 0)
    attempted = sum(len(r.reads) + len(r.writes)
                    for r in log.rounds[first:])
    t = time.perf_counter()
    counts, failed = check(db, log, load_keys, config, seed, first,
                           round_ops, stream.next_insert)
    del db
    phases["check"] = time.perf_counter() - t
    checks = {k: {"value": v, "limit": LIMITS[k]}
              for k, v in counts.items()}
    return {"correct": all(v <= LIMITS[k] for k, v in counts.items()),
            "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device_info, **out, "phases_s": phases,
            "checks": checks}
