"""Host cost of the HotRAP engine (`repro_torch.core`) by function and
by span.

    PYTHONPATH=src python -m repro_torch.launch.profile_lsm \\
        [--system hotrap] [--mix RO] [--dist hotspot] [--scale medium] \\
        [--ops 20000] [--device cuda] [--shards N] [--wal]

Loads `--system` at `runner.default_config(--scale)` with 1,000-byte
values (timed) — with `--wal` the engine keeps its WAL and manifest
(`LSMConfig(wal=True)`), with `--shards N` (N > 1) it is a cluster of N
hash shards with the HotBudget arbiter on
(`make_sharded_system(..., ShardConfig(n_shards=N))`) — then drives `--ops` ops of the YCSB mix, each time
on a copy of the loaded engine (`copy.deepcopy`: its tensors cloned on
the device; the copy is not timed): once under cProfile (the run's wall
under the profiler, and the functions of `repro_torch` with the most
cumulative time); once with a wall-clock observability plane attached
(`Observability(clock="wall")`: each span's count and total and self
µs an op, the device indexes built again a thousand ops, and the
commit's block-cache accesses a get and the share of them that hit,
the checker's candidates a record and block-cache accesses a candidate,
`spans`; on a cluster also the router's own µs an op outside the
shards' root spans and the counters of `ClusterStats` a thousand ops,
`spans.cluster`);
and on CUDA once counting the host syncs CUDA's sync debug mode
reports and once with the plane under `torch.profiler`, whose trace
gives the card's idle seconds by the innermost engine span the host
was in (`spans.idle_by_span`).  On the CPU the engine runs on one torch
thread.  Prints the card's name and power limit (on CUDA), then one
JSON line.  It profiles whatever `repro_torch` is on the path, so
`PYTHONPATH=<tree>/src` measures another tree.
"""
from __future__ import annotations

import argparse
import copy
import cProfile
import dataclasses
import json
import pstats
import subprocess
import time
import warnings

import torch

from ..core import runner
from ..core.baselines import make_sharded_system, make_system
from ..core.shards import ShardConfig
from ..data import workloads
from ..obs import MIRROR_PREFIX, Observability

# the engine's counters of device indexes built again
BUILDS = ("level_index/build", "ralt_index/build")
# the profiler range around the run whose idle gaps are split by span
WINDOW = "profile_lsm.run"
# a cluster's router spans, each with the shards' root span it calls
ROUTER = {"router_batch": "get", "router_put": "put"}
# the counters a cluster adds to `Stats` (`ClusterStats`)
CLUSTER_COUNTERS = ("wal_syncs", "wal_bytes", "router_batches",
                    "shard_calls", "hot_budget_rebalances")


def _run(loaded, args, n_keys: int, obs=None):
    """The workload on a copy of the loaded engine (the copy untimed),
    with `obs` attached to the copy when given: its result, its wall
    seconds and the copy."""
    db = copy.deepcopy(loaded)
    if obs is not None:
        obs.attach(db, name=args.system)
    wl = workloads.ycsb(args.mix, workloads.KeyDist(args.dist, n_keys),
                        args.ops, 1000, seed=0)
    t0 = time.perf_counter()
    res = runner.run_workload(db, wl, name=args.system)
    if db.device.type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, db


def cluster_split(self_times: dict, before, after, ops: int) -> dict:
    """A cluster's run: each router span's µs an op outside the shards'
    root spans it calls (`ROUTER`; the shards' spans lie on their own
    lanes, so `self_times` leaves them in), and the `ClusterStats`
    counters the run moved, a thousand ops."""
    def total(name):
        return self_times.get(name, {}).get("total_s", 0.0)
    return {"router_us_per_op": {
                r: (total(r) - total(inner)) / ops * 1e6
                for r, inner in ROUTER.items()},
            "counters_per_kop": {
                k: (getattr(after, k) - getattr(before, k)) / ops * 1e3
                for k in CLUSTER_COUNTERS}}


def idle_by_span(prof, window: str = WINDOW) -> dict | None:
    """The card's idle seconds inside the host range `window` of a
    `torch.profiler` trace (`idle_s`), and each idle gap's seconds by the
    innermost engine span (a range named `MIRROR_PREFIX` + span) open on
    the host at the gap's midpoint (`by_span`; "none" where none was);
    None where the range holds no device operation."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = [(e.name(), e.device_type() == cuda, e.start_ns(),
            e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    win = [(a, b) for n, dev, a, b in evs if n == window and not dev]
    if not win:
        return None
    w0, w1 = win[0]
    busy = sorted((max(a, w0), min(b, w1)) for n, dev, a, b in evs
                  if dev and b > w0 and a < w1 and n != window
                  and not n.startswith(MIRROR_PREFIX))
    if not busy:
        return None
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    spans = [(n[len(MIRROR_PREFIX):], a, b) for n, dev, a, b in evs
             if not dev and n.startswith(MIRROR_PREFIX)]
    # one sweep over the spans' starts and ends (a start first at a
    # tie) against the gaps' midpoints, both in time order
    marks = sorted([(a, 0, i) for i, (_, a, _) in enumerate(spans)]
                   + [(b, 1, i) for i, (_, _, b) in enumerate(spans)])
    open_: list[int] = []
    by_span: dict[str, float] = {}
    k = 0
    for a, b in gaps:
        mid = (a + b) // 2
        while k < len(marks) and marks[k][0] <= mid:
            _, ends, i = marks[k]
            if ends:
                open_.remove(i)
            else:
                open_.append(i)
            k += 1
        host = (spans[max(open_, key=lambda i: spans[i][1])][0]
                if open_ else "none")
        by_span[host] = by_span.get(host, 0.0) + (b - a) / 1e9
    return {"idle_s": sum(b - a for a, b in gaps) / 1e9,
            "by_span": by_span}


def _spans(loaded, args, n_keys: int) -> dict:
    """The `spans` part of the output: the run with a wall-clock plane
    attached, and on CUDA its idle gaps under the profiler."""
    obs = Observability(clock="wall")
    res, wall, db = _run(loaded, args, n_keys, obs)
    tr = obs.tracer
    st = tr.self_times()
    # the commit's and the checker's counters, summed over their closed
    # spans
    def ends(name):
        return [ev.get("args", {}) for ev in tr.events
                if ev["name"] == name and ev["ph"] == "E"]

    def total(args, key):
        return sum(a.get(key, 0) for a in args)

    commits, checks = ends("get/commit"), ends("checker")
    gets = res.stats["gets"] - loaded.stats.gets
    events = total(commits, "block_events")
    hits = total(commits, "cache_hits")
    records = total(checks, "records")
    cands = total(checks, "candidates")
    walks = total(checks, "block_events")
    out = {"run_s": wall, "dropped": tr.dropped,
           "commit": {"block_events_per_get": events / gets if gets else 0.0,
                      "cache_hit_share": hits / events if events else 0.0},
           "checker": {"candidates_per_record":
                       cands / records if records else 0.0,
                       "block_events_per_candidate":
                       walks / cands if cands else 0.0},
           "us_per_op": {n: {"count": v["count"],
                             "total": v["total_s"] / args.ops * 1e6,
                             "self": v["self_s"] / args.ops * 1e6}
                         for n, v in sorted(st.items())},
           "builds_per_kop": {n: tr.count(n) / args.ops * 1e3
                              for n in BUILDS}}
    if hasattr(db, "shards"):
        out["cluster"] = cluster_split(st, loaded.stats, db.stats,
                                       args.ops)
    if loaded.device.type == "cuda":
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                _run(loaded, args, n_keys, Observability(clock="wall"))
        out["idle_by_span"] = idle_by_span(prof)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--system", default="hotrap")
    ap.add_argument("--mix", default="RO")
    ap.add_argument("--dist", default="hotspot")
    ap.add_argument("--scale", default="medium")
    ap.add_argument("--ops", type=int, default=20_000)
    ap.add_argument("--device", default=None)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--wal", action="store_true")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(runner.default_config(args.scale),
                              wal=args.wal)
    n_keys = runner.db_key_count(cfg, 1000)
    if args.shards > 1:
        db = make_sharded_system(args.system, cfg,
                                 ShardConfig(n_shards=args.shards),
                                 device=args.device)
    else:
        db = make_system(args.system, cfg, device=args.device)
    cuda = db.device.type == "cuda"
    if not cuda:
        torch.set_num_threads(1)     # many small ops: a pool costs more
    t0 = time.perf_counter()
    runner.load_db(db, n_keys, 1000)
    if cuda:
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prof = cProfile.Profile()
    prof.enable()
    res, wall, _ = _run(db, args, n_keys)
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[3], v[2], v[1], f"{k[0].split('repro_torch/')[-1]}:"
                    f"{k[1]}({k[2]})") for k, v in stats.items()
                   if "repro_torch" in k[0]), reverse=True)
    out = {"system": args.system, "mix": args.mix, "dist": args.dist,
           "scale": args.scale, "shards": args.shards, "wal": args.wal,
           "keys": n_keys, "ops": args.ops,
           "device": str(db.device), "load_s": load_s, "run_s": wall,
           "us_per_op": wall / args.ops * 1e6,
           "fd_hit_rate": res.fd_hit_rate, "sim_ops_per_s": res.throughput,
           "durability": res.durability,
           "top_cumulative": [{"fn": name, "cum_s": cum, "self_s": own,
                               "calls": calls}
                              for cum, own, calls, name in rows[:args.top]]}
    out["spans"] = _spans(db, args, n_keys)
    if cuda:
        count = [0]

        def seen(message, *a, **kw):
            count[0] += "synchroniz" in str(message)

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _run(db, args, n_keys)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        out["syncs_per_op"] = count[0] / args.ops
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
