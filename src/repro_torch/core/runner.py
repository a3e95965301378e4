"""Load and run phases of a workload on a `TieredLSM` or a sharded
cluster: the port of `repro.core.runner`.

Mirrors the paper's methodology (§4.2): a load phase inserts the whole
key space (shuffled), then the run phase executes the workload; reported
throughput is ops / simulated-I/O-bound time over the final 10% of the
run phase.  `BENCH_SCHEMA` and `RunResult.to_json()` are the
reference's, field for field.  `run_workload` and `load_db` drive a
`TieredLSM` or a `ShardedTieredLSM` (core/shards.py) alike: a sharded
run is timed shared-nothing (the busiest device of any shard gates
the window), its fan-out ops cost the slowest shard's delta, and the
hottest shard's utilisation is the queueing model, as in the
reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..data.workloads import (OP_INSERT, OP_READ, OP_SCAN, OP_UPDATE,
                              Workload, load_keys)
from ..obs import NULL_OBS, TierLatencyHistogram, jsonify
from .baselines import make_system
from .lsm import LSMConfig, Stats, TieredLSM, key_array
from .sstable import KEY_BYTES
from .storage import MIB

# Version tag for every BENCH_*.json the benchmarks write; bump when a
# field changes meaning, add freely without bumping.
BENCH_SCHEMA = "hotrap-bench/1"


@dataclasses.dataclass
class RunResult:
    system: str
    n_ops: int
    sim_seconds: float          # whole run phase
    tail_window_seconds: float  # final 10% of ops
    throughput: float           # ops/s over final 10% (paper metric)
    fd_hit_rate: float
    latency: TierLatencyHistogram | None  # joint (fd, sd) device-time
                                          # histogram of final-10%
                                          # gets/scans (None when off)
    stats: dict
    storage: dict
    scan_fd_hit_rate: float = 0.0   # scanned records served off FD, final 10%
    scan_merge_ops_per_record: float = 0.0  # cursor pulls + merge compares
                                            # per scanned record (whole run)
    # --- effective admission / cluster settings ---
    range_promo_frac: float = 0.0   # the run's whole-range admission knob
    n_shards: int = 1               # shard count at the END of the run
    shard_budget: dict | None = None  # HotBudget knobs (None: unsharded)
    # --- dynamic repartitioning ---
    n_repartitions: int = 0         # splits + merges during THIS run
    migration_bytes: int = 0        # pre-copy reads + install writes
    repartition: dict | None = None  # Repartitioner snapshot (None: off)
    # --- durability ---
    durability: dict | None = None   # WAL/manifest counters (None: off)
    # --- observability plane ---
    infl_fd: float = 1.0            # 1/(1-rho_FD): queueing inflation
    infl_sd: float = 1.0            # 1/(1-rho_SD): applied at quantile
                                    # time, so the histogram can store
                                    # raw device deltas during the run
    attribution: dict | None = None  # attribution summary (None: no obs)

    # Quantiles of infl_fd*fd + infl_sd*sd over the joint histogram —
    # each term is exact to one log-bin width (ratio ~1.075).
    @property
    def p50(self) -> float:
        return self.latency.percentile(0.50, self.infl_fd, self.infl_sd) \
            if self.latency is not None else 0.0

    @property
    def p99(self) -> float:
        return self.latency.percentile(0.99, self.infl_fd, self.infl_sd) \
            if self.latency is not None else 0.0

    @property
    def p999(self) -> float:
        return self.latency.percentile(0.999, self.infl_fd, self.infl_sd) \
            if self.latency is not None else 0.0

    @property
    def mean_latency(self) -> float:
        h = self.latency
        if h is None or h.count == 0:
            return 0.0
        return (h.sum_fd * self.infl_fd + h.sum_sd * self.infl_sd) / h.count

    def to_json(self) -> dict:
        """Schema-versioned JSON-safe digest (benchmarks' BENCH_*.json)."""
        return jsonify({
            "schema": BENCH_SCHEMA,
            "system": self.system,
            "n_ops": self.n_ops,
            "sim_seconds": self.sim_seconds,
            "tail_window_seconds": self.tail_window_seconds,
            "throughput": self.throughput,
            "fd_hit_rate": self.fd_hit_rate,
            "scan_fd_hit_rate": self.scan_fd_hit_rate,
            "scan_merge_ops_per_record": self.scan_merge_ops_per_record,
            "range_promo_frac": self.range_promo_frac,
            "n_shards": self.n_shards,
            "shard_budget": self.shard_budget,
            "n_repartitions": self.n_repartitions,
            "migration_bytes": self.migration_bytes,
            "repartition": self.repartition,
            "durability": self.durability,
            "latency": {
                "p50": self.p50, "p99": self.p99, "p999": self.p999,
                "mean": self.mean_latency,
                "infl_fd": self.infl_fd, "infl_sd": self.infl_sd,
                "hist": self.latency.to_json() if self.latency else None,
            },
            "attribution": self.attribution,
            "stats": self.stats,
            "storage": self.storage,
        })


def default_config(scale: str = "small") -> LSMConfig:
    """Laptop-scaled versions of the paper's 10 GB FD : 100 GB SD setup."""
    if scale == "tiny":        # tests
        return LSMConfig(fd_size=2 * MIB, sd_size=20 * MIB,
                         target_sstable_bytes=128 * 1024,
                         memtable_bytes=128 * 1024,
                         block_cache_bytes=64 * 1024)
    if scale == "small":       # default benchmarks
        return LSMConfig(fd_size=16 * MIB, sd_size=160 * MIB,
                         target_sstable_bytes=512 * 1024,
                         memtable_bytes=512 * 1024,
                         block_cache_bytes=256 * 1024)
    if scale == "medium":      # --full benchmarks
        return LSMConfig(fd_size=64 * MIB, sd_size=640 * MIB,
                         target_sstable_bytes=1 * MIB,
                         memtable_bytes=1 * MIB,
                         block_cache_bytes=1 * MIB)
    raise ValueError(scale)


def db_key_count(cfg: LSMConfig, value_len: int) -> int:
    """#records so the loaded DB is ~ (fd+sd) * 10/11 full (paper: 110 GB
    into a 10+100 GB hierarchy ≈ fully tiered)."""
    total = cfg.fd_size + cfg.sd_size
    return int(total / (KEY_BYTES + value_len))


def load_db(db: TieredLSM, n_keys: int, value_len: int, seed: int = 0
            ) -> None:
    for k in load_keys(n_keys, seed):
        db.put(int(k), value_len)
    db.flush_all()


def _db_storages(db) -> list:
    """The DB's StorageSim slices: one for a plain TieredLSM, one per
    shard for a ShardedTieredLSM (shared-nothing accounting, including
    slices retired by repartitioning — their history counts)."""
    sts = getattr(db, "storages", None)
    return list(sts) if sts else [db.storage]


def _live_storages(db) -> list:
    """Only the currently-live shards' slices (per-op latency deltas:
    a storage retired *before* the op is frozen, so its delta is
    provably zero — no need to walk the retired list every op)."""
    shards = getattr(db, "shards", None)
    if shards is None:
        return [db.storage]
    return [s.storage for s in shards]


def _durability_snapshot(db) -> dict | None:
    """WAL/manifest lifetime counters for RunResult (None when the
    engine runs without a WAL)."""
    dur = getattr(db, "durability", None)
    if dur is None:
        return None
    shards = getattr(db, "shards", None)
    durs = ([sh.durability for sh in shards] if shards is not None
            else [dur])
    out = {
        "wal_appended_records": sum(d.wal.appended_records for d in durs),
        "wal_group_commits": sum(d.wal.syncs for d in durs),
        "wal_synced_bytes": sum(d.wal.synced_bytes for d in durs),
        "manifest_edits": sum(d.manifest.edits for d in durs),
        "durable_horizon": max((d.horizon() for d in durs), default=0),
    }
    info = getattr(db, "recovery_info", None)
    if info is not None:
        out["recovery"] = dict(info)
    return out


def _merged_storage_snapshot(sts: list) -> dict:
    """Per-tier/per-component sums across shard storages, with the
    per-shard snapshots preserved under "shards"."""
    if len(sts) == 1:
        return sts[0].snapshot()
    snaps = [st.snapshot() for st in sts]
    agg: dict = {}
    for t in ("FD", "SD"):
        agg[t] = {k: sum(s[t][k] for s in snaps) for k in snaps[0][t]}
    comps: dict = {}
    for s in snaps:
        for cname, c in s["components"].items():
            tgt = comps.setdefault(
                cname, {"read_bytes": 0, "write_bytes": 0, "time": 0.0})
            for k in c:
                tgt[k] += c[k]
    agg["components"] = comps
    agg["shards"] = snaps
    return agg


@dataclasses.dataclass
class _DriveCtx:
    """Per-run plumbing shared by `_run_segment` calls (one bundle
    instead of nine positional threading arguments)."""
    db: object
    obs: object
    rep: object
    static_sts: list | None
    lat_hist: TierLatencyHistogram | None
    track_attr: bool
    collect_latency: bool
    fresh_value: int
    results_out: list | None


def _run_segment(ctx: _DriveCtx, g0: int, keys: np.ndarray,
                 scan_lens: np.ndarray, r_mask: np.ndarray,
                 s_mask: np.ndarray, w_mask: np.ndarray,
                 tail: bool) -> None:
    """Execute one visibility-homogeneous workload segment starting at
    global op index `g0`: point reads flow through one columnar
    `multi_get`, writes through one `put_many` (seq assignment is
    order-preserving), scans per op (their extent is data-dependent;
    their batching lives in the router's planned fan-out).  Reordering
    within the segment is sound because the caller's collide check /
    run-length split guarantees the segment's reads cannot observe its
    writes; see docs/ARCHITECTURE.md "Batched execution"."""
    db = ctx.db
    obs = ctx.obs
    rep = ctx.rep
    r_sel = np.flatnonzero(r_mask)
    if len(r_sel):
        lat = (np.zeros((len(r_sel), 2)) if ctx.collect_latency else None)
        ev0 = len(rep.events) if rep is not None else 0
        res = db.multi_get(keys[g0 + r_sel], lat_out=lat)
        if ctx.results_out is not None:
            ro = ctx.results_out
            # lint: allow-loop (oracle-capture scatter — tests only;
            # per-op results are heterogeneous python objects)
            for j, r in zip(r_sel.tolist(), res):
                ro[g0 + j] = r
        if ctx.collect_latency:
            if tail:
                ctx.lat_hist.add_many(lat[:, 0], lat[:, 1])
            if ctx.track_attr:
                obs.attr.commit_stashed(
                    cutover=(rep is not None and len(rep.events) != ev0),
                    migrating=(rep is not None and rep._job is not None))
    # lint: allow-loop (per-scan execution — each range's extent is
    # data-dependent, so a scan is its own batch; the fan-out under it
    # is the router's planned per-shard scatter)
    for j in np.flatnonzero(s_mask).tolist():
        gi = g0 + j
        f0 = ()
        ev0 = 0
        if ctx.collect_latency:
            base = (ctx.static_sts if ctx.static_sts is not None
                    else _live_storages(db))
            f0 = [(st, st.dev["FD"].fg_time, st.dev["SD"].fg_time)
                  for st in base]
            ev0 = len(rep.events) if rep is not None else 0
        out = db.scan(int(keys[gi]), int(scan_lens[gi]))
        if ctx.results_out is not None:
            ctx.results_out[gi] = out
        if ctx.collect_latency:
            # shared-nothing: a fan-out op's shards serve in parallel,
            # so its latency is the slowest shard's delta.  Dynamic
            # topology: candidates = storages live at op start (a
            # cutover inside the op may have retired one — its fg
            # charges still belong to this op) plus any born during
            # the op (baseline 0).
            cand = f0
            if ctx.static_sts is None:
                known = {id(st) for st, _, _ in f0}
                cand = f0 + [(st, 0.0, 0.0) for st in _live_storages(db)
                             if id(st) not in known]
            fd_d = max(st.dev["FD"].fg_time - b for st, b, _ in cand)
            sd_d = max(st.dev["SD"].fg_time - b for st, _, b in cand)
            if tail:
                ctx.lat_hist.add(fd_d, sd_d)
            if ctx.track_attr:
                obs.attr.commit(
                    fd_d + sd_d,
                    cutover=(rep is not None and len(rep.events) != ev0),
                    migrating=(rep is not None and rep._job is not None))
    w_sel = np.flatnonzero(w_mask)
    if len(w_sel):
        seqs = db.put_many(keys[g0 + w_sel], ctx.fresh_value)
        if ctx.results_out is not None:
            ro = ctx.results_out
            # lint: allow-loop (oracle-capture scatter — tests only)
            for j, q in zip(w_sel.tolist(), np.asarray(seqs).tolist()):
                ro[g0 + j] = q


def run_workload(db, wl: Workload, name: str = "?",
                 collect_latency: bool = True, chunk_ops: int = 2048,
                 results_out: list | None = None) -> RunResult:
    """Drive one workload through a TieredLSM *or* a ShardedTieredLSM.

    Batched execution: the workload is sliced into
    struct-of-arrays chunks of `chunk_ops` ops, each grouped by op
    kind and executed through the engine's columnar batch APIs
    (`multi_get` / `put_many`; scans via the router's planned
    fan-out).  Chunk edges are forced at the final-10% boundary so the
    tail accounting snapshot is exact; a chunk whose reads could
    observe its writes (shared keys, or any scan sharing a chunk with
    a write) falls back to exact run-length segments in op order.
    Results and seqs are byte-identical to the former per-op loop;
    per-op (fd, sd) latency deltas are recovered from the engine's
    per-key fg-time snapshots, so the latency histogram and p99
    attribution stay bit-compatible.  `results_out`, when given, is
    extended with each op's outcome in op order (get hit/None, put
    seq, scan list) — the oracle-equivalence hook for tests and the
    card's twin checks.

    Sharded runs are shared-nothing: every shard's devices serve in
    parallel, so the completion window is the *busiest single device
    across all shards* — N-way sharding of a balanced workload shrinks
    the window toward 1/N (throughput scales), while a skewed workload
    leaves one hot shard gating the cluster.  Stats are the field-wise
    aggregate over shards (ShardedTieredLSM.stats), in the `Stats`
    fields alone: a cluster's router and WAL counters (`ClusterStats`)
    stay off `RunResult`, whose fields are the reference's.

    The storage set is re-read from the DB at every accounting point
    and keyed by object identity, because dynamic repartitioning
    (core/shards.py Repartitioner) retires source shards and creates
    destinations *mid-run*: retired slices stay listed by the DB (their
    history, including migration reads, must stay in the window), and a
    device born inside the window simply has no baseline — its whole
    busy time belongs to the window.
    """
    fresh_value = wl.value_len
    n = len(wl.ops)
    tiers = ("FD", "SD")
    # Bounded-memory joint (fd, sd) histogram of final-10% get/scan
    # device deltas; quantiles of the inflated sum are recovered at run
    # end (replaces the former unbounded per-op latency arrays).
    lat_hist = TierLatencyHistogram() if collect_latency else None
    # Observability plane, if one was attached (Observability.attach
    # sets db._obs; the class default NULL_OBS is compiled out).
    obs = getattr(getattr(db, "_db", db), "_obs", NULL_OBS)
    track_attr = obs.enabled and obs.attribution and collect_latency
    obs_on = obs.enabled
    t10_start_ops = int(n * 0.9)
    busy90: dict = {}
    gets90 = hits90 = scanned90 = scan_hits90 = 0
    # only a Repartitioner changes the storage set mid-run; without one
    # the per-op latency loop can reuse one snapshot of the live slices
    rep = getattr(db, "repartitioner", None)
    static_sts = None if rep is not None else _live_storages(db)
    # baseline for this run's repartition/migration deltas (the db's
    # counters are cumulative since reset_storage)
    rep0_events = (rep.n_splits + rep.n_merges) if rep is not None else 0
    rep0_bytes = (rep.migrated_read_bytes + rep.migrated_write_bytes
                  if rep is not None else 0)
    ops = np.ascontiguousarray(wl.ops, dtype=np.int64)
    keys = key_array(wl.keys)
    scan_lens = (np.ascontiguousarray(wl.scan_lens, dtype=np.int64)
                 if wl.scan_lens is not None
                 else np.zeros(n, dtype=np.int64))
    if results_out is not None:
        results_out.extend([None] * n)
    ctx = _DriveCtx(db=db, obs=obs, rep=rep, static_sts=static_sts,
                    lat_hist=lat_hist, track_attr=track_attr,
                    collect_latency=collect_latency,
                    fresh_value=fresh_value, results_out=results_out)
    step = max(int(chunk_ops), 1)
    cuts = sorted({t10_start_ops, n} | set(range(0, n, step)))
    # lint: allow-loop (batch-bounded: one iteration per chunk of
    # `chunk_ops` ops, executed through the engine's columnar
    # multi_get/put_many batch calls below)
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        if c0 == t10_start_ops:
            busy90 = {(id(st), t): st.dev[t].busy
                      for st in _db_storages(db) for t in tiers}
            s = db.stats
            gets90 = s.gets
            hits90 = s.served_mem + s.served_fd + s.served_pc
            scanned90 = s.scanned_records
            scan_hits90 = (s.scan_served_mem + s.scan_served_fd
                           + s.scan_served_pc)
        co = ops[c0:c1]
        w_mask = (co == OP_INSERT) | (co == OP_UPDATE)
        r_mask = co == OP_READ
        s_mask = co == OP_SCAN
        tail = c0 >= t10_start_ops
        # a whole chunk reorders into read/scan/write batches only when
        # its reads provably cannot observe its writes: disjoint
        # read/write key sets, and no scan sharing the chunk with a
        # write (a scan's reach is data-dependent).  Otherwise fall
        # back to exact run-length segments in op order — each segment
        # still executes through the batched engine APIs.
        collide = w_mask.any() and (
            s_mask.any()
            or bool(np.isin(keys[c0:c1][r_mask],
                            keys[c0:c1][w_mask]).any()))
        if collide:
            flips = np.flatnonzero(np.diff(w_mask.astype(np.int8))) + 1
            edges = [0, *flips.tolist(), c1 - c0]
            # lint: allow-loop (data-dependent run-length segmentation
            # of a read/write-colliding chunk — rare; segments stay
            # batched)
            for a, b in zip(edges[:-1], edges[1:]):
                _run_segment(ctx, c0 + a, keys, scan_lens,
                             r_mask[a:b], s_mask[a:b], w_mask[a:b],
                             tail)
        else:
            _run_segment(ctx, c0, keys, scan_lens, r_mask, s_mask,
                         w_mask, tail)
        if obs_on:
            obs.on_ops(db, c1 - c0)
    sts = _db_storages(db)
    total = max(st.sim_time for st in sts)
    # Throughput = ops in window / bottleneck-device work in the window
    # (all devices of all shards serve concurrently; the busiest one
    # gates completion).
    window = max(max(st.dev[t].busy - busy90.get((id(st), t), 0.0)
                     for st in sts for t in tiers), 1e-12)
    thr = (n - t10_start_ops) / window
    # Tail latency (paper Fig. 8 metric: final 10% of the run): service
    # time inflated by steady-state device utilisation (M/M/1-style
    # 1/(1-rho)) — a saturated device queues, an idle one does not.
    # Sharded: the hottest shard's per-tier utilisation is the queueing
    # model (requests route to one shard; the loaded one queues).
    infl = {"FD": 1.0, "SD": 1.0}
    if collect_latency:
        # lint: allow-loop (two fixed tiers, not per-op data)
        for t in tiers:
            busy_t = max(st.dev[t].busy - busy90.get((id(st), t), 0.0)
                         for st in sts)
            rho = min(busy_t / window, 0.95)
            infl[t] = 1.0 / (1.0 - rho)
    # paper metric: FD hit rate over the *final 10%* of the run phase
    stats = db.stats
    gets_w = stats.gets - gets90
    hits_w = (stats.served_mem + stats.served_fd
              + stats.served_pc) - hits90
    hit_final = hits_w / gets_w if gets_w else stats.fd_hit_rate
    scanned_w = stats.scanned_records - scanned90
    scan_hits_w = (stats.scan_served_mem + stats.scan_served_fd
                   + stats.scan_served_pc) - scan_hits90
    scan_hit_final = (scan_hits_w / scanned_w if scanned_w
                      else stats.scan_fd_hit_rate)
    # effective admission / cluster settings (knob surfacing):
    # sharded DBs report the per-shard config and the HotBudget state
    shard_knobs = db.shard_knobs() if hasattr(db, "shard_knobs") else None
    eff_cfg = getattr(db, "shard_cfg", None) or db.cfg
    # repartition events + migration cost
    rep_snap = rep.snapshot() if rep is not None else None
    attr_snap = obs.attr.summary() if track_attr else None
    return RunResult(
        system=name, n_ops=n, sim_seconds=total,
        tail_window_seconds=window, throughput=thr,
        fd_hit_rate=hit_final,
        latency=lat_hist,
        infl_fd=infl["FD"], infl_sd=infl["SD"],
        attribution=attr_snap,
        stats={f.name: getattr(stats, f.name)
               for f in dataclasses.fields(Stats)},
        storage=_merged_storage_snapshot(sts),
        scan_fd_hit_rate=scan_hit_final,
        scan_merge_ops_per_record=stats.scan_merge_ops_per_record,
        range_promo_frac=float(getattr(eff_cfg, "range_promo_frac", 0.0)),
        n_shards=getattr(db, "n_shards", 1),
        shard_budget=shard_knobs,
        n_repartitions=(rep_snap["n_splits"] + rep_snap["n_merges"]
                        - rep0_events if rep_snap else 0),
        migration_bytes=(rep_snap["migrated_bytes"] - rep0_bytes
                         if rep_snap else 0),
        repartition=rep_snap,
        durability=_durability_snapshot(db))


def bench_system(system: str, mix: str, dist, n_ops: int, value_len: int,
                 scale: str = "small", seed: int = 0,
                 cfg: LSMConfig | None = None, *,
                 device=None) -> RunResult:
    from ..data.workloads import ycsb
    cfg = cfg or default_config(scale)
    db = make_system(system, cfg, seed=seed, device=device)
    n_keys = dist.n_keys
    load_db(db, n_keys, value_len, seed)
    wl = ycsb(mix, dist, n_ops, value_len, seed)
    return run_workload(db, wl, name=system)
