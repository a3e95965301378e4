"""The port's dynamic repartitioning (`repro_torch.core.shards.
Repartitioner`) against the numpy reference, on the CPU: the
counterparts of `tests/test_repartition.py`'s cells, the repartitioned
PrismDB included.

Each cell feeds one seeded op stream to a reference cluster and a port
cluster (and, where the reference test has one, a port engine without
shards) and requires every op's result equal at every op, across every
split and merge; then every shard equal by content, the fences, the
repartitioner's ledger and events, the arbiter's shares, and the RALT
records a split hands its children, float64 scores bit for bit."""
import dataclasses
import importlib.util
import io
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref
from repro.core import runner as ref_runner
from repro.data import workloads as ref_wl
from repro_torch import core as port
from repro_torch.configs import hotrap_kv
from repro_torch.core import ralt, runner
from repro_torch.data import workloads as twl

KIB = 1024
MIB = 1024 * 1024
KEYSPACE = 800


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engine's many small CPU ops run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cluster_kw(**kw):
    base = dict(fd_size=512 * KIB, sd_size=4 * MIB,
                target_sstable_bytes=32 * KIB, memtable_bytes=16 * KIB,
                block_cache_bytes=16 * KIB, checker_delay_ops=16,
                hotrap=True)
    base.update(kw)
    return base


def repart_kw(partitioning="range", **kw):
    base = dict(n_shards=4, partitioning=partitioning, key_space=KEYSPACE,
                repartition=True, repartition_interval_ops=300,
                repartition_cooldown_ops=200, migration_records_per_op=64,
                rebalance_interval_ops=250, memtable_floor=8 * KIB,
                block_cache_floor=8 * KIB)
    base.update(kw)
    return base


def pair(system="hotrap", cfg=None, **scfg):
    """The reference's cluster and the port's (on the CPU) of `system`."""
    cfg = cfg or cluster_kw()
    scfg = repart_kw(**scfg)
    return (ref.make_sharded_system(system, ref.LSMConfig(**cfg),
                                    shard_cfg=ref.ShardConfig(**scfg),
                                    seed=0),
            port.make_sharded_system(system, port.LSMConfig(**cfg),
                                     shard_cfg=port.ShardConfig(**scfg),
                                     seed=0, device="cpu"))


def oracle(system="hotrap", cfg=None):
    return port.make_system(system, port.LSMConfig(**(cfg or cluster_kw())),
                            seed=0, device="cpu")


def skewed_ops(n_ops=6000, seed=5, hot_quarter=0, hot_prob=0.7,
               keyspace=KEYSPACE):
    """`test_repartition.skewed_trace`'s stream, drawn once."""
    rng = np.random.default_rng(seed)
    q = keyspace // 4
    out = []
    for _ in range(n_ops):
        if rng.random() < hot_prob:
            k = hot_quarter * q + int(rng.integers(0, q))
        else:
            k = int(rng.integers(0, keyspace))
        r = rng.random()
        if r < 0.50:
            out.append(("put", k, 100))
        elif r < 0.60:
            out.append(("delete", k))
        elif r < 0.80:
            out.append(("get", k))
        elif r < 0.90:
            out.append(("scan", int(rng.integers(0, keyspace)),
                        int(rng.integers(1, 40))))
        else:
            lo = int(rng.integers(0, keyspace))
            out.append(("scan_range", lo, lo + 150))
    return out


def drive(dbs, ops):
    """Every op on every store; results equal at every op."""
    for i, (name, *args) in enumerate(ops):
        res = [getattr(db, name)(*args) for db in dbs]
        assert all(r == res[0] for r in res[1:]), (i, name, args, res)


def ralt_state(sh) -> list:
    """A shard's RALT records run by run in the reference's columns
    (float64 scores and counters as their bytes), with its clocks and
    limits."""
    r = sh.ralt
    if r is None:
        return []
    out = [r.tick, r.epoch, r.hot_threshold, r.hot_set_limit, r.phys_limit,
           r.hot_set_bytes]
    for run in r.runs:
        if hasattr(run, "ints"):
            ints, floats = run.ints.numpy(), run.floats.numpy()
            cols = (ints[ralt.KEY], ints[ralt.VLEN], ints[ralt.TICK],
                    floats[ralt.SCORE], floats[ralt.CNT], ints[ralt.TAG],
                    ints[ralt.EPOCH])
        else:
            cols = (run.keys, run.vlens, run.ticks, run.scores, run.cnts,
                    run.tags, run.epochs)
        out.append([c.astype(np.float64).tobytes() if c.dtype.kind == "f"
                    else c.astype(np.int64).tobytes() for c in cols])
    return out


def assert_same_cluster(want, got):
    assert cs.json_mismatches(cs.engine_digest(want),
                              cs.engine_digest(got)) == []
    # every field of the reference cluster's Stats, exactly; the
    # port's ClusterStats adds the router's and the WALs' counters
    want_stats = dataclasses.asdict(want.stats)
    got_stats = dataclasses.asdict(got.stats)
    assert {k: got_stats[k] for k in want_stats} == want_stats
    assert [s.snapshot() for s in got.storages] == \
        [s.snapshot() for s in want.storages]
    assert [ralt_state(s) for s in got.shards] == \
        [ralt_state(s) for s in want.shards]


def assert_map_consistent(db):
    bounds = db._bounds_list
    assert len(bounds) == len(db.shards) - 1
    assert all(bounds[i] < bounds[i + 1] for i in range(len(bounds) - 1))
    keys = np.arange(0, KEYSPACE, 13)
    assert [db.shard_of(int(k)) for k in keys] == db._shard_ids(keys).tolist()


# ----------------------------------------------------------------------
# oracle equivalence across mid-workload splits and merges
# ----------------------------------------------------------------------
def test_split_and_merge_equal_reference_range():
    """Contiguous skew splits and merges mid-workload in both packages
    at the same ops, at the same keys, with every result unchanged."""
    want, got = pair()
    drive([want, got, oracle()], skewed_ops())
    rep = got.repartitioner
    assert rep.n_splits >= 1 and rep.n_merges >= 1
    assert_map_consistent(got)
    assert rep.events == want.repartitioner.events
    assert_same_cluster(want, got)


def test_hash_cluster_repartition_is_noop():
    want, got = pair(partitioning="hash")
    drive([want, got, oracle()], skewed_ops(3000, 7))
    rep = got.repartitioner
    assert rep.incompatible_checks == want.repartitioner.incompatible_checks
    assert rep.incompatible_checks > 0
    assert rep.n_splits == rep.n_merges == 0 and len(got.shards) == 4
    assert rep.force_split(0) is False and rep.force_merge(0) is False
    assert_same_cluster(want, got)


def test_forced_split_then_merge_roundtrip():
    """A split at a chosen key and the merge back: every get and scan
    over the keyspace equal at each topology, the fences tracking."""
    want, got = pair(repartition_interval_ops=10 ** 9)
    orc = oracle()
    rng = np.random.default_rng(3)
    drive([want, got, orc], [("put", int(rng.integers(0, KEYSPACE)), 120)
                             for _ in range(2500)])

    def check_all():
        assert_map_consistent(got)
        ops = [("get", k) for k in range(0, KEYSPACE, 7)]
        ops += [("scan", lo, 25) for lo in range(0, KEYSPACE, 97)]
        ops += [("scan_range", 0, KEYSPACE)]
        drive([want, got, orc], ops)
        assert_same_cluster(want, got)

    for db in (want, got):
        assert db.repartitioner.force_split(0, split_key=90)
        db.repartitioner.drain()
    assert 90 in got._bounds_list and len(got.shards) == 5
    check_all()
    i = got._bounds_list.index(90)
    for db in (want, got):
        assert db.repartitioner.force_merge(i)
        db.repartitioner.drain()
    assert 90 not in got._bounds_list and len(got.shards) == 4
    check_all()


def test_repartition_tiered_baseline_equals_reference():
    """`rocksdb_tiered` repartitions on its fd-used demand signal."""
    cfg = cluster_kw(hotrap=False)
    want, got = pair("rocksdb_tiered", cfg)
    drive([want, got, oracle("rocksdb_tiered", cfg)], skewed_ops(3000, 11))
    assert_map_consistent(got)
    assert_same_cluster(want, got)


def test_repartition_prismdb_equals_reference():
    """`tests/test_repartition.py:159`'s PrismDB cell: a clock-bit
    engine repartitions on its fd-used demand signal as the
    reference's does."""
    cfg = cluster_kw(hotrap=False)
    want, got = pair("prismdb", cfg)
    drive([want, got, oracle("prismdb", cfg)], skewed_ops(3000, 11))
    assert_map_consistent(got)
    assert_same_cluster(want, got)
    assert [list(sh.clock.items()) for sh in got.shards] == \
        [list(sh.clock.items()) for sh in want.shards]


# ----------------------------------------------------------------------
# live migration
# ----------------------------------------------------------------------
def test_map_atomicity_under_interleaved_multi_get_and_scan():
    want, got = pair(repartition_interval_ops=10 ** 9,
                     migration_records_per_op=8)
    orc = oracle()
    rng = np.random.default_rng(13)
    drive([want, got, orc], [("put", int(rng.integers(0, KEYSPACE)), 120)
                             for _ in range(3000)])
    assert want.repartitioner.force_split(1)
    assert got.repartitioner.force_split(1)
    saw_active = False
    while True:
        active = got.repartitioner._job is not None
        assert active == (want.repartitioner._job is not None)
        saw_active |= active
        assert_map_consistent(got)
        keys = rng.integers(0, KEYSPACE, size=32)
        res = got.multi_get(keys)
        assert res == want.multi_get(keys.astype(np.uint64))
        assert res == [orc.get(int(k)) for k in keys]
        lo = int(rng.integers(0, KEYSPACE))
        k = int(rng.integers(0, KEYSPACE))
        drive([want, got, orc], [("scan", lo, 20), ("put", k, 120)])
        if not active:
            break
    assert saw_active and got.repartitioner.n_splits == 1
    assert_same_cluster(want, got)


def test_migration_pins_source_version_until_cutover():
    want, got = pair(repartition_interval_ops=10 ** 9,
                     migration_records_per_op=4)
    for db in (want, got):
        for k in range(KEYSPACE):
            db.put(k, 150)
        db.flush_all()
    v = got.shards[2].version
    refs_before = v.refs
    rep = got.repartitioner
    assert rep.force_split(2)
    assert v.refs == refs_before + 1
    assert any(p is v for p in rep._job.pins)
    rep.drain()
    assert v.refs == refs_before - 1
    assert want.repartitioner.force_split(2)
    want.repartitioner.drain()
    assert_same_cluster(want, got)


def test_migration_cost_in_runresult_equals_reference():
    """`run_workload` over a repartitioning cluster: `to_json()` (events,
    migration bytes, the merged storage snapshot with retired slices)
    and every op's outcome equal the reference's."""
    want, got = pair(repartition_interval_ops=250,
                     repartition_cooldown_ops=150)
    for db in (want, got):
        for k in range(KEYSPACE):
            db.put(k, 200)
        db.flush_all()
        db.reset_storage()
    kw = dict(hot_frac=0.10, scramble=False)
    w_wl = ref_wl.ycsb("RW", ref_wl.KeyDist("hotspot", KEYSPACE, **kw),
                       6000, 200, seed=7)
    g_wl = twl.ycsb("RW", twl.KeyDist("hotspot", KEYSPACE, **kw), 6000,
                    200, seed=7)
    w_out, g_out = [], []
    w_res = ref_runner.run_workload(want, w_wl, name="x", results_out=w_out)
    res = runner.run_workload(got, g_wl, name="x", results_out=g_out)
    assert cs.json_mismatches(w_res.to_json(), res.to_json()) == []
    assert g_out == w_out
    assert res.n_repartitions >= 1 and res.migration_bytes > 0
    snap = res.repartition
    assert snap["migrated_read_bytes"] > 0 < snap["migrated_write_bytes"]
    assert res.storage["components"]["migration"]["read_bytes"] > 0
    assert len(res.storage["shards"]) >= len(got.shards)
    assert_same_cluster(want, got)


def test_retired_shard_stats_fold_into_aggregate():
    want, got = pair(repartition_interval_ops=10 ** 9)
    for db in (want, got):
        for k in range(KEYSPACE):
            db.put(k, 150)
        for k in range(0, KEYSPACE, 3):
            db.get(k)
    before = got.stats
    for db in (want, got):
        assert db.repartitioner.force_split(0)
        db.repartitioner.drain()
    after = got.stats
    assert after.puts == before.puts == KEYSPACE
    assert after.gets == before.gets
    assert_same_cluster(want, got)


# ----------------------------------------------------------------------
# HotBudget retopology, bounds, hotness handoff
# ----------------------------------------------------------------------
def test_hot_budget_retopology_after_split_and_merge():
    want, got = pair(repartition_interval_ops=10 ** 9)
    rng = np.random.default_rng(2)
    ops = [("put", int(rng.integers(0, KEYSPACE)), 150)
           for _ in range(4000)]
    ops += [("get", int(rng.integers(0, KEYSPACE // 4)))
            for _ in range(3000)]
    drive([want, got], ops)
    for db in (want, got):
        db.hot_budget.rebalance()
        assert db.repartitioner.force_split(0)
        db.repartitioner.drain()
    hb = got.hot_budget
    assert len(hb.shares) == len(hb._scale) == len(got.shards) == 5
    assert hb.shares.tolist() == want.hot_budget.shares.tolist()
    for db in (want, got):
        assert db.repartitioner.force_merge(3)
        db.repartitioner.drain()
    assert len(got.hot_budget.shares) == 4
    assert got.hot_budget.rebalance().tolist() == \
        want.hot_budget.rebalance().tolist()
    assert_same_cluster(want, got)


def test_shard_count_stays_within_bounds():
    want, got = pair(repartition_interval_ops=150,
                     repartition_cooldown_ops=0, split_factor=1.05,
                     merge_factor=0.9, min_shards=3, max_shards=5)
    drive([want, got, oracle()], skewed_ops(4000, 17))
    assert 3 <= len(got.shards) <= 5
    assert_map_consistent(got)
    assert_same_cluster(want, got)


def test_split_hands_hotness_to_children_bit_for_bit():
    """The children inherit the source's RALT hot set (the demand
    signal): their runs — keys, ticks, float64 scores and counters —
    equal the reference's children's bit for bit."""
    want, got = pair(repartition_interval_ops=10 ** 9)
    rng = np.random.default_rng(4)
    ops = [("put", int(rng.integers(0, KEYSPACE)), 150)
           for _ in range(4000)]
    drive([want, got], ops)
    for db in (want, got):
        db.flush_all()
    drive([want, got], [("get", int(rng.integers(0, KEYSPACE // 4)))
                        for _ in range(4000)])
    assert got.shards[0].ralt.hot_set_bytes > 0
    for db in (want, got):
        assert db.repartitioner.force_split(0)
        db.repartitioner.drain()
    child_hot = [got.shards[i].ralt.hot_set_bytes for i in (0, 1)]
    assert child_hot[0] > 0 and child_hot[1] > 0
    assert [ralt_state(got.shards[i]) for i in (0, 1)] == \
        [ralt_state(want.shards[i]) for i in (0, 1)]
    assert_same_cluster(want, got)


def test_split_point_prefers_hot_median():
    want, got = pair(repartition_interval_ops=10 ** 9)
    for db in (want, got):
        for k in range(KEYSPACE):
            db.put(k, 150)
        db.flush_all()
    rng = np.random.default_rng(6)
    drive([want, got], [("get", int(rng.integers(40, 120)))
                        for _ in range(6000)])
    key = got.repartitioner._choose_split_key(0)
    assert 40 < key < 120
    assert key == want.repartitioner._choose_split_key(0)
    # the record-median fallback (no RALT) on the device's union
    tw, tg = pair("rocksdb_tiered", cluster_kw(hotrap=False),
                  repartition_interval_ops=10 ** 9)
    drive([tw, tg], [("put", k, 150) for k in range(0, KEYSPACE, 3)])
    assert tg.repartitioner._choose_split_key(1) == \
        tw.repartitioner._choose_split_key(1)


def test_repartitioned_cluster_survives_pickle():
    want, got = pair(repartition_interval_ops=10 ** 9)
    for db in (want, got):
        for k in range(KEYSPACE):
            db.put(k, 150)
        assert db.repartitioner.force_split(1)
        db.repartitioner.drain()
    buf = io.BytesIO()
    pickle.dump(got, buf, protocol=pickle.HIGHEST_PROTOCOL)
    clone = pickle.loads(buf.getvalue())
    clone.reset_storage()
    assert clone.get(10) == got.get(10)
    assert clone.scan(0, 15) == got.scan(0, 15)
    assert clone._bounds_list == got._bounds_list == want._bounds_list
    assert clone.repartitioner.force_merge(0)
    clone.repartitioner.drain()
    assert len(clone.shards) == len(got.shards) - 1
    assert all(sh.device.type == "cpu" for sh in clone.shards)


def test_single_shard_cluster_grows_under_load():
    want, got = pair(n_shards=1, repartition_interval_ops=300,
                     min_shards=1, max_shards=4)
    drive([want, got, oracle()], skewed_ops(3000, 19))
    assert got.repartitioner.n_splits >= 1 and 1 < len(got.shards) <= 4
    assert_map_consistent(got)
    assert got.hot_budget is not None
    assert len(got.hot_budget.shares) == len(got.shards)
    assert_same_cluster(want, got)


def test_factory_cluster_refuses_shard_builds_after_pickle():
    cfg = port.LSMConfig(**cluster_kw())
    scfg = port.ShardConfig(**repart_kw(repartition_interval_ops=10 ** 9))
    db = port.ShardedTieredLSM(
        scfg, cfg, factory=lambda sub, s: port.TieredLSM(sub, seed=s,
                                                         device="cpu"),
        device="cpu")
    for k in range(KEYSPACE):
        db.put(k, 150)
    clone = pickle.loads(pickle.dumps(db, protocol=pickle.HIGHEST_PROTOCOL))
    assert clone.get(10) == db.get(10)
    with pytest.raises(RuntimeError, match="factory"):
        clone.repartitioner.force_split(0)
        clone.repartitioner.drain()


def test_config_knobs_flow_through_shard_config():
    c = dataclasses.replace(hotrap_kv.CONFIG, partitioning="range",
                            repartition=True, min_shards=3, max_shards=6,
                            split_factor=1.5)
    scfg = hotrap_kv.shard_config(c)
    assert scfg.repartition and scfg.min_shards == 3
    assert scfg.max_shards == 6 and scfg.split_factor == 1.5
