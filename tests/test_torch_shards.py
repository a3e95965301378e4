"""The port's sharded cluster (`repro_torch.core.shards`) and
`repro_torch.configs.hotrap_kv` against the numpy reference, on the
CPU: the counterparts of `tests/test_shards.py`'s cells, the sharded
PrismDB included.

Each cell feeds one seeded op stream to a reference cluster, a port
cluster and (where the reference test has one) a port engine without
shards, and requires every op's result equal at every op; then the
clusters' shards equal by content (`chip_smoke.engine_digest`: levels,
memtables, seqs, fences, arbiter state) and their aggregate stats equal
field for field."""
import dataclasses
import importlib.util
import io
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref
from repro.configs import hotrap_kv as ref_kv
from repro.core import runner as ref_runner
from repro.core import shards as ref_shards
from repro.data import workloads as ref_wl
from repro_torch import core as port
from repro_torch.configs import hotrap_kv
from repro_torch.core import runner, shards
from repro_torch.core.scan import MAX_KEY
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


def dev(pkg) -> dict:
    return {} if pkg is ref else {"device": "cpu"}


def sharded(pkg, system="hotrap", cfg=None, **scfg):
    """`make_sharded_system` of `pkg` over `cluster_kw` (the port's on
    the CPU)."""
    return pkg.make_sharded_system(
        system, pkg.LSMConfig(**(cfg or cluster_kw())),
        shard_cfg=pkg.ShardConfig(**scfg), seed=0, **dev(pkg))


def single(pkg, system="hotrap", cfg=None):
    return pkg.make_system(system, pkg.LSMConfig(**(cfg or cluster_kw())),
                           seed=0, **dev(pkg))


def mixed_ops(n_ops=4000, seed=5, keyspace=KEYSPACE):
    """`test_shards.mixed_trace`'s stream, drawn once."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_ops):
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
            out.append(("scan_range", lo, lo + int(rng.integers(0, 150))))
    return out


def drive(dbs, ops):
    """Every op on every store; results equal at every op."""
    for i, (name, *args) in enumerate(ops):
        res = [getattr(db, name)(*args) for db in dbs]
        assert all(r == res[0] for r in res[1:]), (i, name, args, res)


def assert_same_cluster(want, got):
    assert cs.json_mismatches(cs.engine_digest(want),
                              cs.engine_digest(got)) == []
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert [s.snapshot() for s in got.storages] == \
        [s.snapshot() for s in want.storages]


# ----------------------------------------------------------------------
# cross-shard equivalence
# ----------------------------------------------------------------------
@pytest.mark.parametrize("partitioning", ["hash", "range"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_matches_reference_and_oracle(partitioning, n_shards):
    scfg = dict(n_shards=n_shards, partitioning=partitioning,
                key_space=KEYSPACE, rebalance_interval_ops=500,
                memtable_floor=8 * KIB, block_cache_floor=8 * KIB)
    want, got = sharded(ref, **scfg), sharded(port, **scfg)
    oracle = single(port)
    drive([want, got, oracle], mixed_ops())
    assert_same_cluster(want, got)
    s, o = got.stats, oracle.stats
    assert s.scans == o.scans and s.scanned_records == o.scanned_records
    if n_shards > 1:
        assert sum(1 for sh in got.shards if sh.stats.puts > 0) > 1
        assert sum(sh.stats.flushes for sh in got.shards) > 0
    assert all(t.device.type == "cpu" for t in got.tensors())


def test_sharded_equivalence_with_arbiter_active():
    """HotBudget awards (caps + RALT budgets) change no result, and the
    port's shares are the reference's bit for bit."""
    scfg = dict(n_shards=4, partitioning="range", key_space=KEYSPACE,
                rebalance_interval_ops=200)
    want, got = sharded(ref, **scfg), sharded(port, **scfg)
    drive([want, got, single(port)], mixed_ops(3000, 9))
    assert got.hot_budget.n_rebalances > 0
    assert got.hot_budget.shares.tolist() == want.hot_budget.shares.tolist()
    assert got.hot_budget._scale.tolist() == want.hot_budget._scale.tolist()
    assert [sh.caps for sh in got.shards] == [sh.caps for sh in want.shards]
    assert [(sh.ralt.hot_set_limit, sh.ralt.phys_limit, sh.ralt.cfg.fd_size)
            for sh in got.shards] == \
        [(sh.ralt.hot_set_limit, sh.ralt.phys_limit, sh.ralt.cfg.fd_size)
         for sh in want.shards]
    assert_same_cluster(want, got)


def test_sharded_tiered_baseline_matches_reference():
    cfg = cluster_kw(hotrap=False)
    scfg = dict(n_shards=2, partitioning="hash", key_space=KEYSPACE)
    want = sharded(ref, "rocksdb_tiered", cfg, **scfg)
    got = sharded(port, "rocksdb_tiered", cfg, **scfg)
    drive([want, got, single(port, "rocksdb_tiered", cfg)],
          mixed_ops(2500, 7))
    assert_same_cluster(want, got)


def test_sharded_prismdb_matches_reference():
    """`tests/test_shards.py:99`'s PrismDB cell: clock bits per shard,
    the reference's results and state (the clock dicts in their order
    included)."""
    cfg = cluster_kw(hotrap=False)
    scfg = dict(n_shards=2, partitioning="hash", key_space=KEYSPACE)
    want = sharded(ref, "prismdb", cfg, **scfg)
    got = sharded(port, "prismdb", cfg, **scfg)
    drive([want, got, single(port, "prismdb", cfg)], mixed_ops(2500, 7))
    assert_same_cluster(want, got)
    assert [list(sh.clock.items()) for sh in got.shards] == \
        [list(sh.clock.items()) for sh in want.shards]
    assert all(sh.clock for sh in got.shards)


def test_multi_get_matches_individual_gets():
    scfg = dict(n_shards=4, partitioning="hash", key_space=KEYSPACE)
    want, got = sharded(ref, **scfg), sharded(port, **scfg)
    for db in (want, got):
        for k in range(0, KEYSPACE, 2):
            db.put(k, 120)
    keys = np.arange(0, KEYSPACE, 7)
    lat = np.zeros((len(keys), 2))
    res = got.multi_get(keys, lat_out=lat)
    w_lat = np.zeros((len(keys), 2))
    assert res == want.multi_get(keys.astype(np.uint64), lat_out=w_lat)
    assert lat.tolist() == w_lat.tolist()
    assert res == [got.get(int(k)) for k in keys] \
        == [want.get(int(k)) for k in keys]
    assert got.multi_get([]) == [] == want.multi_get([])
    assert_same_cluster(want, got)


# ----------------------------------------------------------------------
# the router
# ----------------------------------------------------------------------
@pytest.mark.parametrize("part", ["hash", "range"])
def test_router_bucketing_equals_reference(part):
    """Vectorized bucketing and the scalar route both equal the
    reference's `_shard_ids`, on keys up to 2**63 - 1; keys above it
    (or below 0) raise ValueError at the router."""
    rng = np.random.default_rng(2)
    big = np.concatenate([rng.integers(0, 2 ** 63, size=256,
                                       dtype=np.uint64),
                          np.array([0, 1, 2 ** 32, MAX_KEY - 1, MAX_KEY],
                                   dtype=np.uint64)])
    for n in (1, 2, 3, 4, 7):
        scfg = dict(n_shards=n, partitioning=part, key_space=1000)
        want = ref_shards.ShardedTieredLSM(ref.ShardConfig(**scfg),
                                           ref.LSMConfig(**cluster_kw()))
        got = sharded(port, **scfg)
        for keys in (np.arange(0, 1000), big):
            sids = want._shard_ids(keys.astype(np.uint64)).tolist()
            assert got._shard_ids(keys.astype(np.int64)).tolist() == sids
            assert [got.shard_of(int(k)) for k in keys] == sids
        with pytest.raises(ValueError):
            got.shard_of(MAX_KEY + 1)
        with pytest.raises(ValueError):
            got._shard_ids(np.array([MAX_KEY + 1], dtype=np.uint64))
        with pytest.raises(ValueError):
            got._shard_ids(np.array([-1]))
        with pytest.raises(ValueError):
            got.put(MAX_KEY + 1, 10)
        with pytest.raises(ValueError):
            got.multi_get(np.array([2 ** 64 - 1], dtype=np.uint64))


def test_shard_bounds_equal_reference_over_the_key_space():
    """Every shard's [lo, hi] is the reference's, for the tests' key
    space, the default 2**62 and the hotrap_kv range key space; only
    the last shard's top differs: MAX_KEY is 2**63 - 1 in the port."""
    kv = dataclasses.replace(hotrap_kv.CONFIG, partitioning="range")
    spaces = [KEYSPACE, 1000, 2 ** 62, hotrap_kv.shard_config(kv).key_space]
    for key_space in spaces:
        for n in (1, 2, 4, 8):
            scfg = dict(n_shards=n, partitioning="range",
                        key_space=key_space)
            want = ref_shards.ShardedTieredLSM(
                ref.ShardConfig(**scfg), ref.LSMConfig(**cluster_kw()))
            got = sharded(port, **scfg)
            assert got._bounds_list == want._bounds_list
            wb = [want.shard_bounds(i) for i in range(n)]
            gb = [got.shard_bounds(i) for i in range(n)]
            assert gb[:-1] == wb[:-1] and gb[-1][0] == wb[-1][0]
            assert gb[-1][1] == MAX_KEY == 2 ** 63 - 1
            assert wb[-1][1] == 2 ** 64 - 1


# ----------------------------------------------------------------------
# configs and resource split
# ----------------------------------------------------------------------
def test_hotrap_kv_config_equals_reference():
    assert dataclasses.asdict(hotrap_kv.CONFIG) == \
        dataclasses.asdict(ref_kv.CONFIG)
    assert [f.name for f in dataclasses.fields(hotrap_kv.HotrapKVConfig)] \
        == [f.name for f in dataclasses.fields(ref_kv.HotrapKVConfig)]
    for c in (hotrap_kv.CONFIG,
              dataclasses.replace(hotrap_kv.CONFIG, partitioning="range",
                                  repartition=True, min_shards=3,
                                  max_shards=6, split_factor=1.5)):
        rc = ref_kv.HotrapKVConfig(**dataclasses.asdict(c))
        assert dataclasses.asdict(hotrap_kv.lsm_config(c)) == \
            dataclasses.asdict(ref_kv.lsm_config(rc))
        assert dataclasses.asdict(hotrap_kv.shard_config(c)) == \
            dataclasses.asdict(ref_kv.shard_config(rc))
        assert dataclasses.asdict(hotrap_kv.shard_config(c, key_space=123)) \
            == dataclasses.asdict(ref_kv.shard_config(rc, key_space=123))
    ranged = dataclasses.replace(hotrap_kv.CONFIG, partitioning="range")
    nk = runner.db_key_count(hotrap_kv.lsm_config(ranged),
                             ranged.value_len)
    assert hotrap_kv.shard_config(ranged).key_space == 2 * nk
    assert hotrap_kv.shard_config().key_space == 2 ** 62
    for slots in (1, 64, 8192):
        assert hotrap_kv.tiering_defaults(slots) == \
            ref_kv.tiering_defaults(slots)
    with pytest.raises(dataclasses.FrozenInstanceError):
        hotrap_kv.CONFIG.n_shards = 2


def test_shard_lsm_config_field_for_field():
    for n in (1, 2, 4, 8):
        for kw in (cluster_kw(), dict(fd_size=2 * MIB, sd_size=20 * MIB)):
            scfg = dict(n_shards=n, memtable_floor=8 * KIB)
            got = shards.shard_lsm_config(port.LSMConfig(**kw),
                                          port.ShardConfig(**scfg))
            want = ref_shards.shard_lsm_config(ref.LSMConfig(**kw),
                                               ref.ShardConfig(**scfg))
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = port.LSMConfig(**cluster_kw())
    assert shards.shard_lsm_config(cfg, port.ShardConfig(n_shards=1)) is cfg
    assert dataclasses.asdict(port.ShardConfig()) == \
        dataclasses.asdict(ref.ShardConfig())
    for bad in (dict(min_shards=4, max_shards=2), dict(demand_signal="x"),
                dict(partitioning="x"), dict(n_shards=0)):
        with pytest.raises(ValueError):
            port.ShardConfig(**bad)


# ----------------------------------------------------------------------
# HotBudget arbiter
# ----------------------------------------------------------------------
def skewed_budget_pair(**scfg_kw):
    scfg = dict(n_shards=4, partitioning="range", key_space=KEYSPACE,
                rebalance_interval_ops=10 ** 9)
    scfg.update(scfg_kw)
    pair = sharded(ref, **scfg), sharded(port, **scfg)
    for db in pair:
        for k in range(KEYSPACE):
            db.put(k, 200)
        db.flush_all()
    return pair


@pytest.mark.parametrize("ema", [0.5, 1.0])
def test_hot_budget_shares_equal_reference(ema):
    """Skewed traffic earns the hot shard more than its fair share; the
    port's shares, caps and RALT limits equal the reference's after
    every round, and the share bounds hold."""
    want, got = skewed_budget_pair(ema=ema)
    base_caps = [list(s.caps) for s in got.shards]
    rng = np.random.default_rng(3)
    drive([want, got], [("get", int(rng.integers(0, KEYSPACE // 4)))
                        for _ in range(3000)])
    for _ in range(4):
        g, w = got.hot_budget.rebalance(), want.hot_budget.rebalance()
        assert g.tolist() == w.tolist()
    assert g[0] - 0.25 >= 0.10 and g[0] == max(g)
    assert abs(float(g.sum()) - 1.0) < 1e-9
    for li in range(1, got.shards[0].cfg.n_fd_levels):
        assert got.shards[0].caps[li] > base_caps[0][li]
        assert got.shards[3].caps[li] < base_caps[3][li]
    assert got.hot_budget.snapshot() == want.hot_budget.snapshot()
    assert_same_cluster(want, got)


def test_hot_budget_noop_cases():
    cfg = cluster_kw()
    one = port.make_sharded_system("hotrap", port.LSMConfig(**cfg),
                                   shard_cfg=port.ShardConfig(n_shards=1),
                                   seed=0, device="cpu")
    off = port.make_sharded_system(
        "hotrap", port.LSMConfig(**cfg),
        shard_cfg=port.ShardConfig(n_shards=4, hot_budget=False), seed=0,
        device="cpu")
    assert one.hot_budget is None and off.hot_budget is None
    for k in range(200):
        one.put(k, 100), off.put(k, 100)
    assert one.get(5) == off.get(5) == (6, 100)


# ----------------------------------------------------------------------
# point-get GroupView fast path
# ----------------------------------------------------------------------
def test_point_get_view_fast_path_equals_reference():
    """Gets served off scan-built views count the reference's saved
    probes, and equal a twin with the fast path off."""
    fast_w, fast_g = single(ref), single(port)
    slow = single(port, cfg=cluster_kw(point_view_gets=False))
    rng = np.random.default_rng(13)
    ops = []
    for _ in range(3000):
        k = int(rng.integers(0, 600))
        r = rng.random()
        if r < 0.5:
            ops.append(("put", k, 150))
        elif r < 0.6:
            ops.append(("scan", int(rng.integers(0, 600)), 25))
        else:
            ops.append(("get", k))
    drive([fast_w, fast_g, slow], ops)
    st = fast_g.stats
    assert st.get_view_hits > 0 and st.get_probes_saved > 0
    assert slow.stats.get_view_hits == 0
    assert dataclasses.asdict(st) == dataclasses.asdict(fast_w.stats)
    assert fast_g.point_counters.view_gets == st.get_view_hits


def test_point_view_gets_on_clusters():
    """Clusters serve gets off views too, as the reference's do, and a
    get-only stream builds none."""
    scfg = dict(n_shards=2, partitioning="hash", key_space=KEYSPACE)
    want, got = sharded(ref, **scfg), sharded(port, **scfg)
    ops = [("put", k, 150) for k in range(1500)]
    ops += [("get", k) for k in range(0, 1500, 3)]
    drive([want, got], ops)
    assert got.stats.view_builds == 0
    ops = [("scan", 0, 50)] + [("get", k) for k in range(0, 1500, 5)]
    drive([want, got], ops)
    assert got.stats.get_view_hits > 0
    assert_same_cluster(want, got)


# ----------------------------------------------------------------------
# runner integration + knob surfacing
# ----------------------------------------------------------------------
def run_both(want, got, mix, dist, n_ops, value_len, seed, keyspace,
             **dist_kw):
    w_wl = ref_wl.ycsb(mix, ref_wl.KeyDist(dist, keyspace, **dist_kw),
                       n_ops, value_len, seed=seed)
    g_wl = twl.ycsb(mix, twl.KeyDist(dist, keyspace, **dist_kw), n_ops,
                    value_len, seed=seed)
    w_out, g_out = [], []
    w_res = ref_runner.run_workload(want, w_wl, name="x", results_out=w_out)
    g_res = runner.run_workload(got, g_wl, name="x", results_out=g_out)
    assert cs.json_mismatches(w_res.to_json(), g_res.to_json()) == []
    assert g_out == w_out
    return g_res


def test_runner_drives_sharded_cluster_and_surfaces_knobs():
    scfg = dict(n_shards=4, partitioning="hash", key_space=KEYSPACE,
                rebalance_interval_ops=400)
    want, got = sharded(ref, **scfg), sharded(port, **scfg)
    for db in (want, got):
        for k in range(KEYSPACE):
            db.put(k, 200)
        db.flush_all()
        db.reset_storage()
    res = run_both(want, got, "SR", "zipfian", 1500, 200, 7, KEYSPACE)
    assert res.n_shards == 4 and res.shard_budget["partitioning"] == "hash"
    assert len(res.shard_budget["shares"]) == 4
    assert res.stats["scans"] > 0 and res.throughput > 0
    assert len(res.storage["shards"]) == 4
    assert res.storage["FD"]["read_bytes"] == sum(
        s["FD"]["read_bytes"] for s in res.storage["shards"])
    assert res.durability is None
    assert_same_cluster(want, got)


def test_runner_on_a_durable_cluster_fills_durability():
    """`load_db` and `run_workload` on a WAL cluster: the WAL counters in
    `RunResult.durability`, equal to the reference's."""
    scfg = dict(n_shards=2, partitioning="hash", key_space=KEYSPACE)
    cfg = cluster_kw(wal=True)
    want = sharded(ref, cfg=cfg, **scfg)
    got = sharded(port, cfg=cfg, **scfg)
    ref_runner.load_db(want, KEYSPACE, 200)
    runner.load_db(got, KEYSPACE, 200)
    res = run_both(want, got, "RW", "hotspot", 2000, 200, 3, KEYSPACE)
    d = res.durability
    assert d["wal_appended_records"] > KEYSPACE
    assert d["wal_group_commits"] > 0 and d["manifest_edits"] > 0
    assert_same_cluster(want, got)


def test_runresult_knobs_for_unsharded_db():
    want, got = single(ref), single(port)
    for db in (want, got):
        for k in range(300):
            db.put(k, 200)
    res = run_both(want, got, "RW", "uniform", 800, 200, 3, 300)
    assert res.n_shards == 1 and res.shard_budget is None
    assert res.range_promo_frac == port.LSMConfig().range_promo_frac


def test_sharded_stats_aggregate_and_pickle():
    """Aggregated Stats are the field-wise shard sums, and a cluster
    survives a pickle round trip on its device."""
    scfg = dict(n_shards=2, partitioning="hash", key_space=KEYSPACE)
    got = sharded(port, **scfg)
    for k in range(KEYSPACE):
        got.put(k, 150)
    for k in range(0, KEYSPACE, 5):
        got.get(k)
    s = got.stats
    assert s.gets == sum(sh.stats.gets for sh in got.shards) == KEYSPACE // 5
    assert s.puts == KEYSPACE
    buf = io.BytesIO()
    pickle.dump(got, buf, protocol=pickle.HIGHEST_PROTOCOL)
    clone = pickle.loads(buf.getvalue())
    clone.reset_storage()
    assert clone.get(10) == got.get(10)
    assert clone.scan(0, 15) == got.scan(0, 15)
    assert clone.device == got.device and all(
        t.device.type == "cpu" for t in clone.tensors())


def test_entry_points_run_on_cuda_unless_told_otherwise():
    """No quiet CPU fallback: without CUDA a cluster on the default
    device raises, sanitized or not; with `device="cpu"` every shard and
    tensor is on the CPU, for the sanitized cluster and the compared
    systems too."""
    cfg = port.LSMConfig(**cluster_kw())
    if not torch.cuda.is_available():
        for kw in ({}, {"sanitize": True}):
            with pytest.raises(RuntimeError, match="CUDA"):
                port.make_sharded_system("hotrap", cfg, **kw)
    got = port.make_sharded_system("hotrap", cfg, device="cpu")
    assert all(sh.device.type == "cpu" for sh in got.shards)
    wrapped = port.make_sharded_system("hotrap", cfg, sanitize=True,
                                       device="cpu")
    assert isinstance(wrapped, port.SanitizedDB)
    assert all(sh.device.type == "cpu" for sh in wrapped.shards)
    prism = port.make_sharded_system("prismdb", cfg, device="cpu")
    prism.put(3, 100)
    assert prism.get(3) == (1, 100)
    assert all(t.device.type == "cpu" for t in prism.tensors())
