"""The port's durability subsystem (`repro_torch.core.wal`,
`repro_torch.core.crashpoints`) against the numpy reference, on the CPU:
the counterparts of `tests/test_crash_recovery.py` and a seeded
counterpart of `tests/test_crash_property.py`.

Each cell feeds the same seeded op stream to a reference engine and a
port engine, arms the same crash site in both packages' registries
(each package has its own), recovers both, and requires the crash at
the same op, every op's outcome, and the recovered engines equal: each
level's tables by content, the memtables, `seq`, the durable half (WAL
records and counters, horizon), `recovery_info`, Version pins, and for
clusters the fences, topology records and migration ledger
(`chip_smoke.engine_digest`).  The recovered port engine is then held
to the op log folded at its horizon (gets and a scan, byte for byte),
and both recovered engines take the same further traffic.

The sanitized cells wait for the port's sanitizer (ROADMAP Queue 1
item 3)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref
from repro_torch import core as port
from repro_torch.core import (CRASH_SITES, LSMConfig, ShardedTieredLSM,
                              TieredLSM, crashpoints)
from repro_torch.core.sstable import TOMBSTONE_VLEN

KIB = 1024
MIB = 1024 * 1024
KEYSPACE = 1024
MIGRATION_SITES = ("mid-migration-stream", "mid-cutover")


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


@pytest.fixture(autouse=True)
def disarmed():
    """No armed site outlives a test, in either package."""
    yield
    crashpoints.disarm()
    ref.crashpoints.disarm()


def cfg_kw(**kw):
    # the reference's small_cfg: the cold tail of the keyspace lives on
    # SD, the mPC freezes and the checker installs promotions
    base = dict(wal=True, wal_group_commit_records=32,
                fd_size=64 * KIB, sd_size=4 * MIB,
                target_sstable_bytes=2 * KIB, memtable_bytes=8 * KIB,
                block_cache_bytes=8 * KIB, checker_delay_ops=16,
                hotrap=True)
    base.update(kw)
    return base


def scfg_kw(**kw):
    base = dict(n_shards=2, partitioning="range", key_space=KEYSPACE,
                repartition=True, repartition_interval_ops=10 ** 9,
                migration_records_per_op=64, memtable_floor=8 * KIB,
                block_cache_floor=8 * KIB)
    base.update(kw)
    return base


def make(pkg, kind, **kw):
    """A `plain` engine or a `sharded` (2-shard range) cluster of `pkg`
    (`repro.core` or `repro_torch.core`; the port's on the CPU)."""
    dev = {} if pkg is ref else {"device": "cpu"}
    cfg = pkg.LSMConfig(**cfg_kw(**kw))
    if kind == "plain":
        return pkg.TieredLSM(cfg, seed=0, **dev)
    return pkg.ShardedTieredLSM(pkg.ShardConfig(**scfg_kw()), cfg, seed=0,
                                **dev)


# ----------------------------------------------------------------------
# op streams: the reference test's phases, drawn once, applied to both
# ----------------------------------------------------------------------
def mixed_ops(n, seed):
    """`drive_phase`'s skewed mixed traffic."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = (int(rng.integers(0, KEYSPACE // 4)) if rng.random() < 0.7
             else int(rng.integers(0, KEYSPACE)))
        r = rng.random()
        if r < 0.55:
            out.append(("put", k, int(rng.integers(20, 160))))
        elif r < 0.62:
            out.append(("del", k, TOMBSTONE_VLEN))
        elif r < 0.95:
            out.append(("get", k, 0))
        else:
            out.append(("scan", k, 10))
    return out


def read_hot_ops(n, seed):
    """`read_hot_phase`: reads over the lower half, writes confined to
    the upper quarter — the shape that makes RALT promote."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.random() < 0.85:
            out.append(("get", int(rng.integers(0, KEYSPACE // 2)), 0))
        else:
            out.append(("put", int(rng.integers(3 * KEYSPACE // 4,
                                                KEYSPACE)), 64))
    return out


def apply(db, ops, oplog, outs):
    """Run `ops`, logging each write before the call and sealing it
    with the returned seq after (a crash leaves it provisional)."""
    for op, k, v in ops:
        if op in ("put", "del"):
            ent = [0, k, v]
            oplog.append(ent)
            ent[0] = db.put(k, v) if op == "put" else db.delete(k)
            outs.append(ent[0])
        elif op == "get":
            outs.append(db.get(k))
        else:
            outs.append(db.scan(k, v))


def horizon_of(db, key):
    if hasattr(db, "shards"):
        return db.shards[db.shard_of(key)].durability.horizon()
    return db.durability.horizon()


def fold_at_horizons(rec, oplog):
    """key -> (seq, vlen): the newest logged op on each key at or below
    the recovered serving shard's durability horizon."""
    exp = {}
    prev = 0
    for seq, k, v in oplog:
        if seq == 0:            # provisional: the crash unwound this op
            seq = prev + 1
        prev = seq
        if seq <= horizon_of(rec, k):
            cur = exp.get(k)
            if cur is None or seq >= cur[0]:
                exp[k] = (seq, v)
    return exp


def assert_oracle(db, exp):
    """The recovered engine serves the oracle fold byte for byte."""
    assert exp, "oracle fold is empty — the workload never became durable"
    for k, (seq, v) in exp.items():
        got = db.get(k)
        if v == TOMBSTONE_VLEN:
            assert got is None, f"deleted key {k} visible as {got}"
        else:
            assert got == (seq, v), (k, got, (seq, v))
    lo, hi = 0, KEYSPACE // 4
    want = sorted((k, s, v) for k, (s, v) in exp.items()
                  if lo <= k <= hi and v != TOMBSTONE_VLEN)
    assert db.scan_range(lo, hi) == want


def both(kind, drive, site, hits=1, **kw):
    """Build, drive until `site` fires and recover, in each package:
    [(crashed, recovered, oplog, outcomes)] for (reference, port)."""
    out = []
    for pkg in (ref, port):
        db = make(pkg, kind, **kw)
        oplog, outs = [], []
        crashed, rec = pkg.crashpoints.crash_recover(
            db, lambda d: drive(pkg, d, oplog, outs), site, hits)
        out.append((crashed, rec, oplog, outs))
    return out


def assert_same_recovery(pair):
    (wc, want, wlog, wouts), (gc, got, glog, gouts) = pair
    assert gc == wc
    assert gouts == wouts and glog == wlog
    assert cs.json_mismatches(cs.engine_digest(want),
                              cs.engine_digest(got)) == []
    assert [s.snapshot() for s in storages(got)] == \
        [s.snapshot() for s in storages(want)]


def storages(db):
    return list(db.storages) if hasattr(db, "shards") else [db.storage]


def assert_same_after(want, got, oplog, n=1200, seed=99):
    """The port's recovered engine serves the oracle fold, and both
    recovered engines answer the same further traffic identically."""
    exp = fold_at_horizons(got, oplog)
    assert_oracle(got, exp)
    assert_oracle(want, fold_at_horizons(want, oplog))
    ops = mixed_ops(n, seed)
    w_outs, g_outs = [], []
    apply(want, ops, [], w_outs)
    apply(got, ops, [], g_outs)
    assert g_outs == w_outs
    assert cs.json_mismatches(cs.engine_digest(want),
                              cs.engine_digest(got)) == []


def on_cpu(db):
    """The engine's device, and every tensor it holds, are the CPU."""
    return db.device.type == "cpu" and all(
        t.device.type == "cpu" for t in db.tensors())


# ----------------------------------------------------------------------
# the matrix: plain x every site, sharded x every site
# ----------------------------------------------------------------------
@pytest.mark.parametrize("site", CRASH_SITES)
@pytest.mark.parametrize("kind", ("plain", "sharded"))
def test_crash_matrix(site, kind):
    sharded = kind != "plain"

    def drive(pkg, d, oplog, outs):
        apply(d, mixed_ops(4000, 1), oplog, outs)
        if sharded:
            assert d.repartitioner.force_split(0)
        apply(d, read_hot_ops(6000, 5), oplog, outs)
        apply(d, mixed_ops(3000, 2), oplog, outs)

    pair = both(kind, drive, site)
    crashed, rec = pair[1][0], pair[1][1]
    if not sharded and site in MIGRATION_SITES:
        # a single engine has no migrations: the site is unreachable and
        # recovery replays a clean (post-drive) durable image instead
        assert not crashed
    else:
        assert crashed, f"{site} never fired on the {kind} engine"
    assert_same_recovery(pair)
    assert on_cpu(rec)
    assert_same_after(pair[0][1], rec, pair[1][2])


# ----------------------------------------------------------------------
# recovery of an in-flight repartition
# ----------------------------------------------------------------------
def migration_device_bytes(db):
    total = 0
    for st in db.storages:
        comp = st.by_component.get("migration")
        if comp:
            total += int(comp["read_bytes"]) + int(comp["write_bytes"])
    return total


def test_mid_cutover_crash_abandons_migration_cleanly():
    """A crash inside the topology commit recovers the OLD topology with
    zero Version ref leaks and the migration ledger equal to the
    devices' component="migration" history, as the reference does."""
    def drive(pkg, d, oplog, outs):
        apply(d, mixed_ops(4000, 1), oplog, outs)
        assert d.repartitioner.force_split(0)
        apply(d, mixed_ops(9000, 2), oplog, outs)

    pair = both("sharded", drive, "mid-cutover")
    assert_same_recovery(pair)
    crashed, rec = pair[1][0], pair[1][1]
    assert crashed
    assert rec.recovery_info["topology_discarded"] == 1
    assert rec.n_shards == 2
    assert [sh.version.refs for sh in rec.shards] == [1, 1]
    rep = rec.repartitioner
    dev = migration_device_bytes(rec)
    assert dev > 0
    assert rep.migrated_read_bytes + rep.migrated_write_bytes == dev
    assert rep.snapshot() == pair[0][1].repartitioner.snapshot()
    assert_same_after(pair[0][1], rec, pair[1][2])


def test_committed_cutover_recovers_new_topology():
    """A crash after the topology record commits recovers the new shard
    set; destination shards serve their inherited image at the
    build-time horizon floor, on the cluster's device."""
    def drive(pkg, d, oplog, outs):
        apply(d, mixed_ops(4000, 1), oplog, outs)
        assert d.repartitioner.force_split(0)
        d.repartitioner.drain()           # cutover commits here
        pkg.crashpoints.arm("mid-flush", hits=2)
        apply(d, mixed_ops(6000, 2), oplog, outs)

    pair = both("sharded", drive, "mid-flush", hits=10 ** 9)
    assert_same_recovery(pair)
    crashed, rec = pair[1][0], pair[1][1]
    assert crashed and rec.n_shards == 3
    assert rec.recovery_info["topology_discarded"] == 0
    assert any(sh.durability.inherited_seq > 0 for sh in rec.shards)
    assert [sh.version.refs for sh in rec.shards] == [1, 1, 1]
    rep = rec.repartitioner
    assert (rep.migrated_read_bytes + rep.migrated_write_bytes
            == migration_device_bytes(rec) > 0)
    assert rec.device.type == "cpu" and on_cpu(rec)
    assert_same_after(pair[0][1], rec, pair[1][2])


# ----------------------------------------------------------------------
# WAL / manifest mechanics
# ----------------------------------------------------------------------
def test_clean_shutdown_recovers_identical_state():
    """flush_all() quiesces (final WAL sync); recovery then reproduces
    every visible record, with zero torn records — as the reference."""
    recs = []
    for pkg in (ref, port):
        db = make(pkg, "plain")
        oplog = []
        apply(db, mixed_ops(5000, 7), oplog, [])
        db.flush_all()
        before = {k: db.get(k) for _, k, _ in oplog}
        rec = pkg.TieredLSM.recover(db)
        assert rec.recovery_info["discarded_torn"] == 0
        assert rec.seq == db.seq
        assert {k: rec.get(k) for k in before} == before
        recs.append(rec)
    assert cs.json_mismatches(cs.engine_digest(recs[0]),
                              cs.engine_digest(recs[1])) == []


def test_torn_wal_tail_is_discarded_and_counted():
    recs = []
    for pkg in (ref, port):
        db = make(pkg, "plain", wal_group_commit_records=64)
        for i in range(64):
            db.put(i, 32)                 # exactly one full group commit
        for i in range(10):
            db.put(1000 + i, 32)          # buffered, never synced
        assert db.durability.wal.durable_seq == 64
        rec = pkg.TieredLSM.recover(db)
        assert rec.recovery_info["discarded_torn"] == 10
        assert rec.get(5) == (6, 32)
        assert rec.get(1005) is None      # torn tail: durably lost
        recs.append(rec)
    assert cs.json_mismatches(cs.engine_digest(recs[0]),
                              cs.engine_digest(recs[1])) == []


def test_flush_truncates_wal_prefix():
    wals = []
    for pkg in (ref, port):
        db = make(pkg, "plain")
        apply(db, mixed_ops(4000, 3), [], [])
        db.flush_all()
        wal = db.durability.wal
        ft = db.durability.manifest.flushed_through
        assert ft > 0
        assert all(seq > ft for seq, _, _ in wal._synced)
        wals.append((ft, list(wal._synced), wal.syncs, wal.synced_bytes))
    assert wals[1] == wals[0]


def test_group_commit_is_deterministic():
    def run(pkg):
        db = make(pkg, "plain")
        apply(db, mixed_ops(3000, 11), [], [])
        w = db.durability.wal
        return (w.appended_records, w.syncs, w.synced_bytes,
                db.durability.manifest.edits, db.storage.snapshot())
    assert run(port) == run(port) == run(ref)


def test_put_many_wal_matches_scalar_puts():
    """The columnar WAL append of `put_many` syncs at the same records
    and charges the same bytes as the reference's; its tables and
    memtables are the scalar puts' (whose WAL interleaves with the
    flushes, so its horizon differs)."""
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 3000, 2500)
    vlens = rng.integers(50, 900, 2500)
    vlens[::17] = TOMBSTONE_VLEN
    scalar, batched = make(port, "plain"), make(port, "plain")
    want = make(ref, "plain")
    seqs = [scalar.put(int(k), int(v)) for k, v in zip(keys, vlens)]
    assert batched.put_many(keys, vlens).tolist() == seqs
    assert want.put_many(keys.astype(np.uint64), vlens).tolist() == seqs
    assert cs.json_mismatches(cs.engine_digest(want),
                              cs.engine_digest(batched)) == []
    assert batched.storage.snapshot() == want.storage.snapshot()
    digests = [cs.engine_digest(db) for db in (scalar, batched)]
    for d in digests:
        d.pop("durable")
    assert cs.json_mismatches(*digests) == []


def test_recover_without_wal_refuses():
    db = TieredLSM(LSMConfig(**cfg_kw(wal=False)), seed=0, device="cpu")
    with pytest.raises(ValueError):
        TieredLSM.recover(db)
    cl = make(port, "sharded", wal=False)
    with pytest.raises(ValueError):
        ShardedTieredLSM.recover(cl)


def test_arm_validates_site_names():
    with pytest.raises(ValueError):
        crashpoints.arm("mid-nap")
    with pytest.raises(ValueError):
        crashpoints.arm("mid-flush", hits=0)
    crashpoints.arm("mid-flush", hits=3)
    assert crashpoints.armed() == {"mid-flush": 3}
    # the two packages keep separate registries
    assert ref.crashpoints.armed() == {}
    crashpoints.disarm("mid-flush")
    assert crashpoints.armed() == {}
    assert crashpoints.CRASH_SITES == ref.crashpoints.CRASH_SITES


# ----------------------------------------------------------------------
# seeded counterpart of tests/test_crash_property.py
# ----------------------------------------------------------------------
PROP_KEYSPACE = 512


def prop_cfg(pkg):
    return pkg.LSMConfig(wal=True, wal_group_commit_records=16,
                         fd_size=64 * KIB, sd_size=2 * 1024 * KIB,
                         target_sstable_bytes=4 * KIB,
                         memtable_bytes=4 * KIB, block_cache_bytes=8 * KIB,
                         checker_delay_ops=16, hotrap=True)


def prop_ops(rng, n):
    out = []
    for _ in range(n):
        k = int(rng.integers(0, PROP_KEYSPACE))
        r = rng.random()
        if r < 0.6:
            out.append(("put", k, int(rng.integers(16, 128))))
        elif r < 0.7:
            out.append(("del", k, TOMBSTONE_VLEN))
        else:
            out.append(("get", k, 0))
    return out


def check_against_fold(rec, oplog):
    """The engine against the op log folded at its horizon; returns the
    log cut to the surviving prefix (lost ops never happened)."""
    horizon = rec.durability.horizon()
    exp, kept, prev = {}, [], 0
    for seq, k, v in oplog:
        if seq == 0:
            seq = prev + 1
        prev = seq
        if seq <= horizon:
            kept.append([seq, k, v])
            cur = exp.get(k)
            if cur is None or seq >= cur[0]:
                exp[k] = (seq, v)
    for k, (seq, v) in exp.items():
        assert rec.get(k) == (None if v == TOMBSTONE_VLEN else (seq, v))
    assert rec.seq == horizon
    return kept


def crash_lifetime(pkg, seed, schedule):
    """Every round drives until its armed site fires (or 4000 ops run
    out), recovers and checks against the fold; then a clean round.
    Returns each round's recovery digest."""
    rng = np.random.default_rng(seed)
    db = pkg.TieredLSM(prop_cfg(pkg), seed=0,
                       **({} if pkg is ref else {"device": "cpu"}))
    oplog, digests = [], []
    for site, hits in schedule:
        pkg.crashpoints.arm(site, hits=hits)
        outs = []
        try:
            apply(db, prop_ops(rng, 4000), oplog, outs)
        except pkg.crashpoints.CrashError:
            pass
        finally:
            pkg.crashpoints.disarm()
        db = pkg.TieredLSM.recover(db)
        oplog = check_against_fold(db, oplog)
        digests.append((outs, cs.engine_digest(db)))
    apply(db, prop_ops(rng, 1500), oplog, [])
    db.flush_all()
    rec = pkg.TieredLSM.recover(db)
    assert rec.recovery_info["discarded_torn"] == 0
    check_against_fold(rec, oplog)
    digests.append(([], cs.engine_digest(rec)))
    return digests


# (seed, [(site, hits), ...]): multi-crash lifetimes over the three
# single-engine sites, each round's draws continuing the last's
PROPERTY_CASES = [
    (0, [("mid-flush", 1)]),
    (1, [("mid-compaction", 3), ("mid-flush", 2)]),
    (2, [("mid-promotion-install", 1), ("mid-compaction", 1),
         ("mid-flush", 4)]),
    (3, [("mid-flush", 4), ("mid-promotion-install", 2)]),
    (4, [("mid-compaction", 2), ("mid-compaction", 4),
         ("mid-promotion-install", 3)]),
    (5, [("mid-promotion-install", 4), ("mid-flush", 1)]),
]


@pytest.mark.parametrize("seed,schedule", PROPERTY_CASES)
def test_crash_schedule_recovers_to_oracle(seed, schedule):
    want = crash_lifetime(ref, seed, schedule)
    got = crash_lifetime(port, seed, schedule)
    assert len(got) == len(want)
    for (w_outs, w_dig), (g_outs, g_dig) in zip(want, got):
        assert g_outs == w_outs
        assert cs.json_mismatches(w_dig, g_dig) == []
