"""The port's runtime sanitizer (`repro_torch.core.sanitize`) against the
reference's (`repro.core.sanitize`), on the CPU: the tests of
`tests/test_sanitize.py`, each run on both packages.  The positive runs
drive one op stream through both and require equal results, equal
`close()` reports and equal engine state; the detection tests inject the
same fault into both and require the same `SanitizeError`."""
import pickle

import numpy as np
import pytest
import torch

from repro.core import LSMConfig as JLSMConfig
from repro.core import SanitizeError as JSanitizeError
from repro.core import ShardConfig as JShardConfig
from repro.core import make_sharded_system as jmake_sharded
from repro.core import make_system as jmake_system
from repro_torch.core import (LSMConfig, SanitizedDB, SanitizeError,
                              ShardConfig, make_sharded_system, make_system)
from test_torch_lsm import cs

KIB = 1024
MIB = 1024 * 1024
KEYSPACE = 800


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engine's many small CPU ops run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(cls=LSMConfig, **kw):
    base = dict(fd_size=512 * KIB, sd_size=4 * MIB,
                target_sstable_bytes=32 * KIB, memtable_bytes=16 * KIB,
                block_cache_bytes=16 * KIB, checker_delay_ops=16,
                hotrap=True)
    base.update(kw)
    return cls(**base)


def repart_scfg(cls=ShardConfig, **kw):
    base = dict(n_shards=4, partitioning="range", key_space=KEYSPACE,
                repartition=True, repartition_interval_ops=300,
                repartition_cooldown_ops=200, migration_records_per_op=64,
                rebalance_interval_ops=250, memtable_floor=8 * KIB,
                block_cache_floor=8 * KIB)
    base.update(kw)
    return cls(**base)


def single_pair(seed=0):
    return (jmake_system("hotrap", tiny_cfg(JLSMConfig), seed=seed,
                         sanitize=True),
            make_system("hotrap", tiny_cfg(), seed=seed, sanitize=True,
                        device="cpu"))


def cluster_pair(seed=0):
    return (jmake_sharded("hotrap", tiny_cfg(JLSMConfig),
                          shard_cfg=repart_scfg(JShardConfig), seed=seed,
                          sanitize=True),
            make_sharded_system("hotrap", tiny_cfg(),
                                shard_cfg=repart_scfg(), seed=seed,
                                sanitize=True, device="cpu"))


def drive(db, n_ops, seed=5, hot_prob=0.7) -> list:
    """`tests/test_sanitize.py`'s skewed mixed stream; returns every op's
    result."""
    rng = np.random.default_rng(seed)
    q = KEYSPACE // 4
    out = []
    for _ in range(n_ops):
        k = (int(rng.integers(0, q)) if rng.random() < hot_prob
             else int(rng.integers(0, KEYSPACE)))
        r = rng.random()
        if r < 0.50:
            out.append(db.put(k, 100))
        elif r < 0.60:
            out.append(db.delete(k))
        elif r < 0.85:
            out.append(db.get(k))
        elif r < 0.95:
            out.append(db.scan(int(rng.integers(0, KEYSPACE)),
                               int(rng.integers(1, 40))))
        else:
            lo = int(rng.integers(0, KEYSPACE))
            out.append(db.scan_range(lo, lo + 150))
    return out


def same_state(want, got) -> None:
    """Both engines (unwrapped) hold the same state."""
    assert cs.json_mismatches(cs.engine_digest(want._db),
                              cs.engine_digest(got._db)) == []


# ----------------------------------------------------------------------
# positive path
# ----------------------------------------------------------------------
def test_sanitized_single_engine_roundtrip():
    want, got = single_pair()
    assert drive(got, 2500) == drive(want, 2500)
    report = got.close()
    assert report == want.close()
    assert report["checks_seq"] > 0
    assert report["checks_refs"] > 0
    assert report["checks_oracle"] > 0
    assert report["checks_op_conservation"] > 0
    same_state(want, got)


def test_sanitized_cluster_survives_splits_and_merges():
    """A sanitized range cluster under contiguous skew cuts over through
    >= 1 split and >= 1 merge with every invariant intact, as the
    reference's does, with the same results and report."""
    want, got = cluster_pair()
    assert drive(got, 6000) == drive(want, 6000)
    rep = got.repartitioner
    assert rep.n_splits >= 1, rep.snapshot()
    assert rep.n_merges >= 1, rep.snapshot()
    assert rep.snapshot() == want.repartitioner.snapshot()
    report = got.close()
    assert report == want.close()
    assert report["checks_cutovers_checked"] >= 1
    assert report["checks_migration"] > 0
    for sh in got.shards:
        assert sh.version.refs == 1
    same_state(want, got)


def test_sanitized_cluster_conserves_op_counts():
    want, got = cluster_pair(seed=1)
    assert drive(got, 4000, seed=11) == drive(want, 4000, seed=11)
    s = got.sanitizer
    assert got.stats.puts == s._n_puts == want.sanitizer._n_puts
    assert got.stats.gets == s._n_gets == want.sanitizer._n_gets
    assert got.close() == want.close()


def test_reset_storage_rebases_conservation():
    want, got = cluster_pair(seed=2)
    for db in (want, got):
        drive(db, 1500, seed=3)
        db.reset_storage()
    assert drive(got, 1500, seed=4) == drive(want, 1500, seed=4)
    assert got.close() == want.close()


def test_batched_calls_under_the_sanitizer():
    """`multi_get`/`put_many` through the proxy: the same results, report
    and state as the reference."""
    want, got = single_pair(seed=3)
    rng = np.random.default_rng(8)
    for _ in range(6):
        keys = rng.integers(0, KEYSPACE, 300)
        vlens = rng.integers(50, 400, 300)
        assert (got.put_many(keys, vlens).tolist()
                == want.put_many(keys.astype(np.uint64), vlens).tolist())
        probe = rng.integers(0, KEYSPACE, 400)
        assert got.multi_get(probe) == want.multi_get(
            probe.astype(np.uint64))
    assert got.close() == want.close()
    same_state(want, got)


# ----------------------------------------------------------------------
# negative path: every invariant class fires, in both packages
# ----------------------------------------------------------------------
def both(fn, exc_match: str | None = None):
    """Run `fn(db, SanitizeError)` on a fresh sanitized engine of each
    package; both must raise with the same message."""
    msgs = []
    for db, err in zip(single_pair(), (JSanitizeError, SanitizeError)):
        with pytest.raises(err, match=exc_match) as e:
            fn(db)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_detects_oracle_divergence():
    def go(db):
        db.put(42, 100)
        db._db.delete(42)        # lose the write behind the sanitizer
        db.get(42)
    both(go, "oracle divergence")


def test_detects_scan_dropping_live_key():
    def go(db):
        for k in range(0, 200, 5):
            db.put(k, 64)
        db._db.delete(100)
        for _ in range(50):
            db.scan_range(0, 200)
    both(go)


def test_detects_refcount_leak():
    for db, err in zip(single_pair(), (JSanitizeError, SanitizeError)):
        db.put(1, 64)
        leaked = db._db.version.ref()       # a pin nobody will release
        with pytest.raises(err, match="refcount leak"):
            db.sanitizer.check_refs()
        leaked.unref()


def test_detects_premature_release():
    for db, err in zip(single_pair(), (JSanitizeError, SanitizeError)):
        db.put(1, 64)
        db._db.version.unref()              # drop the engine's own pin
        try:
            with pytest.raises(err, match="refcount leak"):
                db.sanitizer.check_refs()
        finally:
            db._db.version.ref()


def test_detects_non_monotone_seq():
    def go(db):
        db.put(1, 64)
        db.sanitizer.note_seq(0)
    both(go, "not monotone")


def test_detects_migration_undercharge():
    msgs = []
    for db, err in zip(cluster_pair(), (JSanitizeError, SanitizeError)):
        db.put(1, 64)
        db.repartitioner.migrated_read_bytes += 4096
        with pytest.raises(err, match="not conserved") as e:
            db.sanitizer.check_migration_accounting()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_sanitized_db_is_not_picklable():
    _, db = single_pair()
    assert isinstance(db, SanitizedDB)
    with pytest.raises(TypeError, match="not picklable"):
        pickle.dumps(db)


def test_sanitizer_transparent_delegation():
    _, db = single_pair()
    assert db.cfg is db._db.cfg
    assert db.stats is db._db.stats
    assert db.storage is db._db.storage
    assert db.device == torch.device("cpu")
    db.defer_pc_inserts = 3                # setattr forwards to the engine
    assert db._db.defer_pc_inserts == 3
