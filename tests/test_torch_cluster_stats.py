"""A cluster's counters beyond the reference's `Stats`
(`repro_torch.core.shards.ClusterStats`): the router's calls, the
shards' WAL group commits and the HotBudget rounds, each equal to a
count this test works out from what it sent; and a single store's
`Stats`, which keeps exactly the reference's fields."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import lsm as jlsm
from repro_torch.core import (ShardConfig, make_sharded_system, make_system,
                              runner)
from repro_torch.core.lsm import Stats
from repro_torch.core.shards import ClusterStats
from repro_torch.core.wal import WAL_RECORD_OVERHEAD, WAL_SYNC_OVERHEAD

VALUE = 120
GROUP = 64
INTERVAL = 256
NEW = ("wal_syncs", "wal_bytes", "router_batches", "shard_calls",
       "hot_budget_rebalances")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cluster(wal: bool = True):
    cfg = dataclasses.replace(runner.default_config("tiny"), wal=wal,
                              wal_group_commit_records=GROUP)
    return make_sharded_system(
        "hotrap", cfg, ShardConfig(n_shards=4,
                                   rebalance_interval_ops=INTERVAL),
        device="cpu")


class Expected:
    """The counters as the test works them out: each shard's WAL buffer
    syncs whole once a call leaves a group or more in it, and the
    arbiter runs a round once the router's ops since the last round
    reach the interval."""

    def __init__(self, db):
        self.db = db
        self.buf = np.zeros(len(db.shards), dtype=np.int64)
        self.c = dict.fromkeys(NEW, 0)
        self.since = 0

    def _sync(self, i: int) -> None:
        self.c["wal_syncs"] += 1
        self.c["wal_bytes"] += (self.buf[i] * (WAL_RECORD_OVERHEAD + VALUE)
                                + WAL_SYNC_OVERHEAD)
        self.buf[i] = 0

    def call(self, keys, put: bool) -> None:
        sids = self.db._shard_ids(keys)
        buckets, counts = np.unique(sids, return_counts=True)
        self.c["router_batches"] += 1
        self.c["shard_calls"] += len(buckets)
        self.since += len(keys)
        if self.since >= INTERVAL:
            self.since = 0
            self.c["hot_budget_rebalances"] += 1
        if put:
            for i, k in zip(buckets.tolist(), counts.tolist()):
                self.buf[i] += k
                if self.buf[i] >= GROUP:
                    self._sync(i)

    def flush_all(self) -> None:
        for i in np.flatnonzero(self.buf).tolist():
            self._sync(i)


def drive(db, want: Expected, rounds: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    n_keys = runner.db_key_count(runner.default_config("tiny"), VALUE)
    for _ in range(rounds):
        reads = rng.integers(0, n_keys, 64)
        db.multi_get(reads)
        want.call(reads, put=False)
        writes = rng.integers(0, n_keys, int(rng.choice([32, 64, 128])))
        db.put_many(writes, VALUE)
        want.call(writes, put=True)


def got(db) -> dict:
    st = db.stats
    return {k: getattr(st, k) for k in NEW}


def test_cluster_counters_equal_the_counts_of_what_was_sent():
    db = cluster()
    want = Expected(db)
    drive(db, want, 60, seed=3)
    assert got(db) == want.c
    assert want.c["wal_syncs"] > 20 and want.c["hot_budget_rebalances"] > 10
    db.flush_all()
    want.flush_all()
    assert got(db) == want.c


def test_cluster_counters_only_grow_and_run_on_across_recovery():
    db = cluster()
    want = Expected(db)
    drive(db, want, 30, seed=5)
    before = got(db)
    rec = type(db).recover(db)
    # recovery replays but syncs nothing; the router's counts carry over
    assert got(rec) == before
    want.db = rec
    # the unsynced tails were lost with the crash, and the arbiter
    # restarts cold: each shard's buffer and the ops since a round start
    # at 0
    want.buf[:] = 0
    want.since = 0
    drive(rec, want, 30, seed=6)
    after = got(rec)
    assert all(after[k] > before[k] for k in NEW)
    assert after == want.c


def test_cluster_without_a_wal_counts_no_syncs():
    db = cluster(wal=False)
    want = Expected(db)
    drive(db, want, 10, seed=7)
    c = got(db)
    assert c["wal_syncs"] == c["wal_bytes"] == 0
    assert c["router_batches"] == want.c["router_batches"] == 20
    assert c["shard_calls"] == want.c["shard_calls"]


def test_cluster_stats_extend_the_references_fields():
    """A single store's `Stats` has exactly the reference's fields, in
    its order; a cluster's adds the five counters after them, and
    `RunResult.stats` keeps the reference's fields for both."""
    ref = [f.name for f in dataclasses.fields(jlsm.Stats)]
    single = make_system("hotrap", runner.default_config("tiny"),
                         device="cpu")
    assert type(single.stats) is Stats
    assert [f.name for f in dataclasses.fields(single.stats)] == ref
    db = cluster()
    assert type(db.stats) is ClusterStats
    assert [f.name for f in dataclasses.fields(db.stats)] == ref + list(NEW)
    n = 2000
    runner.load_db(db, n, VALUE)
    from repro_torch.data import workloads as twl
    res = runner.run_workload(
        db, twl.ycsb("RW", twl.KeyDist("hotspot", n), 2000, VALUE, seed=1))
    assert list(res.stats) == ref
