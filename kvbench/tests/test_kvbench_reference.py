"""The plain reference agrees with the port run on the CPU, and the
comparison built on it rejects a wrong answer and a lost write."""
import numpy as np
import pytest

from kvbench.reference.store import (PlainStore, readback_mismatches,
                                     shard_of)
from kvbench.tests import tiny

DUR = {"partitioning": "hash", "n_shards": 4, "group_commit_records": 64}


@pytest.mark.parametrize("cell", ["hotrap-medium.ro-hotspot5",
                                  "hotrap-medium.rw-hotspot5"])
def test_reference_agrees_with_the_port_for_hundreds_of_rounds(
        monkeypatch, cell):
    monkeypatch.setattr("kvbench.harness.MIN_WINDOW_ROUNDS", 200)
    res = tiny.run(cell, seconds=0.1)
    assert res["attempted"] >= 200 * 64
    assert res["correct"], res["checks"]


def test_reference_agrees_after_crash_and_recovery_of_the_wal_cluster(
        roots):
    """The 4-shard WAL cluster is crashed after its window and recovered
    from its WALs and manifests; every sampled key and every key among
    each shard's newest writes reads back as the durability rule
    allows."""
    res = tiny.run(tiny.KV4, seconds=1.0, root=roots[tiny.KV4])
    assert res["correct"], res["checks"]


def test_recovery_loses_a_suffix_the_rule_accepts():
    """Unsynced WAL records are lost at a crash; the reference accepts
    that suffix (the case the durability rule exists for)."""
    from repro_torch.core import ShardConfig, ShardedTieredLSM, baselines
    from repro_torch.core import runner
    cfg = runner.default_config("tiny")
    cfg.wal = True
    db = baselines.make_sharded_system("hotrap", cfg, ShardConfig(),
                                       seed=3, device="cpu")
    ref = PlainStore()
    rng = np.random.default_rng(3)
    keys = rng.permutation(4000)
    for a in range(0, 4000, 500):
        assert (db.put_many(keys[a:a + 500], 1000)
                == ref.put_many(keys[a:a + 500], 1000)).all()
    extra = np.arange(4000, 4090)          # fewer than 64 a shard
    db.put_many(extra, 1000)
    ref.put_many(extra, 1000)
    rec = ShardedTieredLSM.recover(db)
    assert rec.recovery_info["discarded_torn"] > 0
    probe = np.arange(4090)
    got = rec.multi_get(probe)
    s = np.array([g[0] if g else 0 for g in got])
    v = np.array([g[1] if g else 0 for g in got])
    # torn WAL records whose memtable was flushed survive in tables
    assert 0 < (s == 0).sum() <= rec.recovery_info["discarded_torn"]
    assert readback_mismatches(ref, probe, s, v, DUR) == 0
    assert readback_mismatches(ref, probe, s, v, None) > 0


def _store_with_tail():
    ref = PlainStore()
    keys = np.arange(3000)
    ref.put_many(keys, 1000)
    s, v = ref.multi_get(keys)
    return ref, keys, s.copy(), v.copy()


def test_readback_rule_allows_at_most_63_lost_per_shard():
    ref, keys, s, v = _store_with_tail()
    sh = shard_of(keys, DUR)
    mine = np.flatnonzero(sh == 0)
    s63, v63 = s.copy(), v.copy()
    s63[mine[-63:]] = 0
    v63[mine[-63:]] = 0
    assert readback_mismatches(ref, keys, s63, v63, DUR) == 0
    s64, v64 = s.copy(), v.copy()
    s64[mine[-64:]] = 0
    v64[mine[-64:]] = 0
    assert readback_mismatches(ref, keys, s64, v64, DUR) == 1


def test_readback_rule_rejects_a_loss_that_is_not_a_suffix():
    ref, keys, s, v = _store_with_tail()
    mine = np.flatnonzero(shard_of(keys, DUR) == 1)
    s[mine[-10]] = 0                        # lost, while newer ones live
    v[mine[-10]] = 0
    assert readback_mismatches(ref, keys, s, v, DUR) == 1


def test_readback_rule_rejects_a_seq_off_by_one():
    ref, keys, s, v = _store_with_tail()
    s[5] += 1
    assert readback_mismatches(ref, keys, s, v, DUR) == 1
    assert readback_mismatches(ref, keys, s, v, None) == 1


def test_reference_keeps_the_newest_of_repeated_keys():
    ref = PlainStore()
    acks = ref.put_many(np.array([7, 9, 7]), 1000)
    assert acks.tolist() == [1, 2, 3]
    ref.put_many(np.array([9]), 500)
    s, v = ref.multi_get(np.array([7, 9, 8, 10 ** 9]))
    assert s.tolist() == [3, 4, 0, 0] and v.tolist() == [1000, 500, 0, 0]
