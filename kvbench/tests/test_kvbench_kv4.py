"""The durable 4-shard cell as `BENCHMARK.json` names it
(`hotrap-kv4-wal.rw-hotspot5`, `configs/hotrap-kv4-wal.json`), cut to
the engine's `tiny` scale: sound runs are correct and read the router's
and the WAL's metrics; broken ones are not correct."""
import json

import pytest

from kvbench.tests import tiny

CELL = "hotrap-kv4-wal.rw-hotspot5"


def test_the_cell_and_its_config_are_in_the_benchmark():
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "hotrap-kv4-wal", "rw-hotspot5", 1)
    cfg = json.loads((tiny.ROOT / "kvbench" / "configs"
                      / "hotrap-kv4-wal.json").read_text())
    assert cfg["engine"]["shards"]["n_shards"] == 4
    assert cfg["engine"]["lsm"]["wal"]
    dur = cfg["guarantees"]["durability"]
    assert dur["group_commit_records"] == (
        cfg["engine"]["lsm"]["wal_group_commit_records"])
    assert (cfg["key_bytes"], cfg["value_len"]) == (24, 1000)


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(monkeypatch, trace):
    from kvbench import engine
    real, seen = engine.counters, []

    def kept(db):
        seen.append(real(db))
        return seen[-1]
    monkeypatch.setattr(engine, "counters", kept)
    res = tiny.run(CELL, seconds=0.3, trace=trace)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    if not trace:
        assert {"ops_per_s", "p95_op_ms", "setup_s"} <= set(res["metrics"])
        return
    m = res["metrics"]
    d = engine.delta(*seen)["stats"]
    # a shard syncs once its buffer holds a group of 64, so in the window
    # each of the 4 shards leaves at most 63 puts unsynced at either end
    assert d["wal_syncs"] * 64 >= d["puts"] - 4 * 63 > 0
    assert (m["wal_syncs_per_kput"]["value"]
            == d["wal_syncs"] / d["puts"] * 1000)
    assert m["shard_calls_per_kop"]["value"] > 0


def test_writes_missing_after_recovery_are_caught(monkeypatch):
    """Recovery that skips the WAL's replay loses the memtables'
    acknowledged, synced writes (8 MiB memtables: none flushes after the
    load, so each holds more than the 63 newest a group commit may
    lose)."""
    from repro_torch.core import wal

    def no_replay(self):
        return [], 0
    mt = {"memtable_bytes": 8 << 20}
    assert tiny.run(CELL, seconds=0.3, lsm=mt)["correct"]
    monkeypatch.setattr(wal.WriteAheadLog, "replay", no_replay)
    res = tiny.run(CELL, seconds=0.3, lsm=mt)
    assert not res["correct"]
    assert res["checks"]["readback_mismatches"]["value"] > 0


def test_the_control_fails():
    from kvbench import control
    res = tiny.run(CELL, seconds=0.3, system=control.build)
    assert not res["correct"]
    assert res["checks"]["get_mismatches"]["value"] > 0


@pytest.mark.parametrize("name", ["wal_syncs_per_kput",
                                  "shard_calls_per_kop"])
def test_readers_leave_out_what_the_engine_does_not_count(name):
    """A program without the cluster's counters (a single store, or one
    from before them) gives no value and raises nothing."""
    from kvbench.harness import resolve
    read = resolve(tiny.ROOT, CELL)["readers"][name][0]
    base = {"ops": 2048, "gets": 1536, "puts": 512}
    assert read({**base, "counters": None}) is None
    assert read({**base, "counters": {"stats": {"puts": 512}}}) is None
    stats = {"wal_syncs": 4, "shard_calls": 8}
    assert read({**base, "counters": {"stats": stats}}) > 0
