"""The paper's compared systems in the port (`repro_torch.core.baselines`:
`mutant`, `sas_cache`, `prismdb`) against the numpy reference, on the
CPU: every YCSB mix on hotspot-5% through `Pair` and `assert_same_run`
(`RunResult.to_json()` field for field, every op's outcome, each level's
runs, the stats), each system's policy state (Mutant's temperatures,
SAS-Cache's secondary cache, PrismDB's clock bits) equal to the
reference's, and the cells of the reference's tests that name these
systems (`test_scan.py`, `test_batch_exec.py`, `test_shards.py`,
`test_version.py`)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
from repro_torch import core as port
from test_torch_lsm import Pair, assert_same_run

SYSTEMS = ["mutant", "sas_cache", "prismdb"]
# ops per mix; SR (95% scans) shorter
OPS = {"RO": 3000, "RW": 3000, "WH": 3000, "UH": 2000, "SR": 400}
KIB = 1024


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engine's many small CPU ops run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    return {}


def pair_of(pairs, system) -> Pair:
    if system not in pairs:
        pairs[system] = Pair(system)
    return pairs[system]


def policy_state(db) -> dict:
    """A compared system's own state beyond the engine's."""
    if hasattr(db, "temps"):
        return {"temps": sorted(db.temps.values()),
                "accesses": db._accesses,
                "tiers": [[s.tier for s in lvl] for lvl in db.levels]}
    if hasattr(db, "secondary"):
        sc = db.secondary
        return {"hits": sc.hits, "misses": sc.misses, "n": len(sc._od)}
    return {"clock": list(db.clock.items()), "reads": db._reads}


def assert_same_policy(want, got) -> None:
    assert policy_state(got) == policy_state(want)
    assert got.storage.snapshot() == want.storage.snapshot()


@pytest.mark.parametrize("mix", list(OPS))
@pytest.mark.parametrize("system", SYSTEMS)
def test_system_runs_as_the_reference(pairs, system, mix):
    w, g = pair_of(pairs, system).run(mix, "hotspot", OPS[mix])
    assert_same_run(w, g)
    assert_same_policy(w[0], g[0])
    st = g[0].stats
    assert st.promoted_bytes == st.pc_inserts == 0
    assert g[0]._point_view_ok is (system == "prismdb")
    if system == "sas_cache" and mix != "WH":
        assert g[0].secondary.hits > 0


def test_mutant_migrates_as_the_reference(pairs):
    """A short migration interval: several decay + re-ranking passes,
    tables moved between tiers by placement alone."""
    p = pair_of(pairs, "mutant")
    want, got = p.clones()
    for db in (want, got):
        db.migration_interval = 700
    w = p.run("RO", "hotspot", 3000, clones=(want, got))
    assert_same_run(*w)
    assert_same_policy(want, got)
    comp = got.storage.by_component["migration"]
    assert comp["read_bytes"] > 0 and comp["write_bytes"] > 0


def test_prismdb_clock_sweeps_and_retains_as_the_reference(pairs):
    """A short clock-sweep interval (the hand's draws from the
    reference's generator), and cross-tier merges that write the
    clock-hot records to FD."""
    p = pair_of(pairs, "prismdb")
    want, got = p.clones()
    for db in (want, got):
        db.clock_clear_interval = 900
    w = p.run("UH", "hotspot", 6000, clones=(want, got))
    assert_same_run(*w)
    assert_same_policy(want, got)
    assert got._reads > 3 * 900 and got.stats.retained_bytes > 0
    assert (got._clock_rng.bit_generator.state
            == want._clock_rng.bit_generator.state)


# ----------------------------------------------------------------------
# the reference's cells that name these systems
# ----------------------------------------------------------------------
def tiny_kw(**kw):
    base = dict(fd_size=256 * KIB, sd_size=2 * 1024 * KIB,
                target_sstable_bytes=32 * KIB, memtable_bytes=16 * KIB,
                block_cache_bytes=16 * KIB, checker_delay_ops=16)
    base.update(kw)
    return base


def both(system, **kw):
    """The reference's and the port's (CPU) `system` over `tiny_kw`."""
    return (ref.make_system(system, ref.LSMConfig(**tiny_kw(**kw))),
            port.make_system(system, port.LSMConfig(**tiny_kw(**kw)),
                             device="cpu"))


def test_scan_range_matches_model_sas_cache():
    """`tests/test_scan.py:69` for `sas_cache`: both packages, one
    stream, the same scans."""
    dbs = both("sas_cache")
    rng = np.random.default_rng(4)
    for _ in range(2500):
        k = int(rng.integers(0, 600))
        if rng.random() < 0.85:
            assert len({db.put(k, 120) for db in dbs}) == 1
        else:
            assert len({db.delete(k) for db in dbs}) == 1
    for _ in range(30):
        lo = int(rng.integers(0, 600))
        hi = lo + int(rng.integers(0, 200))
        got, want = dbs[1].scan_range(lo, hi), dbs[0].scan_range(lo, hi)
        assert got == want
    assert dataclasses.asdict(dbs[1].stats) == dataclasses.asdict(
        dbs[0].stats)
    assert_same_policy(*dbs)


def test_scan_counts_records_toward_baseline_counters():
    """`tests/test_scan.py:284` and `:292`: a 40-record scan advances
    Mutant's access count and PrismDB's read count by 40."""
    muts = both("mutant")
    for mut in muts:
        for k in range(3000):
            mut.put(k, 200)
        mut.flush_all()
        mut.migration_interval = 100
        before = mut._accesses
        out = mut.scan(0, 40)
        assert mut._accesses - before == len(out) == 40
    assert_same_policy(*muts)
    prisms = both("prismdb")
    for prism in prisms:
        for k in range(500):
            prism.put(k, 200)
        before = prism._reads
        out = prism.scan(0, 40)
        assert prism._reads - before == len(out) == 40
        assert all(prism.clock.get(k) for k, _, _ in out)
    assert_same_policy(*prisms)


def test_multi_get_falls_back_when_read_hooks_overridden():
    """`tests/test_batch_exec.py:127`: Mutant's `multi_get` takes the
    per-key path, equal to scalar gets and to the reference's."""
    dbs = []
    for pkg, kw in ((ref, {}), (port, {"device": "cpu"}),
                    (port, {"device": "cpu"})):
        cfg = pkg.LSMConfig(**tiny_kw(hotrap=True))
        db = pkg.make_system("mutant", cfg, **kw)
        for k in range(600):
            db.put(k, 120)
        dbs.append(db)
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 620, 128)
    scalar = [dbs[2].get(int(k)) for k in keys]
    lat = np.zeros((len(keys), 2))
    assert dbs[1].multi_get(keys, lat_out=lat) == scalar
    assert dbs[0].multi_get(keys.astype(np.uint64)) == scalar
    assert dbs[1].stats.gets == dbs[2].stats.gets == dbs[0].stats.gets
    assert (lat >= 0).all() and lat.sum() > 0


def test_put_many_falls_back_when_put_overridden():
    """A subclass overriding `put` gets the per-key `put_many`, which
    keeps pre-assigned seqs (the shard router's contract)."""
    class Counting(port.TieredLSM):
        def put(self, key, vlen):
            self.n_put = getattr(self, "n_put", 0) + 1
            return super().put(key, vlen)

    cfg = port.LSMConfig(**tiny_kw())
    db, plain = Counting(cfg, device="cpu"), port.TieredLSM(cfg, device="cpu")
    keys = np.arange(300) % 170
    seqs = np.arange(1000, 1300)
    assert db.put_many(keys, 120, seqs=seqs).tolist() == seqs.tolist()
    assert plain.put_many(keys, 120, seqs=seqs).tolist() == seqs.tolist()
    assert db.n_put == 300 and db.seq == plain.seq == 1299
    assert db.memtable == plain.memtable


def test_point_view_disabled_for_interposing_baselines():
    """`tests/test_shards.py:284`: Mutant and SAS-Cache hook
    `_search_levels`, so the view fast path stays off for them."""
    cfg = port.LSMConfig(**tiny_kw())
    for name in ("mutant", "sas_cache"):
        assert not port.make_system(name, cfg, device="cpu")._point_view_ok
    for name in ("rocksdb_tiered", "prismdb", "hotrap"):
        assert port.make_system(name, cfg, device="cpu")._point_view_ok


def test_interposing_baseline_gets_skip_views():
    """With a scan-built view materialized, Mutant's and SAS-Cache's
    gets still walk the levels (their hooks fire), as the reference's
    do."""
    for name in ("mutant", "sas_cache"):
        dbs = both(name, block_cache_bytes=0)
        for db in dbs:
            for k in range(3000):
                db.put(k, 300)
            db.flush_all()
            db.scan(0, 50)
        got = [dbs[1].get(k) for k in range(0, 3000, 11)]
        assert got == [dbs[0].get(k) for k in range(0, 3000, 11)]
        assert dbs[1].stats.get_view_hits == 0
        assert_same_policy(*dbs)


@pytest.mark.parametrize("system", ["mutant", "sas_cache"])
def test_view_path_charges_scan_io(system):
    """`tests/test_version.py:257`: GroupView scans charge device I/O
    through the baseline's charge hook, as the reference's do."""
    dbs = both(system, block_cache_bytes=0)
    reads = []
    for db in dbs:
        for k in range(3000):
            db.put(k, 300)
        db.flush_all()
        r0 = sum(db.storage.dev[t].read_bytes for t in ("FD", "SD"))
        out = db.scan_range(0, 1500)
        r1 = sum(db.storage.dev[t].read_bytes for t in ("FD", "SD"))
        assert r1 > r0
        reads.append((out, r1 - r0))
    assert reads[0] == reads[1]
    assert_same_policy(*dbs)
