"""The port's HotRAP engine (`repro_torch.core`) against the numpy
reference (`repro.core`) as a whole, on the CPU: a loaded tiny DB per
package, cloned by pickle for each cell, driven through `run_workload`
with the same workload; `RunResult.to_json()` equal field for field
(floats bit for bit), every op's outcome (each get's (seq, vlen), each
put's seq, each scan's records) equal, and each level's runs equal.
The baselines and ablations are in `test_torch_lsm_baselines.py`
and `test_torch_lsm_ablations.py`."""
import dataclasses
import importlib.util
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import runner as jrunner
from repro.core.baselines import make_system as jmake_system
from repro.data import workloads as jwl
from repro_torch.core import runner
from repro_torch.core.baselines import make_sharded_system, make_system
from repro_torch.core.lsm import LSMConfig
from repro_torch.data import workloads as twl

VALUE = 1000


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def levels_of(db) -> list:
    return [[(s.tier, s.level, np.asarray(s.keys).astype(np.int64).tolist(),
              np.asarray(s.seqs).tolist(), np.asarray(s.vlens).tolist())
             for s in level] for level in db.levels]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engine's many small CPU ops run fastest on one thread (more
    threads wake a pool for every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """One system loaded in both packages, pickled for clones;
    `overrides` replace LSMConfig fields in both."""

    def __init__(self, system: str, **overrides):
        self.system = system
        cfg = jrunner.default_config("tiny")
        self.n_keys = jrunner.db_key_count(cfg, VALUE)
        want = jmake_system(system, cfg, **overrides)
        jrunner.load_db(want, self.n_keys, VALUE)
        got = make_system(system, runner.default_config("tiny"),
                          device="cpu", **overrides)
        runner.load_db(got, self.n_keys, VALUE)
        assert levels_of(got) == levels_of(want)
        self.blobs = pickle.dumps(want), pickle.dumps(got)

    def clones(self):
        return pickle.loads(self.blobs[0]), pickle.loads(self.blobs[1])

    def run(self, mix: str, dist: str, n_ops: int, seed: int = 0,
            clones=None):
        """Both packages' `run_workload` of one YCSB stream, on fresh
        clones or on `clones` (a (reference, port) pair)."""
        want, got = clones or self.clones()
        wl = jwl.ycsb(mix, jwl.KeyDist(dist, self.n_keys), n_ops, VALUE,
                      seed=seed)
        twl_ = twl.ycsb(mix, twl.KeyDist(dist, self.n_keys), n_ops, VALUE,
                        seed=seed)
        w_out, g_out = [], []
        w_res = jrunner.run_workload(want, wl, name=self.system,
                                     results_out=w_out)
        g_res = runner.run_workload(got, twl_, name=self.system,
                                    results_out=g_out)
        return (want, w_res, w_out), (got, g_res, g_out)


def assert_same_run(w, g):
    (want, w_res, w_out), (got, g_res, g_out) = w, g
    assert cs.json_mismatches(w_res.to_json(), g_res.to_json()) == []
    assert g_out == w_out
    assert levels_of(got) == levels_of(want)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


@pytest.fixture(scope="module")
def hotrap():
    return Pair("hotrap")


# SR is 95% scans of up to 100 records: fewer ops keep the file fast
CELLS = [("RO", "hotspot", 5000), ("RW", "hotspot", 5000),
         ("WH", "hotspot", 5000), ("UH", "hotspot", 5000),
         ("SR", "hotspot", 1200), ("RO", "zipfian", 5000),
         ("RO", "uniform", 5000), ("UH", "zipfian", 3000)]


@pytest.mark.parametrize("mix,dist,n_ops", CELLS)
def test_hotrap_runs_as_the_reference(hotrap, mix, dist, n_ops):
    w, g = hotrap.run(mix, dist, n_ops)
    assert_same_run(w, g)
    if mix in ("RO", "UH") and dist == "hotspot":
        # the promotion pathways ran: by flush (checker) and compaction
        st = g[0].stats
        assert st.checker_runs > 0 and st.pc_inserts > 0
        assert st.promoted_bytes > 0 and st.retained_bytes > 0
    if mix == "SR":
        assert g[0].stats.scans > 1000 and g[0].stats.view_builds > 0


def test_scans_without_views():
    """`remix_views=False`: scans merge per-table and per-level cursors
    in a k-way heap, and gets walk the levels."""
    w, g = Pair("hotrap", remix_views=False).run("SR", "hotspot", 600)
    assert_same_run(w, g)
    assert g[0].stats.view_builds == 0 and g[0].stats.scans > 500


def test_point_gets_off_views_and_scalar_api(hotrap):
    """Scalar get/put/delete/scan interleaved with batches: gets served
    off scan-built GroupViews, tombstones, deferred PC inserts."""
    want, got = hotrap.clones()
    rng = np.random.default_rng(3)
    keys = rng.integers(0, hotrap.n_keys, 400).tolist()
    want.defer_pc_inserts = got.defer_pc_inserts = 5
    for i, k in enumerate(keys):
        if i % 7 == 0:
            assert got.scan(k, 30) == want.scan(k, 30)
        elif i % 11 == 0:
            assert got.delete(k) == want.delete(k)
        elif i % 13 == 0:
            assert got.put(k, 500) == want.put(k, 500)
        else:
            assert got.get(k) == want.get(k)
    batch = rng.integers(0, hotrap.n_keys, 1500)
    assert got.multi_get(batch) == want.multi_get(batch.astype(np.uint64))
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.stats.get_view_hits > 0
    assert got.storage.snapshot() == want.storage.snapshot()
    # the batch's §3.3 touched lists, views' and walks' alike, through
    # the table-by-table sid map of the two engines' equal levels
    assert levels_of(got) == levels_of(want)
    sid = {w.sid: g.sid for wl, gl in zip(want.levels, got.levels)
           for w, g in zip(wl, gl)}
    assert got._deferred_pc == [(t, k, sq, v, [sid[x] for x in touched])
                                for t, k, sq, v, touched in want._deferred_pc]
    assert any(touched for *_, touched in got._deferred_pc)


# the columnar commit's cases: a block cache of `blocks` blocks (evicting
# inside one batch; 0 counts every access a miss), `defer` ops of
# deferral for the promotion-cache inserts, `lat_out` given or not, a
# batch with `dups` (repeated keys, and runs of neighbours sharing a
# block), and `plane`: a wall-clock plane on the port alone
COMMIT_CASES = {
    "repeats": dict(blocks=4, defer=0, lat=False, dups=True, plane=False),
    "repeats_lat_out": dict(blocks=4, defer=0, lat=True, dups=True,
                            plane=False),
    "sd_inserts_freeze": dict(blocks=6, defer=0, lat=True, dups=False,
                              plane=False),
    "deferred_inserts": dict(blocks=6, defer=5, lat=True, dups=False,
                             plane=False),
    "capacity_zero": dict(blocks=0, defer=0, lat=True, dups=True,
                          plane=False),
    "wall_plane": dict(blocks=4, defer=0, lat=True, dups=True, plane=True),
}


@pytest.mark.parametrize("case", list(COMMIT_CASES))
def test_columnar_commit_matches_the_references_per_key_commit(hotrap,
                                                                case):
    """The port's columnar `multi_get` commit (the LRU replayed in one
    loop, the misses charged in whole columns, `lat_out` from running
    sums) against the reference's per-key commit: equal answers,
    `Stats`, StorageSim counters and clock, block-cache counts and LRU
    order, promotion caches, and `lat_out` rows bit for bit.  Each
    package numbers its SSTables from a module counter of its own, which
    other tests in the process advance apart, so the LRU keys compare
    through the table-by-table map of the two engines' equal levels (a
    compacted table leaves the cache)."""
    from repro_torch.obs import Observability
    c = COMMIT_CASES[case]
    want, got = hotrap.clones()
    for db in (want, got):
        db.block_cache.capacity = c["blocks"] * db.block_cache.block_bytes
        db.defer_pc_inserts = c["defer"]
    if c["plane"]:
        Observability(clock="wall").attach(got)
    rng = np.random.default_rng(11)
    for r in range(3):
        if c["dups"]:
            base = rng.integers(0, hotrap.n_keys, 150)
            batch = np.concatenate([base, base[::3], base[:40] + 1,
                                    base[:40] + 2])
            rng.shuffle(batch)
        else:
            batch = rng.integers(0, hotrap.n_keys, 700)
        before = set(map(id, got.immpcs))
        lat_w = np.full((len(batch), 2), np.nan) if c["lat"] else None
        lat_g = np.full((len(batch), 2), np.nan) if c["lat"] else None
        assert (got.multi_get(batch, lat_out=lat_g)
                == want.multi_get(batch.astype(np.uint64), lat_out=lat_w))
        if c["lat"]:
            assert lat_g.tobytes() == lat_w.tobytes()
            assert (lat_g > 0).any()
        if not c["dups"] and not c["defer"]:
            # an mPC froze inside the batch
            assert set(map(id, got.immpcs)) - before
    assert levels_of(got) == levels_of(want)
    sid = {w.sid: g.sid for wl, gl in zip(want.levels, got.levels)
           for w, g in zip(wl, gl)}
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.storage.snapshot() == want.storage.snapshot()
    assert got.storage.sim_time == want.storage.sim_time
    bc, wbc = got.block_cache, want.block_cache
    assert (bc.hits, bc.misses) == (wbc.hits, wbc.misses)
    assert list(bc._od) == [(sid[s], b) for s, b in wbc._od]
    assert len(bc._od) <= c["blocks"]
    assert got.mpc.data == want.mpc.data
    assert got._deferred_pc == [(t, k, sq, v, [sid[x] for x in touched])
                                for t, k, sq, v, touched in want._deferred_pc]
    assert len(got.immpcs) == len(want.immpcs)
    st = got.stats
    assert st.served_sd > 0 and st.pc_inserts + len(got._deferred_pc) > 0
    if c["blocks"]:
        assert bc.hits > 0
    else:
        assert bc.hits == 0


# the columnar Checker's cases: a block cache of `blocks` blocks (0 counts
# every access a miss), `records` hot records frozen (with 20 cold ones),
# of which `fd` have a newer version flushed to L0 before the freeze (the
# walk stops at its block), `imm` a newer one in a pinned imm-memtable
# and `upd` are put and rotated after the freeze (`updated`); `plane`: a
# wall-clock plane on the port alone.  Under 64 survivors (half a tiny
# table) go back into the mPC.
CHECKER_CASES = {
    "many_candidates": dict(blocks=4, records=300, fd=0, imm=0, upd=0,
                            plane=False),
    "newer_in_fd": dict(blocks=4, records=300, fd=60, imm=0, upd=0,
                        plane=False),
    "newer_in_imm_memtable": dict(blocks=4, records=300, fd=0, imm=40, upd=0,
                                  plane=False),
    "updated_after_freeze": dict(blocks=4, records=300, fd=0, imm=0, upd=40,
                                 plane=False),
    "capacity_zero": dict(blocks=0, records=300, fd=60, imm=20, upd=20,
                          plane=False),
    "reinserted": dict(blocks=4, records=50, fd=10, imm=0, upd=0,
                       plane=False),
    "wall_plane": dict(blocks=4, records=300, fd=60, imm=20, upd=20,
                       plane=True),
}


def newest_versions(db) -> dict:
    """{key: (seq, vlen)} of the newest version in the levels (the
    memtables empty), read without touching the engine."""
    out: dict = {}
    for level in levels_of(db):
        for _, _, keys, seqs, vlens in level:
            for k, sq, v in zip(keys, seqs, vlens):
                out.setdefault(k, (sq, v))
    return out


@pytest.mark.parametrize("case", list(CHECKER_CASES))
def test_columnar_checker_matches_the_references_per_record_checker(
        hotrap, case):
    """The port's Checker (hotness, `updated`, the newer-version walk and
    its block-cache accesses, all in columns) against the reference's
    per-record loop over one immPC frozen alike in both: the same
    survivors (in L0's newest table, or back in the mPC), `Stats`,
    StorageSim counters, clock and components, block-cache counts and
    LRU order (through the table-by-table sid map, as above)."""
    from repro.core.promotion import MutablePromotionCache as JMPC
    from repro_torch.core.promotion import MutablePromotionCache
    from repro_torch.core.sstable import KEY_BYTES
    from repro_torch.obs import Observability
    c = CHECKER_CASES[case]
    want, got = hotrap.clones()
    obs = (Observability(clock="wall").attach(got, name="g") if c["plane"]
           else None)
    for db in (want, got):
        db.block_cache.capacity = c["blocks"] * db.block_cache.block_bytes
    rng = np.random.default_rng(7)
    keys = rng.permutation(hotrap.n_keys)
    hot, cold = keys[:400], keys[400:420]
    # RALT learns the hot keys (and promotions fill L0)
    for _ in range(4):
        assert got.multi_get(hot) == want.multi_get(hot.astype(np.uint64))
    current = newest_versions(got)
    assert current == newest_versions(want)
    chosen = np.concatenate([hot[:c["records"]], cold])
    fd = chosen[:c["fd"]]
    imm = chosen[c["fd"]:c["fd"] + c["imm"]]
    upd = chosen[c["fd"] + c["imm"]:c["fd"] + c["imm"] + c["upd"]]

    def both(f):
        return f(want, JMPC), f(got, MutablePromotionCache)

    def newer_to_l0(db, _):
        db.put_many(fd, VALUE)
        db._rotate_memtable()
        db._flush_imm_memtables()

    def newer_in_imm(db, _):
        db.put_many(imm, VALUE)
        db._rotate_memtable()

    def freeze(db, mpc):
        db.mpc = mpc()
        for k in sorted(chosen.tolist()):
            db.mpc.insert(k, *current[k], KEY_BYTES)
        db._freeze_mpc()
        immpc = db.immpcs[-1]
        db._checker_queue = [q for q in db._checker_queue
                             if q[1] is not immpc]
        return immpc

    def updated(db, _):
        db.put_many(upd, VALUE)
        db._rotate_memtable()

    if len(fd):
        both(newer_to_l0)
    if len(imm):
        both(newer_in_imm)
    w_immpc, g_immpc = both(freeze)
    if len(upd):
        both(updated)
        assert g_immpc.updated == w_immpc.updated == set(upd.tolist())
    # the freeze pinned the imm-memtable of `imm` alone
    assert len(g_immpc.sv.imm_memtables) == (1 if len(imm) else 0)
    def promoted(db):
        return db.storage.by_component.get("promotion", {}).get(
            "write_bytes", 0)

    p0 = promoted(got)
    st0 = dataclasses.replace(got.stats)
    acc0 = got.block_cache.hits + got.block_cache.misses
    want._run_checker(w_immpc)
    got._run_checker(g_immpc)
    assert levels_of(got) == levels_of(want)
    sid = {w.sid: g.sid for wl, gl in zip(want.levels, got.levels)
           for w, g in zip(wl, gl)}
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.storage.snapshot() == want.storage.snapshot()
    assert got.storage.sim_time == want.storage.sim_time
    bc, wbc = got.block_cache, want.block_cache
    assert (bc.hits, bc.misses) == (wbc.hits, wbc.misses)
    assert list(bc._od) == [(sid[s], b) for s, b in wbc._od]
    assert got.mpc.data == want.mpc.data
    assert got.immpcs == [] and want.immpcs == []
    # what the case was to exercise
    st = got.stats
    newer = st.checker_excluded_newer - st0.checker_excluded_newer
    assert newer >= len(fd) + len(imm) and (newer > 0) == bool(
        len(fd) + len(imm))
    assert (st.checker_excluded_updated - st0.checker_excluded_updated
            == len(upd))
    events = bc.hits + bc.misses - acc0
    assert events > 0
    assert "checker" in got.storage.by_component
    # under half a table back into the mPC, else one L0 table written
    # (which compaction may have merged down since)
    if c["records"] < 64:
        assert promoted(got) == p0 and len(got.mpc.data) > 0
    else:
        assert promoted(got) > p0 and not got.mpc.data
    if obs is not None:
        ends = [ev["args"] for ev in obs.tracer.events
                if ev["name"] == "checker" and ev["ph"] == "E"]
        assert ends[-1] == {"records": len(chosen),
                            "candidates": (c["records"] - len(upd)),
                            "block_events": events}
        assert obs.tracer.validate() == []


def test_put_many_matches_scalar_puts_across_rotations():
    """A batch with repeated keys and tombstones crossing several
    memtable rotations: the same seqs, memtables, levels and stats as
    the scalar puts, and as the reference's put_many."""
    cfg = dataclasses.replace(runner.default_config("tiny"),
                              memtable_bytes=32 * 1024)
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 3000, 2500)
    vlens = rng.integers(50, 900, 2500)
    vlens[::17] = 0xFFFFFFFF
    scalar = make_system("hotrap", cfg, device="cpu")
    batched = make_system("hotrap", cfg, device="cpu")
    ref = jmake_system("hotrap", dataclasses.replace(
        jrunner.default_config("tiny"), memtable_bytes=32 * 1024))
    seqs = [scalar.put(int(k), int(v)) for k, v in zip(keys, vlens)]
    got = batched.put_many(keys, vlens)
    want = ref.put_many(keys.astype(np.uint64), vlens)
    assert got.tolist() == seqs == want.tolist()
    assert batched.stats.flushes > 3
    for other in (scalar, ref):
        assert batched.memtable == other.memtable
        assert levels_of(batched) == levels_of(other)
        assert dataclasses.asdict(batched.stats)["puts"] == other.stats.puts
    assert batched.stats.flushes == ref.stats.flushes


def test_pickle_round_trip_continues_identically(hotrap):
    """A clone pickled mid-run (memtable, mPC, immPCs, RALT buffer and
    runs, views dropped) and driven further matches the original."""
    _, got = hotrap.clones()
    first = twl.ycsb("UH", twl.KeyDist("hotspot", hotrap.n_keys), 2500,
                     VALUE, seed=1)
    runner.run_workload(got, first)
    assert got.immpcs or got.mpc.data or got._checker_queue
    clone = pickle.loads(pickle.dumps(got))
    rest = twl.ycsb("SR", twl.KeyDist("hotspot", hotrap.n_keys), 400,
                    VALUE, seed=2)
    a_out, b_out = [], []
    a = runner.run_workload(got, rest, results_out=a_out)
    b = runner.run_workload(clone, rest, results_out=b_out)
    assert cs.json_mismatches(a.to_json(), b.to_json()) == []
    assert a_out == b_out and levels_of(got) == levels_of(clone)


def test_unported_parts_raise_naming_their_item():
    """Nothing of `repro.core` is left unported: every name in `SYSTEMS`
    builds on the CPU, in both factories, and `sanitize=True` wraps each
    in a `SanitizedDB`; an unknown name still raises ValueError."""
    from repro_torch.core import SYSTEMS, SanitizedDB, ShardConfig
    cfg = runner.default_config("tiny")
    scfg = ShardConfig(n_shards=2)
    for name in SYSTEMS:
        db = make_system(name, cfg, device="cpu")
        assert db.device.type == "cpu" and not isinstance(db, SanitizedDB)
        cluster = make_sharded_system(name, cfg, scfg, device="cpu")
        assert len(cluster.shards) == 2
        assert all(type(sh) is type(db) for sh in cluster.shards)
        wrapped = make_system(name, cfg, sanitize=True, device="cpu")
        assert isinstance(wrapped, SanitizedDB)
        assert type(wrapped._db) is type(db)
        wrapped = make_sharded_system(name, cfg, scfg, sanitize=True,
                                      device="cpu")
        assert isinstance(wrapped, SanitizedDB)
        assert len(wrapped.shards) == 2
    with pytest.raises(ValueError):
        make_system("nope", cfg, device="cpu")


def test_entry_points_run_on_cuda_unless_told_otherwise():
    """No quiet CPU fallback: without CUDA the default device raises;
    with `device="cpu"` every tensor the engine builds is on the CPU."""
    cfg = runner.default_config("tiny")
    if not torch.cuda.is_available():
        for make in (lambda: make_system("hotrap", cfg),
                     lambda: runner.bench_system(
                         "hotrap", "RO", twl.KeyDist("hotspot", 10), 10,
                         VALUE, cfg=cfg)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    db = make_system("hotrap", cfg, device="cpu")
    runner.load_db(db, 3000, VALUE)
    db.scan(0, 50)
    assert db.tensors() and all(t.device.type == "cpu"
                                for t in db.tensors())
    assert db.device_bytes() > 0
    assert LSMConfig().wal is False
