"""The parts of the port's LSM engine (`repro_torch.core`,
`repro_torch.data.workloads`) against the numpy reference (`repro.core`,
`repro.data.workloads`) on the same numpy-made inputs, on the CPU.
Everything is held exactly: integers equal, floats equal bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ralt as jralt
from repro.core import scan as jscan
from repro.core import sstable as jsst
from repro.core.runner import db_key_count as jdb_key_count
from repro.core.runner import default_config as jdefault_config
from repro.core.baselines import make_system as jmake_system
from repro.core.storage import StorageSim as JStorageSim
from repro.data import workloads as jwl
from repro_torch.core import lsm, ralt, scan, sstable
from repro_torch.core.baselines import make_system
from repro_torch.core.runner import default_config
from repro_torch.core.storage import BlockCache, StorageSim
from repro_torch.data import workloads as twl

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engine's many small CPU ops run fastest on one thread (more
    threads wake a pool for every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int64).copy())


def same(got, want) -> bool:
    """Exact equality of a tensor or array with a numpy array: values,
    and for floats every bit."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return False
    if want.dtype.kind == "f":
        return np.array_equal(got.astype(np.float64).view(np.int64),
                              want.astype(np.float64).view(np.int64))
    return np.array_equal(got.astype(np.int64), want.astype(np.int64))


def unpacked_bits(words: np.ndarray) -> np.ndarray:
    """The reference's uint64 bloom words as one bool per bit."""
    shifts = np.arange(64, dtype=np.uint64)
    return ((words[:, None] >> shifts) & np.uint64(1)).astype(bool).ravel()


# ----------------------------------------------------------------------
# bloom filters and SSTables
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,bits_per_key", [(0, 10), (1, 10), (1000, 10),
                                            (777, 14), (5000, 3)])
def test_bloom_bits_and_answers(n, bits_per_key):
    """Every bit, and every answer over present and absent keys (false
    positives included: they are charged I/O)."""
    rng = np.random.default_rng(n + bits_per_key)
    keys = np.unique(rng.integers(0, 1 << 62, n))
    want = jsst.BloomFilter(keys.astype(np.uint64), bits_per_key)
    got = sstable.BloomFilter(t64(keys), bits_per_key)
    assert got.k == want.k and got.nbits == int(want.nbits)
    assert got.nbytes == want.nbytes
    ref_bits = unpacked_bits(want.bits)
    assert not ref_bits[got.nbits:].any()
    assert same(got.bits, ref_bits[:got.nbits])
    probe = np.concatenate([keys, rng.integers(0, 1 << 62, 20_000),
                            [0, 1, (1 << 63) - 1]])
    ans = want.may_contain_many(probe.astype(np.uint64))
    assert same(got.may_contain_many(t64(probe)), ans)
    if n > 100:
        assert ans[len(keys):].any()          # some false positives
    for k in probe[::997].tolist():
        assert got.may_contain(k) == want.may_contain(k)


def test_hash_multipliers_wrap_to_the_references_bits():
    assert tuple(m & (2**64 - 1) for m in sstable.MULTS) == tuple(
        int(m) for m in jsst.BloomFilter._MULTS)


def _run(rng, n, tomb_frac=0.1, key_hi=50_000):
    keys = np.sort(rng.choice(key_hi, n, replace=False))
    seqs = rng.integers(1, 10**6, n)
    vlens = rng.integers(1, 3000, n)
    vlens[rng.random(n) < tomb_frac] = jsst.TOMBSTONE_VLEN
    return keys, seqs, vlens


def test_sstable_arrays_and_blocks():
    rng = np.random.default_rng(1)
    keys, seqs, vlens = _run(rng, 700)
    want = jsst.SSTable(keys.astype(np.uint64), seqs,
                        vlens.astype(np.uint32), "FD", 0, 5)
    got = sstable.SSTable(t64(keys), t64(seqs), t64(vlens), "FD", 0, 5)
    assert same(got.record_bytes, want.record_bytes)
    assert same(got.block_of, want.block_of)
    assert (got.n, got.n_blocks, got.size_bytes, got.min_key,
            got.max_key) == (want.n, want.n_blocks, want.size_bytes,
                             want.min_key, want.max_key)
    for k in list(keys[::37]) + [0, 49_999, int(keys[5]) + 1]:
        assert got.find(int(k)) == want.find(int(k))
    assert got.range_bounds(100, 20_000) == want.range_bounds(100, 20_000)
    assert list(got.block_iter(1000, 30_000)) == \
        list(want.block_iter(1000, 30_000))


@pytest.mark.parametrize("drop", [False, True])
def test_merge_runs_and_split(drop):
    """Runs with shared keys (newest seq wins) and tombstones, merged and
    cut into SSTables of the reference's sizes, block maps and bounds."""
    rng = np.random.default_rng(2 + drop)
    runs = [_run(rng, m, key_hi=3000) for m in (500, 800, 300)]
    want = jsst.merge_runs([(k.astype(np.uint64), s, v.astype(np.uint32))
                            for k, s, v in runs], drop_tombstones=drop)
    got = sstable.merge_runs([tuple(map(t64, r)) for r in runs],
                             drop_tombstones=drop)
    for g, w in zip(got, want):
        assert same(g, w)
    want_t = jsst.split_into_sstables(*want, "SD", 3, 9, 64 * 1024)
    got_t = sstable.split_into_sstables(*got, "SD", 3, 9, 64 * 1024)
    assert len(got_t) == len(want_t) > 3
    for g, w in zip(got_t, want_t):
        assert same(g.keys, w.keys) and same(g.seqs, w.seqs)
        assert same(g.vlens, w.vlens) and same(g.block_of, w.block_of)
        assert (g.n_blocks, g.size_bytes, g.min_key, g.max_key) == \
            (w.n_blocks, w.size_bytes, w.min_key, w.max_key)


def test_keys_above_int64_raise():
    """The port's keys are int64: MAX_KEY is 2**63 - 1, not 2**64 - 1,
    and a key above it (or below 0) raises instead of being stored."""
    assert scan.MAX_KEY == 2**63 - 1 and jscan.MAX_KEY == 2**64 - 1
    db = make_system("rocksdb_tiered", default_config("tiny"), device="cpu")
    db.put(scan.MAX_KEY, 10)
    assert db.get(scan.MAX_KEY) == (1, 10)
    for bad in (scan.MAX_KEY + 1, 2**64 - 1, -1):
        with pytest.raises(ValueError):
            db.put(bad, 10)
    with pytest.raises(ValueError):
        db.put_many(np.array([2**63], dtype=np.uint64), 10)
    with pytest.raises(ValueError):
        db.multi_get([2**64 - 1])


# ----------------------------------------------------------------------
# workloads
# ----------------------------------------------------------------------
def test_scramble():
    x = np.random.default_rng(3).integers(0, 1 << 40, 10_000)
    for n in (1, 7, 22_528, 720_896):
        assert same(twl._scramble(x, n), jwl._scramble(x, n))


@pytest.mark.parametrize("mix", list(jwl.MIXES))
@pytest.mark.parametrize("kind", ["hotspot", "zipfian", "uniform"])
def test_ycsb_arrays(mix, kind):
    want = jwl.ycsb(mix, jwl.KeyDist(kind, 22_528), 3000, 1000, seed=4)
    got = twl.ycsb(mix, twl.KeyDist(kind, 22_528), 3000, 1000, seed=4)
    assert same(got.ops, want.ops) and same(got.keys, want.keys)
    assert (got.scan_lens is None) == (want.scan_lens is None)
    if want.scan_lens is not None:
        assert same(got.scan_lens, want.scan_lens)


def test_other_generators():
    assert same(twl.load_keys(5000, 2), jwl.load_keys(5000, 2))
    g = twl.twitter_like_trace(4000, 3000, 0.8, 0.3, 0.5, 100, seed=5)
    w = jwl.twitter_like_trace(4000, 3000, 0.8, 0.3, 0.5, 100, seed=5)
    assert same(g.ops, w.ops) and same(g.keys, w.keys)
    for (gn, g), (wn, w) in zip(twl.dynamic_stages(4000, 500, 100, 6),
                                jwl.dynamic_stages(4000, 500, 100, 6)):
        assert gn == wn and same(g.keys, w.keys) and same(g.ops, w.ops)


# ----------------------------------------------------------------------
# RALT
# ----------------------------------------------------------------------
def _records(rng, n, key_hi, tick_hi):
    """RALT record arrays with repeated keys and far-apart ticks."""
    return (rng.integers(0, key_hi, n), rng.integers(1, 2000, n),
            rng.integers(0, tick_hi, n), rng.random(n) * 3,
            rng.choice([0.0, 1.3, 2.6, 5.0], n), rng.integers(0, 2, n),
            rng.integers(0, 40, n))


def _as_ref(p):
    k, v, t, s, c, g, e = p
    return (k.astype(np.uint64), v.astype(np.uint32), t.astype(np.int64),
            s, c, g.astype(np.int8), e.astype(np.int64))


def _as_port(p):
    """A record part of the port: (ints (5, n), floats (2, n))."""
    k, v, t, s, c, g, e = p
    return t64(np.stack([k, v, t, g, e])), torch.from_numpy(np.stack([s, c]))


def _unpacked(ints, floats):
    """The port's merged part in the reference's column order."""
    return (ints[ralt.KEY], ints[ralt.VLEN], ints[ralt.TICK],
            floats[ralt.SCORE], floats[ralt.CNT], ints[ralt.TAG],
            ints[ralt.EPOCH])


@pytest.mark.parametrize("tick_hi", [5, 40_000, 1_500_000])
def test_merge_records(tick_hi):
    """Groups of up to dozens of members, decays over exponents up to
    1.5 M (where torch.pow and exp/log miss np.power's last bit)."""
    rng = np.random.default_rng(tick_hi)
    parts = [_records(rng, n, 300, tick_hi) for n in (2000, 1500, 40)]
    now = tick_hi
    want = jralt._merge_records([_as_ref(p) for p in parts], 0.999, 41, 5.0)
    got = _unpacked(*ralt._merge_records([_as_port(p) for p in parts],
                                         0.999, 41, 5.0, now))
    assert max(np.bincount(np.concatenate([p[0] for p in parts]))) > 20
    for g, w in zip(got, want):
        assert same(g, w)


def test_decay_table_is_np_power():
    dt = np.random.default_rng(7).integers(0, 2_000_000, 50_000)
    got = ralt.decay(0.999, t64(dt), 2_000_000)
    assert same(got, np.power(0.999, dt))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_threshold(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(30, 3000, 5000)
    scores = rng.random(5000) * 4
    want = jralt.RALT.sample_threshold(sizes, scores, 0.9, 256,
                                       np.random.default_rng(seed))
    got, = ralt.RALT.sample_thresholds(
        t64(sizes)[None], torch.ones(len(sizes), dtype=torch.bool),
        torch.from_numpy(scores), 0.9, 256, np.random.default_rng(seed))
    assert got == want and isinstance(got, float)


class _EdgeRng:
    """A Generator whose draws include the top of their range: the
    clamp to the last record kept is taken."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def uniform(self, low, high, size):
        out = self.rng.uniform(low, high, size)
        out[::7] = high
        return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("edge", [False, True])
def test_sample_thresholds_of_kept_records(seed, edge):
    """Both thresholds of an eviction from the masked rows equal the
    reference's, each drawn from the kept records alone, in order."""
    rng = np.random.default_rng(seed)
    n = 5000
    psizes = np.full(n, 40)
    hsizes = rng.integers(30, 3000, n)
    scores = rng.random(n) * 4
    keep = rng.random(n) < 0.6
    keep[-50:] = False
    draw = _EdgeRng if edge else np.random.default_rng
    r = draw(seed)
    want = [jralt.RALT.sample_threshold(sz[keep], scores[keep], 0.9, 256, r)
            for sz in (psizes, hsizes)]
    got = ralt.RALT.sample_thresholds(
        torch.stack([t64(psizes), t64(hsizes)]), torch.from_numpy(keep),
        torch.from_numpy(scores), 0.9, 256, draw(seed))
    assert got == want
    none = ralt.RALT.sample_thresholds(
        torch.stack([t64(psizes), t64(hsizes)]),
        torch.zeros(n, dtype=torch.bool), torch.from_numpy(scores), 0.9,
        256, draw(seed))
    assert none == [0.0, 0.0]


def _fed_ralts(n_batches=40):
    """The reference's RALT and the port's, fed the same accesses (point
    batches, scans and single accesses) until several evictions ran."""
    fd = 2 * 1024 * 1024
    cfg = dict(fd_size=fd, hot_set_limit=int(0.5 * fd),
               phys_limit=int(0.15 * fd), buffer_bytes=32 * 1024)
    want = jralt.RALT(jralt.RaltConfig(**cfg), JStorageSim())
    got = ralt.RALT(ralt.RaltConfig(**cfg), StorageSim(), CPU)
    rng = np.random.default_rng(8)
    hot = rng.integers(0, 20_000, 400)
    for b in range(n_batches):
        keys = np.where(rng.random(500) < 0.9, rng.choice(hot, 500),
                        rng.integers(0, 20_000, 500))
        vlens = rng.integers(100, 1500, 500)
        want.record_access_many(keys.astype(np.uint64),
                                vlens.astype(np.uint32))
        got.record_access_many(keys, vlens)
        lo = int(rng.integers(0, 19_000))
        sk = np.arange(lo, lo + 60)
        want.record_range_access(lo, lo + 59, sk.astype(np.uint64),
                                 np.full(60, 700, np.uint32))
        got.record_range_access(lo, lo + 59, sk, np.full(60, 700))
        k = int(rng.choice(hot))
        want.record_access(k, 333)
        got.record_access(k, 333)
    return want, got


def test_ralt_evictions_and_queries():
    want, got = _fed_ralts()
    assert want.n_evictions >= 3 and got.n_evictions == want.n_evictions
    for attr in ("tick", "epoch", "hot_threshold", "hot_set_limit",
                 "phys_limit", "hot_set_bytes", "phys_bytes",
                 "_accessed_since_tick", "_accessed_since_epoch"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert len(got.runs) == len(want.runs)
    for g, w in zip(got.runs, want.runs):
        for name in ("keys", "vlens", "ticks", "scores", "cnts", "tags",
                     "epochs", "hot_mask", "block_first_key",
                     "block_cum_hot"):
            assert same(getattr(g, name), getattr(w, name)), name
        assert same(g.bloom.bits, unpacked_bits(w.bloom.bits)[:g.bloom.nbits])
    assert got.memory_usage_bytes() == want.memory_usage_bytes()
    assert got.storage.snapshot() == want.storage.snapshot()
    probe = np.random.default_rng(9).integers(0, 21_000, 5000)
    assert same(got.is_hot_many(probe),
                want.is_hot_many(probe.astype(np.uint64)))
    los = np.random.default_rng(10).integers(-10, 21_000, 300)
    his = los + np.random.default_rng(11).integers(0, 3000, 300)
    assert got.range_hot_bytes_many(los.tolist(), his.tolist()) == \
        [want.range_hot_bytes(int(a), int(b)) for a, b in zip(los, his)]
    gk, gv = got.scan_hot(2000, 9000)
    wk, wv = want.scan_hot(2000, 9000)
    assert same(gk, wk) and same(gv, wv)
    assert got.storage.snapshot() == want.storage.snapshot()


# ----------------------------------------------------------------------
# GroupViews and scans
# ----------------------------------------------------------------------
def test_group_views_and_merge_scan():
    """A loaded tiny DB with updates and deletes in memtables and L0: the
    FD and SD views' arrays, and scans through `merge_scan`."""
    cfg = dataclasses.replace(jdefault_config("tiny"), sd_size=6 << 20)
    n = jdb_key_count(cfg, 1000)
    want = jmake_system("hotrap", cfg)
    got = make_system("hotrap", dataclasses.replace(
        default_config("tiny"), sd_size=6 << 20), device="cpu")
    rng = np.random.default_rng(12)
    for k in jwl.load_keys(n, 0).tolist():
        want.put(k, 1000)
        got.put(k, 1000)
    for k in rng.integers(0, n, 400).tolist():
        want.delete(k)
        got.delete(k)
    for k in rng.integers(0, n, 300).tolist():
        want.put(k, 200)
        got.put(k, 200)
    for group in ("FD", "SD"):
        w = want.group_view(want.version, group)
        g = got.group_view(got.version, group)
        assert g.n > 0 and g.n_source_records == w.n_source_records
        for name in ("keys", "seqs", "vlens", "src", "blks", "sst_mins",
                     "sst_maxs", "sst_pris"):
            assert same(getattr(g, name), getattr(w, name)), name
        for k in rng.integers(0, n, 50).tolist():
            assert g.point_find(k) == w.point_find(k)
            hit = w.point_find(k)
            si = hit[2] if hit else None
            assert g.probes_replaced(k, si) == w.probes_replaced(k, si)
    for lo, cnt in zip(rng.integers(0, n, 40).tolist(),
                       rng.integers(1, 300, 40).tolist()):
        assert got.scan(lo, cnt) == want.scan(lo, cnt)
    assert got.scan_range(100, 2000) == want.scan_range(100, 2000)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.storage.snapshot() == want.storage.snapshot()
    # the sources alone, merged without the engine's bookkeeping
    gc, wc = scan.MergeCounters(), jscan.MergeCounters()
    gsrc = scan.build_sources(got, got.version, 500, 4000,
                              lambda s, b: None)
    wsrc = jscan.build_sources(want, want.version, 500, 4000,
                               lambda s, b: None)
    assert [r[:4] for r in scan.merge_scan(gsrc.sources, gc)] == \
        [r[:4] for r in jscan.merge_scan(wsrc.sources, wc)]
    assert (gc.pulls, gc.compares) == (wc.pulls, wc.compares)


def test_lsm_config_and_stats_are_the_references():
    from repro.core import lsm as jlsm
    assert [f.name for f in dataclasses.fields(lsm.LSMConfig)] == \
        [f.name for f in dataclasses.fields(jlsm.LSMConfig)]
    assert dataclasses.asdict(lsm.LSMConfig()) == \
        dataclasses.asdict(jlsm.LSMConfig())
    assert dataclasses.asdict(lsm.Stats()) == dataclasses.asdict(jlsm.Stats())
    assert dataclasses.asdict(ralt.RaltConfig(1, 2, 3)) == \
        dataclasses.asdict(jralt.RaltConfig(1, 2, 3))


# (cache blocks, accesses, blocks after the warm-up: a shrunk cache
# evicts several on its first miss)
@pytest.mark.parametrize("blocks,n,shrink", [
    (0, 50, None), (4, 0, None), (4, 300, None), (64, 300, None),
    (3, 300, None), (8, 300, 2)])
def test_block_cache_access_many_is_access_in_a_loop(blocks, n, shrink):
    """`access_many` against `access` in a loop: equal hit flags, counts
    and LRU order, from a warmed cache."""
    rng = np.random.default_rng(blocks * 1000 + n)
    sids, blks = rng.integers(0, 6, n), rng.integers(0, 5, n)
    want, got = BlockCache(blocks * 16384, 16384), BlockCache(
        blocks * 16384, 16384)
    for cache in (want, got):
        for key in [(9, 0), (9, 1), (2, 3), (9, 0), (4, 4)]:
            cache.access(key)
        if shrink is not None:
            cache.capacity = shrink * 16384
    flags = [want.access(k) for k in zip(sids.tolist(), blks.tolist())]
    hit = got.access_many(sids, blks)
    assert hit.dtype == bool and hit.tolist() == flags
    assert (got.hits, got.misses) == (want.hits, want.misses)
    assert list(got._od) == list(want._od)
    if blocks and n:
        assert 0 < got.hits and len(got._od) <= (shrink or blocks)


@pytest.mark.parametrize("fg", [True, False])
@pytest.mark.parametrize("n,sd_share", [(0, 0.5), (1, 1.0), (400, 0.0),
                                        (400, 0.3), (400, 1.0)])
def test_rand_read_many_is_rand_read_in_a_loop(fg, n, sd_share):
    """`rand_read_many` against repeated `rand_read` after unrelated
    charges: each row of running times, every counter, the component's
    totals (created only by a charge) and the wall, floats bit for
    bit."""
    rng = np.random.default_rng(n)
    is_sd = rng.random(n) < sd_share
    want, got = StorageSim(), StorageSim()
    for sim in (want, got):
        sim.seq_write("FD", 12345, fg=False, component="compaction")
        sim.rand_read("SD", 4096, fg=True, component="get")
        sim.seq_read("SD", 777777, fg=False, component="compaction")
    field = "fg_time" if fg else "bg_time"
    rows = [[getattr(want.dev[t], field) for t in ("FD", "SD")]]
    for sd in is_sd.tolist():
        want.rand_read("SD" if sd else "FD", 16384, fg=fg,
                       component="promotion")
        rows.append([getattr(want.dev[t], field) for t in ("FD", "SD")])
    got_rows = got.rand_read_many(is_sd, 16384, fg=fg,
                                  component="promotion")
    assert got_rows.shape == (n + 1, 2)
    assert got_rows.tobytes() == np.array(rows).tobytes()
    assert got.snapshot() == want.snapshot()
    assert got.sim_time == want.sim_time
    assert all(type(v) is float for d in got.dev.values()
               for v in (d.fg_time, d.bg_time))
