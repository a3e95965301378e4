"""The port's observability plane (`repro_torch.obs`: `Tracer`,
`MetricsRegistry`, `AttributionSampler`, `Observability`) against the
reference's (`repro.obs`), on the CPU: the tests of `tests/test_obs.py`,
each run on both packages with one op stream.  A run's trace events
(`tracer.to_dict()`: names, phases, pid/tid tracks, args and
timestamps), its metrics (`metrics.to_json()`) and its attribution
(`attr.summary()`, `RunResult.attribution`) equal the reference's, floats
bit for bit.  The plane is read-only: an attached run's results and
engine state equal the unattached run's.  The reference's wall-clock
overhead asserts are held structurally here (a disabled plane reaches no
tracer, metrics or sampler call); `chip_smoke.py` reports the overhead
on the card."""
import json

import numpy as np
import pytest
import torch

from repro.core import LSMConfig as JLSMConfig
from repro.core import ShardConfig as JShardConfig
from repro.core import crashpoints as jcrash
from repro.core import make_sharded_system as jmake_sharded
from repro.core import make_system as jmake_system
from repro.core import runner as jrunner
from repro.data import workloads as jwl
from repro.obs import Observability as JObservability
from repro.obs import Tracer as JTracer
from repro.obs import metrics as jmetrics
from repro_torch.core import (LSMConfig, ShardConfig, crashpoints,
                              make_sharded_system, make_system, runner)
from repro_torch.data import workloads as twl
from repro_torch.obs import (NULL_OBS, Observability, Series, Tracer,
                             jsonify, metrics)
from repro_torch.obs.attribution import TIER_NAMES
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


def cluster_cfg(cls=LSMConfig, **kw):
    base = dict(fd_size=512 * KIB, sd_size=4 * MIB,
                target_sstable_bytes=32 * KIB, memtable_bytes=16 * KIB,
                block_cache_bytes=16 * KIB, checker_delay_ops=16,
                hotrap=True)
    base.update(kw)
    return cls(**base)


def repart_scfg(cls=ShardConfig, **kw):
    base = dict(n_shards=4, partitioning="range", key_space=KEYSPACE,
                repartition=True, repartition_interval_ops=10 ** 9,
                migration_records_per_op=64, memtable_floor=8 * KIB,
                block_cache_floor=8 * KIB)
    base.update(kw)
    return cls(**base)


# the two packages side by side: (reference, port)
PKGS = (
    dict(cfg=lambda **kw: cluster_cfg(JLSMConfig, **kw),
         scfg=lambda **kw: repart_scfg(JShardConfig, **kw),
         make=jmake_system, sharded=jmake_sharded, obs=JObservability,
         runner=jrunner, wl=jwl, crash=jcrash, dev={}),
    dict(cfg=cluster_cfg, scfg=repart_scfg, make=make_system,
         sharded=make_sharded_system, obs=Observability, runner=runner,
         wl=twl, crash=crashpoints, dev={"device": "cpu"}))


def obs_docs(obs) -> dict:
    """Everything the plane recorded, as JSON-like trees."""
    return {"trace": obs.tracer.to_dict(),
            "metrics": jsonify(obs.metrics.to_json()),
            "attribution": jsonify(obs.attr.summary())}


def assert_same_plane(want, got) -> None:
    assert cs.json_mismatches(obs_docs(want), obs_docs(got)) == []
    assert got.tracer.dropped == want.tracer.dropped
    assert got.tracer.validate() == want.tracer.validate() == []
    json.dumps(got.tracer.to_dict())          # host values only


def traced_split_merge_run(p, obs=None):
    """`tests/test_obs.py`'s cluster driven through one forced split and
    one forced merge with live traffic interleaved; (db, obs, results)."""
    obs = obs or p["obs"]()
    db = p["sharded"]("hotrap", p["cfg"](), shard_cfg=p["scfg"](), **p["dev"])
    if obs is not False:
        obs.attach(db, name="t")
    rng = np.random.default_rng(3)
    rep = db.repartitioner
    out = []

    def trade(n):
        for _ in range(n):
            k = int(rng.integers(0, KEYSPACE))
            r = rng.random()
            if r < 0.5:
                out.append(db.put(k, 120))
            elif r < 0.8:
                out.append(db.get(k))
            else:
                out.append(db.scan(int(rng.integers(0, KEYSPACE)), 20))

    trade(1500)
    assert rep.force_split(0)
    trade(400)
    rep.drain()
    trade(200)
    assert rep.force_merge(len(db.shards) - 2)
    rep.drain()
    trade(200)
    return db, obs, out


def loaded(p, system="hotrap", n=400, obs=None, name="a", **cfg_kw):
    db = p["make"](system, p["cfg"](**cfg_kw), seed=0, **p["dev"])
    if obs is not None:
        obs.attach(db, name=name)
    p["runner"].load_db(db, n, 120, 0)
    return db


def run_ycsb(p, db, mix="RW", n_keys=400, n_ops=3000, **kw):
    wl = p["wl"].ycsb(mix, p["wl"].KeyDist("zipfian", n_keys), n_ops, 120,
                      seed=2)
    outs: list = []
    res = p["runner"].run_workload(db, wl, name="x", results_out=outs, **kw)
    return res, outs


# ----------------------------------------------------------------------
# histograms and series: the reference's numbers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["latency", "tier"])
def test_histograms_equal_reference(kind):
    rng = np.random.default_rng(0)
    fd = np.exp(rng.normal(np.log(2e-5), 1.0, 5000))
    sd = np.exp(rng.normal(np.log(2e-4), 1.2, 5000))
    sd[rng.random(5000) < 0.7] = 0.0
    docs = []
    for mod in (jmetrics, metrics):
        if kind == "latency":
            h = mod.LatencyHistogram()
            for x in fd[:300]:
                h.add(float(x))
            h.add_many(fd[300:])
            qs = [h.percentile(q) for q in (0.5, 0.9, 0.99, 0.999)]
        else:
            h = mod.TierLatencyHistogram()
            for i in range(300):
                h.add(float(fd[i]), float(sd[i]))
            h.add_many(fd[300:], sd[300:])
            qs = [h.percentile(q, a, b) for q in (0.5, 0.99)
                  for a, b in ((1.0, 1.0), (1.8, 3.5))]
        docs.append({"json": h.to_json(), "q": qs, "count": h.count})
    assert cs.json_mismatches(*docs) == []


def test_series_ring_buffer_wraps():
    s = Series("x", capacity=8)
    for i in range(20):
        s.append(float(i), float(i * 10))
    assert len(s) == 8
    t, v = s.values()
    assert list(t) == [float(i) for i in range(12, 20)]
    assert s.last() == 190.0


# ----------------------------------------------------------------------
# tracer: span discipline + export schema on a real split+merge
# ----------------------------------------------------------------------
def test_trace_spans_nest_across_split_and_merge(tmp_path):
    (jdb, want, jout), (db, got, out) = (traced_split_merge_run(p)
                                         for p in PKGS)
    assert out == jout
    assert_same_plane(want, got)
    tr = got.tracer
    names = tr.names()
    for required in ("repartition/split", "repartition/merge", "migration",
                     "cutover_stall", "flush", "compaction"):
        assert required in names, f"missing {required}"
    assert tr.count("migration", "B") == tr.count("migration", "E") == 2
    assert tr.count("cutover_stall", "B") == tr.count("cutover_stall", "E")
    paths = tmp_path / "want.json", tmp_path / "got.json"
    want.tracer.export(str(paths[0]))
    tr.export(str(paths[1]))
    doc = json.loads(paths[1].read_text())
    assert doc == json.loads(paths[0].read_text())
    assert doc["otherData"]["dropped_events"] == 0
    assert any(e["ph"] == "M" and e["name"] == "process_name"
               for e in doc["traceEvents"])


def test_trace_validate_catches_broken_stacks():
    problems = []
    for cls in (JTracer, Tracer):
        tr = cls(clock=lambda: 1.0)
        tr.begin("a", "outer")
        tr.begin("a", "inner")
        tr.end("a")
        first = tr.validate()
        tr.end("a")
        second = tr.validate()
        tr.end("a")                          # E with no open B
        problems.append((first, second, tr.validate(), tr.to_dict()))
    assert problems[1][0] == ["unclosed span 'outer' on 'a'"]
    assert problems[1][1] == []
    assert any("no open span" in p for p in problems[1][2])
    assert problems[0] == problems[1]


def test_tracer_bounded_drops_not_grows():
    tr = Tracer(clock=lambda: 0.0, max_events=10)
    for i in range(25):
        tr.instant("t", f"e{i}")
    assert len(tr.events) == 10
    assert tr.dropped == 15
    assert tr.to_dict()["otherData"]["dropped_events"] == 15


def test_tracer_timestamps_clamp_monotone():
    """A clock that steps back (a `reset_storage` mid-attachment) never
    yields a timestamp below the last one, as in the reference."""
    docs = []
    for cls in (JTracer, Tracer):
        ts = iter([1e-3, 2e-3, 5e-4, 3e-3])
        tr = cls(clock=lambda: next(ts))
        with tr.span("x", "outer", {"a": 1}):
            tr.instant("x", "mid")
        tr.counter("x", "c", {"v": 1.5})
        docs.append(tr.to_dict())
    assert docs[0] == docs[1]
    assert [e["ts"] for e in docs[1]["traceEvents"][2:]] == [
        1e3, 2e3, 2e3, 3e3]


# ----------------------------------------------------------------------
# disabled mode: nothing recorded, no plane call reached
# ----------------------------------------------------------------------
class Spy:
    """Stands in for a tracer, metrics registry or sampler and records
    every call that reaches it."""

    def __init__(self, calls: list):
        self._calls = calls

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *a, **kw: self._calls.append(name)


def test_disabled_obs_records_nothing():
    p = PKGS[1]
    db = loaded(p, n=300)
    assert db._obs is NULL_OBS
    res, _ = run_ycsb(p, db, n_keys=300, n_ops=1500)
    assert NULL_OBS.tracer.events == []
    assert NULL_OBS.metrics.n_samples == 0
    assert NULL_OBS.attr.n_seen == 0
    assert res.attribution is None
    assert res.latency.count > 0            # histograms are runner-owned


@pytest.mark.parametrize("target", ["engine", "cluster"])
def test_disabled_plane_reaches_no_call(target):
    """An attached but disabled plane: every instrumentation site stops
    at its `enabled` check, so no tracer, metrics or attribution method
    runs, and the run equals an unattached one."""
    p = PKGS[1]
    calls: list = []
    off = Observability(enabled=False)
    off.tracer = off.metrics = off.attr = Spy(calls)

    def build():
        if target == "engine":
            return loaded(p)
        db = p["sharded"]("hotrap", p["cfg"](wal=True),
                          shard_cfg=p["scfg"](), **p["dev"])
        p["runner"].load_db(db, 400, 120, 0)
        return db

    base, spied = build(), build()
    off.attach(spied, name="off")
    if target == "cluster":
        for db in (base, spied):
            assert db.repartitioner.force_split(0)
    r0, o0 = run_ycsb(p, base)
    r1, o1 = run_ycsb(p, spied)
    if target == "cluster":
        for db in (base, spied):
            db.repartitioner.drain()
    assert calls == []
    assert o1 == o0
    assert cs.json_mismatches(r0.to_json(), r1.to_json()) == []
    assert cs.json_mismatches(cs.engine_digest(base),
                              cs.engine_digest(spied)) == []


# ----------------------------------------------------------------------
# read-only: attached and unattached runs leave equal state
# ----------------------------------------------------------------------
@pytest.mark.parametrize("system", ["hotrap", "sas_cache", "prismdb"])
def test_attached_engine_equals_unattached(system):
    p = PKGS[1]
    base = loaded(p, system)
    obs = Observability(metrics_interval_s=1e-5)
    attached = loaded(p, system, obs=obs)
    r0, o0 = run_ycsb(p, base)
    r1, o1 = run_ycsb(p, attached)
    assert o1 == o0
    doc0, doc1 = r0.to_json(), r1.to_json()
    assert doc0.pop("attribution") is None and doc1.pop("attribution")
    assert cs.json_mismatches(doc0, doc1) == []
    assert cs.json_mismatches(cs.engine_digest(base),
                              cs.engine_digest(attached)) == []
    assert obs.tracer.events and obs.metrics.n_samples > 0


def test_attached_cluster_equals_unattached():
    (db0, _, out0), (db1, obs, out1) = (
        traced_split_merge_run(PKGS[1], obs=False),
        traced_split_merge_run(PKGS[1]))
    assert out1 == out0
    assert cs.json_mismatches(cs.engine_digest(db0),
                              cs.engine_digest(db1)) == []
    assert obs.tracer.count("migration", "B") == 2


# ----------------------------------------------------------------------
# metrics registry: cadence + bounded series
# ----------------------------------------------------------------------
def test_metrics_sampled_on_cadence_and_bounded():
    planes = []
    for p in PKGS:
        obs = p["obs"](metrics_interval_s=1e-5)
        db = loaded(p, obs=obs, name="m")
        run_ycsb(p, db)
        planes.append(obs)
    assert_same_plane(*planes)
    m = planes[1].metrics
    assert m.n_samples > 2
    t, v = m.series["fd_hit_rate"].values()
    assert len(t) == len(v) > 0
    assert all(0.0 <= x <= 1.0 for x in v)
    assert np.all(np.diff(t) >= 0)
    for s in m.series.values():
        assert len(s) <= 4096
    doc = jsonify(m.to_json())
    json.dumps(doc)
    assert set(doc["series"]) == set(m.SERIES)


# ----------------------------------------------------------------------
# cutover stall: measured, surfaced, bounded
# ----------------------------------------------------------------------
def test_cutover_stall_recorded_and_small():
    (jdb, _, _), (db, _, _) = (traced_split_merge_run(p) for p in PKGS)
    rep = db.repartitioner
    assert len(rep.cutover_stalls) == 2
    assert len(rep.cutover_busy) == 2
    snap = rep.snapshot()
    assert cs.json_mismatches(jdb.repartitioner.snapshot(), snap) == []
    assert snap["max_cutover_stall_fg_us"] == pytest.approx(
        max(rep.cutover_stalls) * 1e6)
    assert len(snap["cutover_stalls_fg_us"]) == 2
    assert snap["max_cutover_stall_fg_us"] == 0.0
    assert snap["max_cutover_busy_us"] >= 0.0


# ----------------------------------------------------------------------
# attribution: engine half + runner half meet in RunResult
# ----------------------------------------------------------------------
@pytest.mark.parametrize("system", ["hotrap", "mutant", "sas_cache",
                                    "prismdb"])
def test_attribution_table_populated(system):
    """The stock engine's batched records (`stash_record`) and the
    compared systems' per-key fallback (`stash_pending`) give the
    reference's table."""
    runs = []
    for p in PKGS:
        obs = p["obs"]()
        db = loaded(p, system, obs=obs)
        res, outs = run_ycsb(p, db)
        runs.append((obs, res, outs))
    (want, wres, wout), (got, res, outs) = runs
    assert outs == wout
    assert_same_plane(want, got)
    att = res.attribution
    assert cs.json_mismatches(wres.attribution, att) == []
    assert att is not None and att["n_sampled"] > 0
    assert att["rows"], att
    assert {r["tier"] for r in att["rows"]} <= set(TIER_NAMES)
    assert sum(r["count"] for r in att["rows"]) == att["n_tail"]
    text = got.attr.format_table(0.99, title="t")
    assert text == want.attr.format_table(0.99, title="t")
    assert "attribution" in text and "tier" in text
    json.dumps(jsonify(att))


def test_attribution_reservoir_is_bounded():
    planes = []
    for p in PKGS:
        obs = p["obs"](attr_capacity=64)
        db = loaded(p, obs=obs)
        run_ycsb(p, db, mix="RO", n_ops=2000)
        planes.append(obs)
    assert_same_plane(*planes)
    assert planes[1].attr.n_seen > 64
    assert planes[1].attr.n_kept == 64


# ----------------------------------------------------------------------
# RunResult.to_json: the BENCH_*.json schema
# ----------------------------------------------------------------------
def test_runresult_to_json_schema_and_quantiles():
    docs = [p["runner"].bench_system("hotrap", "RW",
                                     p["wl"].KeyDist("zipfian", 500), 3000,
                                     120, cfg=p["cfg"](), **p["dev"])
            for p in PKGS]
    res = docs[1]
    doc = res.to_json()
    assert cs.json_mismatches(docs[0].to_json(), doc) == []
    json.dumps(doc)
    assert doc["schema"] == runner.BENCH_SCHEMA
    lat = doc["latency"]
    assert lat["hist"]["count"] == res.latency.count > 0
    assert lat["p50"] <= lat["p99"] <= lat["p999"]
    total = sum(c for _, _, c in lat["hist"]["nonzero_cells"])
    assert total == res.latency.count


def test_promotion_pathway_instants_emitted():
    """All three HotRAP promotion pathways leave the reference's
    instants."""
    planes = []
    for p in PKGS:
        obs = p["obs"]()
        cfg = p["cfg"](fd_size=256 * KIB)
        db = p["make"]("hotrap", cfg, seed=0, **p["dev"])
        obs.attach(db, name="p")
        nk = p["runner"].db_key_count(cfg, 120)
        p["runner"].load_db(db, nk, 120, 0)
        rng = np.random.default_rng(5)
        hot = rng.choice(nk, size=max(nk // 20, 16), replace=False)
        for _ in range(6):
            for k in hot:
                db.get(int(k))
            for _ in range(4):
                db.scan(int(nk // 3), 32)
            for k in rng.integers(0, nk, 200):
                db.put(int(k), 120)
        db.flush_all()
        planes.append(obs)
    assert_same_plane(*planes)
    names = planes[1].tracer.names()
    for pathway in ("promo/get", "promo/scan", "promo/retained"):
        assert pathway in names, f"missing {pathway} in {sorted(names)}"


def test_sanitized_cluster_trace_carries_verdicts():
    """`attach` unwraps a `SanitizedDB`; the sanitizer's sweeps land on
    the `<name>/sanitizer` lane as in the reference."""
    planes = []
    for p in PKGS:
        obs = p["obs"]()
        db = p["sharded"]("hotrap", p["cfg"](), shard_cfg=p["scfg"](),
                          sanitize=True, **p["dev"])
        obs.attach(db, name="s")
        rng = np.random.default_rng(6)
        for k in rng.integers(0, KEYSPACE, 1200):
            db.put(int(k), 120)
            db.get(int(k))
        assert db.repartitioner.force_split(0)
        for k in rng.integers(0, KEYSPACE, 600):
            db.put(int(k), 120)
        db.close()
        planes.append(obs)
    assert_same_plane(*planes)
    tr = planes[1].tracer
    assert tr.count("sanitize_ok") > 0
    assert any(e["track"] == "s/sanitizer" for e in tr.events)


# ----------------------------------------------------------------------
# durability: WAL spans, crash instants, recovery trace
# ----------------------------------------------------------------------
def test_recovery_trace_schema():
    """A crashed-and-recovered cluster leaves the reference's durability
    trace: `wal/append` + `wal/group_commit` spans, a `crash_injected`
    instant naming the site, a `recovery` span with the replay counters,
    and a stack-balanced event stream."""
    planes, recs = [], []
    for p in PKGS:
        obs = p["obs"]()
        db = p["sharded"]("hotrap", p["cfg"](wal=True),
                          shard_cfg=p["scfg"](), **p["dev"])
        obs.attach(db, name="t")
        rng = np.random.default_rng(4)

        def drive(d, rng=rng):
            for _ in range(60):
                ks = rng.integers(0, KEYSPACE, 64)
                d.put_many(ks, np.full(64, 120, dtype=np.uint32))
                for k in rng.integers(0, KEYSPACE, 24):
                    d.get(int(k))
            assert d.repartitioner.force_split(0)
            for _ in range(80):
                ks = rng.integers(0, KEYSPACE, 64)
                d.put_many(ks, np.full(64, 120, dtype=np.uint32))

        crashed, rec = p["crash"].crash_recover(
            db, drive, "mid-migration-stream", obs=obs)
        assert crashed
        seq = rec.put(1, 120)
        assert rec.get(1) == (seq, 120)
        planes.append(obs)
        recs.append(rec)
    assert_same_plane(*planes)
    tr = planes[1].tracer
    for required in ("wal/append", "wal/group_commit",
                     "crash_injected", "recovery"):
        assert required in tr.names()
    crash_evs = [e for e in tr.events if e["name"] == "crash_injected"]
    assert len(crash_evs) == 1
    assert crash_evs[0]["args"]["site"] == "mid-migration-stream"
    rec_e = [e for e in tr.events
             if e["name"] == "recovery" and e["ph"] == "E"]
    assert len(rec_e) == 1
    assert rec_e[0]["args"]["n_shards"] == len(recs[1].shards)
    assert rec_e[0]["args"]["horizon"] == max(sh.durability.horizon()
                                              for sh in recs[1].shards)


@pytest.mark.parametrize("site", ["mid-flush", "mid-compaction"])
def test_engine_crash_trace_equals_reference(site):
    """One engine with the WAL crashed at `site` and recovered on the
    same plane: the trace equals the reference's."""
    planes = []
    for p in PKGS:
        obs = p["obs"]()
        db = p["make"]("hotrap", p["cfg"](wal=True), seed=0, **p["dev"])
        obs.attach(db, name="e")
        rng = np.random.default_rng(9)

        def drive(d, rng=rng):
            for k in rng.integers(0, KEYSPACE, 6000):
                d.put(int(k), 120)

        crashed, rec = p["crash"].crash_recover(db, drive, site, obs=obs)
        assert crashed
        for k in range(0, KEYSPACE, 7):
            rec.get(k)
        planes.append(obs)
    assert_same_plane(*planes)
    assert planes[1].tracer.count("crash_injected") == 1


def test_disabled_obs_crash_recovery_records_nothing():
    p = PKGS[1]
    db = p["sharded"]("hotrap", p["cfg"](wal=True), shard_cfg=p["scfg"](),
                      **p["dev"])
    rng = np.random.default_rng(4)

    def drive(d):
        for k in rng.integers(0, KEYSPACE, 4000):
            d.put(int(k), 120)

    crashed, rec = crashpoints.crash_recover(db, drive, "mid-flush")
    assert crashed
    assert NULL_OBS.tracer.events == []
    assert rec._obs is NULL_OBS
