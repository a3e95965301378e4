"""The wall-clock mode of the port's observability plane
(`Observability(clock="wall")`), on the CPU: the engine's wall-only
spans and counters are recorded and balanced, an attached plane leaves
the answers and the engine's state those of an unattached run, the
simulated-clock parts of the plane stay off, `detach` restores the null
plane, `Tracer.self_times` subtracts the children, and
`launch/profile_lsm.py` splits a run and the card's idle time by span.
The simulated clock's traces are held to the JAX reference in
`test_torch_obs.py`."""
import dataclasses
import importlib.util
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (ShardConfig, make_sharded_system, make_system,
                              runner)
from repro_torch.core.storage import BlockCache
from repro_torch.data import workloads as twl
from repro_torch.obs import NULL_OBS, Observability, Tracer

VALUE = 1000
# the spans and counters of `multi_get` and RALT, and the inline
# background work a read round fires
READ_SPANS = ("get", "get/mem", "get/fd", "get/pc", "get/sd", "get/commit",
              "get/answer", "checker", "compaction", "ralt/record",
              "ralt/flush", "ralt/evict", "ralt/query")
COUNTERS = ("level_index/build", "ralt_index/build")
# ... and those of `put_many` with a WAL
WRITE_SPANS = ("put", "wal/append", "flush")


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


def loaded(mix: str):
    """A tiny HotRAP engine, loaded (with a WAL under writes)."""
    cfg = dataclasses.replace(runner.default_config("tiny"),
                              wal=mix == "RW")
    n = runner.db_key_count(cfg, VALUE)
    db = make_system("hotrap", cfg, seed=0, device="cpu")
    if mix == "RW":
        runner.load_db(db, n, VALUE)
    else:
        db.put_many(runner.load_keys(n, 0), VALUE)
    db.flush_all()
    return db, n


def drive(db, mix: str, n: int) -> list:
    wl = twl.ycsb(mix, twl.KeyDist("hotspot", n), 20000, VALUE, seed=2)
    out: list = []
    runner.run_workload(db, wl, name="w", results_out=out)
    return out


@pytest.mark.parametrize("mix", ["RO", "RW"])
def test_wall_plane_records_engine_spans_and_changes_nothing(mix):
    base, n = loaded(mix)
    db = pickle.loads(pickle.dumps(base))
    obs = Observability(clock="wall").attach(db, name="w")
    assert db.ralt._obs is obs and db.ralt._obs_track == "w"
    got = drive(db, mix, n)
    want = drive(base, mix, n)
    assert got == want
    assert cs.json_mismatches(cs.engine_digest(base),
                              cs.engine_digest(db)) == []
    tr = obs.tracer
    assert tr.validate() == [] and tr.dropped == 0
    spans = READ_SPANS + (WRITE_SPANS if mix == "RW" else ())
    assert {n for n in spans if tr.count(n, "B") == 0} == set()
    assert all(tr.count(n, "i") > 0 for n in COUNTERS)
    assert {ev["track"] for ev in tr.events} == {"w"}
    # the simulated clock's parts are off, and so are the instants whose
    # arguments copy RALT's answers to the host
    assert tr.count("promo/get") == 0
    assert obs.metrics.n_samples == 0 and obs.attr.n_seen == 0
    # wall seconds: every span's self time within its total
    st = tr.self_times()
    assert set(spans) <= set(st)
    for row in st.values():
        assert 0.0 <= row["self_s"] <= row["total_s"] + 1e-9
    obs.detach(db)
    assert db._obs is NULL_OBS and db.ralt._obs is NULL_OBS
    assert "_obs" not in db.__dict__ and "_obs" not in db.ralt.__dict__


def test_commit_span_counts_the_block_cache_accesses():
    """The `get/commit` span's end carries the batch's block-cache
    accesses and hits: their sums over a run are what the commit's LRU
    replays gave (the checker's replays, outside the commit, are not
    counted)."""
    db, n = loaded("RO")
    bc = db.block_cache
    replays = []
    in_checker = [False]
    checker_body = db._checker_body

    def access_many(sids, blks):
        hit = BlockCache.access_many(bc, sids, blks)
        if not in_checker[0]:
            replays.append((len(hit), int(hit.sum())))
        return hit

    def watched(immpc):
        in_checker[0] = True
        try:
            return checker_body(immpc)
        finally:
            in_checker[0] = False

    bc.access_many = access_many
    db._checker_body = watched
    obs = Observability(clock="wall").attach(db, name="w")
    drive(db, "RO", n)
    ends = [ev["args"] for ev in obs.tracer.events
            if ev["name"] == "get/commit" and ev["ph"] == "E"]
    assert len(ends) == len(replays) == obs.tracer.count("get/commit", "B")
    assert [(a["block_events"], a["cache_hits"]) for a in ends] == replays
    assert sum(h for _, h in replays) > 0


def test_checker_span_counts_candidates_and_block_events():
    """The `checker` span's end carries its immPC's records, the
    candidates among them (hot, not updated) and the block-cache
    accesses of their walks: what each run's `_newer_in_snapshot` was
    given and made, the excluded ones summing to `Stats`, and the walks'
    accesses with the commits' making up every access of the run."""
    db, n = loaded("RO")
    st0 = dataclasses.replace(db.stats)
    bc = db.block_cache
    acc0 = bc.hits + bc.misses
    seen = []
    newer_in_snapshot = db._newer_in_snapshot

    def watched(keys, seqs, immpc):
        newer, events = newer_in_snapshot(keys, seqs, immpc)
        seen.append((len(immpc.records), len(keys), events,
                     int(newer.sum())))
        return newer, events

    db._newer_in_snapshot = watched
    obs = Observability(clock="wall").attach(db, name="w")
    drive(db, "RO", n)
    tr = obs.tracer
    ends = [ev["args"] for ev in tr.events
            if ev["name"] == "checker" and ev["ph"] == "E"]
    st = db.stats
    assert len(ends) == len(seen) == st.checker_runs - st0.checker_runs > 0
    assert [(a["records"], a["candidates"], a["block_events"])
            for a in ends] == [x[:3] for x in seen]
    assert sum(x[3] for x in seen) == (st.checker_excluded_newer
                                       - st0.checker_excluded_newer)
    updated = st.checker_excluded_updated - st0.checker_excluded_updated
    assert sum(a["candidates"] for a in ends) + updated <= sum(
        a["records"] for a in ends)
    assert sum(a["candidates"] for a in ends) > 0
    commits = sum(ev["args"]["block_events"] for ev in tr.events
                  if ev["name"] == "get/commit" and ev["ph"] == "E")
    walks = sum(a["block_events"] for a in ends)
    assert walks > 0 and commits + walks == bc.hits + bc.misses - acc0


def test_wall_plane_on_a_cluster_detaches_whole():
    """Each shard and its RALT on a track of its own; `detach` restores
    the null plane on every wired object and the router's own
    `_new_shard`."""
    cfg = runner.default_config("tiny")
    n = runner.db_key_count(cfg, VALUE) // 4
    db = make_sharded_system("hotrap", cfg, ShardConfig(n_shards=2),
                             device="cpu")
    db.put_many(runner.load_keys(n, 0), VALUE)
    obs = Observability(clock="wall").attach(db, name="c")
    assert "_new_shard" in db.__dict__
    db.multi_get(runner.load_keys(n, 1)[:512])
    tracks = {ev["track"] for ev in obs.tracer.events
              if ev["name"] == "get"}
    assert tracks == {"c/shard0", "c/shard1"}
    assert obs.tracer.validate() == []
    obs.detach(db)
    assert "_new_shard" not in db.__dict__
    for x in [db, *db.shards, db.hot_budget,
              *(sh.ralt for sh in db.shards)]:
        assert x._obs is NULL_OBS and "_obs_track" not in x.__dict__


def kv4_run(make, cfg, scfg, obs, rounds: int = 30) -> tuple:
    """A tiny 4-shard hash cluster with a WAL, the arbiter every 256 ops,
    loaded and driven by rounds of one 64-key `multi_get` and one
    64-key `put_many`, with `obs` attached after the load; the gets'
    answers, the cluster and the arbiter's rounds in the rounds (the
    port's `ClusterStats` count them; None for the reference)."""
    db = make("hotrap", dataclasses.replace(cfg, wal=True), scfg,
              **({} if make is not make_sharded_system
                 else {"device": "cpu"}))
    n = runner.db_key_count(runner.default_config("tiny"), VALUE) // 4
    db.put_many(runner.load_keys(n, 0), VALUE)
    obs.attach(db, name="w")
    loaded = getattr(db.stats, "hot_budget_rebalances", None)
    rng = np.random.default_rng(11)
    out = []
    for _ in range(rounds):
        out.append(db.multi_get(rng.integers(0, n, 64)))
        db.put_many(rng.integers(0, 2 * n, 64), VALUE)
    return out, db, (None if loaded is None
                     else db.stats.hot_budget_rebalances - loaded)


def _intervals(tr, name: str) -> dict:
    """{track: [(begin, end), ...]} of the closed spans `name`."""
    out: dict = {}
    open_: dict = {}
    for ev in tr.events:
        if ev["name"] != name:
            continue
        if ev["ph"] == "B":
            open_[ev["track"]] = ev["ts"]
        elif ev["ph"] == "E":
            out.setdefault(ev["track"], []).append(
                (open_.pop(ev["track"]), ev["ts"]))
    return out


def test_router_put_and_rebalance_spans_on_a_wal_cluster():
    """Under a wall plane the router's `router_put` holds every shard's
    `put` (and its `wal/append`), once a `put_many`, on the router's
    lane; `hot_budget/rebalance` runs on the cluster's lane once an
    arbitration round, outside the router's spans.  A simulated-clock
    plane over the same run records neither, and its trace is the
    reference's."""
    from repro.core import ShardConfig as JShardConfig
    from repro.core import make_sharded_system as jmake_sharded
    from repro.core import runner as jrunner
    from repro.obs import Observability as JObservability
    from test_torch_obs import assert_same_plane
    scfg = dict(n_shards=4, rebalance_interval_ops=256)
    wall = Observability(clock="wall")
    got, _, rounds = kv4_run(make_sharded_system,
                             runner.default_config("tiny"),
                             ShardConfig(**scfg), wall)
    tr = wall.tracer
    assert tr.validate() == [] and tr.dropped == 0
    assert rounds > 5 and tr.count("hot_budget/rebalance", "B") == rounds
    puts = _intervals(tr, "router_put")
    assert list(puts) == ["w/router"] and len(puts["w/router"]) == 30
    assert list(_intervals(tr, "hot_budget/rebalance")) == ["w/cluster"]
    router = sorted(puts["w/router"]
                    + _intervals(tr, "router_batch")["w/router"])
    for name in ("put", "wal/append"):
        inner = [iv for ivs in _intervals(tr, name).values() for iv in ivs]
        assert len(inner) > 30
        assert all(any(a <= b0 and e0 <= e for a, e in puts["w/router"])
                   for b0, e0 in inner)
    for b0, e0 in _intervals(tr, "hot_budget/rebalance")["w/cluster"]:
        assert not any(a < e0 and b0 < e for a, e in router)
    st = tr.self_times()
    assert st["router_put"]["total_s"] >= st["put"]["total_s"]
    # the simulated clock: the reference's trace, without the wall spans
    planes, answers = [], []
    for make, cfg, sc, plane in (
            (jmake_sharded, jrunner.default_config("tiny"),
             JShardConfig(**scfg), JObservability()),
            (make_sharded_system, runner.default_config("tiny"),
             ShardConfig(**scfg), Observability())):
        out, _, _ = kv4_run(make, cfg, sc, plane)
        planes.append(plane)
        answers.append(out)
    assert_same_plane(*planes)
    assert answers[0] == answers[1] == got
    sim = planes[1].tracer
    assert sim.count("router_put") == sim.count("hot_budget/rebalance") == 0
    assert sim.count("router_batch", "B") == 30
    assert sim.count("hot_budget_rebalance") > 0


def test_attached_wall_plane_is_not_pickled():
    db, _ = loaded("RO")
    Observability(clock="wall").attach(db)
    copy = pickle.loads(pickle.dumps(db))
    assert copy._obs is NULL_OBS and copy.ralt._obs is NULL_OBS


def test_clock_is_sim_or_wall():
    assert not Observability().wall
    assert not Observability(enabled=False, clock="wall").wall
    with pytest.raises(ValueError):
        Observability(clock="host")


def test_self_times_subtract_children_on_the_same_track():
    t = [0.0]
    tr = Tracer(clock=lambda: t[0])

    def at(s, fn, *args):
        t[0] = s
        fn(*args)

    at(0.0, tr.begin, "a", "get")
    at(1.0, tr.begin, "a", "get/fd")
    at(3.0, tr.end, "a")
    at(3.5, tr.begin, "a", "checker")
    at(4.0, tr.begin, "a", "ralt/query")
    at(4.5, tr.end, "a")
    at(6.0, tr.end, "a")
    at(2.0, tr.begin, "b", "flush")     # clamped to 6.0: another track
    at(7.0, tr.end, "b")
    at(9.0, tr.end, "a")                # closes get
    at(9.0, tr.begin, "a", "get")
    at(10.0, tr.end, "a")
    st = tr.self_times()
    assert st["get"] == {"count": 2, "total_s": 10.0, "self_s": 5.5}
    assert st["get/fd"] == {"count": 1, "total_s": 2.0, "self_s": 2.0}
    assert st["checker"] == {"count": 1, "total_s": 2.5, "self_s": 2.0}
    assert st["ralt/query"] == {"count": 1, "total_s": 0.5, "self_s": 0.5}
    assert st["flush"] == {"count": 1, "total_s": 1.0, "self_s": 1.0}
    tr.begin("a", "put")                # open spans are not counted
    assert "put" not in tr.self_times()


def test_mirror_ranges_only_while_a_profiler_records():
    tr = Tracer(clock=lambda: 0.0)
    tr.mirror = "repro_torch/"
    tr.begin("a", "get")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.begin("a", "get/fd")
        torch.ones(4).sum()
        tr.end("a")
    tr.end("a")
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "repro_torch/get/fd" in names
    assert "repro_torch/get" not in names
    assert tr.validate() == [] and tr._ranges == {"a": []}


class Ev:
    """A `torch.profiler` event, as `profile_lsm.idle_by_span` reads it."""

    def __init__(self, name, dev, a, b):
        self.n, self.d, self.a, self.b = name, dev, a, b

    def name(self):
        return self.n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.d
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a


def prof_of(evs):
    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return evs
    return Prof


def test_idle_by_span_goes_to_the_innermost_engine_span():
    from repro_torch.launch.profile_lsm import WINDOW, idle_by_span
    e = "repro_torch/"
    evs = [Ev(WINDOW, False, 0, 1000),
           Ev(e + "get", False, 10, 790),
           Ev(e + "checker", False, 20, 300),
           Ev(e + "ralt/query", False, 100, 200),
           Ev(e + "get/sd", False, 400, 600),
           Ev(e + "get/sd", True, 400, 600),        # its range on the card
           Ev(WINDOW, True, 0, 1000),
           Ev("void k<int>(int*)", True, 150, 160),
           Ev("void k<int>(int*)", True, 250, 400),
           Ev("Memcpy DtoH (Device -> Pageable)", True, 500, 700)]
    got = idle_by_span(prof_of(evs))
    # gaps: [0,150) mid 75 checker, [160,250) mid 205 checker,
    # [400,500) mid 450 get/sd, [700,1000) mid 850 none
    assert got["idle_s"] == pytest.approx(640e-9)
    assert got["by_span"] == pytest.approx(
        {"checker": 240e-9, "get/sd": 100e-9, "none": 300e-9})
    # a gap inside ralt/query goes to it, not to the checker around it
    evs.append(Ev("void k<long>(long*)", True, 0, 120))
    assert idle_by_span(prof_of(evs))["by_span"] == pytest.approx(
        {"ralt/query": 30e-9, "checker": 90e-9, "get/sd": 100e-9,
         "none": 300e-9})
    assert idle_by_span(prof_of(evs[:5])) is None


def test_profile_lsm_splits_the_run_by_span(capsys):
    from repro_torch.launch import profile_lsm
    profile_lsm.main(["--scale", "tiny", "--ops", "3000", "--mix", "RW",
                      "--device", "cpu", "--top", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spans = out["spans"]
    assert {"get", "get/commit", "put", "ralt/record"} <= set(
        spans["us_per_op"])
    for row in spans["us_per_op"].values():
        assert 0.0 <= row["self"] <= row["total"] + 1e-6
    assert set(spans["builds_per_kop"]) == set(profile_lsm.BUILDS)
    assert "idle_by_span" not in spans and spans["dropped"] == 0
    commit = spans["commit"]
    assert commit["block_events_per_get"] > 0
    assert 0.0 < commit["cache_hit_share"] < 1.0
    checker = spans["checker"]
    assert set(checker) == {"candidates_per_record",
                            "block_events_per_candidate"}
    assert all(np.isfinite(v) and v >= 0 for v in checker.values())
    assert 0.0 < checker["candidates_per_record"] <= 1.0


def test_profile_lsm_splits_a_wal_cluster(capsys):
    """`--shards 4 --wal`: the router's, the WAL's and the arbiter's
    spans, the router's own time outside the shards' spans, and the
    cluster's counters."""
    from repro_torch.launch import profile_lsm
    profile_lsm.main(["--scale", "tiny", "--ops", "3000", "--mix", "RW",
                      "--device", "cpu", "--top", "3", "--shards", "4",
                      "--wal"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spans = out["spans"]
    assert {"router_batch", "router_put", "wal/append", "wal/group_commit",
            "hot_budget/rebalance", "get", "put"} <= set(spans["us_per_op"])
    cl = spans["cluster"]
    assert set(cl["router_us_per_op"]) == set(profile_lsm.ROUTER)
    assert all(v > 0 for v in cl["router_us_per_op"].values())
    kop = cl["counters_per_kop"]
    assert set(kop) == set(profile_lsm.CLUSTER_COUNTERS)
    assert kop["shard_calls"] > kop["router_batches"] > 0
    assert kop["wal_syncs"] > 0 and kop["hot_budget_rebalances"] > 0
