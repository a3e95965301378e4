"""The port's serving plane (`repro_torch.obs.serving`) against the
reference's (`repro.obs.serving`), on the CPU at smoke widths: the tests
of `tests/test_serving_obs.py`, each run on both packages.  The tiering
components take the reference's threshold-sampling draws, so a plane
attached to the same access stream records the same trace events
(names, phases, tracks, args and timestamps, which are `SimClock` sums),
the same metrics and the same token attribution.  The plane is read-only:
an attached component's clock, tables and outputs equal the unattached
one's.  The reference's wall-clock overhead assert is held structurally
(a disabled plane reaches no tracer, metrics or sampler call)."""
import json
import pickle

import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.obs.serving import ServingObservability as JServingObservability
from repro.obs.serving import TokenAttributionSampler as JTokenAttribution
from repro.obs.serving import component_sample as jcomponent_sample
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.tiering import ExpertCache as JExpertCache
from repro.tiering import KVTierConfig as JKVTierConfig
from repro.tiering import TieredEmbedding as JTieredEmbedding
from repro.tiering import TieredKVCache as JTieredKVCache
from repro.tiering.kvcache import HBM_BW, PCIE_BW
from repro_torch.configs import smoke_config
from repro_torch.obs import jsonify
from repro_torch.obs.serving import (NULL_SERVING_OBS, ServingObservability,
                                     TokenAttributionSampler,
                                     component_sample)
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.tiering import (ExpertCache, KVTierConfig, TieredEmbedding,
                                 TieredKVCache)
from test_torch_lsm import cs
from test_torch_obs import Spy
from test_torch_tiering import COUNTERS, reference_sampler

BW = dict(hbm_bw=HBM_BW, pcie_bw=PCIE_BW, device="cpu",
          sampler=reference_sampler)


def small_kw(**kw):
    base = dict(n_pages=64, fast_slots=8, page_tokens=2, kv_heads=1,
                head_dim=4, staging_slots=4, sweep_every=16)
    base.update(kw)
    return base


def kv_pair(**kw):
    """(reference, port) `TieredKVCache`s of one small config."""
    return (JTieredKVCache(JKVTierConfig(**small_kw(**kw))),
            TieredKVCache(KVTierConfig(**small_kw(**kw)), **BW))


def drive(kv, n_ops=200, seed=0, zipf=1.5, width=4) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_ops):
        pages = kv.read_pages(rng.zipf(zipf, width) % kv.cfg.n_pages)
        out.append([p.float().numpy() if isinstance(p, torch.Tensor)
                    else np.asarray(p, np.float32) for p in pages])
    return out


def plane_docs(obs) -> dict:
    return {"trace": obs.tracer.to_dict(),
            "metrics": jsonify(obs.metrics.to_json()),
            "attribution": jsonify(obs.attr.summary())}


def assert_same_plane(want, got) -> None:
    assert cs.json_mismatches(plane_docs(want), plane_docs(got)) == []
    assert got.tracer.dropped == want.tracer.dropped == 0
    assert got.tracer.validate() == want.tracer.validate() == []
    json.dumps(got.tracer.to_dict())          # host values only


def assert_same_kv(a, b) -> None:
    """Two caches' clocks and slot tables, bit for bit (the `tiered`
    phase's check)."""
    assert cs.kv_state_mismatch(a, b) == []


# ----------------------------------------------------------------------
# disabled mode: nothing recorded, pickles cleanly, no call reached
# ----------------------------------------------------------------------
def test_disabled_serving_obs_records_nothing():
    _, kv = kv_pair()
    assert kv._obs is NULL_SERVING_OBS
    drive(kv)
    assert NULL_SERVING_OBS.tracer.events == []
    assert NULL_SERVING_OBS.metrics.n_samples == 0
    assert NULL_SERVING_OBS.attr.n_seen == 0


def test_components_pickle_cleanly():
    """Attached components round-trip through pickle without the plane:
    the class-level NULL plane reasserts on load."""
    _, kv = kv_pair()
    drive(kv, 64)
    emb = TieredEmbedding(np.zeros((32, 4), np.float32), 8, **BW)
    ec = ExpertCache(np.zeros((8, 2, 2), np.float32), 2, **BW)
    obs = ServingObservability()
    for comp, name in ((kv, "kv"), (emb, "emb"), (ec, "expert")):
        obs.attach(comp, name)
    for comp in (kv, emb, ec):
        clone = pickle.loads(pickle.dumps(comp))
        assert clone._obs is NULL_SERVING_OBS
        assert clone.clock.total_s == comp.clock.total_s
    kv2 = pickle.loads(pickle.dumps(kv))
    drive(kv2, 16)
    assert kv2.clock.fast_hits > kv.clock.fast_hits


def test_disabled_plane_reaches_no_call():
    calls: list = []
    off = ServingObservability(enabled=False)
    off.tracer = off.metrics = off.attr = Spy(calls)
    _, base = kv_pair(n_pages=128, fast_slots=16)
    _, spied = kv_pair(n_pages=128, fast_slots=16)
    off.attach(spied, "off")
    a = drive(base, 400, seed=3)
    b = drive(spied, 400, seed=3)
    spied.sweep()
    base.sweep()
    assert calls == []
    assert all(np.array_equal(x, y) for u, v in zip(a, b)
               for x, y in zip(u, v))
    assert_same_kv(base, spied)


# ----------------------------------------------------------------------
# read-only: attached components equal unattached ones
# ----------------------------------------------------------------------
def test_attached_kv_equals_unattached():
    _, base = kv_pair(staging_slots=4, sweep_every=8)
    _, attached = kv_pair(staging_slots=4, sweep_every=8)
    obs = ServingObservability(metrics_interval_s=1e-7).attach(attached,
                                                               "kv")
    a = drive(base, 300, zipf=1.3, width=6)
    b = drive(attached, 300, zipf=1.3, width=6)
    assert all(np.array_equal(x, y) for u, v in zip(a, b)
               for x, y in zip(u, v))
    assert_same_kv(base, attached)
    assert obs.metrics.n_samples > 2 and obs.attr.n_seen == 300


def test_attached_caches_equal_unattached():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((256, 8)).astype(np.float32)
    blobs = rng.standard_normal((8, 2, 2)).astype(np.float32)
    streams = [np.where(rng.random(24) < 0.9, rng.integers(0, 24, 24),
                        rng.integers(0, 256, 24)) for _ in range(60)]
    counts = [np.bincount(np.minimum(rng.zipf(1.4, 32), 8) - 1,
                          minlength=8) for _ in range(60)]
    runs = []
    for attach in (False, True):
        emb = TieredEmbedding(table, 32, 8, **BW)
        ec = ExpertCache(blobs, 2, 4, **BW)
        if attach:
            obs = ServingObservability(metrics_interval_s=1e-7)
            obs.attach(emb, "emb")
            obs.attach(ec, "expert")
        outs = [emb.lookup(ids).numpy() for ids in streams]
        outs += [np.asarray(ec.route(c)) for c in counts]
        runs.append((emb, ec, outs))
    (e0, c0, o0), (e1, c1, o1) = runs
    assert all(np.array_equal(x, y) for x, y in zip(o0, o1))
    for a, b in ((e0, e1), (c0, c1)):
        for name in COUNTERS + ("hbm_s", "pcie_s"):
            assert getattr(a.clock, name) == getattr(b.clock, name), name
        assert a.free == b.free
    np.testing.assert_array_equal(e0.slot_of_row, e1.slot_of_row)
    np.testing.assert_array_equal(c0.expert_of_slot, c1.expert_of_slot)
    assert obs.tracer.names() >= {"emb/flush_promote"}


# ----------------------------------------------------------------------
# spans + pathway instants, against the reference
# ----------------------------------------------------------------------
def test_span_nesting_across_sweep_and_flush():
    planes = []
    for kv, cls in zip(kv_pair(), (JServingObservability,
                                   ServingObservability)):
        obs = cls().attach(kv, "kv")
        drive(kv, 64)
        kv.sweep()
        assert kv.clock.sweeps >= 1 and kv.clock.flushes >= 1
        planes.append(obs)
    assert_same_plane(*planes)
    names = planes[1].tracer.names()
    assert "kv/sweep" in names and "kv/staging_flush" in names
    assert "page/retained" in names
    assert names & {"page/promo_flush", "page/promo_compaction"}


def test_all_three_pathways_emit_instants():
    planes, kvs = [], kv_pair(staging_slots=4, sweep_every=8)
    for kv, cls in zip(kvs, (JServingObservability, ServingObservability)):
        obs = cls().attach(kv, "kv")
        drive(kv, 300, zipf=1.3, width=6)
        kv.staging.clear()
        hot = np.asarray(kv._hot_set()).nonzero()[0]
        p = next(int(q) for q in hot if kv.tier[q] == kv.TIER_FAST)
        kv._demote(p)
        kv.staging[p] = int(kv.version[p])
        kv.sweep()
        planes.append(obs)
    assert_same_plane(*planes)
    assert_same_kv(*kvs)
    names = planes[1].tracer.names()
    assert {"page/retained", "page/promo_compaction",
            "page/promo_flush"} <= names, sorted(names)


def test_version_mismatch_abort_emits_instant():
    planes = []
    for kv, cls in zip(kv_pair(), (JServingObservability,
                                   ServingObservability)):
        obs = cls().attach(kv, "kv")
        page = 5
        for _ in range(8):
            kv.read_pages([page])
        staged = int(kv.version[page])
        kv.staging[page] = staged
        z = np.zeros((1, 2, 1, 4), np.float32)
        kv.write_page(page, z, z)
        assert kv._promote(page, staged, hot=True) is False
        assert kv.clock.aborted == 1
        planes.append(obs)
    assert_same_plane(*planes)
    aborts = [e for e in planes[1].tracer.events
              if e["name"] == "page/promo_abort"]
    assert len(aborts) == 1
    args = aborts[0]["args"]
    assert args["page"] == 5
    assert args["version"] == args["staged_version"] + 1


def test_cache_spans_equal_reference():
    """`TieredEmbedding`'s flush-promote spans and `ExpertCache`'s
    rebalance spans on one plane, against the reference's."""
    rng = np.random.default_rng(7)
    table = rng.standard_normal((256, 8)).astype(np.float32)
    blobs = rng.standard_normal((8, 2, 2)).astype(np.float32)
    streams = [np.where(rng.random(24) < 0.9, rng.integers(0, 24, 24),
                        rng.integers(0, 256, 24)) for _ in range(60)]
    counts = [np.bincount(np.minimum(rng.zipf(1.4, 32), 8) - 1,
                          minlength=8) for _ in range(60)]
    planes = []
    for obs, emb, ec in (
            (JServingObservability(metrics_interval_s=1e-7),
             JTieredEmbedding(table, fast_rows=32, staging_slots=8),
             JExpertCache(blobs, fast_experts=2, swap_every=4)),
            (ServingObservability(metrics_interval_s=1e-7),
             TieredEmbedding(table, 32, 8, **BW),
             ExpertCache(blobs, 2, 4, **BW))):
        obs.attach(emb, "emb")
        obs.attach(ec, "expert")
        for ids, c in zip(streams, counts):
            emb.lookup(ids)
            ec.route(c)
        planes.append(obs)
    assert_same_plane(*planes)
    names = planes[1].tracer.names()
    assert {"emb/flush_promote", "expert/rebalance"} <= names


# ----------------------------------------------------------------------
# metrics + attribution
# ----------------------------------------------------------------------
def test_pool_series_sampled_on_cadence():
    planes = []
    for kv, cls in zip(kv_pair(), (JServingObservability,
                                   ServingObservability)):
        obs = cls(metrics_interval_s=1e-7)
        obs.attach(kv, "kv")
        drive(kv, 150)
        planes.append(obs)
    assert_same_plane(*planes)
    m = planes[1].metrics
    assert m.n_samples > 2
    for metric in ("hbm_occupancy", "staging_depth", "page_hit_rate",
                   "promoted_bytes", "demoted_bytes"):
        t, v = m.series[f"kv/{metric}"].values()
        assert len(t) == len(v) > 0
        assert np.all(np.diff(t) >= 0)
    occ = m.series["kv/hbm_occupancy"].values()[1]
    assert all(0.0 <= x <= 1.0 for x in occ)
    assert {"pool", "pcie_bytes"} <= planes[1].tracer.names()


def test_component_sample_reads_only():
    samples = []
    for kv in kv_pair():
        drive(kv, 64)
        before = (kv.clock.total_s, kv.clock.promoted, len(kv.staging),
                  list(kv.free_slots))
        fn = (component_sample if isinstance(kv, TieredKVCache)
              else jcomponent_sample)
        samples.append(fn(kv))
        assert (kv.clock.total_s, kv.clock.promoted, len(kv.staging),
                list(kv.free_slots)) == before
    assert samples[0] == samples[1]
    s, kv = samples[1], kv_pair()[1]
    assert 0.0 <= s["page_hit_rate"] <= 1.0
    assert 0.0 <= s["hbm_occupancy"] <= 1.0
    assert component_sample(kv)["promoted_bytes"] == 0


def test_attribution_reservoir_and_table():
    tables = []
    for cls in (JTokenAttribution, TokenAttributionSampler):
        attr = cls(capacity=64, seed=1)
        for i in range(500):
            attr.observe("kv", lat=float(i + 1) * 1e-6, units=4,
                         host_units=i % 3, behind_sweep=(i % 10 == 0))
        tables.append((attr.table(0.9), attr.format_table(0.9, "unit")))
    assert cs.json_mismatches(*[jsonify(t) for t, _ in tables]) == []
    assert tables[0][1] == tables[1][1]
    t, txt = tables[1]
    assert t["n_sampled"] == 64 and t["n_seen"] == 500
    assert t["rows"]
    assert abs(sum(r["share"] for r in t["rows"]) - 1.0) < 1e-9
    assert "kv" in txt and "unit" in txt


# ----------------------------------------------------------------------
# engine: spans and the step budget
# ----------------------------------------------------------------------
def engines(n_req=4, max_new=6):
    """The reference's and the port's engine on internvl2-1b's smoke
    config, with the same requests (their random weights differ, and no
    engine event depends on a token)."""
    out = []
    for make_cfg, eng_cls, req_cls, kw in (
            (jsmoke_config, JServeEngine, JRequest, {}),
            (smoke_config, ServeEngine, Request, {"device": "cpu"})):
        cfg = make_cfg("internvl2-1b")
        eng = eng_cls(cfg, batch=2, max_len=48, **kw)
        rng = np.random.default_rng(0)
        for rid in range(n_req):
            eng.submit(req_cls(rid=rid,
                               prompt=list(rng.integers(0, cfg.vocab, 8)),
                               max_new=max_new))
        out.append(eng)
    return out


@pytest.mark.parametrize("max_steps", [10_000, 5])
def test_engine_spans_and_drain_counters(max_steps):
    planes, pair = [], engines()
    for eng, cls in zip(pair, (JServingObservability, ServingObservability)):
        obs = cls().attach(eng, "engine")
        eng.run(max_steps=max_steps)
        planes.append(obs)
    assert_same_plane(*planes)
    eng = pair[1]
    assert (eng.steps_used, eng.starved) == (pair[0].steps_used,
                                             pair[0].starved)
    names = planes[1].tracer.names()
    if max_steps == 5:
        starved = [e for e in planes[1].tracer.events
                   if e["name"] == "engine/starved"]
        assert len(starved) == 1
        assert starved[0]["args"]["steps_used"] == 5
        assert (starved[0]["args"]["live_slots"]
                + starved[0]["args"]["queued"]) > 0
    else:
        assert {"engine/prefill", "engine/decode", "engine/assign",
                "engine"} <= names
        assert "engine/starved" not in names
        assert eng.requests_completed == 4 and not eng.starved


def test_attached_engine_tokens_equal_unattached():
    base, attached = (engines()[1], engines()[1])
    obs = ServingObservability().attach(attached, "engine")
    a = [r.out for r in base.run()]
    b = [r.out for r in attached.run()]
    assert a == b and len(a) == 4
    assert base.steps_used == attached.steps_used > 0
    assert obs.tracer.count("engine/decode", "B") > 0
