"""Tiering parity: the port's RALT tracker and tiered KV cache against the
reference (`repro.tiering`), fed the same accesses and the reference's
own threshold-sampling draws (torch cannot reproduce `jax.random`).  The
tiered embedding and expert cache are in `test_torch_tiered_caches.py`."""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.tiered_serving import access_stream, make_kv
from repro.tiering import hotness as jhot
from repro.tiering.kvcache import HBM_BW, KVTierConfig as JKVTierConfig
from repro.tiering.kvcache import PCIE_BW, TieredKVCache as JTieredKVCache
from repro_torch.tiering import ExpertCache, TieredEmbedding
from repro_torch.tiering import hotness as thot
from repro_torch.tiering.kvcache import KVTierConfig, TieredKVCache

CPU = torch.device("cpu")


def reference_sampler(now, n, n_units):
    """The reference's index draw of `sampled_threshold`
    (`repro/tiering/hotness.py:119-120`)."""
    key = jax.random.fold_in(jax.random.key(17), now)
    return np.array(jax.random.randint(key, (n,), 0, n_units))


def assert_states_match(js, ts):
    """Every field of the tracker state, bit for bit."""
    for name in ("tick", "score", "now", "c", "t", "seen", "hot_limit",
                 "accessed_bytes", "accessed_bytes_r", "threshold"):
        np.testing.assert_array_equal(ts[name].numpy(),
                                      np.asarray(js[name]), err_msg=name)


# ----------------------------------------------------------------------
# hotness tracker
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(n_units=128, unit_bytes=1024, fast_bytes=16 * 1024, n_samples=64),
    dict(n_units=256, unit_bytes=4096, fast_bytes=8 * 4096, alpha=0.9,
         gamma=0.05, n_samples=128),
])
def test_tracker_matches_reference(kw):
    jcfg, tcfg = jhot.TrackerConfig(**kw), thot.TrackerConfig(**kw)
    jt = jhot.HotTracker(jcfg)
    tt = thot.HotTracker(tcfg, device="cpu", sampler=reference_sampler)
    rng = np.random.default_rng(0)
    hot_ids = np.arange(8)
    for step in range(80):
        ids = np.concatenate([hot_ids, rng.integers(8, kw["n_units"], 6)])
        if step >= 40:                      # hotspot shift
            ids = ids + kw["n_units"] // 2
        ids = ids % kw["n_units"]
        jt.record_ids(jnp.asarray(ids, jnp.int32))
        tt.record_ids(ids)
        if step % 7 == 6:
            jt.refresh_limits()
            tt.refresh_limits()
            np.testing.assert_array_equal(tt.hot().numpy(),
                                          np.asarray(jt.hot()))
        assert_states_match(jt.state, tt.state)
    assert int(tt.state["now"]) > 40, "slices must advance"
    # the lazily decayed scores go through torch's and XLA's float32 pow,
    # which need not round alike
    np.testing.assert_allclose(tt.scores().numpy(), np.asarray(jt.scores()),
                               rtol=1e-5)


def replay_both(kw, records, *, refresh_every=5, as_mask=False):
    """Feed `records` (lists of ids) to the reference's tracker and the
    port's (CPU, plain path), refreshing limits every `refresh_every`
    records; every state field bit for bit after each record.  With
    `as_mask` the port records a bool mask (`record`) instead of ids."""
    jcfg, tcfg = jhot.TrackerConfig(**kw), thot.TrackerConfig(**kw)
    jt = jhot.HotTracker(jcfg)
    tt = thot.HotTracker(tcfg, device="cpu", sampler=reference_sampler)
    for i, ids in enumerate(records):
        ids = np.asarray(ids, np.int64)
        jt.record_ids(jnp.asarray(ids, jnp.int32))
        if as_mask:
            mask = torch.zeros(kw["n_units"], dtype=torch.bool)
            mask[torch.from_numpy(ids)] = True
            tt.record(mask)
        else:
            tt.record_ids(ids)
        if i % refresh_every == refresh_every - 1:
            jt.refresh_limits()
            tt.refresh_limits()
        assert_states_match(jt.state, tt.state)
    return jt, tt


EDGE_KW = dict(n_units=64, unit_bytes=4096, fast_bytes=8 * 4096,
               n_samples=32)


def test_tracker_duplicate_ids_count_once():
    """Repeats within one record count once, as the reference's mask
    does: the bytes accessed are distinct units x unit_bytes."""
    rng = np.random.default_rng(1)
    records = [np.concatenate([[3, 3, 3, 5, 5], rng.integers(0, 64, 6),
                               rng.integers(0, 64, 6)]) for _ in range(30)]
    _, tt = replay_both(EDGE_KW, records)
    _, once = replay_both(EDGE_KW, [np.unique(r) for r in records])
    for name, x in once.state.items():
        assert torch.equal(tt.state[name], x), name


def test_tracker_record_advances_several_slices():
    """gamma small against unit_bytes: one record moves `now` by many
    slices at once (the slice remainder is not fused)."""
    kw = dict(EDGE_KW, gamma=0.0037)
    rng = np.random.default_rng(2)
    records = [rng.integers(0, 64, 1 + i % 9) for i in range(30)]
    jt, tt = replay_both(kw, records)
    jt1 = jhot.record_accesses(jt.state, jnp.zeros(64, bool).at[
        jnp.arange(12)].set(True), jhot.TrackerConfig(**kw))
    assert int(jt1["now"]) - int(jt.state["now"]) > 100
    assert int(tt.state["now"]) > 30 * 20


def test_tracker_record_crosses_r_bytes():
    """hot_hi_frac small: R is about 2.4 units' bytes, so every record
    of 4-6 units decrements the counters by 1-3 (dec >= 1; the R-byte
    remainder is one fused multiply-add) and clears the tags of units
    whose counter reaches 0."""
    kw = dict(EDGE_KW, hot_hi_frac=0.3, hot_lo_frac=0.01, delta_c=7.5,
              c_max=40.0)
    rng = np.random.default_rng(3)
    hot = np.arange(4)
    records = [np.concatenate([hot, rng.integers(4, 64, i % 3)])
               for i in range(30)]
    _, tt = replay_both(kw, records)
    c, seen = tt.state["c"].numpy(), tt.state["seen"].numpy()
    assert 0 < c[:4].min() and c[:4].max() < 40.0, "capped, then dec >= 1"
    cold = seen & (np.arange(64) >= 4)
    assert (c[cold] == 0).any() and (c[cold] > 0).any()
    assert not tt.state["t"].numpy()[c == 0].any()


def test_tracker_record_mask_matches_record_ids():
    """`record(mask)` and `record_ids(ids)` are one step: both against
    the reference, and against each other."""
    rng = np.random.default_rng(4)
    records = [rng.integers(0, 64, rng.integers(0, 12)) for _ in range(40)]
    _, by_mask = replay_both(EDGE_KW, records, as_mask=True)
    _, by_ids = replay_both(EDGE_KW, records)
    for name, x in by_ids.state.items():
        assert torch.equal(by_mask.state[name], x), name


def test_ralt_record_host_ids():
    """The fused record's host side: ids sorted, distinct, negatives
    from the end as a mask index takes them; out of range raises."""
    from repro_torch.kernels import ralt_score
    got = ralt_score.sorted_ids([9, 2, 2, -1, 0, 9], 10)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, [0, 2, 9])
    np.testing.assert_array_equal(
        ralt_score.sorted_ids(torch.tensor([3, 3]), 4), [3])
    assert ralt_score.sorted_ids([], 4).size == 0
    for bad in ([10], [-11]):
        with pytest.raises(IndexError):
            ralt_score.sorted_ids(bad, 10)


def test_ralt_record_clock_views():
    """The two-slot clock: a fresh state's scalars are copied into row
    0; views of a row are recognised as such; the views hold the same
    values and dtypes as the state's 0-d tensors."""
    from repro_torch.kernels import ralt_score
    cfg = thot.TrackerConfig(n_units=16, unit_bytes=64, fast_bytes=1024)
    st = thot.init_state(cfg, CPU)
    st = {**st, "now": torch.tensor(7, dtype=torch.int32),
          "accessed_bytes": torch.tensor(1.5),
          "accessed_bytes_r": torch.tensor(-2.25)}
    buf, slot = ralt_score._clock(st)
    assert slot == 0 and buf.shape == (2, 4)
    views = buf.clock_views[0]
    for k, v in views.items():
        assert v.shape == () and v.dtype == st[k].dtype
        assert torch.equal(v, st[k]), k
    for row in (0, 1):
        b2, s2 = ralt_score._clock({**st, **buf.clock_views[row]})
        assert b2 is buf and s2 == row
    with pytest.raises(ValueError, match="CUDA"):
        ralt_score.ralt_record_(st, [1], cfg)


def test_ralt_record_param_ids_fit_launch():
    """The ids passed by value and the rest of the launch's parameters
    stay inside the classic 4 KB limit on kernel parameters, and fit
    the shared-memory staging."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "ralt_score.cu").read_text()
    k = int(re.search(r"constexpr int kParamIds = (\d+);", src).group(1))
    smem = int(re.search(r"constexpr int kSmemIds = (\d+);", src).group(1))
    assert 4 * k + 128 <= 4096 and k <= smem
    assert "ralt_record" in _build.LAUNCHES


def test_sampled_threshold_targets_fraction():
    """§3.2 sampling with the port's own seeded sampler: the threshold
    keeps about target_bytes of the hottest units."""
    cfg = thot.TrackerConfig(n_units=1024, unit_bytes=1024,
                             fast_bytes=16 * 1024, n_samples=256)
    state = thot.init_state(cfg, CPU)
    state = {**state, "score": torch.arange(1024, dtype=torch.float32)}
    target = torch.tensor(0.25 * 1024 * cfg.unit_bytes)
    thr = float(thot.sampled_threshold(state, cfg, target,
                                       thot.SeededSampler(CPU)))
    kept = (np.arange(1024) >= thr).mean()
    assert 0.15 < kept < 0.35, (thr, kept)


# ----------------------------------------------------------------------
# tiered KV cache
# ----------------------------------------------------------------------
COUNTERS = ("fast_hits", "slow_hits", "promoted", "demoted", "retained",
            "aborted", "sweeps", "flushes")


def port_make_kv(n_pages, fast_slots):
    """The port's counterpart of `benchmarks.tiered_serving.make_kv`."""
    cfg = KVTierConfig(n_pages=n_pages, fast_slots=fast_slots,
                       page_tokens=16, kv_heads=4, head_dim=32,
                       staging_slots=16, sweep_every=64)
    kv = TieredKVCache(cfg, hbm_bw=HBM_BW, pcie_bw=PCIE_BW, device="cpu",
                       sampler=reference_sampler)
    z = np.zeros((1, cfg.page_tokens, cfg.kv_heads, cfg.head_dim),
                 np.float32)
    for p in range(n_pages):
        kv.write_page(p, z, z)
    kv.clock.pcie_s = kv.clock.hbm_s = 0.0
    return kv


@pytest.mark.parametrize("kind,shift", [("hotspot", False), ("zipf", False),
                                        ("uniform", False),
                                        ("hotspot", True)])
def test_tiered_kv_replay_matches_reference(kind, shift):
    """`benchmarks.tiered_serving.run_system("hotrap", ...)` at its quick
    size (256 pages, 32 fast, 1500 ops), replayed on both packages."""
    n_ops = 1500
    shift_at = n_ops // 2 if shift else None
    ref = make_kv(256, 32)
    port = port_make_kv(256, 32)
    for p in access_stream(kind, 256, n_ops, shift_at=shift_at):
        ref.read_pages([p])
        port.read_pages([p])
    for name in COUNTERS:
        assert getattr(port.clock, name) == getattr(ref.clock, name), name
    assert port.clock.total_s == pytest.approx(ref.clock.total_s, rel=1e-9)
    assert port.fast_hit_rate() == ref.fast_hit_rate()
    np.testing.assert_array_equal(port.tier, ref.tier)
    np.testing.assert_array_equal(port.page_of_slot, ref.page_of_slot)
    assert port.clock.promoted > 0


def test_promotion_aborts_on_newer_version():
    """§3.3/3.4 (`tests/test_tiering.py:122` on both packages): a page
    rewritten after staging is not promoted, and reads serve the newer
    data."""
    kw = dict(n_pages=64, fast_slots=16, page_tokens=4, kv_heads=2,
              head_dim=8, staging_slots=4, sweep_every=10_000)
    ref = JTieredKVCache(JKVTierConfig(**kw))
    port = TieredKVCache(KVTierConfig(**kw), hbm_bw=HBM_BW, pcie_bw=PCIE_BW,
                         device="cpu", sampler=reference_sampler)
    rng = np.random.default_rng(2)
    shape = (1, 4, 2, 8)
    for p in range(64):
        k, v = rng.random(shape), rng.random(shape)
        ref.write_page(p, k, v)
        port.write_page(p, k, v)
    for kv in (ref, port):
        kv.read_pages([0])
        assert 0 in kv.staging
    newer = rng.random(shape)
    for kv in (ref, port):
        kv.write_page(0, newer, newer)
        for i in range(200):
            kv.read_pages([i % 4])
    assert port.clock.aborted >= 1
    for name in COUNTERS:
        assert getattr(port.clock, name) == getattr(ref.clock, name), name
    got = port.read_pages([0])[0].float().numpy()
    np.testing.assert_allclose(got[0], newer, rtol=1e-2, atol=1e-2)


# ----------------------------------------------------------------------
# pickling (`tests/test_serving_obs.py:49-66` on the port)
# ----------------------------------------------------------------------
def assert_same_state(a, b, path="obj"):
    """Every attribute of `a` equals `b`'s, walking dicts, lists and
    objects: tensors and arrays bit for bit (dtype and device too)."""
    assert type(a) is type(b), path
    if torch.is_tensor(a):
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device)
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same_state(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_state(x, y, f"{path}[{i}]")
    elif hasattr(a, "__dict__") and not dataclasses.is_dataclass(a):
        assert_same_state(vars(a), vars(b), path)
    else:
        assert a == b, path


def _drive_tracker(t, step):
    rng = np.random.default_rng(step)
    for i in range(12):
        t.record_ids(np.unique(rng.integers(0, 64, 6)))
        if i % 4 == 3:
            t.refresh_limits()


def _drive_kv(kv, step):
    for p in access_stream("hotspot", 128, 300, seed=step):
        kv.read_pages([p])


def _drive_embedding(emb, step):
    rng = np.random.default_rng(step)
    for _ in range(20):
        emb.lookup(np.where(rng.random(16) < 0.9, rng.integers(0, 8, 16),
                            rng.integers(0, 64, 16)))


def _drive_experts(ec, step):
    rng = np.random.default_rng(step)
    for _ in range(40):
        ec.route(np.bincount(np.minimum(rng.zipf(1.4, 32), 8) - 1,
                             minlength=8))


def _drive_engine(eng, step):
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(step)
    for rid in range(3):
        eng.submit(Request(rid=10 * step + rid,
                           prompt=[int(t) for t in rng.integers(0, 256, 4)],
                           max_new=3))
    eng.run()


def _kv():
    cfg = KVTierConfig(n_pages=128, fast_slots=16, page_tokens=4,
                       kv_heads=2, head_dim=8, staging_slots=8,
                       sweep_every=32)
    kv = TieredKVCache(cfg, hbm_bw=HBM_BW, pcie_bw=PCIE_BW, device="cpu")
    z = np.zeros((1, 4, 2, 8), np.float32)
    for p in range(cfg.n_pages):
        kv.write_page(p, z + p, z - p)
    return kv


def _engine():
    from repro_torch.configs import smoke_config
    from repro_torch.serving.engine import ServeEngine
    return ServeEngine(smoke_config("llama3-8b"), batch=2, max_len=16,
                       device="cpu")


@pytest.mark.parametrize("make,drive", [
    (lambda: thot.HotTracker(thot.TrackerConfig(
        n_units=64, unit_bytes=4096, fast_bytes=8 * 4096, n_samples=32),
        device="cpu"), _drive_tracker),
    (_kv, _drive_kv),
    (lambda: TieredEmbedding(
        np.random.default_rng(0).standard_normal((64, 4)).astype(
            np.float32), 8, 4, hbm_bw=HBM_BW, pcie_bw=PCIE_BW,
        device="cpu"), _drive_embedding),
    (lambda: ExpertCache(
        np.random.default_rng(1).standard_normal((8, 2, 2)).astype(
            np.float32), 2, 4, hbm_bw=HBM_BW, pcie_bw=PCIE_BW,
        device="cpu"), _drive_experts),
    (_engine, _drive_engine),
], ids=["HotTracker", "TieredKVCache", "TieredEmbedding", "ExpertCache",
        "ServeEngine"])
def test_components_pickle_cleanly(make, drive):
    """Driven with the default threshold sampler, then pickled: the clone
    holds the same clock and state, and a further drive of the clone
    leaves what the same drive of the original leaves."""
    comp = make()
    drive(comp, 1)
    clone = pickle.loads(pickle.dumps(comp))
    assert_same_state(comp, clone)
    drive(comp, 2)
    drive(clone, 2)
    assert_same_state(comp, clone)
