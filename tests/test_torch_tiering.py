"""Tiering parity: the port's RALT tracker and tiered KV cache against the
reference (`repro.tiering`), fed the same accesses and the reference's
own threshold-sampling draws (torch cannot reproduce `jax.random`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.tiered_serving import access_stream, make_kv
from repro.tiering import hotness as jhot
from repro.tiering.kvcache import HBM_BW, KVTierConfig as JKVTierConfig
from repro.tiering.kvcache import PCIE_BW, TieredKVCache as JTieredKVCache
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


def test_sampled_threshold_targets_fraction():
    """§3.2 sampling with the port's own seeded sampler: the threshold
    keeps about target_bytes of the hottest units."""
    cfg = thot.TrackerConfig(n_units=1024, unit_bytes=1024,
                             fast_bytes=16 * 1024, n_samples=256)
    state = thot.init_state(cfg, CPU)
    state = {**state, "score": torch.arange(1024, dtype=torch.float32)}
    target = torch.tensor(0.25 * 1024 * cfg.unit_bytes)
    thr = float(thot.sampled_threshold(state, cfg, target,
                                       thot.seeded_sampler(CPU)))
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
