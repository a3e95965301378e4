"""Tiering parity of the port's tiered embedding and expert cache against
the reference (`repro.tiering.TieredEmbedding`, `ExpertCache`): the
streams of `tests/test_tiering.py:165-198` and of
`benchmarks/tiered_serving.py:166-199` on both packages, the port on the
CPU with the reference's threshold-sampling draws.  Outputs, clocks, slot
tables and tracker state must be equal bit for bit."""
import numpy as np
import torch

from repro.tiering import ExpertCache as JExpertCache
from repro.tiering import TieredEmbedding as JTieredEmbedding
from repro.tiering.kvcache import HBM_BW, PCIE_BW
from repro_torch.tiering import ExpertCache, TieredEmbedding
from test_torch_tiering import COUNTERS, assert_states_match, \
    reference_sampler


def assert_clocks_match(port, ref):
    for name in COUNTERS:
        assert getattr(port.clock, name) == getattr(ref.clock, name), name
    # the same sums of the same float64 terms in the same order
    assert (port.clock.hbm_s, port.clock.pcie_s) == \
        (ref.clock.hbm_s, ref.clock.pcie_s)


def replay_embedding(table, fast_rows, staging_slots, streams):
    """Both packages' `TieredEmbedding` over the same lookups; every
    output bit for bit, then the clocks, slot tables, free list, staging
    set and tracker state."""
    ref = JTieredEmbedding(table, fast_rows=fast_rows,
                           staging_slots=staging_slots)
    port = TieredEmbedding(table, fast_rows, staging_slots, hbm_bw=HBM_BW,
                           pcie_bw=PCIE_BW, device="cpu",
                           sampler=reference_sampler)
    for ids in streams:
        want = np.asarray(ref.lookup(ids))
        got = port.lookup(ids)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), table[ids])
    assert_clocks_match(port, ref)
    assert port.fast_hit_rate() == ref.fast_hit_rate()
    np.testing.assert_array_equal(port.slot_of_row, ref.slot_of_row)
    np.testing.assert_array_equal(port.row_of_slot, ref.row_of_slot)
    assert port.free == ref.free
    assert list(port.staging) == list(ref.staging)
    assert_states_match(ref.tracker.state, port.tracker.state)
    return port, ref


def test_tiered_embedding_matches_reference_skewed():
    """`tests/test_tiering.py::test_embedding_exact_and_hit_rate_improves`
    on both packages."""
    V, d = 512, 16
    rng = np.random.default_rng(4)
    table = rng.standard_normal((V, d)).astype(np.float32)
    streams = [np.where(rng.random(32) < 0.9, rng.integers(0, 32, 32),
                        rng.integers(0, V, 32)) for _ in range(80)]
    port, _ = replay_embedding(table, 64, 16, streams)
    assert port.clock.promoted > 0 and port.fast_hit_rate() > 0.5
    # the eviction pass ran, and kept a hot resident once
    assert port.clock.demoted > 0 and port.clock.retained > 0


def test_tiered_embedding_matches_reference_zipf():
    """The embedding replay of `benchmarks/tiered_serving.py:166-182` at
    its full size (V 4096, 512 fast rows, 400 lookups of 64 zipf(1.3)
    ids); ids drawn from the benchmark's generator in its order."""
    rng = np.random.default_rng(0)
    V, d = 4096, 64
    table = rng.standard_normal((V, d)).astype(np.float32)
    streams = [np.minimum(rng.zipf(1.3, 64) - 1, V - 1) for _ in range(400)]
    port, _ = replay_embedding(table, 512, 64, streams)
    assert port.clock.promoted > 0 and port.clock.flushes > 0
    assert port.clock.demoted > 0


def test_tiered_embedding_bf16_table_and_shapes():
    """A bf16 table (a torch tensor) and a (B, S) id array: the lookup is
    the exact gather, shaped (B, S, d)."""
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.standard_normal((300, 8)).astype(
        np.float32)).to(torch.bfloat16)
    emb = TieredEmbedding(table, 32, 8, hbm_bw=HBM_BW, pcie_bw=PCIE_BW,
                          device="cpu", sampler=reference_sampler)
    for _ in range(40):
        ids = np.minimum(rng.zipf(1.5, (2, 12)) - 1, 299)
        got = emb.lookup(ids)
        assert got.shape == (2, 12, 8) and got.dtype == torch.bfloat16
        assert torch.equal(got, table[torch.from_numpy(ids)])
    assert emb.clock.promoted > 0
    resident = int((emb.row_of_slot >= 0).sum())
    gone = np.flatnonzero(emb.slot_of_row >= 0)[:3]
    emb.invalidate_rows(gone)
    assert (emb.row_of_slot >= 0).sum() == resident - 3
    assert (emb.slot_of_row[gone] == -1).all() and len(emb.free) >= 3
    assert torch.equal(emb.lookup(gone), table[torch.from_numpy(gone)])


def replay_experts(weights, fast, swap_every, steps):
    """Both packages' `ExpertCache` over the same router histograms; the
    clocks, slot tables, free list, tracker state, resident blobs and
    `resident_fraction` after every step."""
    ref = JExpertCache(weights, fast_experts=fast, swap_every=swap_every)
    port = ExpertCache(weights, fast, swap_every, hbm_bw=HBM_BW,
                       pcie_bw=PCIE_BW, device="cpu",
                       sampler=reference_sampler)
    for counts in steps:
        ref.route(counts)
        port.route(counts)
        np.testing.assert_array_equal(port.slot_of, ref.slot_of)
        assert port.resident_fraction(counts) == \
            ref.resident_fraction(counts)
    assert_clocks_match(port, ref)
    np.testing.assert_array_equal(port.expert_of_slot, ref.expert_of_slot)
    assert port.free == ref.free
    assert_states_match(ref.tracker.state, port.tracker.state)
    np.testing.assert_array_equal(port.cache.numpy(), np.asarray(ref.cache))
    for s, e in enumerate(port.expert_of_slot):
        if e >= 0:
            np.testing.assert_array_equal(port.cache[s].numpy(), weights[e])
    return port, ref


def test_expert_cache_matches_reference_skewed():
    """`tests/test_tiering.py::test_expert_cache_tracks_skewed_routing` on
    both packages."""
    E = 32
    rng = np.random.default_rng(5)
    weights = rng.standard_normal((E, 8, 8)).astype(np.float32)
    steps = []
    for _ in range(200):
        counts = np.zeros(E, np.int64)
        for _ in range(16):
            e = rng.integers(0, 4) if rng.random() < 0.9 \
                else rng.integers(0, E)
            counts[e] += 1
        steps.append(counts)
    port, _ = replay_experts(weights, 8, 8, steps)
    assert port.resident_fraction(steps[-1]) > 0.8
    assert port.clock.promoted >= 4


def test_expert_cache_matches_reference_zipf():
    """The expert replay of `benchmarks/tiered_serving.py:184-199` at its
    full size (64 experts of 32 x 32, 16 fast, a sweep every 8 of 300
    steps of 128 zipf(1.4) draws); the benchmark's generator continues
    from its embedding replay, as there."""
    rng = np.random.default_rng(0)
    rng.standard_normal((4096, 64))
    for _ in range(400):
        rng.zipf(1.3, 64)
    E = 64
    weights = rng.standard_normal((E, 32, 32)).astype(np.float32)
    steps = [np.bincount(np.minimum(rng.zipf(1.4, 128) - 1, E - 1),
                         minlength=E) for _ in range(300)]
    port, ref = replay_experts(weights, 16, 8, steps)
    assert port.clock.sweeps == 300 // 8
    assert port.clock.promoted > 0 and port.clock.demoted > 0
