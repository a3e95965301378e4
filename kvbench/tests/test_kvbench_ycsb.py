"""The benchmark's frozen traffic generator draws what the port's does."""
import numpy as np
import pytest

from kvbench import ycsb

SEEDS = (0, 12345, 2 ** 31 + 99)


@pytest.mark.parametrize("seed", SEEDS)
def test_load_keys_equal_the_ports(seed):
    from repro_torch.data import workloads
    np.testing.assert_array_equal(ycsb.load_keys(22528, seed),
                                  workloads.load_keys(22528, seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mix,kind", [("RO", "hotspot"), ("RW", "hotspot"),
                                      ("RO", "uniform"), ("UH", "zipfian"),
                                      ("SR", "zipfian")])
def test_block_equals_the_ports_ycsb(seed, mix, kind):
    from repro_torch.data import workloads
    n = 22528
    ops, keys, lens = ycsb.ycsb_block(mix, ycsb.KeyDist(kind, n), 5000,
                                      seed, insert_base=n)
    want = workloads.ycsb(mix, workloads.KeyDist(kind, n), 5000, 1000,
                          seed=seed)
    np.testing.assert_array_equal(ops, want.ops)
    np.testing.assert_array_equal(keys, want.keys)
    if want.scan_lens is None:
        assert lens is None
    else:
        np.testing.assert_array_equal(lens, want.scan_lens)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_is_the_ports_blocks_with_inserts_continuing(seed):
    """Block b of the stream is the port's `ycsb` under the seed
    [seed, b], its inserts numbered on from the previous block's."""
    from repro_torch.data import workloads
    n, round_ops, rounds = 22528, 64, ycsb.BLOCK_ROUNDS
    traffic = {"mix": "RW", "round_ops": round_ops,
               "dist": {"kind": "hotspot", "hot_frac": 0.05,
                        "hot_ops": 0.95}}
    s = ycsb.Stream(traffic, n, seed)
    got = [s.next() for _ in range(3 * rounds)]
    base = n
    for b in range(3):
        want = workloads.ycsb("RW", workloads.KeyDist("hotspot", n),
                              round_ops * rounds, 1000, seed=[seed, b])
        ins = want.ops == workloads.OP_INSERT
        keys = want.keys.copy()
        keys[ins] += base - n
        base += int(ins.sum())
        for r in range(rounds):
            sl = slice(r * round_ops, (r + 1) * round_ops)
            w = (want.ops[sl] == workloads.OP_INSERT) | (
                want.ops[sl] == workloads.OP_UPDATE)
            rnd = got[b * rounds + r]
            np.testing.assert_array_equal(rnd.reads, keys[sl][~w])
            np.testing.assert_array_equal(rnd.writes, keys[sl][w])
