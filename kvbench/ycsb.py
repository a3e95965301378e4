"""The traffic generator: a frozen copy of the port's YCSB stream
(`repro_torch.data.workloads`: `KeyDist`, `ycsb`, `load_keys`,
`_scramble`), numpy only, made to stream in blocks.

A frozen copy, so that a later change to the program cannot change the
traffic it is measured on.  The draws are the port's, in the port's
order: `ycsb_block(..., seed=s, insert_base=n_keys)` equals
`repro_torch.data.workloads.ycsb(..., seed=s)` for every seed (a CPU
test holds them together).  `Stream` cuts an unbounded op stream into
rounds of `round_ops` ops: block `b`, `BLOCK_ROUNDS` rounds, is drawn
with the seed `[seed, b]`, and its inserts continue the fresh key range
past the previous block's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

OP_READ, OP_INSERT, OP_UPDATE, OP_SCAN = 0, 1, 2, 3
# rounds drawn a block; the block's seed is [seed, block], so this
# number defines the op stream of every seed
BLOCK_ROUNDS = 16

# (read, insert, update, scan) fractions per mix (paper Table 2, YCSB-E)
MIXES = {
    "RO": (1.00, 0.00, 0.00, 0.00),
    "RW": (0.75, 0.25, 0.00, 0.00),
    "WH": (0.50, 0.50, 0.00, 0.00),
    "UH": (0.50, 0.00, 0.50, 0.00),
    "SR": (0.00, 0.05, 0.00, 0.95),
}


def _scramble(x: np.ndarray, n: int) -> np.ndarray:
    """FNV-ish scramble so that rank->key is spread over the key space."""
    h = (x.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) \
        >> np.uint64(17)
    return (h % np.uint64(n)).astype(np.int64)


@dataclasses.dataclass
class KeyDist:
    kind: str                  # "hotspot", "zipfian", "uniform"
    n_keys: int
    hot_frac: float = 0.05     # hotspot: fraction of records that are hot
    hot_ops: float = 0.95      # hotspot: fraction of ops hitting hot set
    zipf_s: float = 0.99
    hot_offset: float = 0.0
    scramble: bool = True
    _zipf_cdf: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def sample(self, rng: np.random.Generator, m: int) -> np.ndarray:
        n = self.n_keys
        if self.kind == "uniform":
            return rng.integers(0, n, size=m)
        if self.kind == "hotspot":
            n_hot = max(1, int(self.hot_frac * n))
            start = int(self.hot_offset * n) % n
            hot = rng.random(m) < self.hot_ops
            offs = np.where(hot,
                            rng.integers(0, n_hot, size=m),
                            n_hot + rng.integers(0, max(n - n_hot, 1),
                                                 size=m))
            ranks = (start + offs) % n
            return _scramble(ranks, n) if self.scramble \
                else ranks.astype(np.int64)
        if self.kind == "zipfian":
            if (self._zipf_cdf is None or self._zipf_cdf[0] != self.zipf_s
                    or len(self._zipf_cdf[1]) != n):
                ranks = np.arange(1, n + 1, dtype=np.float64)
                w = 1.0 / np.power(ranks, self.zipf_s)
                cdf = np.cumsum(w)
                cdf /= cdf[-1]
                self._zipf_cdf = (self.zipf_s, cdf)
            u = rng.random(m)
            r = np.searchsorted(self._zipf_cdf[1], u)
            return _scramble(r, n) if self.scramble else r.astype(np.int64)
        raise ValueError(self.kind)


def ycsb_block(mix: str, dist: KeyDist, n_ops: int, seed,
               insert_base: int, max_scan_len: int = 100) -> tuple:
    """(ops, keys, scan_lens) of `n_ops` ops: the port's `ycsb` draws,
    with the inserts' fresh keys numbered from `insert_base`."""
    rng = np.random.default_rng(seed)
    r, i, u, s = MIXES[mix]
    ops = rng.choice([OP_READ, OP_INSERT, OP_UPDATE, OP_SCAN], size=n_ops,
                     p=[r, i, u, s])
    keys = dist.sample(rng, n_ops)
    n_ins = int((ops == OP_INSERT).sum())
    if n_ins:
        keys = keys.copy()
        keys[ops == OP_INSERT] = insert_base + np.arange(n_ins)
    scan_lens = None
    if s > 0:
        scan_lens = np.zeros(n_ops, dtype=np.int64)
        is_scan = ops == OP_SCAN
        scan_lens[is_scan] = rng.integers(1, max_scan_len + 1,
                                          size=int(is_scan.sum()))
    return ops, keys, scan_lens


def load_keys(n_keys: int, seed: int = 0) -> np.ndarray:
    """Load-phase insertion order (shuffled, like YCSB load)."""
    rng = np.random.default_rng(seed + 1)
    keys = np.arange(n_keys)
    rng.shuffle(keys)
    return keys


def key_dist(traffic: dict, n_keys: int) -> KeyDist:
    """The `KeyDist` a traffic file's "dist" object describes."""
    d = dict(traffic["dist"])
    return KeyDist(d.pop("kind"), n_keys, **d)


@dataclasses.dataclass
class Round:
    """The ops one round gathers: the reads go to the store as one
    `multi_get`, then the writes (inserts and updates, in op order) as
    one `put_many`, so every read of a round is linearized before its
    writes."""
    reads: np.ndarray
    writes: np.ndarray


class Stream:
    """The seed's unbounded op stream of one traffic mix, in rounds of
    `round_ops` ops, drawn `BLOCK_ROUNDS` rounds at a time."""

    def __init__(self, traffic: dict, n_keys: int, seed: int):
        self.mix = traffic["mix"]
        if MIXES[self.mix][3]:
            raise ValueError("scan mixes have no round form yet")
        self.round_ops = int(traffic["round_ops"])
        self.dist = key_dist(traffic, n_keys)
        self.seed = int(seed)
        self.next_insert = n_keys
        self.block = 0
        self._queue: list[Round] = []

    def _draw(self) -> None:
        c = self.round_ops
        ops, keys, _ = ycsb_block(self.mix, self.dist, c * BLOCK_ROUNDS,
                                  [self.seed, self.block], self.next_insert)
        self.next_insert += int((ops == OP_INSERT).sum())
        self.block += 1
        w = (ops == OP_INSERT) | (ops == OP_UPDATE)
        self._queue = [Round(keys[a:a + c][~w[a:a + c]],
                             keys[a:a + c][w[a:a + c]])
                       for a in range(0, len(ops), c)][::-1]

    def next(self) -> Round:
        if not self._queue:
            self._draw()
        return self._queue.pop()
