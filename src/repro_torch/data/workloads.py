"""Workload generators for the HotRAP benchmarks (paper §4).

YCSB-style key distributions (paper §4.2):
  * hotspot-5%: 95% of operations uniformly hit 5% of records; the
    remaining 5% of operations uniformly hit the other 95%;
  * zipfian: P(k-th hottest) ∝ 1/k^0.99, with the standard YCSB
    scrambled mapping from rank to key so hot keys are spread over the
    key space;
  * uniform.

Read-write mixes (paper Table 2): RO 100%R, RW 75%R/25%I, WH 50%R/50%I,
UH 50%R/50%U (update-heavy draws update keys from the *same* skewed
distribution as reads — the paper's worst case for HotRAP).  SR is the
YCSB-E short-range-scan mix (95% scan / 5% insert): scan *start* keys
come from the configured distribution (zipfian for YCSB-E) and scan
lengths are uniform in [1, max_scan_len] (default 100), per the YCSB
core workload definition.

Twitter-like traces (paper §4.3): we do not ship the raw Twitter traces;
`twitter_like_trace` synthesises a trace with a prescribed read ratio,
*sunk*-read fraction (reads whose key was last written > 5% of DB size
ago) and *hot*-read fraction (reads whose key was read < 5% of DB size
ago), the two axes of paper Fig. 9.

The generators stay numpy, with the reference's `np.random.Generator`
draws in the reference's order (`repro.data.workloads`), so one seed
gives the same operations in both packages; the engine moves each chunk
of keys to its device (`core/lsm.py:TieredLSM.multi_get`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

OP_READ, OP_INSERT, OP_UPDATE, OP_SCAN = 0, 1, 2, 3

# (read, insert, update, scan) fractions per mix
MIXES = {
    "RO": (1.00, 0.00, 0.00, 0.00),
    "RW": (0.75, 0.25, 0.00, 0.00),
    "WH": (0.50, 0.50, 0.00, 0.00),
    "UH": (0.50, 0.00, 0.50, 0.00),
    "SR": (0.00, 0.05, 0.00, 0.95),    # YCSB-E: scan-heavy
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
    hot_offset: float = 0.0    # shift the hotspot (dynamic workloads)
    scramble: bool = True      # YCSB rank->key hashing; False keeps hot
                               # keys *contiguous* at the bottom of the
                               # key space (shard-skew workloads: a
                               # range-partitioned cluster then sees all
                               # the heat on one shard)
    # cached zipfian CDF as (zipf_s, cdf) (O(n_keys) to build; reused
    # across sample calls, rebuilt if n_keys or zipf_s change)
    _zipf_cdf: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def sample(self, rng: np.random.Generator, m: int) -> np.ndarray:
        n = self.n_keys
        if self.kind == "uniform":
            return rng.integers(0, n, size=m)
        if self.kind == "hotspot":
            # YCSB hashes insertion order -> the hot *logical* range is
            # scattered over the key space (this scattering is what
            # defeats SSTable/block-granularity promotion, limitation 2).
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
            # draw ranks by inverse-CDF over 1/k^s, then scramble
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


@dataclasses.dataclass
class Workload:
    ops: np.ndarray            # (m,) op codes
    keys: np.ndarray           # (m,) key indices (scan *start* for OP_SCAN)
    value_len: int
    scan_lens: np.ndarray | None = None   # (m,) records per scan (0: not a scan)


def ycsb(mix: str, dist: KeyDist, n_ops: int, value_len: int,
         seed: int = 0, max_scan_len: int = 100) -> Workload:
    rng = np.random.default_rng(seed)
    r, i, u, s = MIXES[mix]
    ops = rng.choice([OP_READ, OP_INSERT, OP_UPDATE, OP_SCAN], size=n_ops,
                     p=[r, i, u, s])
    keys = dist.sample(rng, n_ops)
    # inserts append fresh keys beyond the loaded range
    n_ins = int((ops == OP_INSERT).sum())
    if n_ins:
        keys = keys.copy()
        keys[ops == OP_INSERT] = dist.n_keys + np.arange(n_ins)
    scan_lens = None
    if s > 0:
        scan_lens = np.zeros(n_ops, dtype=np.int64)
        is_scan = ops == OP_SCAN
        scan_lens[is_scan] = rng.integers(1, max_scan_len + 1,
                                          size=int(is_scan.sum()))
    return Workload(ops, keys, value_len, scan_lens)


def load_keys(n_keys: int, seed: int = 0) -> np.ndarray:
    """Load-phase insertion order (shuffled, like YCSB load)."""
    rng = np.random.default_rng(seed + 1)
    keys = np.arange(n_keys)
    rng.shuffle(keys)
    return keys


def twitter_like_trace(n_keys: int, n_ops: int, read_ratio: float,
                       sunk_frac: float, hot_frac: float, value_len: int,
                       seed: int = 0) -> Workload:
    """Synthetic trace with prescribed (read ratio, sunk-read fraction,
    hot-read fraction) — the axes of paper Fig. 9.

    * a `hot` read re-reads a recently-read key (drawn from a small
      working set) — promotable;
    * a `sunk` read targets keys that have not been written recently
      (the bottom of the key space, which the load phase left in SD);
    * other reads hit recently-written keys (still in FD);
    * writes update a skewed subset (recently-written set).
    """
    rng = np.random.default_rng(seed)
    ops = np.where(rng.random(n_ops) < read_ratio, OP_READ, OP_UPDATE)
    hot_set = rng.integers(0, n_keys, size=max(1, int(0.03 * n_keys)))
    recent_w = rng.integers(0, n_keys, size=max(1, int(0.10 * n_keys)))
    # batch class selection (no per-op Python loop): reads split into
    # hot-and-sunk / sunk-cold / recent by one uniform draw per op;
    # writes always target the recently-written set.
    u = rng.random(n_ops)
    reads = ops == OP_READ
    hot_sel = reads & (u < hot_frac * sunk_frac)
    sunk_sel = reads & ~hot_sel & (u < sunk_frac)
    recent_sel = ~hot_sel & ~sunk_sel
    keys = np.empty(n_ops, dtype=np.int64)
    keys[hot_sel] = hot_set[rng.integers(0, len(hot_set),
                                         size=int(hot_sel.sum()))]
    keys[sunk_sel] = rng.integers(0, n_keys, size=int(sunk_sel.sum()))
    keys[recent_sel] = recent_w[rng.integers(0, len(recent_w),
                                             size=int(recent_sel.sum()))]
    return Workload(ops, keys, value_len)


def dynamic_stages(n_keys: int, ops_per_stage: int, value_len: int,
                   seed: int = 0) -> list[tuple[str, Workload]]:
    """Paper Fig. 15: uniform, then hotspot 2→4→6→8→5→5'(shifted)→3→1%.

    Expanding hotspots contain the previous one; the second 5% stage is
    non-overlapping with the first; shrinking ones are contained."""
    stages = [("uniform", None), ("hs2", 0.02), ("hs4", 0.04),
              ("hs6", 0.06), ("hs8", 0.08), ("hs5a", 0.05),
              ("hs5b", 0.05), ("hs3", 0.03), ("hs1", 0.01)]
    out = []
    for si, (name, frac) in enumerate(stages):
        if frac is None:
            dist = KeyDist("uniform", n_keys)
        else:
            offset = 0.5 if name == "hs5b" else 0.0   # non-overlapping shift
            dist = KeyDist("hotspot", n_keys, hot_frac=frac,
                           hot_offset=offset)
        out.append((name, ycsb("RO", dist, ops_per_stage, value_len,
                               seed=seed + si)))
    return out
