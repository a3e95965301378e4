"""RALT — Recent Access Lookup Table (paper §3.2, §3.7), on the device.

The port of `repro.core.ralt`.  A small, specially-made LSM-tree on FD
that logs record accesses:

  access record = (key, value_len, tick, score [, c, tag, epoch])

* scores use exponential smoothing with the lazy (tick, score)
  representation and the paper's merge rule (core/scoring.py);
* an in-memory *unsorted* buffer on the host absorbs inserts (critical
  path of lookups) and is sorted+flushed to a run on the device when
  full;
* sorted runs are tensors — one (5, n) int64 tensor of keys, vlens,
  ticks, tags and epochs and one (2, n) float64 tensor of scores and
  counters, so a merge moves two tensors, not seven — and carry (a) a
  bloom filter over their *hot* keys (14 bits/key) and (b) index blocks
  storing, per 16 KiB data block, the first key and the prefix sum of
  the HotRAP size of hot keys — O(1) range hot-set-size queries;
* the runs' blooms and index blocks are also stacked into one
  `RunsIndex`, rebuilt when the runs change, so a hotness or
  range-hotness query over every run is one set of launches;
* eviction drops ~beta of the records using the paper's *sampling*
  threshold and merges the survivors into one run;
* the auto-tuner (paper Alg. 1) runs at eviction time.

Exactness against the float64 numpy reference is designed in:

* every decay alpha**dt has an integer exponent and is read from one
  table ``np.power(alpha, np.arange(n))`` copied to the device and
  grown on demand (`decay`): the values `np.power` gives the reference,
  where ``torch.pow`` and ``exp(dt * log(alpha))`` differ in the last
  bit for some exponents;
* ``np.lexsort`` is stable sorts, the least significant key first;
* ``np.add.at`` over the merged groups is a sum in the reference's
  order: the groups are contiguous after the sort, and step k adds the
  k-th member of every group (`group_sum`), never CUDA's atomic
  ``index_add_``;
* `sample_thresholds` draws from the reference's numpy Generator on the
  host; its prefix sums of integer sizes are exact.

The float64 scores do not go through the float32 ``ralt_update``
kernel of `kernels/ralt_score.py`, which would change them.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..obs import NULL_OBS
from . import scoring
from .sstable import (_LOW31, BLOCK_BYTES, KEY_BYTES, BloomFilter,
                      _mults, bloom_k, bloom_nbits, bounds, lexsort)
from .storage import StorageSim

PHYS_RECORD_BYTES = (KEY_BYTES + 4) + 4 * 3 + 2
RALT_BITS_PER_KEY = 14   # paper: 14-bit blooms for hot keys

_POW: dict = {}


def decay(alpha: float, dt: torch.Tensor, bound: int) -> torch.Tensor:
    """alpha ** dt for integer exponents 0 <= dt <= bound, as float64 on
    dt's device: a gather from a table of `np.power` values, grown on
    demand to cover `bound`."""
    key = (alpha, dt.device)
    table = _POW.get(key)
    if table is None or len(table) <= bound:
        n = max(1024, 2 * bound + 2)
        table = _POW[key] = torch.from_numpy(
            np.power(alpha, np.arange(n))).to(dt.device)
    return table[dt]


_POW_HOST: dict = {}


def decay_host(alpha: float, dt: np.ndarray, bound: int) -> np.ndarray:
    """`decay` on the host: a gather from the same `np.power` table."""
    table = _POW_HOST.get(alpha)
    if table is None or len(table) <= bound:
        n = max(1024, 2 * bound + 2)
        table = _POW_HOST[alpha] = np.power(alpha, np.arange(n))
    return table[dt]


def group_sum(x: torch.Tensor, first: torch.Tensor,
              counts: torch.Tensor) -> torch.Tensor:
    """Sums of each contiguous group of every row of `x` (c, n) (groups
    start at `first` and hold `counts` members), added member by member
    from 0.0 in group order: `np.add.at`'s result on a sorted group
    index.  Takes as many steps as the largest group has members."""
    out = torch.zeros(x.shape[0], len(first), dtype=x.dtype,
                      device=x.device)
    if not len(first):
        return out
    # every member of every group in one gather: (c, k, groups), 0.0
    # past a group's end
    ks = torch.arange(int(counts.max()), device=x.device)[:, None]
    members = torch.where(counts > ks,
                          x[:, (first + ks).clamp(max=x.shape[1] - 1)], 0.0)
    for k in range(members.shape[1]):
        out = out + members[:, k]
    return out


@dataclasses.dataclass
class RaltConfig:
    fd_size: int                       # bytes of FD (drives tick + R)
    hot_set_limit: int                 # initial: 0.5 * FD (paper §4.1)
    phys_limit: int                    # initial: 0.15 * FD
    beta: float = 0.10                 # eviction fraction
    gamma: float = scoring.GAMMA       # tick every gamma * FD bytes accessed
    alpha: float = scoring.ALPHA
    buffer_bytes: int = 64 * 1024      # unsorted buffer flush threshold
    n_samples: int = 256               # eviction threshold sampling
    # --- auto-tuning (paper §3.7) ---
    autotune: bool = True
    delta_c: float = 2.6
    c_max: float = 5.0
    l_hs_frac: float = 0.05            # L_hs = 0.05 * FD
    r_hs_frac: float = 0.70            # R_hs = 0.70 * FD
    d_hs_frac: float = 0.10            # D_hs = 0.10 * R_hs

    @property
    def tick_bytes(self) -> int:
        return max(1, int(self.gamma * self.fd_size))

    @property
    def r_bytes(self) -> int:          # R = R_hs (paper implementation detail)
        return max(1, int(self.r_hs_frac * self.fd_size))

    @property
    def l_hs(self) -> int:
        return int(self.l_hs_frac * self.fd_size)

    @property
    def r_hs(self) -> int:
        return int(self.r_hs_frac * self.fd_size)

    @property
    def d_hs(self) -> int:
        return int(self.d_hs_frac * self.r_hs)


# rows of a run's int64 and float64 tensors
KEY, VLEN, TICK, TAG, EPOCH = range(5)
SCORE, CNT = range(2)


class RaltRun:
    """One sorted run of access records, with hot-key bloom + index blocks.
    `ints` (5, n) holds keys, vlens, ticks, tags and epochs; `floats`
    (2, n) scores and counters.  Its hot bytes, bounds and sizes are
    Python ints, read once."""

    __slots__ = ("ints", "floats", "hot_mask", "bloom", "block_first_key",
                 "block_cum_hot", "hot_bytes", "phys_bytes", "n", "min_key",
                 "max_key")

    def __init__(self, ints: torch.Tensor, floats: torch.Tensor,
                 hot_threshold: float, now_tick: int, alpha: float):
        self.ints = ints
        self.floats = floats
        keys, vlens = ints[KEY], ints[VLEN]
        self.n = n = ints.shape[1]
        cur = floats[SCORE] * decay(alpha, now_tick - ints[TICK], now_tick)
        self.hot_mask = hot = cur >= hot_threshold
        # HotRAP sizes of records; hot prefix sums at block granularity.
        hot_sizes = torch.where(hot, vlens + KEY_BYTES, 0)
        cum = torch.cumsum(hot_sizes, 0)
        self.phys_bytes = n * PHYS_RECORD_BYTES
        # index blocks: one entry per data block of PHYS records
        per_block = max(1, BLOCK_BYTES // PHYS_RECORD_BYTES)
        starts = torch.arange(0, n, per_block, device=keys.device)
        self.block_first_key = keys[starts] if n else keys
        # cumulative hot size *before* each block
        self.block_cum_hot = torch.zeros(max(len(starts), 1),
                                         dtype=torch.int64,
                                         device=keys.device)
        if len(starts) > 1:
            self.block_cum_hot[1:] = cum[starts[1:] - 1]
        stats = (torch.stack([cum[-1], keys[0], keys[-1], hot.sum()]).tolist()
                 if n else [0, None, None, 0])
        self.hot_bytes, self.min_key, self.max_key, n_hot = stats
        # the bloom filter over the hot keys, built over every key with
        # the cold ones' bits sent to one bit past the filter's end
        nbits = bloom_nbits(n_hot, RALT_BITS_PER_KEY)
        bits = torch.zeros(nbits + 1, dtype=torch.bool, device=keys.device)
        if n:
            h = keys.reshape(-1, 1) * _mults(bloom_k(RALT_BITS_PER_KEY),
                                             keys.device)
            idx = ((h >> 33) & _LOW31) % nbits
            bits[torch.where(hot[:, None], idx, nbits)] = True
        self.bloom = BloomFilter.of_bits(bits[:nbits], n_hot,
                                         RALT_BITS_PER_KEY)

    keys = property(lambda self: self.ints[KEY])
    vlens = property(lambda self: self.ints[VLEN])
    ticks = property(lambda self: self.ints[TICK])
    tags = property(lambda self: self.ints[TAG])
    epochs = property(lambda self: self.ints[EPOCH])
    scores = property(lambda self: self.floats[SCORE])
    cnts = property(lambda self: self.floats[CNT])

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.ints, self.floats, self.hot_mask, self.bloom.bits,
                self.block_first_key, self.block_cum_hot)

    def slice_range(self, lo: int, hi: int):
        return slice(*bounds(self.keys, lo, hi))


class RunsIndex:
    """Every run's hot-key bloom and index blocks, stacked: the bloom
    bits concatenated (each run at its offset, with its own bit count)
    and the index blocks padded to one (runs, blocks) matrix, so
    `is_hot_many` and `range_hot_bytes_many` over all runs are one set
    of launches.  Answers are the per-run ones combined."""

    _PAD = (1 << 63) - 1          # sorts after every key

    def __init__(self, runs: list[RaltRun], device: torch.device):
        self.k = runs[0].bloom.k
        assert all(r.bloom.k == self.k for r in runs)
        nbits = [r.bloom.nbits for r in runs]
        offs = np.concatenate([[0], np.cumsum(nbits)[:-1]])
        L = [len(r.block_cum_hot) for r in runs]
        meta = torch.tensor(
            [nbits, offs.tolist(), L, [r.hot_bytes for r in runs],
             [r.max_key if r.n else -1 for r in runs],
             [r.min_key if r.n else 0 for r in runs],
             [r.n for r in runs]], dtype=torch.int64).to(device)
        (self.nbits, self.offs, self.L, self.hot, self.max_key,
         self.min_key, self.n) = (m[:, None] for m in meta.unbind(0))
        self.bits = torch.cat([r.bloom.bits for r in runs])
        self.first_key = torch.full((len(runs), max(L)), self._PAD,
                                    dtype=torch.int64, device=device)
        self.cum = torch.zeros(len(runs), max(L), dtype=torch.int64,
                               device=device)
        for i, r in enumerate(runs):
            self.first_key[i, :len(r.block_first_key)] = r.block_first_key
            self.cum[i, :L[i]] = r.block_cum_hot

    def is_hot_many(self, keys: torch.Tensor) -> torch.Tensor:
        h = keys.reshape(-1, 1) * _mults(self.k, keys.device)
        base = ((h >> 33) & _LOW31)[:, None, :]             # (m, 1, k)
        idx = base % self.nbits[None] + self.offs[None]     # (m, R, k)
        return self.bits[idx].all(dim=2).any(dim=1)

    def range_hot_bytes_many(self, los: torch.Tensor,
                             his: torch.Tensor) -> torch.Tensor:
        R = self.first_key.shape[0]
        lo = los.reshape(1, -1).expand(R, -1).contiguous()
        hi = his.reshape(1, -1).expand(R, -1).contiguous()
        last = self.L - 1
        bi = torch.minimum(
            (torch.searchsorted(self.first_key, lo, right=True) - 1
             ).clamp(min=0), last)
        bj = torch.searchsorted(self.first_key, hi, right=True)
        hi_cum = torch.where(bj >= self.L, self.hot,
                             self.cum.gather(1, torch.minimum(bj, last)))
        est = (hi_cum - self.cum.gather(1, bi)).clamp(min=0)
        outside = (lo > self.max_key) | (hi < self.min_key) | (self.n == 0)
        return torch.where(outside, 0, est).sum(dim=0)


def _merge_records(parts: list[tuple], alpha: float, now_epoch: int,
                   c_max: float, now_tick: int) -> tuple:
    """k-way merge of RALT record parts, each (ints (5, n), floats
    (2, n)); same-key records fold via the score merge rule; autotune
    counters add (lazily epoch-decremented), tag activates on any
    repeat.  `now_tick` bounds every tick."""
    ints = torch.cat([p[0] for p in parts], dim=1)
    floats = torch.cat([p[1] for p in parts], dim=1)
    n = ints.shape[1]
    if n == 0:
        return ints, floats
    order = lexsort([ints[TICK], ints[KEY]])
    ints, floats = ints[:, order], floats[:, order]
    keys, ticks = ints[KEY], ints[TICK]
    # group boundaries
    new_grp = torch.ones(n, dtype=torch.bool, device=keys.device)
    new_grp[1:] = keys[1:] != keys[:-1]
    first = torch.nonzero(new_grp).reshape(-1)
    counts = torch.diff(first, append=first.new_tensor([n]))
    gid = torch.cumsum(new_grp, 0) - 1
    # score merge: rescale every record to the group's max tick (its
    # last member's: ticks ascend within a group), then sum in order;
    # lazy epoch decrement of the counters, then sum (capped)
    gmax_tick = ticks[first + counts - 1]
    scaled = floats[SCORE] * decay(alpha, gmax_tick[gid] - ticks, now_tick)
    eff_c = (floats[CNT] - (now_epoch - ints[EPOCH])).clamp(min=0.0)
    sums = group_sum(torch.stack([scaled, eff_c]), first, counts)
    sums[CNT] = sums[CNT].clamp(max=c_max)
    out = ints[:, first]
    out[TICK] = gmax_tick
    # tag: 1 if any member tagged, or if group has >= 2 members (repeat hit)
    out[TAG] = torch.where(counts >= 2, 1, out[TAG])
    out[EPOCH] = now_epoch
    return out, sums


def _merge_records_host(ints: np.ndarray, floats: np.ndarray, alpha: float,
                        now_epoch: int, c_max: float,
                        now_tick: int) -> tuple[np.ndarray, np.ndarray]:
    """`_merge_records` of one part held on the host (the buffer's), in
    numpy, as the reference merges it: the same sort, the same decays
    (`decay_host`) and `np.add.at`'s sums in group order, so the merged
    part equals the device's bit for bit."""
    n = ints.shape[1]
    if n == 0:
        return ints, floats
    order = np.lexsort((ints[TICK], ints[KEY]))
    ints, floats = ints[:, order], floats[:, order]
    keys, ticks = ints[KEY], ints[TICK]
    new_grp = np.ones(n, dtype=bool)
    new_grp[1:] = keys[1:] != keys[:-1]
    first = np.flatnonzero(new_grp)
    counts = np.diff(first, append=n)
    gid = np.cumsum(new_grp) - 1
    gmax_tick = ticks[first + counts - 1]
    scaled = floats[SCORE] * decay_host(alpha, gmax_tick[gid] - ticks,
                                        now_tick)
    eff_c = np.maximum(floats[CNT] - (now_epoch - ints[EPOCH]), 0.0)
    sums = np.zeros((2, len(first)))
    np.add.at(sums[SCORE], gid, scaled)
    np.add.at(sums[CNT], gid, eff_c)
    sums[CNT] = np.minimum(sums[CNT], c_max)
    out = ints[:, first]
    out[TICK] = gmax_tick
    out[TAG] = np.where(counts >= 2, 1, out[TAG])
    out[EPOCH] = now_epoch
    return out, sums


def _wall_span(name: str):
    """Time a method as span `name` on its object's track (RALT's, or
    `HotBudget`'s in core/shards.py) under a wall-clock plane
    (`Observability(clock="wall")`); one attribute check otherwise."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(self, *args, **kw):
            obs = self._obs
            if not obs.wall:
                return fn(self, *args, **kw)
            with obs.tracer.span(self._obs_track, name):
                return fn(self, *args, **kw)
        return run
    return wrap


class RALT:
    """The Recent Access Lookup Table; its runs live on `device`."""

    # the engine's observability plane and track (`Observability.attach`
    # wires both); only a wall-clock plane records RALT's spans
    _obs = NULL_OBS
    _obs_track = "db"

    def __init__(self, cfg: RaltConfig, storage: StorageSim,
                 device: torch.device):
        self.cfg = cfg
        self.storage = storage
        self.device = device
        self.buf_keys: list[int] = []
        self.buf_vlens: list[int] = []
        self.buf_ticks: list[int] = []
        # batch inserts (range scans, batched gets) land as whole host
        # numpy chunks of (keys, vlens, ticks, score_weights)
        self.buf_chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]] = []
        self._buf_chunk_len = 0
        self.runs: list[RaltRun] = []     # newest first
        self._index: RunsIndex | None = None
        self.tick = 0
        self.epoch = 0
        self._accessed_since_tick = 0
        self._accessed_since_epoch = 0
        self.hot_threshold = 0.0
        self.hot_set_limit = cfg.hot_set_limit
        self.phys_limit = cfg.phys_limit
        self.n_evictions = 0

    # ------------------------------------------------------------------
    def _advance_clocks(self, nbytes: int) -> None:
        self._accessed_since_tick += nbytes
        if self._accessed_since_tick >= self.cfg.tick_bytes:
            self.tick += self._accessed_since_tick // self.cfg.tick_bytes
            self._accessed_since_tick %= self.cfg.tick_bytes
        self._accessed_since_epoch += nbytes
        if self._accessed_since_epoch >= self.cfg.r_bytes:
            self.epoch += self._accessed_since_epoch // self.cfg.r_bytes
            self._accessed_since_epoch %= self.cfg.r_bytes

    def _maybe_flush_or_evict(self) -> None:
        if ((len(self.buf_keys) + self._buf_chunk_len) * PHYS_RECORD_BYTES
                >= self.cfg.buffer_bytes):
            self._flush_buffer()
        if (self.hot_set_bytes > self.hot_set_limit
                or self.phys_bytes > self.phys_limit):
            self._evict()

    def record_access(self, key: int, vlen: int) -> None:
        """Log one access; advances tick/epoch clocks by accessed bytes."""
        self.buf_keys.append(key)
        self.buf_vlens.append(vlen)
        self.buf_ticks.append(self.tick)
        self._advance_clocks(KEY_BYTES + vlen)
        self._maybe_flush_or_evict()

    @_wall_span("ralt/record")
    def record_range_access(self, lo: int, hi: int, keys: np.ndarray,
                            vlens: np.ndarray) -> None:
        """Vectorized batch analogue of `record_access` for range scans,
        with scan-length-aware scoring: each record's initial score is
        clipped to 1/len(keys), so one scan adds ~one get's worth of
        total score spread over its range.  Clocks advance by the total
        scanned HotRAP bytes."""
        if len(keys) == 0:
            return
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        vlens = np.ascontiguousarray(vlens, dtype=np.int64)
        ticks = np.full(len(keys), self.tick, dtype=np.int64)
        weights = np.full(len(keys), min(1.0, 1.0 / len(keys)))
        self.buf_chunks.append((keys, vlens, ticks, weights))
        self._buf_chunk_len += len(keys)
        nbytes = int(vlens.sum()) + KEY_BYTES * len(keys)
        self._advance_clocks(nbytes)
        self._maybe_flush_or_evict()

    @_wall_span("ralt/record")
    def record_access_many(self, keys: np.ndarray,
                           vlens: np.ndarray) -> None:
        """Vectorized `record_access` for the batched point-read path
        (`TieredLSM.multi_get`): the whole batch lands as one chunk at
        full per-record score.  Per-record ticks are reconstructed from
        the byte prefix-sum, so every record carries exactly the tick it
        would have been logged at had the accesses arrived one by one;
        the clocks then advance by the batch total and the flush/evict
        check runs once at the batch edge."""
        if len(keys) == 0:
            return
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        vlens = np.ascontiguousarray(vlens, dtype=np.int64)
        sizes = vlens + KEY_BYTES
        csum = np.cumsum(sizes)
        before = self._accessed_since_tick + csum - sizes
        ticks = self.tick + before // self.cfg.tick_bytes
        self.buf_chunks.append((keys, vlens, ticks.astype(np.int64),
                                np.ones(len(keys))))
        self._buf_chunk_len += len(keys)
        self._advance_clocks(int(csum[-1]))
        self._maybe_flush_or_evict()

    def seed_records(self, keys: torch.Tensor,
                     vlens: torch.Tensor) -> None:
        """Transplant access records from another RALT (shard-migration
        hotness handoff, core/shards.py): each key lands as one
        full-score access at the current tick and the chunk is flushed
        to a run immediately, so ``hot_set_bytes`` (the HotBudget /
        Repartitioner demand signal) reflects the inherited heat right
        away instead of a fresh shard looking stone cold.  Clocks do not
        advance — a migration is not workload traffic.  ``keys`` and
        ``vlens`` are `scan_hot`'s tensors; they come to the host in one
        copy, as the buffer's chunks live there."""
        if len(keys) == 0:
            return
        keys, vlens = torch.stack([keys, vlens]).cpu().numpy()
        ticks = np.full(len(keys), self.tick, dtype=np.int64)
        self.buf_chunks.append((keys, vlens, ticks, np.ones(len(keys))))
        self._buf_chunk_len += len(keys)
        self._flush_buffer()
        if (self.hot_set_bytes > self.hot_set_limit
                or self.phys_bytes > self.phys_limit):
            self._evict()

    # ------------------------------------------------------------------
    @property
    def hot_set_bytes(self) -> int:
        return sum(r.hot_bytes for r in self.runs)

    @property
    def phys_bytes(self) -> int:
        return (sum(r.phys_bytes for r in self.runs)
                + (len(self.buf_keys) + self._buf_chunk_len)
                * PHYS_RECORD_BYTES)

    def _set_runs(self, runs: list[RaltRun]) -> None:
        self.runs = runs
        self._index = None

    def index(self) -> RunsIndex:
        """The runs' stacked blooms and index blocks (built on first use
        after the runs change)."""
        if self._index is None:
            if self._obs.wall:
                self._obs.tracer.instant(self._obs_track, "ralt_index/build")
            self._index = RunsIndex(self.runs, self.device)
        return self._index

    def is_hot(self, key: int) -> bool:
        """Bloom-filter check across runs (in memory — no I/O, paper §3.2)."""
        return any(r.bloom.may_contain(key) for r in self.runs)

    @_wall_span("ralt/query")
    def is_hot_many(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized `is_hot` over a host key array -> host bool array."""
        if len(keys) == 0 or not self.runs:
            return np.zeros(len(keys), dtype=bool)
        ks = torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int64)
                              ).to(self.device)
        return self.index().is_hot_many(ks).cpu().numpy()

    @_wall_span("ralt/query")
    def hotness(self, lo: int, hi: int, keys: np.ndarray
                ) -> tuple[int, np.ndarray]:
        """(`range_hot_bytes(lo, hi)`, `is_hot_many(keys)`) in one
        device-to-host copy."""
        if not self.runs:
            return 0, np.zeros(len(keys), dtype=bool)
        idx = self.index()
        q = torch.tensor([[lo], [hi]], dtype=torch.int64).to(self.device)
        kd = torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int64)
                              ).to(self.device)
        flat = torch.cat([idx.range_hot_bytes_many(q[0], q[1]),
                          idx.is_hot_many(kd).long()]).cpu().numpy()
        return int(flat[0]), flat[1:].astype(bool)

    def range_hot_bytes(self, lo: int, hi: int) -> int:
        """Estimated hot-set HotRAP size in [lo, hi] (overestimates dups)."""
        return self.range_hot_bytes_many([lo], [hi])[0]

    @_wall_span("ralt/query")
    def range_hot_bytes_many(self, los: list[int], his: list[int]
                             ) -> list[int]:
        """`range_hot_bytes` of every [los[i], his[i]], in one
        device-to-host copy."""
        if not self.runs:
            return [0] * len(los)
        q = torch.tensor([los, his], dtype=torch.int64).to(self.device)
        return self.index().range_hot_bytes_many(q[0], q[1]).tolist()

    @_wall_span("ralt/query")
    def scan_hot(self, lo: int, hi: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Hot keys (sorted, deduped) and their vlens within [lo, hi].

        Charges the sequential RALT read I/O of the touched ranges; used
        by retention's sort-merge iterator (paper Fig. 2 step 4)."""
        parts, nbytes = [], 0
        for r in self.runs:
            sl = r.slice_range(lo, hi)
            if sl.stop <= sl.start:
                continue
            nbytes += (sl.stop - sl.start) * PHYS_RECORD_BYTES
            parts.append((r.ints[:, sl], r.floats[:, sl]))
        if nbytes:
            self.storage.seq_read("FD", nbytes, fg=False, component="ralt")
        if not parts:
            e = torch.zeros(0, dtype=torch.int64, device=self.device)
            return e, e.clone()
        ints, floats = _merge_records(parts, self.cfg.alpha, self.epoch,
                                      self.cfg.c_max, self.tick)
        cur = floats[SCORE] * decay(self.cfg.alpha, self.tick - ints[TICK],
                                    self.tick)
        hot = cur >= self.hot_threshold
        return ints[KEY][hot], ints[VLEN][hot]

    # ------------------------------------------------------------------
    def _buffer_part(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Drain the point-access lists and scan chunks into one record
        part, merged on the host (`_merge_records_host`) and sent to the
        device in one copy: point accesses score 1, scan chunks carry
        their scan-length-clipped weights; counters delta_c, tags 0,
        epochs the current one."""
        parts_k, parts_v, parts_t, parts_w = [], [], [], []
        if self.buf_keys:
            parts_k.append(np.array(self.buf_keys, dtype=np.int64))
            parts_v.append(np.array(self.buf_vlens, dtype=np.int64))
            parts_t.append(np.array(self.buf_ticks, dtype=np.int64))
            parts_w.append(np.ones(len(parts_k[-1])))
        for k, v, t, w in self.buf_chunks:
            parts_k.append(k)
            parts_v.append(v)
            parts_t.append(t)
            parts_w.append(w)
        self.buf_keys, self.buf_vlens, self.buf_ticks = [], [], []
        self.buf_chunks, self._buf_chunk_len = [], 0
        n = sum(len(k) for k in parts_k)
        ints = np.zeros((5, n), dtype=np.int64)
        floats = np.empty((2, n))
        if n:
            ints[KEY] = np.concatenate(parts_k)
            ints[VLEN] = np.concatenate(parts_v)
            ints[TICK] = np.concatenate(parts_t)
            floats[SCORE] = np.concatenate(parts_w)
        ints[EPOCH] = self.epoch
        floats[CNT] = self.cfg.delta_c
        ints, floats = _merge_records_host(ints, floats, self.cfg.alpha,
                                           self.epoch, self.cfg.c_max,
                                           self.tick)
        # the ints and the floats' bits in one copy
        d = torch.from_numpy(np.concatenate(
            [ints, floats.view(np.int64)])).to(self.device)
        return d[:5], d[5:].view(torch.float64)

    def _new_run(self, merged) -> RaltRun:
        return RaltRun(*merged, hot_threshold=self.hot_threshold,
                       now_tick=self.tick, alpha=self.cfg.alpha)

    def _merge(self, parts) -> tuple:
        return _merge_records(parts, self.cfg.alpha, self.epoch,
                              self.cfg.c_max, self.tick)

    @_wall_span("ralt/flush")
    def _flush_buffer(self) -> None:
        if not self.buf_keys and not self.buf_chunks:
            return
        run = self._new_run(self._buffer_part())
        self.storage.seq_write("FD", run.phys_bytes, fg=False, component="ralt")
        self._set_runs([run] + self.runs)
        # Leveling-ish maintenance: bound the run count by merging all
        # runs once too many accumulate (RALT is small; the paper merges
        # step-by-step to bound temp space — same I/O, simpler shape).
        if len(self.runs) > 8:
            self._merge_all_runs()

    def _gather_all(self) -> tuple:
        """All records merged: the pending buffer merged on its own (the
        run the reference flushes without I/O first), then with every
        run's records."""
        parts = [(r.ints, r.floats) for r in self.runs]
        if self.buf_keys or self.buf_chunks:
            parts.insert(0, self._buffer_part())
        if not parts:
            return (torch.zeros(5, 0, dtype=torch.int64, device=self.device),
                    torch.zeros(2, 0, dtype=torch.float64,
                                device=self.device))
        return self._merge(parts)

    def _merge_all_runs(self) -> None:
        total_phys = sum(r.phys_bytes for r in self.runs)
        self.storage.seq_read("FD", total_phys, fg=False, component="ralt")
        run = self._new_run(self._gather_all())
        self.storage.seq_write("FD", run.phys_bytes, fg=False, component="ralt")
        self._set_runs([run])

    # ------------------------------------------------------------------
    @staticmethod
    def sample_thresholds(sizes: torch.Tensor, keep: torch.Tensor,
                          scores: torch.Tensor, keep_frac: float,
                          n_samples: int,
                          rng: np.random.Generator) -> list[float]:
        """Paper §3.2 eviction, for each row i of `sizes` (m, n) in row
        order, over the records `keep` selects: sample positions
        uniformly in cumulative size space; the k-th largest sampled
        score (k = N * keep_frac) approximates the threshold S' with
        sum_{S_i >= S'} A_i ~= keep * A.  `sizes` are integers, so their
        float64 prefix sums are exact in any order; the positions are
        the host Generator's draws.  A record left out weighs 0 bytes, so
        no position falls on it, and a position at the total takes the
        last record kept, as the reference's clamp over the kept records
        does.  Two copies to the host in all."""
        cum = torch.cumsum(torch.where(keep, sizes, 0), 1)
        totals = cum[:, -1].tolist() if sizes.shape[1] else [0] * len(sizes)
        if not totals[0]:       # sizes are positive: nothing is kept
            return [0.0] * len(sizes)
        cum = cum.to(torch.float64)
        # each row's positions, then its total less half a byte: the
        # prefix sums are whole bytes, so the first above it is the
        # first at the total, the last record kept
        pos = torch.from_numpy(np.stack([
            np.append(rng.uniform(0.0, float(t), size=n_samples), t - 0.5)
            for t in totals])).to(cum.device)
        idx = torch.searchsorted(cum, pos, right=True)
        idx = torch.minimum(idx[:, :-1], idx[:, -1:])
        sampled = torch.sort(scores[idx], dim=1, descending=True).values
        k = min(max(int(round(n_samples * keep_frac)), 1), n_samples)
        return sampled[:, k - 1].tolist()

    @_wall_span("ralt/evict")
    def _evict(self) -> None:
        """Eviction + merge-all + (optionally) auto-tune (paper Alg. 1)."""
        self.n_evictions += 1
        cfg = self.cfg
        rng = np.random.default_rng(self.n_evictions)
        total_phys_before = self.phys_bytes
        # two full scans: one to sample thresholds, one to merge (paper RA)
        self.storage.seq_read("FD", 2 * total_phys_before, fg=False,
                              component="ralt")
        ints, floats = self._gather_all()
        self._set_runs([])
        n = ints.shape[1]
        if n == 0:
            return
        cur = floats[SCORE] * decay(cfg.alpha, self.tick - ints[TICK],
                                    self.tick)
        hsizes = ints[VLEN] + KEY_BYTES
        eff_c = (floats[CNT] - (self.epoch - ints[EPOCH])).clamp(min=0.0)
        stable = (eff_c > 0) & (ints[TAG] == 1)

        def sizes_of(*masks):   # (hot-set bytes, physical bytes) per mask
            s = torch.stack([x for m in masks
                             for x in ((hsizes * m).sum(), m.sum())]).tolist()
            return [(s[i], s[i + 1] * PHYS_RECORD_BYTES)
                    for i in range(0, len(s), 2)]

        # Alg.1 line 15: first drop old *unstable* records (autotune);
        # the sizes of both candidate keep sets come in one copy
        keep = torch.ones(n, dtype=torch.bool, device=self.device)
        (hot_now, _), (hot_stable, phys_stable), (hot_kept, phys_kept) = \
            sizes_of(cur >= self.hot_threshold, stable, keep)
        hot_total = hot_kept
        if cfg.autotune and (hot_now > self.hot_set_limit
                             or phys_kept > self.phys_limit):
            keep = stable
            hot_kept, phys_kept = hot_stable, phys_stable
        kept_frac = 1.0 - cfg.beta
        # Alg.1 line 16 / §3.2: continue evicting by low score if needed.
        if hot_kept > self.hot_set_limit or phys_kept > self.phys_limit:
            psizes = torch.full((n,), PHYS_RECORD_BYTES, dtype=torch.int64,
                                device=self.device)
            phys_thr, hot_thr = self.sample_thresholds(
                torch.stack([psizes, hsizes]), keep, cur, kept_frac,
                cfg.n_samples, rng)
            # records below the *physical* threshold leave RALT entirely;
            # those between stay but are no longer hot (paper §3.2).
            keep = keep & (cur >= phys_thr)
            self.hot_threshold = max(hot_thr, phys_thr)

        sel = torch.nonzero(keep).reshape(-1)
        kept = ints[:, sel]
        kept[EPOCH] = self.epoch
        run = self._new_run((kept, floats[:, sel]))
        self.storage.seq_write("FD", run.phys_bytes, fg=False, component="ralt")
        self._set_runs([run])

        if cfg.autotune:
            # Alg.1 lines 18-21.
            (t_sz, p_sz), = sizes_of(keep & stable)
            self.hot_set_limit = max(cfg.l_hs, min(t_sz + cfg.d_hs, cfg.r_hs))
            # the mean of integer sizes: their exact sum over the count,
            # correctly rounded, as numpy's float64 mean gives it
            r = PHYS_RECORD_BYTES / max(hot_total / n, 1.0)
            self.phys_limit = int(p_sz + r * cfg.d_hs)

    # ------------------------------------------------------------------
    def memory_usage_bytes(self) -> int:
        """In-memory footprint: blooms + index blocks (paper §3.2), in the
        reference's representation (bit-packed blooms, 8-byte entries)."""
        bloom = sum(r.bloom.nbytes for r in self.runs)
        index = sum(8 * (len(r.block_first_key) + len(r.block_cum_hot))
                    for r in self.runs)
        return bloom + index

    def tensors(self) -> list[torch.Tensor]:
        return [t for r in self.runs for t in r.tensors()]

    def __getstate__(self):
        """Pickle without the observability plane: a copy reads the
        class-level null plane."""
        state = self.__dict__.copy()
        state.pop("_obs", None)
        state.pop("_obs_track", None)
        return state
