"""Metrics plane: fixed-memory log-bin latency histograms and a
ring-buffered time-series registry sampled on a sim-time cadence.

Histograms
----------
`LatencyHistogram` covers [100ns, 100s) with 32 bins per decade
(ratio 10^(1/32) ≈ 1.075 between bin edges) plus an underflow bin for
exact zeros and an overflow bin.  Counts are exact; a percentile is
answered with the *geometric midpoint* of the bin holding that rank,
so any quantile is reproduced within one bin width of the exact
per-sample answer — the contract `tests/test_obs.py` proves against
``np.percentile``.  Memory is a fixed ~2.3KB regardless of op count,
replacing the runner's former unbounded per-op latency arrays.

`TierLatencyHistogram` is the 2-D version the runner actually needs:
per-op latency is ``fd_delta/(1-rho_fd) + sd_delta/(1-rho_sd)`` where
the utilization terms are only known at run *end*, so the sum cannot
be binned online.  It bins the raw ``(fd_delta, sd_delta)`` pairs into
a joint grid during the run (amortized via a small vectorized flush
buffer) and evaluates ``percentile(q, a, b)`` = quantile of
``a·fd + b·sd`` over the joint mass afterwards, for any inflation
coefficients.  Both per-term representatives are within one bin width,
so the recovered quantile is too.

Time series
-----------
`Series` is a (t, value) ring buffer; `MetricsRegistry.maybe_sample`
reads engine aggregates (never writes — see the stats-discipline lint)
every `interval_s` simulated seconds, producing autotuner-ready series
like ``fd_hit_rate(t)``, ``hot_set_bytes(t)``, ``migration_bytes(t)``,
and mirrors per-device busy/byte counters onto the trace's counter
tracks.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["LatencyHistogram", "TierLatencyHistogram", "Series",
           "MetricsRegistry", "LOG_LO", "LOG_HI", "BINS_PER_DECADE",
           "BIN_RATIO"]

LOG_LO = 1e-7                 # 100ns: below any simulated device charge
LOG_HI = 1e2                  # 100s:  above any sane per-op latency
BINS_PER_DECADE = 32
_DECADES = int(round(math.log10(LOG_HI / LOG_LO)))
_NBINS = _DECADES * BINS_PER_DECADE
BIN_RATIO = 10.0 ** (1.0 / BINS_PER_DECADE)

# edges[0]=LOG_LO .. edges[_NBINS]=LOG_HI; slot 0 is [0, LOG_LO)
# (underflow, representative 0.0 — exact for the common "free op"
# case), slot _NBINS+1 is [LOG_HI, inf) represented by LOG_HI.
_EDGES = np.logspace(math.log10(LOG_LO), math.log10(LOG_HI),
                     num=_NBINS + 1)
_REPS = np.empty(_NBINS + 2)
_REPS[0] = 0.0
_REPS[1:-1] = np.sqrt(_EDGES[:-1] * _EDGES[1:])
_REPS[-1] = LOG_HI


class LatencyHistogram:
    """Exact-count, bounded-memory log-bin histogram of seconds."""

    __slots__ = ("counts", "sum", "max")

    def __init__(self):
        self.counts = np.zeros(_NBINS + 2, dtype=np.int64)
        self.sum = 0.0
        self.max = 0.0

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def add(self, x: float) -> None:
        self.counts[int(np.searchsorted(_EDGES, x, side="right"))] += 1
        self.sum += x
        if x > self.max:
            self.max = x

    def add_many(self, xs: np.ndarray) -> None:
        if len(xs) == 0:
            return
        idx = np.searchsorted(_EDGES, xs, side="right")
        np.add.at(self.counts, idx, 1)
        self.sum += float(xs.sum())
        self.max = max(self.max, float(xs.max()))

    def merge(self, other: "LatencyHistogram") -> None:
        self.counts += other.counts
        self.sum += other.sum
        self.max = max(self.max, other.max)

    def percentile(self, q: float) -> float:
        total = self.count
        if total == 0:
            return 0.0
        rank = max(1, int(math.ceil(q * total)))
        cum = np.cumsum(self.counts)
        return float(_REPS[int(np.searchsorted(cum, rank))])

    @property
    def mean(self) -> float:
        n = self.count
        return self.sum / n if n else 0.0

    def to_json(self) -> dict:
        nz = np.nonzero(self.counts)[0]
        return {"unit": "seconds", "bins_per_decade": BINS_PER_DECADE,
                "lo": LOG_LO, "hi": LOG_HI, "count": self.count,
                "mean": self.mean, "max": self.max,
                "nonzero_bins": {int(i): int(self.counts[i]) for i in nz},
                "p50": self.percentile(0.50), "p99": self.percentile(0.99),
                "p999": self.percentile(0.999)}


class TierLatencyHistogram:
    """Joint (fd, sd) per-op device-time histogram; quantiles of
    ``a·fd + b·sd`` recoverable for run-end inflation coefficients."""

    __slots__ = ("counts", "_buf_fd", "_buf_sd", "_bn", "sum_fd", "sum_sd")
    _BUF = 2048

    def __init__(self):
        self.counts = np.zeros((_NBINS + 2, _NBINS + 2), dtype=np.int64)
        self._buf_fd = np.empty(self._BUF)
        self._buf_sd = np.empty(self._BUF)
        self._bn = 0
        self.sum_fd = 0.0
        self.sum_sd = 0.0

    def add(self, fd: float, sd: float) -> None:
        n = self._bn
        self._buf_fd[n] = fd
        self._buf_sd[n] = sd
        self._bn = n + 1
        if self._bn == self._BUF:
            self._flush()

    def add_many(self, fd: np.ndarray, sd: np.ndarray) -> None:
        self._flush()
        i = np.searchsorted(_EDGES, fd, side="right")
        j = np.searchsorted(_EDGES, sd, side="right")
        np.add.at(self.counts, (i, j), 1)
        self.sum_fd += float(np.sum(fd))
        self.sum_sd += float(np.sum(sd))

    def _flush(self) -> None:
        if self._bn == 0:
            return
        fd = self._buf_fd[:self._bn]
        sd = self._buf_sd[:self._bn]
        self._bn = 0
        self.add_many(fd.copy(), sd.copy())

    @property
    def count(self) -> int:
        self._flush()
        return int(self.counts.sum())

    def merge(self, other: "TierLatencyHistogram") -> None:
        self._flush()
        other._flush()
        self.counts += other.counts
        self.sum_fd += other.sum_fd
        self.sum_sd += other.sum_sd

    def percentile(self, q: float, a: float = 1.0, b: float = 1.0) -> float:
        """Quantile q of ``a·fd + b·sd`` over the joint mass."""
        self._flush()
        total = int(self.counts.sum())
        if total == 0:
            return 0.0
        vals = (a * _REPS[:, None] + b * _REPS[None, :]).ravel()
        weights = self.counts.ravel()
        order = np.argsort(vals, kind="stable")
        cum = np.cumsum(weights[order])
        rank = max(1, int(math.ceil(q * total)))
        return float(vals[order[int(np.searchsorted(cum, rank))]])

    @property
    def mean(self) -> float:
        n = self.count
        return (self.sum_fd + self.sum_sd) / n if n else 0.0

    def to_json(self) -> dict:
        self._flush()
        i, j = np.nonzero(self.counts)
        return {"unit": "seconds", "bins_per_decade": BINS_PER_DECADE,
                "lo": LOG_LO, "hi": LOG_HI, "count": self.count,
                "mean_fd": (self.sum_fd / max(1, self.count)),
                "mean_sd": (self.sum_sd / max(1, self.count)),
                "nonzero_cells": [[int(a_), int(b_), int(self.counts[a_, b_])]
                                  for a_, b_ in zip(i, j)]}


class Series:
    """Fixed-capacity (t, value) ring buffer."""

    __slots__ = ("name", "_t", "_v", "_n", "_head")

    def __init__(self, name: str, capacity: int = 4096):
        self.name = name
        self._t = np.zeros(capacity)
        self._v = np.zeros(capacity)
        self._n = 0
        self._head = 0

    def append(self, t: float, v: float) -> None:
        cap = len(self._t)
        self._t[self._head] = t
        self._v[self._head] = v
        self._head = (self._head + 1) % cap
        if self._n < cap:
            self._n += 1

    def __len__(self) -> int:
        return self._n

    def values(self) -> tuple[np.ndarray, np.ndarray]:
        """(t, v) in chronological order (oldest retained first)."""
        cap = len(self._t)
        if self._n < cap:
            return self._t[:self._n].copy(), self._v[:self._n].copy()
        idx = (np.arange(cap) + self._head) % cap
        return self._t[idx], self._v[idx]

    def last(self) -> float:
        if self._n == 0:
            return 0.0
        return float(self._v[(self._head - 1) % len(self._t)])


class MetricsRegistry:
    """Cadenced read-only sampler of engine aggregates."""

    SERIES = ("fd_hit_rate", "scan_fd_hit_rate", "hot_set_bytes",
              "migration_bytes", "n_shards", "promoted_bytes",
              "retained_bytes", "compaction_bytes", "pc_inserts",
              "cache_hit_rate")

    def __init__(self, interval_s: float = 0.02, capacity: int = 4096,
                 enabled: bool = True):
        self.enabled = enabled
        self.interval_s = interval_s
        self.series = {name: Series(name, capacity) for name in self.SERIES}
        self._next_t = 0.0
        self.n_samples = 0

    def maybe_sample(self, now: float, db, tracer=None) -> None:
        if not self.enabled or now < self._next_t:
            return
        self._next_t = now + self.interval_s
        self._sample(now, db, tracer)

    def _sample(self, now: float, db, tracer) -> None:
        self.n_samples += 1
        st = db.stats
        add = self.series
        gets = max(1, st.gets)
        fd_hits = st.served_mem + st.served_fd + st.served_pc
        add["fd_hit_rate"].append(now, fd_hits / gets)
        scanned = max(1, st.scan_served_fd + st.scan_served_sd)
        add["scan_fd_hit_rate"].append(now, st.scan_served_fd / scanned)
        add["promoted_bytes"].append(now, st.promoted_bytes)
        add["retained_bytes"].append(now, st.retained_bytes)
        add["compaction_bytes"].append(now, st.compaction_bytes)
        add["pc_inserts"].append(now, st.pc_inserts)
        shards = getattr(db, "shards", None) or [db]
        add["n_shards"].append(now, len(shards))
        hot = sum(sh.ralt.hot_set_bytes for sh in shards
                  if sh.ralt is not None)   # baselines track no RALT
        add["hot_set_bytes"].append(now, hot)
        rep = getattr(db, "repartitioner", None)
        add["migration_bytes"].append(
            now, (rep.migrated_read_bytes + rep.migrated_write_bytes)
            if rep is not None else 0.0)
        bc_total = sum(sh.block_cache.hits + sh.block_cache.misses
                       for sh in shards)
        bc_hits = sum(sh.block_cache.hits for sh in shards)
        add["cache_hit_rate"].append(now, bc_hits / max(1, bc_total))
        if tracer is not None and tracer.enabled:
            for sh in shards:
                track = getattr(sh, "_obs_track", "db")
                for tier, tot in sh.storage.device_totals().items():
                    tracer.counter(f"{track}/{tier}", "busy_s",
                                   {"fg": round(tot["fg"], 6),
                                    "bg": round(tot["bg"], 6)})
            tracer.counter("cluster", "hot_set_bytes", {"bytes": hot})

    def to_json(self) -> dict:
        out = {"interval_s": self.interval_s, "n_samples": self.n_samples,
               "series": {}}
        for name, s in self.series.items():
            t, v = s.values()
            out["series"][name] = {"t": [round(float(x), 6) for x in t],
                                   "v": [float(x) for x in v]}
        return out
