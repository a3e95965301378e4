"""Exponential-smoothing hotness scores (paper §3.2).

The score of a key is  sum_i a_i * alpha^(t - i)  over time slices i,
stored lazily as a (tick, score) pair where `score` is exact as of time
slice `tick`.  Reading at current slice t rescales by alpha^(t - tick);
merging two records for the same key rescales the older to the newer
tick and adds:

    merge((t_i, s_i), (t_j, s_j)) with t_i <= t_j
        = (t_j, alpha^(t_j - t_i) * s_i + s_j)

The merge is associative and commutative (up to tick normalisation),
which is what lets RALT merge records in any compaction order.  Scalar
Python, as in `repro.core.scoring`; the record-level float64 version in
`core/ralt.py` reads the decays from one table of `np.power` values.

Defaults per paper: gamma = 0.001 (tick advances every gamma * |FD|
bytes accessed), alpha = 1 - gamma = 0.999.
"""
from __future__ import annotations

GAMMA = 0.001
ALPHA = 1.0 - GAMMA


def value_at(tick: int, score: float, now: int, alpha: float = ALPHA) -> float:
    """Score of a stored (tick, score) record read at time slice `now`."""
    return score * (alpha ** (now - tick))


def merge(tick_i: int, score_i: float, tick_j: int, score_j: float,
          alpha: float = ALPHA) -> tuple[int, float]:
    """Paper's merge rule for two access records of the same key."""
    if tick_i > tick_j:
        tick_i, score_i, tick_j, score_j = tick_j, score_j, tick_i, score_i
    return tick_j, (alpha ** (tick_j - tick_i)) * score_i + score_j


def on_access(tick: int, score: float, now: int,
              alpha: float = ALPHA) -> tuple[int, float]:
    """Fold a new access (worth 1.0 at slice `now`) into a record."""
    return merge(tick, score, now, 1.0, alpha)
