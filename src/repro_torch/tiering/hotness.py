"""RALT hotness tracker over dense unit ids (port of
`repro.tiering.hotness`).

The paper's algorithms, unchanged from the reference:

  * exponential-smoothing scores with lazy decay:
    real_score(now) = alpha^(now - tick) * score   (§3.2), updated by
    the RALT kernel `kernels.ops.ralt_update`;
  * time slices advance every `gamma x fast-tier bytes` accessed (§3.2);
  * eviction / hot-threshold via the paper's *sampling* scheme: sample
    positions uniformly in cumulative-size space, take the k-th largest
    sampled score (§3.2 Fig. 4);
  * auto-tuning of the hot-set size limit via Algorithm 1: counters c
    (+delta_c per hit, capped c_max, -1 per R bytes accessed) and
    stability tags t; limit = clamp(stable_size + D_hs, [L_hs, R_hs]).

Every state scalar is a float32 or int32 0-d tensor on the tracker's
device and all scalar arithmetic is float32, as in the reference: the
slice advance and the R-byte decrement change where slices advance if
they are done in float64.  The R-byte remainder `accr - dec * R` is one
fused multiply-add and the slice remainder is not, as the reference's
XLA CPU backend contracts them.  Constants enter as float32 device
scalars made with `torch.full` (a fill, no host copy), so recording an
access never waits for the host.  Only `sampled_threshold` reads `now`
on the host, to seed the index sampler.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device, to_device
from ..kernels import ops as kops
from ..kernels.ralt_score import fma_f32

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    n_units: int                  # tracked units (pages/experts/rows)
    unit_bytes: int               # HotRAP size of one unit
    fast_bytes: int               # fast-tier capacity in bytes
    alpha: float = 0.999
    gamma: float = 0.001          # time slice per gamma*fast_bytes
    # Algorithm 1
    delta_c: float = 2.6
    c_max: float = 5.0
    hot_lo_frac: float = 0.05     # L_hs / fast_bytes
    hot_hi_frac: float = 0.70     # R_hs
    d_hs_frac: float = 0.10       # D_hs / R_hs
    init_hot_frac: float = 0.50
    n_samples: int = 256          # sampling-based threshold (§3.2)


def _f32(x, device) -> torch.Tensor:
    """A Python number as a float32 device scalar (rounded once, as the
    reference's weakly typed constants are)."""
    return torch.full((), x, dtype=F32, device=device)


def init_state(cfg: TrackerConfig, device) -> dict:
    n = cfg.n_units

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "tick": z(n, I32),
        "score": z(n, F32),
        "c": z(n, F32),                   # Alg. 1 counter
        "t": z(n, torch.bool),            # Alg. 1 stability tag
        "seen": z(n, torch.bool),
        "now": z((), I32),
        "accessed_bytes": z((), F32),     # since last slice
        "accessed_bytes_r": z((), F32),   # since last decrement
        "hot_limit": _f32(cfg.init_hot_frac * cfg.fast_bytes, device),
        "threshold": z((), F32),
    }


def record_accesses(state, hit_mask, cfg: TrackerConfig):
    """Log one batch of accesses (bool mask over units).  Advances the
    time slice when gamma*fast_bytes have been accessed, applies the
    RALT kernel, and runs Alg. 1's counter updates."""
    dev = hit_mask.device
    batch_bytes = hit_mask.sum().to(F32) * _f32(cfg.unit_bytes, dev)
    every = _f32(cfg.gamma * cfg.fast_bytes, dev)
    acc = state["accessed_bytes"] + batch_bytes
    adv = torch.floor_divide(acc, every).to(I32)
    now = state["now"] + adv
    acc = acc - adv.to(F32) * every

    new_tick, new_score, _ = kops.ralt_update(
        state["tick"], state["score"], hit_mask, now, state["threshold"],
        alpha=cfg.alpha)

    # Algorithm 1 counters
    c = torch.where(hit_mask,
                    torch.minimum(state["c"] + _f32(cfg.delta_c, dev),
                                  _f32(cfg.c_max, dev)),
                    state["c"])
    t = state["t"] | (hit_mask & state["seen"])
    seen = state["seen"] | hit_mask

    # decrement sweep every R bytes accessed
    R = _f32(cfg.hot_hi_frac * cfg.fast_bytes, dev)
    accr = state["accessed_bytes_r"] + batch_bytes
    dec = torch.floor_divide(accr, R)
    accr = fma_f32(-dec, R, accr)
    c = torch.clamp(c - dec, min=0.0)
    t = t & (c > 0)

    return {**state, "tick": new_tick, "score": new_score, "c": c,
            "t": t, "seen": seen, "now": now, "accessed_bytes": acc,
            "accessed_bytes_r": accr}


def current_scores(state, cfg: TrackerConfig):
    """Lazily-decayed scores at `now` (§3.2 real_score)."""
    dt = (state["now"] - state["tick"]).to(F32)
    return state["score"] * torch.pow(_f32(cfg.alpha, dt.device), dt)


def seeded_sampler(device):
    """The default index source of `sampled_threshold`: uniform unit ids
    from a `torch.Generator` seeded from (17, now).  The reference draws
    `jax.random.randint(fold_in(key(17), now))`, which torch cannot
    reproduce; parity tests inject the reference's draws instead."""
    def sample(now: int, n: int, n_units: int) -> torch.Tensor:
        g = torch.Generator(device=device)
        g.manual_seed((17 << 32) + now)
        return torch.randint(0, n_units, (n,), generator=g, device=device)
    return sample


def sampled_threshold(state, cfg: TrackerConfig, target_bytes, sampler):
    """The paper's eviction-threshold sampling (§3.2, Fig. 4).

    Sample n positions uniformly in cumulative-size space (uniform unit
    sizes => uniform unit ids), take the k-th largest sampled score
    where k = n * target_bytes / total_bytes.  `sampler(now, n, n_units)`
    returns the n sampled unit ids."""
    scores = current_scores(state, cfg)
    dev = scores.device
    n = cfg.n_samples
    idx = to_device(sampler(int(state["now"]), n, cfg.n_units),
                    dev).long()
    samp = torch.sort(scores[idx], descending=True).values
    total = cfg.n_units * cfg.unit_bytes
    k = (_f32(n, dev) * target_bytes / _f32(total, dev)).to(I32)
    return samp[k.clamp(0, n - 1).long()]


def update_limits(state, cfg: TrackerConfig, sampler):
    """Alg. 1 lines 18–21: hot-set limit from the stable-record size;
    refresh the hot threshold from the sampled quantile."""
    dev = state["c"].device
    stable = (state["c"] > 0) & state["t"]
    stable_bytes = stable.sum().to(F32) * _f32(cfg.unit_bytes, dev)
    L = cfg.hot_lo_frac * cfg.fast_bytes
    Rl = cfg.hot_hi_frac * cfg.fast_bytes
    D = cfg.d_hs_frac * Rl
    hot_limit = torch.maximum(
        _f32(L, dev),
        torch.minimum(stable_bytes + _f32(D, dev), _f32(Rl, dev)))
    threshold = sampled_threshold(state, cfg, hot_limit, sampler)
    return {**state, "hot_limit": hot_limit, "threshold": threshold}


def hot_mask(state, cfg: TrackerConfig):
    """Units currently above the hot threshold (bounded by hot_limit
    through the threshold construction)."""
    dev = state["threshold"].device
    return current_scores(state, cfg) >= torch.maximum(
        state["threshold"], _f32(1e-6, dev))


class HotTracker:
    """Stateful wrapper over the functions above.  `sampler` is the index
    source of `sampled_threshold` (default: `seeded_sampler`)."""

    def __init__(self, cfg: TrackerConfig, device=None, sampler=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = init_state(cfg, self.device)
        self.sampler = sampler or seeded_sampler(self.device)

    def record(self, hit_mask):
        self.state = record_accesses(self.state, hit_mask, self.cfg)

    def record_ids(self, ids):
        mask = torch.zeros(self.cfg.n_units, dtype=torch.bool,
                           device=self.device)
        mask[to_device(ids, self.device).long()] = True
        self.record(mask)

    def refresh_limits(self):
        self.state = update_limits(self.state, self.cfg, self.sampler)

    def hot(self):
        return hot_mask(self.state, self.cfg)

    def scores(self):
        return current_scores(self.state, self.cfg)
