"""Tiered MoE expert weights: hot experts resident in device memory (port
of `repro.tiering.expert_cache`).

qwen3-moe has 128 experts x 36 MiB (bf16, d=4096, ff=1536, 3 mats) per
layer — 4.5 GiB a layer, 423 GiB over its 94 layers: far beyond device
memory at small serving footprints, with Zipf-skewed routing in
production traces.  The RALT tracker scores experts by the steps that
route to them; swaps follow the paper's pathways (retention of hot
residents during eviction, batch promotion of hot non-residents).
Unlike KV pages, expert weights are immutable during serving => no
version hazard.

The blobs (E, ...) live in host memory (pinned when the device is CUDA),
the resident cache (fast_experts, ...) on the device; the slot tables
are host numpy and the sweep ranks experts with the reference's
`np.argsort(-scores)`, so either device swaps the same experts.  Each
step is one tracker record of the experts it used: one `ralt_record`
launch on CUDA.  `SimClock` charges blob moves at the bandwidths the
caller passes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import host_tensor, resolve_device
from ..obs.serving import NULL_SERVING_OBS
from .hotness import HotTracker, TrackerConfig
from .kvcache import SimClock


class ExpertCache:
    # Observability is compiled out: class-level null plane, one
    # attribute check per site.
    _obs = NULL_SERVING_OBS
    _obs_track = "expert"

    def __init__(self, expert_weights, fast_experts: int,
                 swap_every: int = 16, *, hbm_bw: float, pcie_bw: float,
                 device=None, sampler=None):
        """expert_weights: host array or CPU tensor (E, ...) — one blob
        per expert.  `hbm_bw` / `pcie_bw`: bytes/s that `SimClock`
        charges for a resident and a streamed blob.  `sampler`: index
        source of the tracker's threshold sampling."""
        self.device = resolve_device(device)
        self.host = host_tensor(expert_weights, self.device)
        E = self.host.shape[0]
        self.E = E
        self.hbm_bw = float(hbm_bw)
        self.pcie_bw = float(pcie_bw)
        self.fast_experts = fast_experts
        self.blob_bytes = self.host[0].numel() * self.host.element_size()
        self.cache = torch.zeros((fast_experts, *self.host.shape[1:]),
                                 dtype=self.host.dtype, device=self.device)
        self.slot_of = np.full(E, -1, np.int64)
        self.expert_of_slot = np.full(fast_experts, -1, np.int64)
        self.free = list(range(fast_experts))[::-1]
        self.tracker = HotTracker(TrackerConfig(
            n_units=E, unit_bytes=self.blob_bytes,
            fast_bytes=fast_experts * self.blob_bytes), device=self.device,
            sampler=sampler)
        self.clock = SimClock()
        self.swap_every = swap_every
        self._steps = 0

    def route(self, expert_counts: np.ndarray):
        """Record one step's router histogram (E,) and charge the weights'
        fetch.  Resident experts are device reads; non-resident experts
        are streamed from the host (PCIe) for this step."""
        obs, c = self._obs, self.clock
        if obs.enabled:
            t0 = c.total_s
            s0, m0 = c.slow_hits, c.sweeps
        used = np.nonzero(np.asarray(expert_counts) > 0)[0]
        self.tracker.record_ids(used)
        for e in used:
            if self.slot_of[e] >= 0:
                self.clock.hbm_s += self.blob_bytes / self.hbm_bw
                self.clock.fast_hits += 1
            else:
                self.clock.pcie_s += self.blob_bytes / self.pcie_bw
                self.clock.slow_hits += 1
        self._steps += 1
        if self._steps % self.swap_every == 0:
            self.rebalance()
        if obs.enabled:
            if obs.attribution:
                obs.attr.observe("expert", c.total_s - t0, len(used),
                                 c.slow_hits - s0, c.sweeps > m0)
            obs.on_access()

    def rebalance(self):
        """Sweep: retain hot residents, demote cold ones, promote the
        hottest non-residents into freed slots."""
        obs, c = self._obs, self.clock
        if obs.enabled:
            obs.tracer.begin(
                self._obs_track, "expert/rebalance",
                {"resident": int((self.expert_of_slot >= 0).sum())})
            r0, d0, p0 = c.retained, c.demoted, c.promoted
        self.tracker.refresh_limits()
        scores = self.tracker.host_scores()
        hot = self.tracker.hot().cpu().numpy()
        order = np.argsort(-scores)
        want = [int(e) for e in order[:self.fast_experts] if hot[e]]
        want_set = set(want)
        for s, e in enumerate(self.expert_of_slot):
            if e >= 0 and e not in want_set:
                self.slot_of[e] = -1
                self.expert_of_slot[s] = -1
                self.free.append(int(s))
                self.clock.demoted += 1
            elif e >= 0:
                self.clock.retained += 1
        new = [e for e in want if self.slot_of[e] < 0]
        slots = []
        for e in new:
            if not self.free:
                break
            s = self.free.pop()
            slots.append(s)
            self.slot_of[e] = s
            self.expert_of_slot[s] = e
        for s, e in zip(slots, new):
            # a blob is one contiguous host view: one queued copy each
            self.cache[s].copy_(self.host[e], non_blocking=True)
        if slots:
            self.clock.pcie_s += len(slots) * self.blob_bytes / self.pcie_bw
            self.clock.promoted += len(slots)
        c.sweeps += 1
        if obs.enabled:
            tr, track = obs.tracer, self._obs_track
            if c.retained > r0:                       # retention pathway
                tr.instant(track, "page/retained",
                           {"pages": c.retained - r0})
            if c.promoted > p0:                       # promo-by-compaction
                tr.instant(track, "page/promo_compaction",
                           {"pages": c.promoted - p0})
            tr.end(track, "expert/rebalance",
                   {"demoted": c.demoted - d0,
                    "promoted": c.promoted - p0})

    def resident_fraction(self, expert_counts: np.ndarray) -> float:
        """Fraction of routed tokens whose expert is device-resident."""
        expert_counts = np.asarray(expert_counts)
        total = expert_counts.sum()
        if total == 0:
            return 0.0
        res = sum(int(c) for e, c in enumerate(expert_counts)
                  if self.slot_of[e] >= 0)
        return res / float(total)
