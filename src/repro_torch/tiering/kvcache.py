"""Tiered paged KV cache — the paper's retention/promotion pathways on
the GPU memory hierarchy (port of `repro.tiering.kvcache`; device memory
= FD, pinned host memory = SD).

Pages (fixed tokens/page) live in either the device pool or the host
pool; a page table maps logical page -> (tier, slot).  The three
pathways (HotRAP §3.1):

  * retention            — eviction sweeps (the FD->SD "compaction"
    analogue, run when the device pool is full) *skip hot pages*: only
    cold pages are demoted to host slots.
  * promotion by compaction — the same sweep checks the staging list of
    recently-accessed host pages and copies the hot ones into freed
    device slots.
  * promotion by flush   — when the staging list reaches its capacity
    between sweeps, hot staged pages are bulk-promoted immediately.

Every page carries a version; promotion records the version at stage
time and aborts if the page was rewritten since (§3.3/3.4).

`fast_pool` is a device tensor, `slow_pool` a host tensor (pinned when
the device is CUDA, so page copies are queued without waiting); the page
table, staging list and sweeps are host numpy, as in the reference.
`SimClock` charges page moves at the bandwidths the caller passes: the
port carries no device constants of its own.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..obs.serving import NULL_SERVING_OBS
from .hotness import HotTracker, TrackerConfig


@dataclasses.dataclass(frozen=True)
class KVTierConfig:
    n_pages: int                 # logical pages
    fast_slots: int              # device pool capacity (pages)
    page_tokens: int = 16
    kv_heads: int = 8
    head_dim: int = 128
    n_layers: int = 1            # pages are per-layer-group blobs
    dtype: str = "bfloat16"
    staging_slots: int = 32      # promotion-by-flush trigger size
    sweep_every: int = 64        # accesses between eviction sweeps

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def page_bytes(self) -> int:
        return (2 * self.n_layers * self.page_tokens * self.kv_heads
                * self.head_dim * self.torch_dtype.itemsize)


class SimClock:
    def __init__(self):
        self.hbm_s = 0.0
        self.pcie_s = 0.0
        self.fast_hits = 0
        self.slow_hits = 0
        self.promoted = 0
        self.demoted = 0
        self.retained = 0
        self.aborted = 0
        self.sweeps = 0         # maintenance passes (sweep/rebalance)
        self.flushes = 0        # bulk staging flushes

    @property
    def total_s(self):
        return self.hbm_s + self.pcie_s


class TieredKVCache:
    TIER_FAST, TIER_SLOW = 0, 1

    # Observability is compiled out: class-level null plane, one
    # attribute check per site.
    _obs = NULL_SERVING_OBS
    _obs_track = "kv"

    def __init__(self, cfg: KVTierConfig, tracker_cfg: TrackerConfig
                 | None = None, *, hbm_bw: float, pcie_bw: float,
                 device=None, sampler=None):
        """`hbm_bw` / `pcie_bw`: bytes/s that `SimClock` charges for a
        device-pool and a host<->device page move.  `sampler`: index
        source of the tracker's threshold sampling."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.hbm_bw = float(hbm_bw)
        self.pcie_bw = float(pcie_bw)
        shape = (cfg.n_layers, cfg.page_tokens, cfg.kv_heads,
                 cfg.head_dim)
        dt = cfg.torch_dtype
        self.fast_pool = torch.zeros((cfg.fast_slots, 2, *shape), dtype=dt,
                                     device=self.device)
        self.slow_pool = torch.zeros(
            (cfg.n_pages, 2, *shape), dtype=dt,
            pin_memory=self.device.type == "cuda")
        # page table (host): tier, slot, version
        self.tier = np.full(cfg.n_pages, self.TIER_SLOW, np.int8)
        self.slot_of = np.full(cfg.n_pages, -1, np.int64)
        self.version = np.zeros(cfg.n_pages, np.int64)
        self.free_slots = list(range(cfg.fast_slots))[::-1]
        self.page_of_slot = np.full(cfg.fast_slots, -1, np.int64)
        self.staging: dict[int, int] = {}     # page -> staged version
        self.tracker = HotTracker(tracker_cfg or TrackerConfig(
            n_units=cfg.n_pages, unit_bytes=cfg.page_bytes,
            fast_bytes=cfg.fast_slots * cfg.page_bytes),
            device=self.device, sampler=sampler)
        self.clock = SimClock()
        self._access_count = 0

    # ------------------------------------------------------------------
    # data plane
    # ------------------------------------------------------------------
    def _host_fence(self):
        """Wait for queued copies out of the pinned host pool before the
        host writes into it."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def write_page(self, page: int, k, v):
        """Append/overwrite a page (prefill writes; bumps version)."""
        self.version[page] += 1
        data = torch.stack([torch.as_tensor(k), torch.as_tensor(v)])
        if self.tier[page] == self.TIER_FAST:
            s = self.slot_of[page]
            self.fast_pool[s] = to_device(
                data.to(self.fast_pool.dtype), self.device)
            self.clock.hbm_s += self.cfg.page_bytes / self.hbm_bw
        else:
            self._host_fence()
            self.slow_pool[page] = data
            self.clock.pcie_s += self.cfg.page_bytes / self.pcie_bw

    def read_pages(self, pages):
        """Gather pages for attention.  Fast pages: one device gather;
        slow pages: host fetch (PCIe-charged) + staged for promotion."""
        obs = self._obs
        if obs.enabled:
            t0 = self.clock.total_s
            m0 = self.clock.sweeps + self.clock.flushes
        pages = list(int(p) for p in pages)
        out = {}
        fast = [p for p in pages if self.tier[p] == self.TIER_FAST]
        slow = [p for p in pages if self.tier[p] == self.TIER_SLOW]
        if fast:
            self._gather_fast(fast, out)
        if slow:
            self._fetch_slow(slow, out)
        self._record(pages)
        self._maybe_flush()
        self._access_count += 1
        if self._access_count % self.cfg.sweep_every == 0:
            self.sweep()
        if obs.enabled:
            if obs.attribution:
                obs.attr.observe(
                    "kv", self.clock.total_s - t0, len(pages), len(slow),
                    self.clock.sweeps + self.clock.flushes > m0)
            obs.on_access()
        return [out[p] for p in pages]

    def _gather_fast(self, fast, out):
        """Fast pages: one device gather."""
        slots = to_device(self.slot_of[fast], self.device)
        gathered = self.fast_pool.index_select(0, slots)
        for i, p in enumerate(fast):
            out[p] = gathered[i]
        self.clock.hbm_s += len(fast) * self.cfg.page_bytes / self.hbm_bw
        self.clock.fast_hits += len(fast)

    def _fetch_slow(self, slow, out):
        """Slow pages: a host-to-device copy each, staged for promotion."""
        for p in slow:
            out[p] = self.slow_pool[p].to(self.device, non_blocking=True,
                                          copy=True)
            self.clock.pcie_s += self.cfg.page_bytes / self.pcie_bw
            self.clock.slow_hits += 1
            # insert into the staging list (the mPC analogue) with the
            # version observed at read time (§3.3 check)
            self.staging.setdefault(p, int(self.version[p]))

    # ------------------------------------------------------------------
    # hotness plumbing
    # ------------------------------------------------------------------
    def _record(self, pages):
        """The tracker's record of this read: on CUDA one `ralt_record`
        launch with the page ids by value."""
        self.tracker.record_ids(np.asarray(pages, np.int64))

    def _hot_set(self):
        self.tracker.refresh_limits()
        return self.tracker.hot().cpu().numpy()

    # ------------------------------------------------------------------
    # pathways
    # ------------------------------------------------------------------
    def _promote(self, page: int, staged_version: int, hot: bool):
        """Copy page host->device if hot, version unchanged, space found,
        and the hot-set size limit (Alg. 1 auto-tuned) has headroom."""
        if not hot:
            self.staging.pop(page, None)
            return False
        if self.version[page] != staged_version:      # §3.3/3.4 hazard
            self.clock.aborted += 1
            self.staging.pop(page, None)
            if self._obs.enabled:
                self._obs.tracer.instant(
                    self._obs_track, "page/promo_abort",
                    {"page": int(page),
                     "staged_version": int(staged_version),
                     "version": int(self.version[page])})
            return False
        occupied = self.cfg.fast_slots - len(self.free_slots)
        hot_limit = float(self.tracker.state["hot_limit"])
        if (occupied + 1) * self.cfg.page_bytes > hot_limit:
            return False                              # hot-set cap
        if not self.free_slots:
            return False                              # retry next sweep
        s = self.free_slots.pop()
        self.fast_pool[s].copy_(self.slow_pool[page], non_blocking=True)
        self.tier[page] = self.TIER_FAST
        self.slot_of[page] = s
        self.page_of_slot[s] = page
        self.clock.pcie_s += self.cfg.page_bytes / self.pcie_bw
        self.clock.promoted += 1
        self.staging.pop(page, None)
        return True

    def _demote(self, page: int):
        s = self.slot_of[page]
        # a synchronous copy on the stream that queued the earlier reads
        # of this host page, so it lands after them
        self.slow_pool[page].copy_(self.fast_pool[s])
        self.tier[page] = self.TIER_SLOW
        self.slot_of[page] = -1
        self.page_of_slot[s] = -1
        self.free_slots.append(int(s))
        self.clock.pcie_s += self.cfg.page_bytes / self.pcie_bw
        self.clock.demoted += 1

    def sweep(self):
        """Scheduled maintenance (the compaction analogue): demote cold
        resident pages (retention skips hot ones), then promote hot
        staged pages into the freed slots (promotion by compaction)."""
        obs, c = self._obs, self.clock
        if obs.enabled:
            obs.tracer.begin(
                self._obs_track, "kv/sweep",
                {"resident": int((self.page_of_slot >= 0).sum()),
                 "staged": len(self.staging)})
            r0, d0, p0, a0 = c.retained, c.demoted, c.promoted, c.aborted
        hot = self._hot_set()
        resident = [int(p) for p in self.page_of_slot if p >= 0]
        for p in resident:
            if hot[p]:
                self.clock.retained += 1              # retention
            elif len(self.free_slots) < max(self.cfg.fast_slots // 4, 1):
                self._demote(p)
        for p, ver in list(self.staging.items()):
            self._promote(p, ver, bool(hot[p]))
        c.sweeps += 1
        if obs.enabled:
            tr, track = obs.tracer, self._obs_track
            if c.retained > r0:                       # retention pathway
                tr.instant(track, "page/retained",
                           {"pages": c.retained - r0})
            if c.promoted > p0:                       # promo-by-compaction
                tr.instant(track, "page/promo_compaction",
                           {"pages": c.promoted - p0})
            tr.end(track, "kv/sweep",
                   {"demoted": c.demoted - d0, "promoted": c.promoted - p0,
                    "aborted": c.aborted - a0})

    def _maybe_flush(self):
        """Promotion by flush: staging full between sweeps."""
        if len(self.staging) < self.cfg.staging_slots:
            return
        obs, c = self._obs, self.clock
        if obs.enabled:
            obs.tracer.begin(self._obs_track, "kv/staging_flush",
                             {"staged": len(self.staging)})
            p0, a0 = c.promoted, c.aborted
        hot = self._hot_set()
        for p, ver in list(self.staging.items()):
            self._promote(p, ver, bool(hot[p]))
        # cold staged pages are dropped (paper: cold immPC records)
        self.staging.clear()
        c.flushes += 1
        if obs.enabled:
            if c.promoted > p0:                       # promo-by-flush
                obs.tracer.instant(self._obs_track, "page/promo_flush",
                                   {"pages": c.promoted - p0})
            obs.tracer.end(self._obs_track, "kv/staging_flush",
                           {"promoted": c.promoted - p0,
                            "aborted": c.aborted - a0})

    # ------------------------------------------------------------------
    def fast_hit_rate(self):
        t = self.clock.fast_hits + self.clock.slow_hits
        return self.clock.fast_hits / t if t else 0.0
