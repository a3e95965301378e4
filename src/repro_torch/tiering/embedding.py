"""Tiered embedding table: hot vocab rows resident in device memory (port
of `repro.tiering.embedding`).

The 128k–262k-vocab archs (llama3, minitron, gemma3, qwen3) have
multi-GiB embedding tables with Zipf-skewed row access — the paper's
workload shape.  The full table lives in host memory (SD; pinned when
the device is CUDA); a fixed-size device row cache (FD) holds the hot
rows, tracked by the RALT tracker; misses are served from the host
(PCIe-charged) and staged; staged rows are bulk-promoted when hot
(promotion by flush — embedding rows are read-only during serving, so
the version checks of the KV path are unnecessary; training updates
invalidate via `invalidate_rows`).

The slot tables, free list and staging set are host numpy / Python, as
in the reference, and change in the same order, so the same lookups on
either device promote, demote and retain the same rows.  Each lookup is
one tracker record of its sorted distinct ids: one `ralt_record` launch
on CUDA.  `SimClock` charges row moves at the bandwidths the caller
passes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import gather_to_device, host_tensor, resolve_device, to_device
from ..obs.serving import NULL_SERVING_OBS
from .hotness import HotTracker, TrackerConfig
from .kvcache import SimClock


class TieredEmbedding:
    # Observability is compiled out: class-level null plane, one
    # attribute check per site.
    _obs = NULL_SERVING_OBS
    _obs_track = "emb"

    def __init__(self, table, fast_rows: int, staging_slots: int = 256, *,
                 hbm_bw: float, pcie_bw: float, device=None, sampler=None):
        """`table`: the (V, d) host table (numpy array or CPU tensor, any
        dtype).  `hbm_bw` / `pcie_bw`: bytes/s that `SimClock` charges
        for a cache row and a host row.  `sampler`: index source of the
        tracker's threshold sampling."""
        self.device = resolve_device(device)
        self.table = host_tensor(table, self.device)        # host (V, d)
        V, d = self.table.shape
        self.hbm_bw = float(hbm_bw)
        self.pcie_bw = float(pcie_bw)
        self.fast_rows = fast_rows
        self.cache = torch.zeros((fast_rows, d), dtype=self.table.dtype,
                                 device=self.device)
        self.row_of_slot = np.full(fast_rows, -1, np.int64)
        self.slot_of_row = np.full(V, -1, np.int64)
        self.free = list(range(fast_rows))[::-1]
        self.staging: set[int] = set()
        self.staging_slots = staging_slots
        self.row_bytes = d * self.table.element_size()
        self.tracker = HotTracker(TrackerConfig(
            n_units=V, unit_bytes=self.row_bytes,
            fast_bytes=fast_rows * self.row_bytes), device=self.device,
            sampler=sampler)
        self.clock = SimClock()

    def lookup(self, token_ids) -> torch.Tensor:
        """Exact gather on the device (resident rows from the cache,
        misses from the host table), shaped (*token_ids.shape, d)."""
        obs = self._obs
        if obs.enabled:
            t0 = self.clock.total_s
            f0 = self.clock.flushes
        shape = tuple(np.shape(token_ids))
        ids = np.asarray(token_ids).reshape(-1)
        slots = self.slot_of_row[ids]
        hit = slots >= 0
        dev = self.device
        out = torch.empty((len(ids), self.table.shape[1]),
                          dtype=self.table.dtype, device=dev)
        if hit.any():
            got = self.cache.index_select(0, to_device(slots[hit], dev))
            out.index_copy_(0, to_device(np.nonzero(hit)[0], dev), got)
            uniq = len(np.unique(ids[hit]))
            self.clock.hbm_s += uniq * self.row_bytes / self.hbm_bw
            self.clock.fast_hits += int(hit.sum())
        miss = ~hit
        if miss.any():
            rows = np.unique(ids[miss])
            out.index_copy_(0, to_device(np.nonzero(miss)[0], dev),
                            gather_to_device(self.table, ids[miss], dev))
            self.clock.pcie_s += len(rows) * self.row_bytes / self.pcie_bw
            self.clock.slow_hits += int(miss.sum())
            self.staging.update(int(r) for r in rows)
        self.tracker.record_ids(np.unique(ids))
        if len(self.staging) >= self.staging_slots:
            self.flush_promote()
        if obs.enabled:
            if obs.attribution:
                obs.attr.observe(
                    "emb", self.clock.total_s - t0, len(ids),
                    int(miss.sum()), self.clock.flushes > f0)
            obs.on_access()
        return out.reshape(*shape, -1)

    def flush_promote(self):
        """Promotion by flush: hot staged rows -> device cache; cold
        resident rows are evicted to make room (retention keeps hot)."""
        obs, c = self._obs, self.clock
        if obs.enabled:
            obs.tracer.begin(self._obs_track, "emb/flush_promote",
                             {"staged": len(self.staging)})
            r0, p0 = c.retained, c.promoted
        self.tracker.refresh_limits()
        hot = self.tracker.hot().cpu().numpy()
        scores = self.tracker.host_scores()
        want = [r for r in self.staging if hot[r]]
        self.staging.clear()
        c.flushes += 1
        if not want:
            if obs.enabled:
                obs.tracer.end(self._obs_track, "emb/flush_promote",
                               {"promoted": 0})
            return
        # evict coldest residents if needed
        if len(self.free) < len(want):
            resident = [r for r in self.row_of_slot if r >= 0]
            resident.sort(key=lambda r: scores[r])
            for r in resident[:len(want) - len(self.free)]:
                if hot[r]:
                    self.clock.retained += 1    # retention: keep hot
                    continue
                s = self.slot_of_row[r]
                self.slot_of_row[r] = -1
                self.row_of_slot[s] = -1
                self.free.append(int(s))
                self.clock.demoted += 1
        new_slots, new_rows = [], []
        for r in want:
            if not self.free:
                break
            s = self.free.pop()
            new_slots.append(s)
            new_rows.append(r)
            self.slot_of_row[r] = s
            self.row_of_slot[s] = r
        if new_rows:
            self.cache.index_copy_(
                0, to_device(np.asarray(new_slots, np.int64), self.device),
                gather_to_device(self.table, new_rows, self.device))
            self.clock.pcie_s += (len(new_rows) * self.row_bytes
                                  / self.pcie_bw)
            self.clock.promoted += len(new_rows)
        if obs.enabled:
            tr, track = obs.tracer, self._obs_track
            if c.retained > r0:                       # retention pathway
                tr.instant(track, "page/retained",
                           {"pages": c.retained - r0})
            if c.promoted > p0:                       # promo-by-flush
                tr.instant(track, "page/promo_flush",
                           {"pages": c.promoted - p0})
            tr.end(track, "emb/flush_promote",
                   {"promoted": c.promoted - p0})

    def __getstate__(self):
        """Pickle without the attached plane (it holds clock references);
        the class-level NULL plane reasserts itself on load."""
        state = dict(self.__dict__)
        state.pop("_obs", None)
        state.pop("_obs_track", None)
        return state

    def invalidate_rows(self, rows):
        for r in np.asarray(rows).reshape(-1):
            s = self.slot_of_row[r]
            if s >= 0:
                self.slot_of_row[r] = -1
                self.row_of_slot[s] = -1
                self.free.append(int(s))

    def fast_hit_rate(self):
        t = self.clock.fast_hits + self.clock.slow_hits
        return self.clock.fast_hits / t if t else 0.0
