"""Simulated two-tier storage (paper Table 1).

Host Python, as in `repro.core.storage`: the simulated clock is a sum of
Python floats in call order, so an engine that makes the same charges
in the same order has the reference's clock bit for bit.

The container has no tiered disks, so I/O is *accounted*, not performed:
every block read / sequential write charges simulated busy time to its
device.  Calibrated to the paper's AWS testbed:

  FD  (AWS Nitro local SSD): ~83k random 16K IOPS, 1.4 GiB/s seq
  SD  (gp3 capped as HDD-RAID stand-in): 10k IOPS, 1000 MiB/s seq

Foreground (Get path) and background (flush/compaction) time are
accounted separately per device; the simulated run time assumes the
background work overlaps foreground I/O on the other device but shares
device bandwidth, i.e.

    sim_time = max over devices (fg_time + bg_time)

which reproduces the paper's bottleneck structure: tiered baselines are
bound by SD random-read IOPS; HotRAP (after promotion) is bound by FD.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

KIB = 1024
MIB = 1024 * 1024
GIB = 1024 * 1024 * 1024


@dataclasses.dataclass
class DeviceSpec:
    name: str
    rand_iops: float          # random 16K read IOPS
    seq_read_bw: float        # bytes/s
    seq_write_bw: float       # bytes/s

    def rand_read_cost(self, nbytes: int) -> float:
        # A random read of `nbytes` costs max(IOPS service time, transfer).
        ios = max(1, (nbytes + 16 * KIB - 1) // (16 * KIB))
        return max(ios / self.rand_iops, nbytes / self.seq_read_bw)

    def seq_read_cost(self, nbytes: int) -> float:
        return nbytes / self.seq_read_bw

    def seq_write_cost(self, nbytes: int) -> float:
        return nbytes / self.seq_write_bw


# Paper Table 1.
FD_SPEC = DeviceSpec("FD", rand_iops=83_000.0,
                     seq_read_bw=1.4 * GIB, seq_write_bw=1.1 * GIB)
SD_SPEC = DeviceSpec("SD", rand_iops=10_000.0,
                     seq_read_bw=1000 * MIB, seq_write_bw=1000 * MIB)


@dataclasses.dataclass
class DeviceCounters:
    fg_time: float = 0.0      # foreground (Get path) busy seconds
    bg_time: float = 0.0      # background (flush/compaction) busy seconds
    read_bytes: int = 0
    write_bytes: int = 0
    rand_reads: int = 0

    @property
    def busy(self) -> float:
        return self.fg_time + self.bg_time


class StorageSim:
    """Charges simulated I/O time; owns the per-device counters.

    `component` tags every charge (e.g. "get", "compaction", "ralt",
    "promotion") so benchmarks can reproduce the paper's Fig. 12/13
    I/O breakdowns.
    """

    def __init__(self, fd: DeviceSpec = FD_SPEC, sd: DeviceSpec = SD_SPEC):
        self.spec = {"FD": fd, "SD": sd}
        self.dev = {"FD": DeviceCounters(), "SD": DeviceCounters()}
        self._wall = 0.0
        # component -> {"read_bytes","write_bytes","time"}
        self.by_component: dict[str, dict[str, float]] = {}

    # -- accounting helpers -------------------------------------------------
    def _charge(self, tier: str, seconds: float, fg: bool, component: str,
                read_bytes: int = 0, write_bytes: int = 0,
                rand_reads: int = 0) -> float:
        d = self.dev[tier]
        if fg:
            d.fg_time += seconds
        else:
            d.bg_time += seconds
        d.read_bytes += read_bytes
        d.write_bytes += write_bytes
        d.rand_reads += rand_reads
        c = self.by_component.setdefault(
            component, {"read_bytes": 0, "write_bytes": 0, "time": 0.0})
        c["read_bytes"] += read_bytes
        c["write_bytes"] += write_bytes
        c["time"] += seconds
        # monotonic wall clock: devices run in parallel; the wall tracks
        # whichever device is currently the bottleneck.
        if d.busy > self._wall:
            self._wall = d.busy
        return seconds

    # -- I/O primitives ------------------------------------------------------
    def rand_read(self, tier: str, nbytes: int, *, fg: bool,
                  component: str) -> float:
        cost = self.spec[tier].rand_read_cost(nbytes)
        return self._charge(tier, cost, fg, component,
                            read_bytes=nbytes, rand_reads=1)

    def rand_read_many(self, is_sd, nbytes: int, *, fg: bool,
                       component: str) -> np.ndarray:
        """`rand_read` of `nbytes` from SD where ``is_sd[j]``, else from FD,
        for each j in order, charged in whole columns.

        Returns an (m + 1, 2) float array of the FD and SD time charged
        (fg or bg, by `fg`): row 0 before the charges, row j + 1 after
        charge j.  Every float equals what the m `rand_read` calls give,
        bit for bit: each total is the last element of a sequential
        `np.cumsum` that starts from the old value, and a device's busy
        time only grows, so `_wall` takes each charged device's last."""
        is_sd = np.asarray(is_sd, dtype=bool)
        m = len(is_sd)
        field = "fg_time" if fg else "bg_time"
        costs = np.where(is_sd, self.spec["SD"].rand_read_cost(nbytes),
                         self.spec["FD"].rand_read_cost(nbytes))
        out = np.empty((m + 1, 2))
        # lint: allow-loop (per tier: FD and SD)
        for col, (tier, sel) in enumerate((("FD", ~is_sd), ("SD", is_sd))):
            d = self.dev[tier]
            run = np.cumsum(np.concatenate(([getattr(d, field)],
                                            costs[sel])))
            out[1:, col] = run[np.cumsum(sel)]
            out[0, col] = run[0]
            k = len(run) - 1
            if k:
                setattr(d, field, float(run[-1]))
                d.read_bytes += k * nbytes
                d.rand_reads += k
                if d.busy > self._wall:
                    self._wall = d.busy
        if m:
            c = self.by_component.setdefault(
                component, {"read_bytes": 0, "write_bytes": 0, "time": 0.0})
            c["read_bytes"] += m * nbytes
            c["time"] = float(np.cumsum(np.concatenate(([c["time"]],
                                                        costs)))[-1])
        return out

    def seq_read(self, tier: str, nbytes: int, *, fg: bool,
                 component: str) -> float:
        cost = self.spec[tier].seq_read_cost(nbytes)
        return self._charge(tier, cost, fg, component, read_bytes=nbytes)

    def seq_write(self, tier: str, nbytes: int, *, fg: bool,
                  component: str) -> float:
        cost = self.spec[tier].seq_write_cost(nbytes)
        return self._charge(tier, cost, fg, component, write_bytes=nbytes)

    # -- summary -------------------------------------------------------------
    @property
    def sim_time(self) -> float:
        return self._wall

    def snapshot(self) -> dict:
        return {
            t: dataclasses.asdict(d) for t, d in self.dev.items()
        } | {"components": {k: dict(v) for k, v in self.by_component.items()}}

    def device_totals(self) -> dict:
        """Read-only per-device busy/byte totals for the observability
        plane (repro_torch/obs) — sampling must never go through _charge."""
        return {t: {"fg": d.fg_time, "bg": d.bg_time,
                    "read_bytes": d.read_bytes,
                    "write_bytes": d.write_bytes,
                    "rand_reads": d.rand_reads}
                for t, d in self.dev.items()}


class BlockCache:
    """In-memory LRU block cache keyed by (sstable_id, block_idx).

    A hit avoids the device charge entirely (the paper's in-memory block
    cache); capacity is in bytes of cached blocks.
    """

    def __init__(self, capacity_bytes: int, block_bytes: int):
        self.capacity = max(capacity_bytes, 0)
        self.block_bytes = block_bytes
        self._od: OrderedDict[tuple, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __contains__(self, key: tuple) -> bool:  # does not touch LRU order
        return key in self._od

    def access(self, key: tuple) -> bool:
        """Returns True on hit (and refreshes LRU); False on miss (and inserts)."""
        if self.capacity <= 0:
            self.misses += 1
            return False
        if key in self._od:
            self._od.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        self._od[key] = None
        while len(self._od) * self.block_bytes > self.capacity:
            self._od.popitem(last=False)
        return False

    def access_many(self, sids, blks) -> np.ndarray:
        """`access((sids[j], blks[j]))` for each j in order: the hit flags,
        with `hits`, `misses` and the LRU order those calls leave."""
        keys = list(zip(np.asarray(sids).tolist(), np.asarray(blks).tolist()))
        hit = np.zeros(len(keys), dtype=bool)
        if self.capacity <= 0:
            self.misses += len(keys)
            return hit
        od = self._od
        move, pop = od.move_to_end, od.popitem
        limit = self.capacity // self.block_bytes   # blocks that fit
        hits = []
        # lint: allow-loop (the LRU is order-dependent: whether an access
        # hits depends on every access before it)
        for j, key in enumerate(keys):
            if key in od:
                move(key)
                hits.append(j)
            else:
                od[key] = None
                while len(od) > limit:
                    pop(False)
        hit[hits] = True
        self.hits += len(hits)
        self.misses += len(keys) - len(hits)
        return hit

    def invalidate_sstable(self, sstable_id: int) -> None:
        stale = [k for k in self._od if k[0] == sstable_id]
        for k in stale:
            del self._od[k]
