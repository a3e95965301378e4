"""Compared systems (paper §4.1), the port of `repro.core.baselines`.

Every baseline reuses the same LSM engine so that differences in the
benchmark come only from the tiering/promotion policy:

  rocksdb_fd       — everything on FD (upper bound)
  rocksdb_tiered   — plain tiered LSM, FD levels sized to the FD budget
  mutant           — SSTable-granularity temperatures, periodic placement
                     migration (Mutant, SoCC'18) — paper limitation 2
  sas_cache        — FD secondary *block* cache over the tiered LSM
                     (RocksDB SecondaryCache / SAS-Cache) — limitation 2
  prismdb          — clock-bit popularity; retention/promotion happen
                     only during compactions (PrismDB, ASPLOS'23) —
                     limitation 3
  hotrap           — the paper's system
  hotrap_noretain  — Table 3 ablation (promotion only)
  hotrap_nohotcheck— Table 4 ablation (promote everything read from SD)

The three compared systems keep their policy state on the host, as the
reference does: Mutant's temperatures and placement ranking, SAS-Cache's
secondary block cache and PrismDB's clock bits are host dicts, and
Mutant's migration re-targets tables without copying their tensors.
PrismDB's cross-tier merge runs on the device; its clock mask is built
on the host from one copy of the merged keys and indexes the merged run
on the device.  `make_system` / `make_sharded_system` build every name
in `SYSTEMS`; ``sanitize=True`` wraps the engine in core/sanitize.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .lsm import LSMConfig, TieredLSM
from .sstable import (BLOCK_BYTES, TOMBSTONE_VLEN, SSTable, merge_runs,
                      split_into_sstables)
from .storage import BlockCache, StorageSim


# ----------------------------------------------------------------------
class RocksDBFD(TieredLSM):
    """All levels on FD: the paper's upper bound."""

    def __init__(self, cfg: LSMConfig, **kw):
        cfg = dataclasses.replace(cfg, hotrap=False,
                                  n_fd_levels=len(cfg.level_caps()) + 1)
        super().__init__(cfg, **kw)


class RocksDBTiered(TieredLSM):
    def __init__(self, cfg: LSMConfig, **kw):
        cfg = dataclasses.replace(cfg, hotrap=False)
        super().__init__(cfg, **kw)


# ----------------------------------------------------------------------
class Mutant(TieredLSM):
    """SSTable-level temperature tracking + periodic placement migration.

    Temperature = exponentially-decayed access count / size.  Every
    `migration_interval` accesses, SSTables are re-ranked and the hottest
    ones are placed on FD up to the FD budget; moved SSTables charge a
    sequential read+write.  Granularity is the whole SSTable — the cold
    records it contains ride along (paper limitation 2).  Placement is
    host metadata: a moved table keeps its tensors where they are.
    """

    def __init__(self, cfg: LSMConfig, migration_interval: int = 20_000,
                 decay: float = 0.5, **kw):
        cfg = dataclasses.replace(cfg, hotrap=False)
        super().__init__(cfg, **kw)
        self.migration_interval = migration_interval
        self.decay = decay
        self.temps: dict[int, float] = {}
        self._accesses = 0

    def _search_levels(self, key, level_range, fg, touched=None,
                       version=None):
        # wrap to count per-sstable accesses: piggyback on find path
        res = super()._search_levels(key, level_range, fg, touched, version)
        if res is not None:
            sid = res[2]
            self.temps[sid] = self.temps.get(sid, 0.0) + 1.0
        return res

    def _count_accesses(self, n: int) -> None:
        before = self._accesses
        self._accesses += n
        crossings = (self._accesses // self.migration_interval
                     - before // self.migration_interval)
        for _ in range(crossings):   # one decay+migration per interval
            self._migrate()

    def get(self, key: int):
        out = super().get(key)
        self._count_accesses(1)
        return out

    def _scan_charge_block(self, sst, blk):
        # scanned blocks heat their SSTable just like point reads do
        self.temps[sst.sid] = self.temps.get(sst.sid, 0.0) + 1.0
        super()._scan_charge_block(sst, blk)

    def _scan(self, lo, hi, limit, tags=None):
        out = super()._scan(lo, hi, limit, tags=tags)
        # a scan is one record-access per returned record, not one op —
        # otherwise scan-heavy mixes never reach the migration interval
        self._count_accesses(max(1, len(out)))
        return out

    def _migrate(self) -> None:
        # decay temperatures, rank by heat density, fill the FD budget
        all_ssts: list[SSTable] = [s for lvl in self.levels for s in lvl]
        for sid in list(self.temps):
            self.temps[sid] *= self.decay
        ranked = sorted(
            all_ssts,
            key=lambda s: -(self.temps.get(s.sid, 0.0) / max(s.size_bytes, 1)))
        budget = self.cfg.fd_size
        want_fd: set[int] = set()
        for s in ranked:
            if budget - s.size_bytes < 0:
                continue
            budget -= s.size_bytes
            want_fd.add(s.sid)
        for s in all_ssts:
            tgt = "FD" if s.sid in want_fd else "SD"
            if s.tier != tgt:
                # migration I/O: read from old tier, write to new
                self.storage.seq_read(s.tier, s.size_bytes, fg=False,
                                      component="migration")
                self.storage.seq_write(tgt, s.size_bytes, fg=False,
                                       component="migration")
                s.retarget(tier=tgt)

    def _install_edits(self, edits):
        super()._install_edits(edits)
        for _, removed, _ in edits:
            for s in removed:
                self.temps.pop(s.sid, None)


# ----------------------------------------------------------------------
class SASCache(TieredLSM):
    """Tiered LSM + an FD secondary cache of SD data *blocks*.

    On an SD block read that misses the in-memory block cache, the
    secondary cache is consulted: hit => FD random read; miss => SD read
    plus an FD write to admit the block.  Cold records inside hot blocks
    ride along (paper limitation 2).
    """

    def __init__(self, cfg: LSMConfig, secondary_frac: float = 0.6, **kw):
        cfg = dataclasses.replace(cfg, hotrap=False)
        super().__init__(cfg, **kw)
        # paper: 6 GB secondary cache for 10 GB FD => 0.6 * fd_size
        self.secondary = BlockCache(int(secondary_frac * cfg.fd_size),
                                    BLOCK_BYTES)

    def _block_read_via_secondary(self, sst, blk, *, rand: bool, fg: bool,
                                  component: str) -> None:
        """Shared block-read ladder: secondary-cache hit turns an SD
        block read into an FD one; a miss reads SD and admits the block
        to the FD secondary cache (one FD write)."""
        read = self.storage.rand_read if rand else self.storage.seq_read
        if sst.tier == "SD":
            if self.secondary.access((sst.sid, blk)):
                read("FD", BLOCK_BYTES, fg=fg, component=component)
            else:
                read("SD", BLOCK_BYTES, fg=fg, component=component)
                self.storage.seq_write("FD", BLOCK_BYTES, fg=False,
                                       component="secondary")
        else:
            read("FD", BLOCK_BYTES, fg=fg, component=component)

    def _search_levels(self, key, level_range, fg, touched=None,
                       version=None):
        levels = (version or self.version).levels
        for li in level_range:
            sstables = levels[li]
            if not sstables:
                continue
            if li == 0:
                cands = [s for s in sstables if s.min_key <= key <= s.max_key]
            else:
                idx = self._bisect_level(sstables, key)
                cands = [sstables[idx]] if idx is not None else []
            for s in cands:
                if touched is not None:
                    touched.append(s.sid)
                if not s.bloom.may_contain(key):
                    continue
                found = s.find(key)
                # a bloom false positive reads the block the key's
                # insertion point falls in
                blk = found[2] if found else s.miss_block(key)
                if not self.block_cache.access((s.sid, blk)):
                    self._block_read_via_secondary(s, blk, rand=True, fg=fg,
                                                   component="get")
                if found:
                    return found[0], found[1], s.sid
        return None

    def _scan_charge_block(self, sst, blk):
        if self.block_cache.access((sst.sid, blk)):
            return
        self._block_read_via_secondary(sst, blk, rand=False, fg=True,
                                       component="scan")


# ----------------------------------------------------------------------
class PrismDB(TieredLSM):
    """Clock-bit popularity; movement only piggybacks on compactions.

    Reads set an in-memory clock bit per key (hash-table footprint the
    paper criticises).  During cross-tier compactions, records whose
    clock bit is set are written to FD (retention + promotion), all in
    one pass; the clock hand clears bits periodically.  No promotion
    cache and no flush pathway => promotion waits for compactions
    (paper limitation 3).
    """

    def __init__(self, cfg: LSMConfig, clock_clear_interval: int = 50_000,
                 **kw):
        cfg = dataclasses.replace(cfg, hotrap=False)
        super().__init__(cfg, **kw)
        self.clock: dict[int, bool] = {}
        self._reads = 0
        self.clock_clear_interval = clock_clear_interval
        self._clock_rng = np.random.default_rng(7)

    def _count_reads(self, n: int) -> None:
        before = self._reads
        self._reads += n
        crossings = (self._reads // self.clock_clear_interval
                     - before // self.clock_clear_interval)
        for _ in range(crossings):
            # clock hand sweep: clear ~half the bits per interval crossed,
            # one draw per bit in the clock's order (the reference's
            # per-key draws, taken as one array)
            keys = list(self.clock)
            keep = self._clock_rng.random(len(keys)) >= 0.5
            self.clock = dict.fromkeys(
                np.asarray(keys, dtype=np.int64)[keep].tolist(), True)

    def get(self, key: int):
        out = super().get(key)
        if out is not None:
            self.clock[key] = True
        self._count_reads(1)
        return out

    def _scan(self, lo, hi, limit, tags=None):
        out = super()._scan(lo, hi, limit, tags=tags)
        for k, _, _ in out:           # scanned records set clock bits too
            self.clock[k] = True
        # record-granular accounting: without it scan-heavy mixes set
        # bits ~scan_len times faster than the sweep interval assumes
        self._count_reads(max(1, len(out)))
        return out

    def _clock_mask(self, keys: torch.Tensor) -> torch.Tensor:
        """The clock bit of each merged key, on the keys' device: one
        copy of the keys to the host, one of the mask back."""
        if not self.clock or not len(keys):
            return torch.zeros(len(keys), dtype=torch.bool,
                               device=keys.device)
        set_keys = np.fromiter(self.clock, dtype=np.int64,
                               count=len(self.clock))
        hot = np.isin(keys.cpu().numpy(), set_keys)
        return torch.from_numpy(hot).to(keys.device)

    def _merge_into_next(self, li, inputs, lo, hi):
        lj = li + 1
        if lj != self.cfg.n_fd_levels:
            return super()._merge_into_next(li, inputs, lo, hi)
        # cross-tier: split merged output by clock bit
        nexts = [t for t in self.levels[lj] if t.overlaps(lo, hi)]
        all_inputs = inputs + nexts
        for s in all_inputs:
            self.storage.seq_read(s.tier, s.size_bytes, fg=False,
                                  component="compaction")
        st = self.stats
        st.compaction_bytes += sum(s.size_bytes for s in all_inputs)
        st.compactions += 1
        merged = merge_runs([(s.keys, s.seqs, s.vlens) for s in all_inputs],
                            drop_tombstones=(lj == len(self.levels) - 1),
                            device=self.device)
        keys, seqs, vlens = merged
        hot = self._clock_mask(keys) & (vlens != TOMBSTONE_VLEN)
        new_fd = split_into_sstables(keys[hot], seqs[hot], vlens[hot],
                                     "FD", li, self.now,
                                     self.cfg.target_sstable_bytes)
        new_sd = split_into_sstables(keys[~hot], seqs[~hot], vlens[~hot],
                                     "SD", lj, self.now,
                                     self.cfg.target_sstable_bytes)
        fd_bytes = sum(s.size_bytes for s in new_fd)
        sd_bytes = sum(s.size_bytes for s in new_sd)
        if fd_bytes:
            self.storage.seq_write("FD", fd_bytes, fg=False,
                                   component="compaction")
            st.retained_bytes += fd_bytes
        if sd_bytes:
            self.storage.seq_write("SD", sd_bytes, fg=False,
                                   component="compaction")
        st.compaction_bytes += fd_bytes + sd_bytes
        self._install_edits([(li, inputs, new_fd), (lj, nexts, new_sd)])
        for s in all_inputs:
            # no mark_compacting() cycle: PrismDB has no promotion cache,
            # so the §3.3 in-flight abort window does not apply — only the
            # terminal compacted flag matters (for _sid_compacted parity)
            s.finish_compaction()
            self._sid_compacted[s.sid] = True


# ----------------------------------------------------------------------
SYSTEMS = ["hotrap", "rocksdb_fd", "rocksdb_tiered", "mutant", "sas_cache",
           "prismdb", "hotrap_noretain", "hotrap_nohotcheck"]


def make_system(name: str, cfg: LSMConfig | None = None,
                storage: StorageSim | None = None, seed: int = 0,
                sanitize: bool = False, *, device=None,
                **overrides) -> TieredLSM:
    """The engine of system `name` on `device` (``cuda`` unless the
    caller passes ``device="cpu"``); ``sanitize=True`` wraps it in the
    runtime sanitizer (core/sanitize.py)."""
    if sanitize:
        from .sanitize import sanitize_db
        return sanitize_db(make_system(name, cfg, storage, seed,
                                       device=device, **overrides))
    cfg = cfg or LSMConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    kw = dict(storage=storage, seed=seed, device=device)
    if name == "hotrap":
        return TieredLSM(dataclasses.replace(cfg, hotrap=True), **kw)
    if name == "hotrap_noretain":
        return TieredLSM(dataclasses.replace(cfg, hotrap=True,
                                             retention=False), **kw)
    if name == "hotrap_nohotcheck":
        return TieredLSM(dataclasses.replace(cfg, hotrap=True,
                                             hotness_check=False), **kw)
    if name == "rocksdb_fd":
        return RocksDBFD(cfg, **kw)
    if name == "rocksdb_tiered":
        return RocksDBTiered(cfg, **kw)
    if name == "mutant":
        return Mutant(cfg, **kw)
    if name == "sas_cache":
        return SASCache(cfg, **kw)
    if name == "prismdb":
        return PrismDB(cfg, **kw)
    raise ValueError(f"unknown system {name!r} (choose from {SYSTEMS})")


def make_sharded_system(name: str, cfg: LSMConfig | None = None,
                        shard_cfg=None, seed: int = 0,
                        sanitize: bool = False, *, device=None,
                        **overrides):
    """Sharded construction for every compared system: N shared-nothing
    shards of `name`'s engine behind the core/shards.py router, each on
    `device` (``cuda`` unless the caller passes ``device="cpu"``).
    `cfg` is the *cluster-total* resource budget; each shard gets a 1/N
    slice (see shards.shard_lsm_config).  `shard_cfg` is a ShardConfig
    (defaults: 4 hash-partitioned shards with the HotBudget arbiter on).
    `sanitize=True` wraps the cluster in the runtime sanitizer
    (core/sanitize.py); the wrapper is not picklable.
    """
    from .shards import ShardConfig, ShardedTieredLSM
    if sanitize:
        from .sanitize import sanitize_db
        return sanitize_db(make_sharded_system(name, cfg, shard_cfg, seed,
                                               device=device, **overrides))
    cfg = cfg or LSMConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    scfg = shard_cfg or ShardConfig()
    # construction by system *name* (not a factory closure) keeps the
    # cluster picklable and lets the Repartitioner build destination
    # shards after a pickle round-trip
    return ShardedTieredLSM(scfg, cfg, seed=seed, system=name,
                            device=device)
