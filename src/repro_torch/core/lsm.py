"""Tiered LSM-tree engine with HotRAP retention & promotion, on a
versioned read path, with its sorted runs on the device.

The port of `repro.core.lsm`.  One engine implements the paper's HotRAP
plus the compared systems via feature flags (see core/baselines.py):

  * leveling + RocksDB-style partial compaction (one SSTable merged into
    the overlapping SSTables of the next level), L0 by flush count;
  * a tier boundary: levels [0, n_fd_levels) live on FD, the rest on SD;
  * HotRAP pathways — retention (cross-tier compactions sort-merge
    against a RALT hot-key iterator), promotion by compaction (mPC
    records in the compaction range), promotion by flush (immPC checker
    -> L0) with the paper's §3.3/§3.4 correctness checks;
  * HotSize-adjusted cost-benefit SSTable picking (§3.5) with
    fall-back-to-oldest;
  * §3.6's shrunk-first-SD-level write-amplification option.

What lives where
----------------
Every SSTable's records and bloom bits, every GroupView and every RALT
run are tensors on ``device`` (``cuda`` unless the caller passes
``device="cpu"``).  Merges, splits, bloom probes, binary searches and
RALT's score arithmetic run there.  The memtables stay Python dicts and
the promotion caches host dicts, as in RocksDB; the simulated clock
(core/storage.py), the block cache, the level fences and the stateful
commit of a batch (block-cache LRU order, I/O charges, promotion-cache
inserts) stay on the host, in the reference's order, so a run gives the
reference's results bit for bit.  Each step that needs a device result
on the host copies it in one transfer.

Keys are int64: a key above ``MAX_KEY = 2**63 - 1`` (or below 0) raises
``ValueError``.  ``LSMConfig(wal=True)`` gives the engine its durable
half (core/wal.py): a group-committed WAL and a manifest of Version
edits, host lists charged to `StorageSim` as in the reference, with the
named crash sites (core/crashpoints.py) between each install's two
manifest halves; `TieredLSM.recover` rebuilds an engine from them on
the crashed engine's device.

Read semantics are faithful top-down-first-match (NOT max-seq), as in
the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..obs import NULL_OBS
from . import crashpoints
from .promotion import ImmutablePromotionCache, MutablePromotionCache
from .ralt import RALT, RaltConfig
from .scan import MAX_KEY, MergeCounters, build_sources, merge_scan
from .sstable import (BLOCK_BYTES, KEY_BYTES, TOMBSTONE_VLEN, SSTable,
                      lexsort, merge_runs, split_into_sstables,
                      sstable_from_host, storage_bytes)
from .storage import BlockCache, StorageSim
from .version import (GroupView, LevelIndex, Superversion, Version,
                      ViewCache)
from .wal import ShardDurability, recover_shard

MIB = 1024 * 1024

# sorted levels whose concatenated probe index (LevelIndex) stays cached
LEVEL_CACHE = 8

# point-get fast path: "no materialized view for this group" sentinel
# (distinct from None, which means "key definitively absent from group")
_VIEW_MISS = object()


def key_array(keys) -> np.ndarray:
    """Keys as a host int64 array; raises ValueError for a key outside
    [0, MAX_KEY] (the port's keys are int64)."""
    ks = np.asarray(keys)
    try:
        bad = (ks > MAX_KEY) if ks.dtype.kind == "u" else (ks < 0)
        if ks.size and bad.any():
            raise OverflowError
        return np.ascontiguousarray(ks, dtype=np.int64)
    except (OverflowError, TypeError):
        raise ValueError(f"keys must lie in [0, {MAX_KEY}]") from None


@dataclasses.dataclass
class LSMConfig:
    fd_size: int = 64 * MIB
    sd_size: int = 640 * MIB
    size_ratio: int = 10
    n_fd_levels: int = 3                 # L0..L2 on FD
    target_sstable_bytes: int = 1 * MIB
    memtable_bytes: int = 1 * MIB
    l0_compaction_trigger: int = 4
    block_cache_bytes: int = 1 * MIB     # scaled-down 128 MiB (paper §4.1)
    bits_per_key: int = 10
    # --- HotRAP features ---
    hotrap: bool = False                 # enable RALT + promotion cache
    retention: bool = True
    promotion_by_compaction: bool = True
    promotion_by_flush: bool = True
    hotness_check: bool = True           # False => Table 4 ablation
    checker_delay_ops: int = 64          # async Checker emulation
    shrink_sd_first_level: bool = False  # §3.6 WA optimisation
    sd_first_level_factor: float = 0.5   # the "p" used when shrinking
    ralt_hot_limit_frac: float = 0.50    # initial: 50% of FD (paper §4.1)
    ralt_phys_limit_frac: float = 0.15   # initial: 15% of FD
    ralt_autotune: bool = True
    # --- versioned read path ---
    remix_views: bool = True             # REMIX cross-run views for scans
    range_promotion: bool = True         # whole-range promotion on hot scans
    range_promo_frac: float = 0.5        # range is hot when RALT hot bytes
                                         # >= frac * scanned HotRAP bytes
    # --- point-get fast path ---
    point_view_gets: bool = True         # serve gets from an *already
                                         # materialized* GroupView via one
                                         # binary search (never builds one)
    # --- durability (core/wal.py) ---
    wal: bool = False                    # per-shard WAL + manifest; every
                                         # append/sync/edit byte-charged to
                                         # the devices (component="wal")
    wal_group_commit_records: int = 64

    def level_caps(self) -> list[float]:
        """Byte capacity per level (L0 handled by count, entry is inf)."""
        t = self.size_ratio
        base = self.fd_size / (1 + t)    # L1 + L2 = fd_size for n_fd=3
        caps = [float("inf"), base]
        while True:
            nxt = caps[-1] * t
            lvl = len(caps)
            if self.shrink_sd_first_level and lvl == self.n_fd_levels:
                nxt *= self.sd_first_level_factor  # shrink first SD level
            caps.append(nxt)
            covered = sum(c for c in caps[self.n_fd_levels:])
            if covered >= self.sd_size:
                break
            if len(caps) > 12:
                break
        caps[-1] = float("inf")          # last level unbounded
        return caps


@dataclasses.dataclass
class Stats:
    gets: int = 0
    puts: int = 0
    served_mem: int = 0
    served_fd: int = 0
    served_pc: int = 0
    served_sd: int = 0
    misses: int = 0
    promoted_bytes: int = 0              # written to FD by promotion paths
    retained_bytes: int = 0              # written back to FD by retention
    compaction_bytes: int = 0            # read+write compaction traffic
    flushes: int = 0
    compactions: int = 0
    pc_insert_aborts: int = 0
    pc_inserts: int = 0
    checker_runs: int = 0
    checker_excluded_updated: int = 0
    checker_excluded_newer: int = 0
    # --- range scans ---
    scans: int = 0
    scanned_records: int = 0             # live records returned by scans
    scan_served_mem: int = 0
    scan_served_fd: int = 0
    scan_served_pc: int = 0
    scan_served_sd: int = 0
    scan_pc_inserts: int = 0             # scan-side PC insert *attempts*
                                         # (the §3.3 check may still abort)
    # --- versioned read path / merge cost ---
    scan_cursor_pulls: int = 0           # records drawn from scan cursors
    scan_merge_compares: int = 0         # modelled heap/2-way compares
    view_builds: int = 0                 # GroupView constructions
    get_view_hits: int = 0               # gets served off a cached view
    get_probes_saved: int = 0            # per-level probes those replaced
    version_installs: int = 0            # Versions published
    range_promotions: int = 0            # whole-range promotion batches
    range_promoted_records: int = 0      # records in those batches

    @property
    def scan_merge_ops_per_record(self) -> float:
        """Cursor pulls + merge compares per scanned record — the REMIX
        acceptance metric (lower is better)."""
        return ((self.scan_cursor_pulls + self.scan_merge_compares)
                / max(self.scanned_records, 1))

    @property
    def fd_hit_rate(self) -> float:
        num = self.served_mem + self.served_fd + self.served_pc
        den = max(self.gets, 1)
        return num / den

    @property
    def scan_fd_hit_rate(self) -> float:
        """Fraction of scanned records served without touching SD."""
        num = self.scan_served_mem + self.scan_served_fd + self.scan_served_pc
        den = max(self.scanned_records, 1)
        return num / den


class TieredLSM:
    """The key-value store.  `put`/`get`/`delete`/`scan`/`scan_range`
    are the public API; `multi_get`/`put_many` their batched forms."""

    # observability plane: the class-level null plane is compiled out —
    # every instrumentation site below guards on `self._obs.enabled`, or
    # on `self._obs.wall` for the spans a wall-clock plane alone records
    _obs = NULL_OBS
    _obs_track = "db"

    # durability (core/wal.py): None unless cfg.wal — every durability
    # site below guards on this single attribute check
    durability = None

    def __init__(self, cfg: LSMConfig, storage: StorageSim | None = None,
                 seed: int = 0, *, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.storage = storage or StorageSim()
        self.caps = cfg.level_caps()
        self._next_vid = 0
        self.version = self._make_version([[] for _ in self.caps]).ref()
        self._view_cache = ViewCache(self.device)
        self._level_cache: dict[bytes, LevelIndex] = {}
        self.memtable: dict[int, tuple[int, int]] = {}
        self.memtable_bytes = 0
        self.imm_memtables: list[dict[int, tuple[int, int]]] = []
        self.seq = 0
        self.now = 0                      # logical op counter
        self.block_cache = BlockCache(cfg.block_cache_bytes, BLOCK_BYTES)
        self.stats = Stats()
        self.rng = np.random.default_rng(seed)
        self.durability = (
            ShardDurability(self.storage, type(self), cfg, seed,
                            cfg.wal_group_commit_records, self.device)
            if cfg.wal else None)
        if self.durability is not None:
            self.durability.owner = self
        self._sid_compacted: dict[int, bool] = {}
        # --- HotRAP state ---
        self.ralt: RALT | None = None
        self.mpc = MutablePromotionCache()
        self.immpcs: list[ImmutablePromotionCache] = []
        self._checker_queue: list[tuple[int, ImmutablePromotionCache]] = []
        if cfg.hotrap:
            rcfg = RaltConfig(
                fd_size=cfg.fd_size,
                hot_set_limit=int(cfg.ralt_hot_limit_frac * cfg.fd_size),
                phys_limit=int(cfg.ralt_phys_limit_frac * cfg.fd_size),
                autotune=cfg.ralt_autotune,
                # scale the unsorted buffer with FD so small test configs
                # still exercise flush/hotness paths
                buffer_bytes=min(64 * 1024, max(4096, cfg.fd_size // 64)))
            self.ralt = RALT(rcfg, self.storage, self.device)
        # point-get view fast path: only safe when the per-level search
        # is not interposed by a baseline (Mutant temperatures, SAS-Cache
        # secondary cache hook _search_levels; a view hit would skip
        # them).  The cfg flags are re-read per get so ablations that
        # flip remix_views on a live store behave consistently.
        self._point_view_ok = (
            type(self)._search_levels is TieredLSM._search_levels)
        # test hook: when set, PC insertions are deferred by this many ops
        self.defer_pc_inserts: int = 0
        self._deferred_pc: list[tuple[int, int, int, int, list[int]]] = []

    # ------------------------------------------------------------------
    # version publishing
    # ------------------------------------------------------------------
    @property
    def levels(self) -> list[list[SSTable]]:
        """The current Version's level lists (read-only by contract:
        mutations must go through ``_publish``)."""
        return self.version.levels

    def _make_version(self, levels: list[list[SSTable]]) -> Version:
        v = Version(levels, self._next_vid)
        self._next_vid += 1
        return v

    def _publish(self, new_levels: list[list[SSTable]]) -> None:
        """Install a new Version (flush/compaction/promotion install)."""
        old = self.version
        self.version = self._make_version(new_levels).ref()
        old.unref()
        self.stats.version_installs += 1  # lint: allow-stats (engine)

    def _levels_with(self, li: int, new_list: list[SSTable]
                     ) -> list[list[SSTable]]:
        """Copy of the current level lists with level `li` replaced."""
        levels = list(self.version.levels)
        levels[li] = new_list
        return levels

    def group_view(self, version: Version, group: str) -> GroupView | None:
        """The REMIX GroupView of a level group ("FD" or "SD") for a
        Version, from the signature-keyed cache (built on first use
        after the group's composition changes, then reused)."""
        n_fd = self.cfg.n_fd_levels
        sig = (group,) + version.group_signature(group, n_fd)
        before = self._view_cache.builds
        view = self._view_cache.get(
            sig, lambda: version.group_runs(group, n_fd))
        # lint: allow-stats (engine-owned Stats)
        self.stats.view_builds += self._view_cache.builds - before
        return view

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def put(self, key: int, vlen: int) -> int:
        if not 0 <= key <= MAX_KEY:
            raise ValueError(f"key {key} outside [0, {MAX_KEY}]")
        self.seq += 1
        seq = self.seq
        if self.durability is not None:
            # WAL before apply: the record is durable only once its
            # group commit syncs (core/wal.py)
            self.durability.wal.append(seq, key, vlen)
        prev = self.memtable.get(key)
        if prev is not None:
            self.memtable_bytes -= KEY_BYTES + self._vbytes(prev[1])
        self.memtable[key] = (seq, vlen)
        self.memtable_bytes += KEY_BYTES + self._vbytes(vlen)
        self.stats.puts += 1  # lint: allow-stats (engine)
        if self.memtable_bytes >= self.cfg.memtable_bytes:
            self._rotate_memtable()
            self._flush_imm_memtables()
            self._maybe_compact()
        self._tick()
        return seq

    def delete(self, key: int) -> int:
        return self.put(key, TOMBSTONE_VLEN)

    def put_many(self, keys, vlens, seqs=None) -> np.ndarray:
        """Batched writes; returns the assigned seqs (int64 array),
        byte-identical to the scalar `put` sequence.

        ``vlens`` may be a scalar or a per-key array; ``seqs`` lets a
        caller pre-assign sequence numbers (ascending within the batch).
        Memtable rotations land at the same ops as the scalar path: the
        batch splits into sub-batches at each *predicted* threshold
        crossing, and the threshold test against the real
        ``memtable_bytes`` after each sub-batch keeps the rotation
        points exact.  The op clock advances once at the end of the
        batch (`_tick_many`).
        """
        ks = key_array(keys)
        n = len(ks)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        vl = (np.full(n, int(vlens), dtype=np.int64)
              if np.ndim(vlens) == 0
              else np.ascontiguousarray(vlens, dtype=np.int64))
        if type(self).put is not TieredLSM.put:
            return self._put_many_fallback(ks, vl, seqs)
        obs = self._obs
        if obs.wall:
            obs.tracer.begin(self._obs_track, "put")
        sq = (np.arange(self.seq + 1, self.seq + 1 + n, dtype=np.int64)
              if seqs is None
              else np.ascontiguousarray(seqs, dtype=np.int64))
        self.seq = int(sq[-1])
        self.stats.puts += n  # lint: allow-stats (engine)
        if self.durability is not None:
            self._wal_append_batch(sq, ks, vl)
        op_bytes = KEY_BYTES + np.where(vl == TOMBSTONE_VLEN, 0, vl)
        limit = self.cfg.memtable_bytes
        start = 0
        while start < n:
            room = limit - self.memtable_bytes
            csum = np.cumsum(op_bytes[start:])
            stop = start + min(
                int(np.searchsorted(csum, room, "left")) + 1, n - start)
            upd = dict(zip(ks[start:stop].tolist(),
                           zip(sq[start:stop].tolist(),
                               vl[start:stop].tolist())))
            mt = self.memtable
            removed = sum(KEY_BYTES + self._vbytes(mt[k][1])
                          for k in upd if k in mt)
            added = sum(KEY_BYTES + self._vbytes(v[1])
                        for v in upd.values())
            mt.update(upd)
            self.memtable_bytes += added - removed
            if self.memtable_bytes >= limit:
                self._rotate_memtable()
                self._flush_imm_memtables()
                self._maybe_compact()
            start = stop
        self._tick_many(n)
        if obs.wall:
            obs.tracer.end(self._obs_track, "put")
        return sq

    def _put_many_fallback(self, ks: np.ndarray, vl: np.ndarray,
                           seqs) -> np.ndarray:
        out = np.empty(len(ks), dtype=np.int64)
        vll = vl.tolist()
        sl = (None if seqs is None
              else np.ascontiguousarray(seqs, dtype=np.int64).tolist())
        # lint: allow-loop (baseline-interposed write path: a subclass
        # overriding `put` keeps scalar per-key semantics; the stock
        # engine takes the vectorized sub-batch path above)
        for i, k in enumerate(ks.tolist()):
            if sl is not None:
                self.seq = sl[i] - 1
            out[i] = self.put(k, vll[i])
        return out

    def _wal_append_batch(self, seqs: np.ndarray, keys: np.ndarray,
                          vlens: np.ndarray) -> None:
        """WAL the whole batch before applying it (the `wal/append`
        span; group commits fire inside as windows fill)."""
        wal = self.durability.wal
        obs = self._obs
        if not obs.enabled:
            wal.append_columns(seqs, keys, vlens)
            return
        track = self._obs_track
        obs.tracer.begin(track, "wal/append", {"records": int(len(seqs))})
        syncs0 = wal.syncs
        synced = wal.append_columns(seqs, keys, vlens)
        obs.tracer.end(track, "wal/append",
                       {"synced_bytes": int(synced),
                        "group_commits": wal.syncs - syncs0})

    def multi_get(self, keys, lat_out=None) -> list:
        """Batched point lookups: ``[(seq, vlen) | None]`` per key, in
        input order — byte-identical to ``[self.get(k) for k in keys]``.

        Probe *resolution* is columnar: one folded-dict map over the
        memtables and mPC, and per level group either one binary search
        over a materialized GroupView or one fence-pointer
        ``searchsorted`` per level with one bloom + binary-search probe
        on the device per touched SSTable, across the whole batch.  The
        stateful *commit* on the host is columnar too, but for the
        block-cache LRU replay (`BlockCache.access_many`): the misses
        are charged in whole columns (`StorageSim.rand_read_many`), each
        key's (fd, sd) fg-time delta into ``lat_out`` is a difference of
        their running sums, and the §3.3 promotion-cache inserts loop
        over the SD hits alone — the scalar path's charge sequence and
        floats, bit for bit.  A simulated-clock plane with attribution
        or `promo/get` instants takes `_commit_per_key` instead.  The op
        clock advances once (`_tick_many`).

        ``lat_out``: optional float (n, 2) array receiving each key's
        (fd, sd) foreground device-time delta.
        """
        ks = key_array(keys)
        n = len(ks)
        if n == 0:
            return []
        cls = type(self)
        if (cls.get is not TieredLSM.get
                or cls._search_levels is not TieredLSM._search_levels
                or cls._finish_get is not TieredLSM._finish_get):
            # baseline-interposed read path (Mutant, SAS-Cache, PrismDB
            # hook get/_search_levels): vectorizing would skip them
            return self._multi_get_fallback(ks, lat_out)
        obs = self._obs
        # wall-clock spans (`Observability(clock="wall")`): the root
        # `get`, the checker fired by the tick, the four resolutions,
        # the commit, RALT's record and the answer
        wall = obs.wall
        tr, track = obs.tracer, self._obs_track
        if wall:
            tr.begin(track, "get")
        st = self.stats
        st.gets += n
        self._tick_many(n)
        attr_on = (obs.enabled and obs.attribution
                   and lat_out is not None)
        if wall:
            tr.begin(track, "get/mem")
        v = self.version
        kl = ks.tolist()
        res_seq = np.zeros(n, dtype=np.int64)
        res_vlen = np.zeros(n, dtype=np.int64)
        has = np.zeros(n, dtype=bool)
        tier_c = np.full(n, 4, dtype=np.int8)   # 0..4 = mem/FD/PC/SD/miss
        viewhit = np.zeros(n, dtype=bool)
        ev: list = []        # pending charges: (pos, sid, blk, is_sd) arrays
        pend = np.arange(n)

        def serve(mask, seqs, vlens, code):
            """Serve the pending positions `mask` picks (the seqs and
            vlens of those alone) from tier `code`; the rest stay
            pending.  Returns the served positions."""
            nonlocal pend
            w = pend[mask]
            res_seq[w] = seqs
            res_vlen[w] = vlens
            has[w] = True
            tier_c[w] = code
            pend = pend[~mask]
            return w

        # -- resolve 1: memtables, newest table wins -------------------
        mem_get = self.memtable.get
        if self.imm_memtables:
            folded: dict = {}
            # lint: allow-loop (imm-memtable fold — bounded by the
            # rotation backlog, not by batch size)
            for t in reversed(self.imm_memtables):
                folded.update(t)
            folded.update(self.memtable)
            mem_get = folded.get
        st.served_mem += len(serve(*self._dict_resolve(mem_get, kl), 0))
        if wall:
            tr.end(track, "get/mem")
        # -- resolve 2: FD group ---------------------------------------
        if len(pend):
            if wall:
                tr.begin(track, "get/fd")
            found, seqs, vlens, _, via_view = self._batch_probe_group(
                ks, pend, "FD", v, ev)
            viewhit[pend] |= via_view
            st.served_fd += len(serve(found, seqs, vlens, 1))
            if wall:
                tr.end(track, "get/fd")
        # -- resolve 3: mutable promotion cache ------------------------
        if len(pend):
            if wall:
                tr.begin(track, "get/pc")
            st.served_pc += len(serve(
                *self._dict_resolve(self.mpc.get, ks[pend].tolist()), 2))
            if wall:
                tr.end(track, "get/pc")
        # -- resolve 4: SD group, and the §3.3 touched lists of the live
        # SD hits (no other key is inserted into the promotion cache)
        sd_touch: dict[int, list[int]] = {}
        if len(pend):
            if wall:
                tr.begin(track, "get/sd")
            found, seqs, vlens, sids, via_view = self._batch_probe_group(
                ks, pend, "SD", v, ev)
            viewhit[pend] |= via_view
            w = serve(found, seqs, vlens, 3)
            st.served_sd += len(w)
            if self.cfg.hotrap:
                live = vlens != TOMBSTONE_VLEN
                sd_touch = dict(zip(w[live].tolist(), v.sd_touched_many(
                    ks[w[live]], sids[live], self.cfg.n_fd_levels)))
            if wall:
                tr.end(track, "get/sd")
        if wall:
            tr.begin(track, "get/commit")
        st.misses += int(np.count_nonzero(~has)) + int(
            np.count_nonzero(has & (res_vlen == TOMBSTONE_VLEN)))
        # -- commit: the charges of each key, in input order -----------
        if ev:
            e_pos = np.concatenate([e[0] for e in ev])
            e_rank = np.concatenate(
                [np.full(len(e[0]), r, dtype=np.int32)
                 for r, e in enumerate(ev)])
            order = np.lexsort((e_rank, e_pos))
            e_pos = e_pos[order]
            e_sid = np.concatenate([e[1] for e in ev])[order]
            e_blk = np.concatenate([e[2] for e in ev])[order]
            e_sd = np.concatenate([e[3] for e in ev])[order]
        else:
            e_pos = e_sid = e_blk = np.zeros(0, dtype=np.int64)
            e_sd = np.zeros(0, dtype=bool)
        bc = self.block_cache
        hits0 = bc.hits
        tomb = TOMBSTONE_VLEN
        # the `promo/get` instants (not in wall mode: their arguments
        # copy RALT's answers to the host)
        promo_on = obs.enabled and not wall and self.ralt is not None
        if attr_on or promo_on:
            self._commit_per_key(ks, kl, e_pos, e_sid, e_blk, e_sd, tier_c,
                                 res_seq, res_vlen, viewhit, sd_touch,
                                 lat_out, attr_on, promo_on)
        else:
            # the LRU replay is the only order-dependent part: the
            # charges are per-tier sequential sums, each key's latency a
            # difference of them, and the §3.3 inserts touch neither
            miss = ~bc.access_many(e_sid, e_blk)
            times = self.storage.rand_read_many(e_sd[miss], BLOCK_BYTES,
                                                fg=True, component="get")
            if lat_out is not None:
                cnt = np.bincount(e_pos[miss], minlength=n)
                end = np.cumsum(cnt)
                lat_out[:n] = times[end] - times[end - cnt]
            sel = np.flatnonzero((tier_c == 3) & (res_vlen != tomb))
            if self.cfg.hotrap and len(sel):
                # lint: allow-loop (§3.3 promotion-cache inserts of the
                # SD hits alone: each may freeze the mPC the next sees)
                for i, seq, vlen in zip(sel.tolist(), res_seq[sel].tolist(),
                                        res_vlen[sel].tolist()):
                    self._insert_pc(kl[i], seq, vlen, sd_touch[i])
        if wall:
            tr.end(track, "get/commit", {"block_events": len(e_pos),
                                         "cache_hits": bc.hits - hits0})
        # -- RALT hotness: one chunked batch for every live hit --------
        live = has & (res_vlen != tomb)
        if self.ralt is not None and live.any():
            sel = np.flatnonzero(live)
            self.ralt.record_access_many(ks[sel], res_vlen[sel])
        if wall:
            tr.begin(track, "get/answer")
        out = [sv if ok else None
               for sv, ok in zip(zip(res_seq.tolist(), res_vlen.tolist()),
                                 live.tolist())]
        if wall:
            tr.end(track, "get/answer")
            tr.end(track, "get")
        return out

    def _commit_per_key(self, ks, kl, e_pos, e_sid, e_blk, e_sd, tier_c,
                        res_seq, res_vlen, viewhit, sd_touch, lat_out,
                        attr_on: bool, promo_on: bool) -> None:
        """`multi_get`'s commit key by key, in input order, as the
        reference makes it.  Kept for the simulated-clock plane alone:
        its attribution records and `promo/get` instants read the clock
        (StorageSim) between one key's charges and the next's, so they
        need the charges made one at a time; every other caller takes
        the columnar commit."""
        obs = self._obs
        n = len(kl)
        tiers = ("mem", "FD", "PC", "SD", "miss")
        bc = self.block_cache
        storage = self.storage
        dev_fd = storage.dev["FD"]
        dev_sd = storage.dev["SD"]
        hotrap = self.cfg.hotrap
        tomb = TOMBSTONE_VLEN
        promo_args = ({} if not (promo_on and hotrap)
                      else self._promo_get_args(ks, tier_c, res_vlen))
        e_pos = e_pos.tolist()
        e_sid = e_sid.tolist()
        e_blk = e_blk.tolist()
        e_sd = e_sd.tolist()
        ep = 0
        n_ev = len(e_pos)
        b0 = r0 = 0
        # lint: allow-loop (stateful per-key commit for a plane that reads
        # the simulated clock between keys; see the docstring)
        for i in range(n):
            if attr_on:
                b0 = bc.hits
                r0 = dev_fd.rand_reads + dev_sd.rand_reads
            f0 = dev_fd.fg_time
            s0 = dev_sd.fg_time
            while ep < n_ev and e_pos[ep] == i:
                if not bc.access((e_sid[ep], e_blk[ep])):
                    storage.rand_read("SD" if e_sd[ep] else "FD",
                                      BLOCK_BYTES, fg=True,
                                      component="get")
                ep += 1
            if tier_c[i] == 3:          # SD hit: HotRAP promotion
                vlen = int(res_vlen[i])
                if hotrap and vlen != tomb:
                    key = kl[i]
                    if promo_on:
                        obs.tracer.instant(self._obs_track, "promo/get",
                                           promo_args[i])
                    self._insert_pc(key, int(res_seq[i]), vlen,
                                    sd_touch[i])
            if lat_out is not None:
                lat_out[i, 0] = dev_fd.fg_time - f0
                lat_out[i, 1] = dev_sd.fg_time - s0
                if attr_on:
                    served = tiers[4 if res_vlen[i] == tomb
                                   else int(tier_c[i])]
                    cache_hits = bc.hits - b0
                    obs.attr.stash_record(
                        served,
                        (dev_fd.rand_reads + dev_sd.rand_reads - r0
                         + cache_hits),
                        bool(viewhit[i]), cache_hits > 0,
                        float(lat_out[i, 0] + lat_out[i, 1]))

    def _promo_get_args(self, ks: np.ndarray, tier_c: np.ndarray,
                        res_vlen: np.ndarray) -> dict:
        """The `promo/get` instant's args of every SD-served live key of a
        batch, by position: the scalar `get`'s `is_hot(key)` and
        `range_hot_bytes(key, key)`, asked of RALT for the whole batch in
        one device-to-host copy each.  RALT does not change inside the
        batch's commit loop (the accesses are recorded after it), so the
        answers are those the per-key questions would get there."""
        pos = np.flatnonzero((tier_c == 3) & (res_vlen != TOMBSTONE_VLEN))
        if not len(pos):
            return {}
        keys = ks[pos]
        hot = self.ralt.is_hot_many(keys).tolist()
        kl = keys.tolist()
        score = self.ralt.range_hot_bytes_many(kl, kl)
        return {i: {"key": k, "ralt_hot": bool(h), "score_bytes": float(b)}
                for i, k, h, b in zip(pos.tolist(), kl, hot, score)}

    def _multi_get_fallback(self, ks: np.ndarray, lat_out) -> list:
        obs = self._obs
        attr_on = (obs.enabled and obs.attribution
                   and lat_out is not None)
        dev = self.storage.dev
        out: list = []
        f0 = s0 = 0.0
        # lint: allow-loop (baseline-interposed read path — subclasses
        # overriding get/_search_levels keep per-key semantics; the
        # stock engine takes the vectorized path above)
        for i, k in enumerate(ks.tolist()):
            if lat_out is not None:
                f0 = dev["FD"].fg_time
                s0 = dev["SD"].fg_time
            out.append(self.get(k))
            if lat_out is not None:
                lat_out[i, 0] = dev["FD"].fg_time - f0
                lat_out[i, 1] = dev["SD"].fg_time - s0
                if attr_on:
                    obs.attr.stash_pending(
                        float(lat_out[i, 0] + lat_out[i, 1]))
        return out

    def get(self, key: int):
        """Returns (seq, vlen) of the visible version, or None.

        Resolves against the Version pinned right after the clock tick:
        a checker/compaction fired by the tick publishes first, then the
        whole probe sequence sees one consistent snapshot."""
        if not 0 <= key <= MAX_KEY:
            raise ValueError(f"key {key} outside [0, {MAX_KEY}]")
        self.stats.gets += 1  # lint: allow-stats (engine)
        self._tick()
        obs = self._obs
        if obs.enabled and obs.attribution:
            obs.attr.begin_get(self)
        v = self.version
        # 1. memtables
        for table in [self.memtable, *self.imm_memtables]:
            hit = table.get(key)
            if hit is not None:
                self.stats.served_mem += 1  # lint: allow-stats (engine)
                return self._finish_get(key, hit, tier=None)
        # 2. FD levels (via cached GroupView when one is materialized)
        hit = self._probe_group(key, "FD", v)
        if hit is not None:
            self.stats.served_fd += 1  # lint: allow-stats (engine)
            return self._finish_get(key, hit[:2], tier="FD")
        # 3. mutable promotion cache
        pc_hit = self.mpc.get(key)
        if pc_hit is not None:
            self.stats.served_pc += 1  # lint: allow-stats (engine)
            return self._finish_get(key, pc_hit, tier="PC")
        # 4. SD levels (recording touched SSTables for the §3.3 check)
        touched: list[int] = []
        hit = self._probe_group(key, "SD", v, touched=touched)
        if hit is not None:
            self.stats.served_sd += 1  # lint: allow-stats (engine)
            seq, vlen, _ = hit
            if self.cfg.hotrap and vlen != TOMBSTONE_VLEN:
                if obs.enabled and not obs.wall and self.ralt is not None:
                    obs.tracer.instant(
                        self._obs_track, "promo/get",
                        {"key": int(key),
                         "ralt_hot": bool(self.ralt.is_hot(key)),
                         "score_bytes":
                             float(self.ralt.range_hot_bytes(key, key))})
                self._insert_pc(key, seq, vlen, touched)
            return self._finish_get(key, (seq, vlen), tier="SD")
        self.stats.misses += 1  # lint: allow-stats (engine)
        if obs.enabled and obs.attribution:
            obs.attr.end_get(self, "miss")
        return None

    def scan(self, lo: int, n: int) -> list[tuple[int, int, int]]:
        """YCSB-style scan: up to `n` live records with key >= lo.

        Returns [(key, seq, vlen)] in ascending key order, with `get`'s
        visibility semantics per key (top-down-first-match, tombstones
        suppress).  Charges per-block sequential scan I/O; see
        core/scan.py for the merged-iterator machinery.
        """
        return self._scan(lo, MAX_KEY, n)

    def scan_range(self, lo: int, hi: int) -> list[tuple[int, int, int]]:
        """All live records with lo <= key <= hi (same semantics as scan)."""
        return self._scan(lo, hi, None)

    def scan_tagged(self, lo: int, n: int,
                    hi: int | None = None) -> list[tuple[int, int, int, str]]:
        """Router API (core/shards.py): `scan`/`scan_range` plus each
        record's serving tier ("mem"/"FD"/"PC"/"SD"), so a fan-out merge
        can correct aggregate stats for records it discards."""
        tags: list[str] = []
        out = self._scan(lo, MAX_KEY if hi is None else hi, n, tags=tags)
        return [(k, s, v, t) for (k, s, v), t in zip(out, tags)]

    def _scan(self, lo: int, hi: int, limit: int | None,
              tags: list | None = None) -> list[tuple[int, int, int]]:
        self.stats.scans += 1  # lint: allow-stats (engine)
        self._tick()
        if limit is not None and limit <= 0:
            return []
        obs = self._obs
        if obs.enabled and obs.attribution:
            obs.attr.begin_get(self)
        v = self.version               # pinned snapshot for the whole scan
        counters = MergeCounters()
        smap = build_sources(self, v, lo, hi, self._scan_charge_block)
        out: list[tuple[int, int, int]] = []
        sd_hits: list[tuple[int, int, int, int]] = []
        st = self.stats
        for key, seq, vlen, pri, sid in merge_scan(smap.sources, counters):
            if vlen == TOMBSTONE_VLEN:
                continue
            out.append((key, seq, vlen))
            tier = smap.classify(pri)
            if tags is not None:
                tags.append(tier)
            if tier == "mem":
                st.scan_served_mem += 1
            elif tier == "FD":
                st.scan_served_fd += 1
            elif tier == "PC":
                st.scan_served_pc += 1
            else:
                st.scan_served_sd += 1
                sd_hits.append((key, seq, vlen, sid))
            if limit is not None and len(out) >= limit:
                break
        st.scanned_records += len(out)
        st.scan_cursor_pulls += counters.pulls
        st.scan_merge_compares += counters.compares
        if obs.enabled and obs.attribution:
            obs.attr.end_get(self, "scan")
        if self.cfg.hotrap and self.ralt is not None and out:
            # clamp an open-ended scan(lo, n) to the range actually served
            hi_eff = out[-1][0] if limit is not None else hi
            self._record_scan_hotness(lo, hi_eff, out, sd_hits, v)
        return out

    def _record_scan_hotness(self, lo: int, hi: int,
                             out: list[tuple[int, int, int]],
                             sd_hits: list[tuple[int, int, int, int]],
                             version: Version) -> None:
        """Scan-side hotness pathway, on the scan's pinned Version.

        Every served record is batch-logged in RALT (scan-length-aware
        scoring).  SD-served records then promote: as one whole-range
        batch when RALT's index says the scanned range itself is hot
        (range promotion), otherwise per record, gated by the vectorized
        `is_hot_many`.  Both paths run the §3.3 concurrency check per
        record with touched-SSTable lists from the pinned Version.
        """
        keys = np.fromiter((k for k, _, _ in out), dtype=np.int64,
                           count=len(out))
        vlens = np.fromiter((v for _, _, v in out), dtype=np.int64,
                            count=len(out))
        self.ralt.record_range_access(lo, hi, keys, vlens)
        if not sd_hits:
            return
        skeys = np.fromiter((k for k, _, _, _ in sd_hits), dtype=np.int64,
                            count=len(sd_hits))
        wsids = np.fromiter((s for _, _, _, s in sd_hits), dtype=np.int64,
                            count=len(sd_hits))
        # RALT's range hot bytes and its per-key answers are pure reads:
        # both come in one copy, whichever of them the branch below uses
        hot_bytes, hot = self.ralt.hotness(lo, hi, skeys) \
            if self.cfg.hotness_check else (0, None)
        if (self.cfg.range_promotion and self.cfg.hotness_check
                and self._scanned_range_is_hot(out, hot_bytes)):
            touched = version.sd_touched_many(skeys, wsids,
                                              self.cfg.n_fd_levels)
            self.stats.range_promotions += 1  # lint: allow-stats (engine)
            # lint: allow-stats (engine-owned Stats)
            self.stats.range_promoted_records += len(sd_hits)
            if self._obs.enabled and not self._obs.wall:
                self._obs.tracer.instant(
                    self._obs_track, "promo/scan",
                    {"records": len(sd_hits), "range_promotion": True,
                     "score_bytes": float(self.ralt.range_hot_bytes(lo, hi)),
                     "scanned": len(out)})
            for (key, seq, vlen, _), t in zip(sd_hits, touched):
                self.stats.scan_pc_inserts += 1  # lint: allow-stats (engine)
                self._insert_pc(key, seq, vlen, t)
            return
        # Table-4 ablation parity: hotness_check=False promotes every
        # SD-served record, on scans just like on point gets.
        if not self.cfg.hotness_check:
            hot = np.ones(len(sd_hits), dtype=bool)
        sel = np.flatnonzero(hot)
        if not len(sel):
            return
        touched = version.sd_touched_many(skeys[sel], wsids[sel],
                                          self.cfg.n_fd_levels)
        if self._obs.enabled and not self._obs.wall:
            self._obs.tracer.instant(
                self._obs_track, "promo/scan",
                {"records": int(len(sel)), "range_promotion": False,
                 "score_bytes": float(self.ralt.range_hot_bytes(lo, hi)),
                 "scanned": len(out)})
        for j, t in zip(sel, touched):
            key, seq, vlen, _ = sd_hits[j]
            self.stats.scan_pc_inserts += 1  # lint: allow-stats (engine)
            self._insert_pc(key, seq, vlen, t)

    def _scanned_range_is_hot(self, out: list[tuple[int, int, int]],
                              hot_bytes: int) -> bool:
        """Range-promotion trigger: RALT's per-run hot-bytes index says
        at least `range_promo_frac` of the scanned HotRAP bytes belong to
        the hot set (`hot_bytes`: its estimate over the scanned range)."""
        scanned_bytes = sum(KEY_BYTES + v for _, _, v in out)
        if scanned_bytes <= 0:
            return False
        return hot_bytes >= self.cfg.range_promo_frac * scanned_bytes

    def _scan_charge_block(self, sst: SSTable, blk: int) -> None:
        """Charge one scanned data block (block-cache hits are free)."""
        if not self.block_cache.access((sst.sid, blk)):
            self.storage.seq_read(sst.tier, BLOCK_BYTES, fg=True,
                                  component="scan")

    # ------------------------------------------------------------------
    # read path internals
    # ------------------------------------------------------------------
    @staticmethod
    def _vbytes(vlen: int) -> int:
        return 0 if vlen == TOMBSTONE_VLEN else vlen

    @staticmethod
    def _dict_resolve(get, keys: list) -> tuple[np.ndarray, ...]:
        """Look `keys` up through `get` (a memtable's or the mPC's): the
        hit mask, and the hits' seqs and vlens in key order."""
        hits = list(map(get, keys))     # (seq, vlen) tuples or None
        mask = np.fromiter(map(bool, hits), dtype=bool, count=len(hits))
        rows = np.array(list(filter(None, hits)),
                        dtype=np.int64).reshape(-1, 2)
        return mask, rows[:, 0], rows[:, 1]

    def _probe_group(self, key: int, group: str, version: Version,
                     touched: list[int] | None = None):
        """Search one level group ("FD" or "SD") for `key`: one binary
        search over the group's view when a scan has materialized it,
        else the per-level probe walk.  Returns (seq, vlen, sid) or
        None."""
        if (self._point_view_ok and self.cfg.remix_views
                and self.cfg.point_view_gets):
            res = self._view_point_get(key, group, version, touched)
            if res is not _VIEW_MISS:
                return res
        n_fd = self.cfg.n_fd_levels
        rng = (range(0, n_fd) if group == "FD"
               else range(n_fd, len(version.levels)))
        return self._search_levels(key, rng, touched=touched,
                                   version=version)

    def _view_point_get(self, key: int, group: str, version: Version,
                        touched: list[int] | None = None):
        """One binary search over a cached GroupView; ``_VIEW_MISS``
        when the view is not materialized.  The winner's data block is
        charged exactly like the probe walk's winning probe; an absent
        key charges nothing.  SD hits fill `touched` with the §3.3
        probed-above-winner table list via the pinned Version."""
        sig = (group,) + version.group_signature(group, self.cfg.n_fd_levels)
        view = self._view_cache.peek(sig)
        if view is None:
            return _VIEW_MISS
        found = view.point_find(key)
        saved = view.probes_replaced(key, found[2] if found else None)
        self.stats.get_view_hits += 1  # lint: allow-stats (engine)
        self.stats.get_probes_saved += saved  # lint: allow-stats (engine)
        if found is None:
            return None
        seq, vlen, si, blk = found
        sst = view.ssts[si]
        if not self.block_cache.access((sst.sid, blk)):
            self.storage.rand_read(sst.tier, BLOCK_BYTES, fg=True,
                                   component="get")
        if touched is not None and group == "SD":
            touched.extend(version.sd_touched_many(
                np.array([key], dtype=np.int64),
                np.array([sst.sid], dtype=np.int64),
                self.cfg.n_fd_levels)[0])
        return seq, vlen, sst.sid

    def _finish_get(self, key: int, hit: tuple[int, int], tier):
        seq, vlen = hit
        obs = self._obs
        if vlen == TOMBSTONE_VLEN:
            self.stats.misses += 1  # lint: allow-stats (engine)
            if obs.enabled and obs.attribution:
                obs.attr.end_get(self, "miss")
            return None
        if obs.enabled and obs.attribution:
            obs.attr.end_get(self, tier or "mem")
        if self.ralt is not None:
            self.ralt.record_access(key, vlen)
        return seq, vlen

    def _search_levels(self, key: int, level_range,
                       touched: list[int] | None = None,
                       version: Version | None = None):
        levels = (version or self.version).levels
        for li in level_range:
            sstables = levels[li]
            if not sstables:
                continue
            if li == 0:
                cands = [s for s in sstables
                         if s.min_key <= key <= s.max_key]
            else:
                idx = self._bisect_level(sstables, key)
                cands = [sstables[idx]] if idx is not None else []
            for s in cands:
                if touched is not None:
                    touched.append(s.sid)
                if not s.bloom.may_contain(key):
                    continue
                found = s.find(key)
                # bloom said maybe: charge the data-block read even on FP
                blk = found[2] if found else s.miss_block(key)
                if not self.block_cache.access((s.sid, blk)):
                    self.storage.rand_read(s.tier, BLOCK_BYTES, fg=True,
                                           component="get")
                if found:
                    return found[0], found[1], s.sid
        return None

    @staticmethod
    def _bisect_level(sstables: list[SSTable], key: int):
        lo, hi = 0, len(sstables) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            s = sstables[mid]
            if key < s.min_key:
                hi = mid - 1
            elif key > s.max_key:
                lo = mid + 1
            else:
                return mid
        return None

    # ------------------------------------------------------------------
    # batched read path (vectorized batch execution)
    # ------------------------------------------------------------------
    def _batch_probe_group(self, ks: np.ndarray, idx: np.ndarray,
                           group: str, version: Version, ev: list):
        """Columnar `_probe_group`: resolve one level group for the
        batch positions `idx`.  Returns (found_mask, seqs, vlens, sids,
        via_view): the mask aligned with `idx`, the seqs, vlens and
        winning sids of the found positions alone, and whether a view
        served the group.  Pure resolution — no I/O or cache state
        mutates here; pending charges are appended to `ev` as (pos, sid,
        blk, is_sd) array tuples in scalar probe order and the caller
        replays them per key in input order."""
        nk = len(idx)
        sub = ks[idx]
        f_seq = np.zeros(nk, dtype=np.int64)
        f_vlen = np.zeros(nk, dtype=np.int64)
        f_sid = np.zeros(nk, dtype=np.int64)
        f_found = np.zeros(nk, dtype=bool)
        n_fd = self.cfg.n_fd_levels
        if (self._point_view_ok and self.cfg.remix_views
                and self.cfg.point_view_gets):
            view = self._view_cache.peek(
                (group,) + version.group_signature(group, n_fd))
            if view is not None:
                self._batch_view_get(view, group, sub, idx, ev,
                                     f_seq, f_vlen, f_sid, f_found)
                return (f_found, f_seq[f_found], f_vlen[f_found],
                        f_sid[f_found], True)
        levels = (range(0, n_fd) if group == "FD"
                  else range(n_fd, len(version.levels)))
        active = np.ones(nk, dtype=bool)
        # lint: allow-loop (the walk's steps: L0's tables and the group's
        # levels, bounded by tree topology, not batch size)
        for sel, sids, on_sd, rows in self._batch_walk_levels(
                sub, levels, version, active):
            # one pending charge per bloom-positive key: false positives
            # charge the block they would have read, like the scalar walk
            may = rows[0] != 0
            if not may.any():
                continue
            psel, psid, prow = sel[may], sids[may], rows[:, may]
            ev.append((idx[psel].astype(np.int64), psid, prow[4],
                       on_sd[may]))
            found = prow[1] != 0
            w = psel[found]
            f_seq[w] = prow[2][found]
            f_vlen[w] = prow[3][found]
            f_sid[w] = psid[found]
            f_found[w] = True
            active[w] = False
        return f_found, f_seq[f_found], f_vlen[f_found], f_sid[f_found], False

    def _batch_view_get(self, view: GroupView, group: str, sub: np.ndarray,
                        idx: np.ndarray, ev: list, f_seq: np.ndarray,
                        f_vlen: np.ndarray, f_sid: np.ndarray,
                        f_found: np.ndarray) -> None:
        """`_view_point_get`, batched: one binary search on the device
        over an already-materialized GroupView for the whole sub-batch,
        its results copied to the host in one transfer.  Absent keys
        charge nothing; each winner charges exactly its data block.  The
        probes-saved tally is the vectorized `probes_replaced`."""
        sd = torch.from_numpy(sub).to(view.rows.device)
        nv = view.n
        if nv:
            pos = torch.searchsorted(view.keys, sd)
            posc = pos.clamp(max=nv - 1)
            hit = (pos < nv) & (view.keys[posc] == sd)
        else:
            posc = torch.zeros_like(sd)
            hit = torch.zeros(len(sd), dtype=torch.bool, device=sd.device)
        if len(view.sids):
            cover = ((view.sst_mins[None, :] <= sd[:, None])
                     & (sd[:, None] <= view.sst_maxs[None, :]))
            saved = (cover.sum(dim=1) - 1).clamp(min=0)
            if nv:
                win_pri = view.sst_pris[view.src[posc]]
                above = (cover
                         & (view.sst_pris[None, :] < win_pri[:, None])
                         ).sum(dim=1)
                saved = torch.where(hit, above, saved)
        else:
            saved = torch.zeros_like(sd)
        cols = [hit.long(), saved]
        if nv:
            cols += [view.seqs[posc], view.vlens[posc], view.src[posc],
                     view.blks[posc]]
        cols = torch.stack(cols).cpu().numpy()
        hit, saved = cols[0].astype(bool), cols[1]
        self.stats.get_view_hits += len(sub)  # lint: allow-stats (engine)
        # lint: allow-stats (engine-owned Stats)
        self.stats.get_probes_saved += int(saved.sum())
        if not hit.any():
            return
        w = np.flatnonzero(hit)
        f_seq[w] = cols[2][w]
        f_vlen[w] = cols[3][w]
        f_sid[w] = np.asarray(view.sids, dtype=np.int64)[cols[4][w]]
        f_found[w] = True
        ev.append((idx[w].astype(np.int64), f_sid[w], cols[5][w],
                   np.full(len(w), group == "SD", dtype=bool)))

    def _batch_walk_levels(self, keys: np.ndarray, levels: range,
                           version: Version, active: np.ndarray):
        """Columnar `_search_levels`, the engine's one walk over a
        Version's levels: yields each probe step in walk order, L0's
        tables in list order (newest first, one `SSTable.probe_many`
        each), then one step per sorted level (a fence-pointer
        `searchsorted` on the host, one `LevelIndex.probe` on the
        device).  A step is (sel, sids, on_sd, rows): the positions in
        `keys` still `active` that the table or level covers, each
        one's table sid and whether that table is on SD, and the (5, m)
        probe rows (bloom says maybe, found, seq, vlen, block).
        `active` is read at every step, so the caller may clear
        positions between steps; the walk stops once none is left."""
        # lint: allow-loop (per-level walk — bounded by tree topology,
        # not batch size; the per-key work inside each level is
        # vectorized)
        for li in levels:
            sstables = version.levels[li]
            if not sstables:
                continue
            if li == 0:
                # L0 runs overlap: probe in list order (newest first)
                # lint: allow-loop (L0 run list — bounded by the
                # compaction trigger, not by batch size)
                for s in sstables:
                    if not active.any():
                        return
                    sel = np.flatnonzero(
                        active & (s.min_key <= keys) & (keys <= s.max_key))
                    if len(sel):
                        yield (sel, np.full(len(sel), s.sid, dtype=np.int64),
                               np.full(len(sel), s.tier == "SD"),
                               s.probe_many(keys[sel]))
                continue
            if not active.any():
                return
            # a sorted level: at most one table covers a key
            mins, maxs, sids = version.level_fences(li)
            pos = np.searchsorted(maxs, keys, "left")
            posc = np.minimum(pos, len(sstables) - 1)
            sel = np.flatnonzero(
                active & (pos < len(sstables)) & (mins[posc] <= keys))
            if not len(sel):
                continue
            tables = posc[sel]
            on_sd = np.fromiter((s.tier == "SD" for s in sstables), bool,
                                len(sstables))
            yield (sel, sids[tables], on_sd[tables],
                   self._level_index(version, li).probe(keys[sel], tables))

    def _level_index(self, version: Version, li: int) -> LevelIndex:
        """The LevelIndex of a sorted level, cached by the level's sids
        (a level's tables never change, so the sids name its data)."""
        sig = version.level_fences(li)[2].tobytes()
        index = self._level_cache.pop(sig, None)
        if index is None:
            if self._obs.wall:
                self._obs.tracer.instant(self._obs_track, "level_index/build")
            index = LevelIndex(version.levels[li], self.device)
            while len(self._level_cache) >= LEVEL_CACHE:
                self._level_cache.pop(next(iter(self._level_cache)))
        self._level_cache[sig] = index
        return index

    # ------------------------------------------------------------------
    # promotion cache (§3.3)
    # ------------------------------------------------------------------
    def _insert_pc(self, key: int, seq: int, vlen: int,
                   touched: list[int]) -> None:
        if self.defer_pc_inserts > 0:
            self._deferred_pc.append(
                (self.now + self.defer_pc_inserts, key, seq, vlen, touched))
            return
        self._do_insert_pc(key, seq, vlen, touched)

    def _do_insert_pc(self, key: int, seq: int, vlen: int,
                      touched: list[int]) -> None:
        # §3.3: abort when any SD SSTable recorded during the access is
        # being / has been compacted (a newer version may have sunk past us).
        if any(self._sid_compacted.get(sid, False) for sid in touched):
            self.stats.pc_insert_aborts += 1  # lint: allow-stats (engine)
            return
        self.stats.pc_inserts += 1  # lint: allow-stats (engine)
        self.mpc.insert(key, seq, vlen, KEY_BYTES)
        if self.mpc.bytes >= self.cfg.target_sstable_bytes:
            self._freeze_mpc()

    # ------------------------------------------------------------------
    # promotion by flush (§3.4)
    # ------------------------------------------------------------------
    def _freeze_mpc(self) -> None:
        if not self.cfg.promotion_by_flush:
            # without the flush path the mPC just grows; cap it by dropping
            # (records remain readable from SD) — keeps ablations runnable.
            if self.mpc.bytes >= 4 * self.cfg.target_sstable_bytes:
                self.mpc = MutablePromotionCache()
            return
        records = sorted((k, sv[0], sv[1]) for k, sv in self.mpc.data.items())
        if self._obs.enabled:
            self._obs.tracer.instant(self._obs_track, "mpc_freeze",
                                     {"records": len(records),
                                      "bytes": int(self.mpc.bytes)})
        # pin the superversion (paper step 4, under DB mutex): the
        # current Version plus the immutable memtables, by reference —
        # installs after this point publish new Versions and cannot
        # perturb what the Checker will search.
        sv = Superversion(self.version.ref(),
                          [dict(m) for m in self.imm_memtables])
        immpc = ImmutablePromotionCache(records, sv)
        self.immpcs.append(immpc)
        self.mpc = MutablePromotionCache()
        self._checker_queue.append((self.now + self.cfg.checker_delay_ops,
                                    immpc))

    def _run_checker(self, immpc: ImmutablePromotionCache) -> None:
        """Background Checker (Fig. 5 steps 5-11), against the frozen
        Superversion pinned at freeze time.  Under a wall-clock plane the
        `checker` span ends with the records' count, the candidates among
        them and the block-cache accesses their walks made."""
        obs = self._obs
        if not obs.enabled:
            self._checker_body(immpc)
            return
        tr, track = obs.tracer, self._obs_track
        args = {"records": len(immpc.records)}
        tr.begin(track, "checker", args)
        counts = (0, 0)
        try:
            counts = self._checker_body(immpc)
        finally:
            tr.end(track, "checker",
                   {**args, "candidates": counts[0],
                    "block_events": counts[1]} if obs.wall else None)

    def _checker_body(self, immpc: ImmutablePromotionCache
                      ) -> tuple[int, int]:
        """The reference's per-record checker, decided in whole columns:
        the records' hotness (RALT's probes on the device), the `updated`
        mask, and for the candidates left (hot, not updated)
        `_newer_in_snapshot`; the survivors, in record order, go to L0
        or, under half a table, back into the mPC.  Returns the count of
        candidates and of the block-cache accesses made."""
        st = self.stats
        st.checker_runs += 1  # lint: allow-stats (engine)
        if immpc not in self.immpcs:
            immpc.sv.release()              # no-op if already released
            return 0, 0
        try:
            rec = np.array(immpc.records, dtype=np.int64).reshape(-1, 3)
            keys = rec[:, 0]
            check_hot = self.cfg.hotness_check and self.ralt is not None
            is_hot = (self.ralt.is_hot_many(keys) if check_hot
                      else np.ones(len(keys), dtype=bool))
            upd = np.zeros(len(keys), dtype=bool)
            if immpc.updated:                # Fig. 5 (a)-(c) protocol
                upd = np.isin(keys, np.fromiter(immpc.updated, np.int64,
                                                len(immpc.updated)))
            cand = np.flatnonzero(is_hot & ~upd)
            newer, n_events = self._newer_in_snapshot(keys[cand],
                                                      rec[cand, 1], immpc)
            # lint: allow-stats (engine-owned Stats)
            st.checker_excluded_updated += int(np.count_nonzero(is_hot & upd))
            # lint: allow-stats (engine-owned Stats)
            st.checker_excluded_newer += int(np.count_nonzero(newer))
            hot = rec[cand[~newer]]
        finally:
            # unpin the frozen Version on *every* exit
            self.immpcs.remove(immpc)
            immpc.sv.release()
        counts = (len(cand), n_events)
        if not len(hot):
            return counts
        hot_bytes = KEY_BYTES * len(hot) + int(hot[:, 2].sum())
        if hot_bytes < self.cfg.target_sstable_bytes // 2:
            # too few: back into the mPC instead of polluting L0 (footnote 1)
            # lint: allow-loop (under half a table of survivors; each
            # insert compares with what the mPC holds by then)
            for k, s, v in hot.tolist():
                self.mpc.insert(k, s, v, KEY_BYTES)
            return counts
        sst = sstable_from_host(hot, "FD", 0, self.now, self.cfg.bits_per_key,
                                self.device)
        self.storage.seq_write("FD", sst.size_bytes, fg=False,
                               component="promotion")
        # lint: allow-stats (engine-owned Stats)
        self.stats.promoted_bytes += sst.size_bytes
        if self._obs.enabled:
            self._obs.tracer.instant(self._obs_track, "promo/flush",
                                     {"records": len(hot),
                                      "bytes": int(sst.size_bytes)})
        self._publish(self._levels_with(0, [sst] + self.version.levels[0]))
        if self.durability is not None:
            self.durability.manifest.begin_edit("promotion",
                                                self.version)
            crashpoints.hit("mid-promotion-install", self._obs,
                            self._obs_track)
            self.durability.manifest.commit_edit()
        self._maybe_compact()
        return counts

    def _newer_in_snapshot(self, keys: np.ndarray, seqs: np.ndarray,
                           immpc: ImmutablePromotionCache
                           ) -> tuple[np.ndarray, int]:
        """Fig. 5 step 8 for every candidate at once: whether a newer
        version is in the frozen superversion's imm-memtables or FD
        levels, with the block-cache accesses and charges the reference's
        per-record walk makes, in its order.  A walk ends at the first
        newer version: an imm-memtable's (no block read) or the first
        event (a table, in walk order, whose probe finds the key) with a
        newer seq; it reads the block of each event up to and including
        that one.  Returns the newer mask and the count of accesses."""
        n = len(keys)
        newer = np.zeros(n, dtype=bool)
        if immpc.sv.imm_memtables and n:
            kl, sl = keys.tolist(), seqs.tolist()
            # lint: allow-loop (the pinned imm-memtables, bounded by the
            # rotation backlog, not by the records)
            for m in immpc.sv.imm_memtables:
                newer |= np.array([h is not None and h[0] > s
                                   for h, s in zip(map(m.get, kl), sl)],
                                  dtype=bool)
        walk = np.flatnonzero(~newer)
        pos, rank, sid, blk, fseq, sd = self._snapshot_probes(
            keys[walk], immpc.sv.version)
        if not len(pos):
            return newer, 0
        pos = walk[pos]
        # each candidate's first newer event, by walk rank
        never = np.iinfo(np.int64).max
        first = np.full(n, never, dtype=np.int64)
        late = fseq > seqs[pos]
        np.minimum.at(first, pos[late], rank[late])
        made = np.flatnonzero(rank <= first[pos])
        made = made[np.lexsort((rank[made], pos[made]))]
        miss = ~self.block_cache.access_many(sid[made], blk[made])
        self.storage.rand_read_many(sd[made][miss], BLOCK_BYTES, fg=False,
                                    component="checker")
        newer |= first != never
        return newer, len(made)

    def _snapshot_probes(self, keys: np.ndarray, version: Version
                         ) -> tuple[np.ndarray, ...]:
        """Device probes of a frozen Version's FD tables for the
        checker's keys, as the events of the reference's walk: each
        (key, covering table) pair whose bloom says maybe and whose
        search finds the key, in columns: the key's position in `keys`,
        the step's rank in `_batch_walk_levels`, the table's sid, the
        record's block and seq, and whether the table is on SD.  Every
        key walks every FD level: a walk ends at a newer version, which
        `_newer_in_snapshot` finds from the ranks."""
        ev: list = []
        steps = self._batch_walk_levels(
            keys, range(min(self.cfg.n_fd_levels, len(version.levels))),
            version, np.ones(len(keys), dtype=bool))
        # lint: allow-loop (the walk's steps: L0's tables and the FD
        # levels, topology, not records)
        for rank, (sel, sids, on_sd, rows) in enumerate(steps):
            e = (rows[0] != 0) & (rows[1] != 0)
            ev.append((sel[e], np.full(int(np.count_nonzero(e)), rank,
                                       dtype=np.int64),
                       sids[e], rows[4][e], rows[2][e], on_sd[e]))
        if not ev:
            return tuple(np.zeros(0, dtype=np.int64) for _ in range(5)) + (
                np.zeros(0, dtype=bool),)
        return tuple(np.concatenate(c) for c in zip(*ev))

    # ------------------------------------------------------------------
    # flush & the updated-field protocol (Fig. 5 a-c)
    # ------------------------------------------------------------------
    def _rotate_memtable(self) -> None:
        if not self.memtable:
            return
        # memtable becomes immutable: register its keys with every immPC
        if self.immpcs:
            for key in self.memtable:
                for immpc in self.immpcs:
                    if key in immpc.key_set:
                        immpc.updated.add(key)
        self.imm_memtables.insert(0, self.memtable)
        self.memtable = {}
        self.memtable_bytes = 0

    def _flush_imm_memtables(self) -> None:
        while self.imm_memtables:
            table = self.imm_memtables.pop()
            if not table:
                continue
            # the span covers the sort and the table's build on the
            # device; neither charges simulated I/O
            obs = self._obs
            if obs.enabled:
                obs.tracer.begin(self._obs_track, "flush",
                                 {"records": len(table)})
            cols = np.array([(k, sv[0], sv[1]) for k, sv in
                             sorted(table.items())], dtype=np.int64)
            sst = sstable_from_host(cols, "FD", 0, self.now,
                                    self.cfg.bits_per_key, self.device)
            self.storage.seq_write("FD", sst.size_bytes, fg=False,
                                   component="flush")
            # each flush publishes a new Version with the run at the L0
            # front (newest first)
            self._publish(self._levels_with(0,
                                            [sst] + self.version.levels[0]))
            self.stats.flushes += 1  # lint: allow-stats (engine)
            if obs.enabled:
                obs.tracer.end(self._obs_track, "flush",
                               {"bytes": int(sst.size_bytes),
                                "vid": self.version.vid})
            if self.durability is not None:
                self._log_flush(int(cols[:, 1].max()))

    def _log_flush(self, flushed_through: int) -> None:
        """Durably record one flush install: a two-phase manifest edit
        (the mid-flush crash site sits between the halves — a crash
        leaves a torn edit and the flushed run as orphaned debris), then
        drop the WAL prefix the committed cut covers."""
        d = self.durability
        d.manifest.begin_edit("flush", self.version, flushed_through)
        crashpoints.hit("mid-flush", self._obs, self._obs_track)
        d.manifest.commit_edit()
        d.wal.truncate_through(d.manifest.flushed_through)

    # ------------------------------------------------------------------
    # compaction
    # ------------------------------------------------------------------
    def level_bytes(self, li: int) -> int:
        return sum(s.size_bytes for s in self.levels[li])

    def _maybe_compact(self) -> None:
        stuck: set[int] = set()
        for _ in range(256):  # progress guard
            work = False
            if len(self.levels[0]) >= self.cfg.l0_compaction_trigger:
                self._compact_l0()
                work = True
            for li in range(1, len(self.levels) - 1):
                if li in stuck:
                    continue
                if self.level_bytes(li) > self.caps[li]:
                    before = self.level_bytes(li)
                    self._compact_one(li)
                    if self.level_bytes(li) >= before:
                        # retention wrote everything back — no progress is
                        # possible right now (all-hot level); defer.
                        stuck.add(li)
                    else:
                        work = True
            if not work:
                return

    def _compact_l0(self) -> None:
        inputs = list(self.levels[0])
        if not inputs:
            return
        lo = min(s.min_key for s in inputs)
        hi = max(s.max_key for s in inputs)
        self._merge_into_next(0, inputs, lo, hi)

    def _compact_one(self, li: int) -> bool:
        sstables = self.levels[li]
        if not sstables:
            return False
        cross_tier = (li == self.cfg.n_fd_levels - 1) and self.cfg.hotrap \
            and self.cfg.retention
        pick = self._pick_sstable(li, cross_tier)
        if pick is None:
            return False
        self._merge_into_next(li, [pick], pick.min_key, pick.max_key)
        return True

    def _pick_sstable(self, li: int, cross_tier: bool) -> SSTable | None:
        """§3.5: cost-benefit with HotSize-adjusted benefit at the tier
        boundary; fall back to the oldest SSTable when all benefits <= 0.
        RALT's hot bytes of every candidate come in one batch."""
        level = self.levels[li]
        hots = None
        if cross_tier and self.ralt is not None:
            hots = self.ralt.range_hot_bytes_many(
                [s.min_key for s in level], [s.max_key for s in level])
        # bytes of the next (sorted, disjoint) level's tables overlapping
        # each candidate: a contiguous run of it, summed by prefix sums
        mins, maxs, _ = self.version.level_fences(li)
        nmins, nmaxs, _ = self.version.level_fences(li + 1)
        cum = np.concatenate([[0], np.cumsum(
            [t.size_bytes for t in self.levels[li + 1]], dtype=np.int64)])
        overlaps = (cum[np.searchsorted(nmins, maxs, "right")]
                    - cum[np.searchsorted(nmaxs, mins, "left")]).tolist()
        best, best_score = None, -1.0
        for i, s in enumerate(level):
            overlap = max(overlaps[i], 0)
            benefit = float(s.size_bytes)
            if hots is not None:
                benefit -= hots[i]
            score = benefit / float(s.size_bytes + overlap)
            if score > best_score:
                best, best_score = s, score
        if best_score <= 0.0:
            best = min(level, key=lambda s: s.created_at)
        return best

    def _merge_into_next(self, li: int, inputs: list[SSTable],
                         lo: int, hi: int) -> None:
        lj = li + 1
        obs = self._obs
        if obs.enabled:
            obs.tracer.begin(self._obs_track, "compaction",
                             {"from": li, "to": lj})
        ret0 = self.stats.retained_bytes
        pro0 = self.stats.promoted_bytes
        nexts = [t for t in self.levels[lj] if t.overlaps(lo, hi)]
        all_inputs = inputs + nexts
        for s in all_inputs:
            s.mark_compacting()
        in_bytes = sum(s.size_bytes for s in all_inputs)
        for s in all_inputs:
            self.storage.seq_read(s.tier, s.size_bytes, fg=False,
                                  component="compaction")
        self.stats.compaction_bytes += in_bytes  # lint: allow-stats (engine)
        self.stats.compactions += 1  # lint: allow-stats (engine)

        cross_tier = (lj == self.cfg.n_fd_levels) and self.cfg.hotrap
        last_level = (lj == len(self.levels) - 1)
        if cross_tier:
            fd_out, sd_out = self._merge_cross_tier(inputs, nexts, lo, hi,
                                                    last_level)
            new_fd = split_into_sstables(*fd_out, "FD", li, self.now,
                                         self.cfg.target_sstable_bytes)
            new_sd = split_into_sstables(*sd_out, "SD", lj, self.now,
                                         self.cfg.target_sstable_bytes)
            fd_bytes = sum(s.size_bytes for s in new_fd)
            sd_bytes = sum(s.size_bytes for s in new_sd)
            if fd_bytes:
                self.storage.seq_write("FD", fd_bytes, fg=False,
                                       component="compaction")
            if sd_bytes:
                self.storage.seq_write("SD", sd_bytes, fg=False,
                                       component="compaction")
            # lint: allow-stats (engine-owned Stats)
            self.stats.compaction_bytes += fd_bytes + sd_bytes
            self._install_edits([(li, inputs, new_fd),
                                 (lj, nexts, new_sd)])
        else:
            runs = [(s.keys, s.seqs, s.vlens) for s in all_inputs]
            merged = merge_runs(runs, drop_tombstones=last_level,
                                device=self.device)
            tier = "FD" if lj < self.cfg.n_fd_levels else "SD"
            new = split_into_sstables(*merged, tier, lj, self.now,
                                      self.cfg.target_sstable_bytes)
            out_bytes = sum(s.size_bytes for s in new)
            if out_bytes:
                self.storage.seq_write(tier, out_bytes, fg=False,
                                       component="compaction")
            # lint: allow-stats (engine-owned Stats)
            self.stats.compaction_bytes += out_bytes
            self._install_edits([(li, inputs, []),
                                 (lj, nexts, new)])
        for s in all_inputs:
            s.finish_compaction()
            self._sid_compacted[s.sid] = True
            self.block_cache.invalidate_sstable(s.sid)
        if obs.enabled:
            dret = self.stats.retained_bytes - ret0
            dpro = self.stats.promoted_bytes - pro0
            if dret or dpro:
                obs.tracer.instant(self._obs_track, "promo/retained",
                                   {"retained_bytes": dret,
                                    "promoted_bytes": dpro})
            obs.tracer.end(self._obs_track, "compaction",
                           {"in_bytes": int(in_bytes),
                            "cross_tier": cross_tier,
                            "vid": self.version.vid})

    def _merge_cross_tier(self, fd_inputs: list[SSTable],
                          sd_inputs: list[SSTable], lo: int, hi: int,
                          last_level: bool):
        """Retention (Fig. 2 steps 3-5) + promotion by compaction (6-9),
        on the device.

        Returns ((keys,seqs,vlens) destined for FD, same for SD)."""
        SRC_FD, SRC_PC, SRC_SD = 0, 1, 2
        dev = self.device
        tables = list(fd_inputs) + list(sd_inputs)
        pc_records = []
        if self.cfg.promotion_by_compaction:
            pc_records = self.mpc.extract_range(lo, hi, KEY_BYTES)
        n_pc = len(pc_records)
        # the mPC's records (key, seq, vlen rows) and every row's source
        # in one copy to the device
        srcs = np.concatenate(
            [np.full(s.n, SRC_FD if i < len(fd_inputs) else SRC_SD)
             for i, s in enumerate(tables)] + [np.full(n_pc, SRC_PC)])
        host = (np.concatenate([np.array(pc_records, dtype=np.int64)
                                .T.reshape(-1), srcs]) if n_pc else srcs)
        d = torch.from_numpy(host.astype(np.int64)).to(dev)
        pc = d[:3 * n_pc].view(3, n_pc)
        # (key, seq, vlen, source) rows of every input, sorted by key,
        # newest first, ties by source
        rows = torch.stack([torch.cat([getattr(s, name) for s in tables]
                                      + [pc[i]])
                            for i, name in enumerate(("keys", "seqs",
                                                      "vlens"))]
                           + [d[3 * n_pc:]])
        rows = rows[:, lexsort([rows[3], -rows[1], rows[0]])]
        keys, seqs, vlens, srcs = rows
        first = torch.ones(len(keys), dtype=torch.bool, device=dev)
        first[1:] = keys[1:] != keys[:-1]

        # hotness of each winning key via the RALT hot-key iterator
        if self.ralt is not None:
            hot_keys, _ = self.ralt.scan_hot(lo, hi)
        else:
            hot_keys = torch.zeros(0, dtype=torch.int64, device=dev)
        # the winners, one row a key (a fresh tensor: edited in place)
        win = rows[:, first]
        wk, ws, wv, wsrc = win
        nh = len(hot_keys)
        if nh:
            pos = torch.searchsorted(hot_keys, wk)
            is_hot = (pos < nh) & (hot_keys[pos.clamp(max=nh - 1)] == wk)
        else:
            is_hot = torch.zeros(len(wk), dtype=torch.bool, device=dev)
        not_tomb = wv != TOMBSTONE_VLEN
        from_pc = wsrc == SRC_PC
        to_fd = from_pc & (is_hot | (not self.cfg.hotness_check))
        if self.cfg.retention:
            to_fd |= (wsrc == SRC_FD) & is_hot
        to_fd &= not_tomb
        # PC-cold winners: drop the PC copy, but keep the best SD copy so
        # the record is not lost from the rewritten SD run.
        pc_cold = from_pc & ~to_fd
        if bool(pc_cold.any()):
            # non-winner rows: find best SD row per pc_cold key
            gid = torch.cumsum(first, 0) - 1
            sd_rows = torch.nonzero((srcs == SRC_SD) & ~first).reshape(-1)
            if len(sd_rows):
                # first SD row per group (rows are seq-desc within key)
                g = gid[sd_rows]
                keep_sd = torch.ones(len(sd_rows), dtype=torch.bool,
                                     device=dev)
                keep_sd[1:] = g[1:] != g[:-1]
                sd_rows = sd_rows[keep_sd]
                sd_rows = sd_rows[pc_cold[gid[sd_rows]]]
                if len(sd_rows):
                    repl_g = gid[sd_rows]
                    ws[repl_g] = seqs[sd_rows]
                    wv[repl_g] = vlens[sd_rows]
                    wsrc[repl_g] = SRC_SD
                    pc_cold[repl_g] = False
        to_sd = ~to_fd & ~pc_cold
        if last_level:
            to_sd &= wv != TOMBSTONE_VLEN
        fd_sel = torch.nonzero(to_fd).reshape(-1)
        sd_sel = torch.nonzero(to_sd).reshape(-1)
        if self.cfg.hotrap and len(fd_sel):
            pc_mask = wsrc[fd_sel] == SRC_PC
            sizes = wv[fd_sel] + KEY_BYTES
            promoted, retained = torch.stack(
                [(sizes * pc_mask).sum(), (sizes * ~pc_mask).sum()]).tolist()
            self.stats.promoted_bytes += promoted  # lint: allow-stats (engine)
            self.stats.retained_bytes += retained  # lint: allow-stats (engine)
        return (tuple(win[:3, fd_sel].unbind(0)),
                tuple(win[:3, sd_sel].unbind(0)))

    def _install_edits(self, edits: list[tuple[int, list[SSTable],
                                              list[SSTable]]]) -> None:
        """Compaction install: publish ONE new Version with every edited
        level rebuilt, so every published Version is a consistent
        snapshot.  The old Version's lists are never touched."""
        levels = list(self.version.levels)
        for li, removed, added in edits:
            rm = set(s.sid for s in removed)
            kept = [s for s in levels[li] if s.sid not in rm]
            for s in added:
                s.retarget(tier="FD" if li < self.cfg.n_fd_levels else "SD",
                           level=li)
            kept.extend(added)
            if li == 0:
                kept.sort(key=lambda s: -s.created_at)
            else:
                kept.sort(key=lambda s: s.min_key)
            levels[li] = kept
        self._publish(levels)
        if self.durability is not None:
            self.durability.manifest.begin_edit("compaction",
                                                self.version)
            crashpoints.hit("mid-compaction", self._obs, self._obs_track)
            self.durability.manifest.commit_edit()

    # ------------------------------------------------------------------
    # clock: deferred checkers & deferred PC inserts (test hook)
    # ------------------------------------------------------------------
    def _tick(self) -> None:
        self.now += 1
        self._fire_due()

    def _tick_many(self, n: int) -> None:
        """Advance the op clock by a whole batch.  Identical to `n`
        scalar `_tick`s except that everything that comes due *inside*
        the batch fires at its start — a placement-only timing shift."""
        self.now += n
        self._fire_due()

    def _fire_due(self) -> None:
        if self._checker_queue and self._checker_queue[0][0] <= self.now:
            due = [c for c in self._checker_queue if c[0] <= self.now]
            self._checker_queue = [c for c in self._checker_queue
                                   if c[0] > self.now]
            for _, immpc in due:
                self._run_checker(immpc)
        if self._deferred_pc:
            due = [d for d in self._deferred_pc if d[0] <= self.now]
            self._deferred_pc = [d for d in self._deferred_pc
                                 if d[0] > self.now]
            for _, key, seq, vlen, touched in due:
                self._do_insert_pc(key, seq, vlen, touched)

    def flush_all(self) -> None:
        """Drain memtables + pending checkers (test/benchmark helper)."""
        if self.durability is not None:
            # quiesce: sync the WAL tail *before* flushing, so the flush
            # commit's truncation covers every record and a clean
            # shutdown recovers to the exact visible state
            self.durability.wal.sync()
        self._rotate_memtable()
        self._flush_imm_memtables()
        self._maybe_compact()
        for _, immpc in self._checker_queue:
            self._run_checker(immpc)
        self._checker_queue = []

    # ------------------------------------------------------------------
    # durability / recovery (core/wal.py, core/crashpoints.py)
    # ------------------------------------------------------------------
    @classmethod
    def recover(cls, crashed: "TieredLSM", obs=None) -> "TieredLSM":
        """Rebuild a fresh engine from ``crashed``'s durable half (its
        WAL + manifest), on its device.  The crashed engine's in-memory
        state is never consulted — exactly as a restarted process never
        sees its predecessor's heap."""
        if crashed.durability is None:
            raise ValueError("recover() needs an engine built with "
                             "LSMConfig(wal=True)")
        return recover_shard(crashed.durability, obs=obs)

    # ------------------------------------------------------------------
    def __getstate__(self):
        """Pickle without the GroupView and LevelIndex caches (they can
        be large — up to one row per record — and are rebuilt lazily on
        first use).  Tensors pickle with their device."""
        state = self.__dict__.copy()
        state["_view_cache"] = ViewCache(self.device)
        state["_level_cache"] = {}
        # the observability plane is session-scoped: pickles revert to
        # the class-level null plane
        state.pop("_obs", None)
        state.pop("_obs_track", None)
        return state

    # ------------------------------------------------------------------
    def reset_storage(self) -> None:
        """Fresh I/O + op accounting (run-phase-only measurements)."""
        self.storage = StorageSim(self.storage.spec["FD"],
                                  self.storage.spec["SD"])
        if self.ralt is not None:
            self.ralt.storage = self.storage
        if self.durability is not None:
            # the durable half moves with the engine onto the fresh
            # devices (its logical contents are untouched)
            self.durability.storage = self.storage
            self.durability.wal.storage = self.storage
            self.durability.manifest.storage = self.storage
        self.stats = Stats()

    def fd_used_bytes(self) -> int:
        used = sum(self.level_bytes(li)
                   for li in range(self.cfg.n_fd_levels))
        if self.ralt is not None:
            used += self.ralt.phys_bytes
        return used

    def total_records(self) -> int:
        return sum(s.n for level in self.levels for s in level)

    # ------------------------------------------------------------------
    # device state
    # ------------------------------------------------------------------
    def tensors(self) -> list[torch.Tensor]:
        """Every tensor the engine holds: each SSTable's records and
        bloom bits, each cached GroupView and LevelIndex, each RALT
        run."""
        out = [t for level in self.levels for s in level for t in s.tensors()]
        out += [t for v in self._view_cache.views() for t in v.tensors()]
        out += [t for x in self._level_cache.values() for t in x.tensors()]
        if self.ralt is not None:
            out += self.ralt.tensors()
        return out

    def device_bytes(self) -> int:
        """Bytes of the distinct storages behind `tensors()`."""
        return storage_bytes(self.tensors())

