"""Versioned read path: Superversion snapshots + REMIX-style views.

The port of `repro.core.version`.

``Version`` (RocksDB-style)
---------------------------
An immutable snapshot of the LSM's level lists.  ``TieredLSM`` publishes
a *new* Version on every flush / compaction / promotion install and
never mutates a published one, so a reader that captured a Version at
the top of ``get``/``scan`` keeps seeing a consistent set of SSTables.
Versions are refcounted: the engine holds one reference on the current
Version, and every frozen immutable promotion cache pins the Version it
snapshotted (via ``Superversion``) until its Checker has run.  The level
fences are host arrays built from the tables' Python-int bounds, so
locating tables never touches device memory.

``Superversion``
----------------
Version + a snapshot of the immutable memtables — together the full
read view the paper's Fig. 5 Checker consults in step 8.

``GroupView`` (REMIX-style, Zhong et al. 2020)
----------------------------------------------
A persistent cross-run sorted view over one *level group* (the FD
levels L0..n_fd-1, or the SD levels n_fd..), held on the engine's
device.  Building it concatenates every run of the group, lexsorts by
(key, run priority) with stable sorts and keeps the first occurrence
per key: the arrays then map global sorted order directly to the
winning record's (SSTable, block) cursor.  The winners' five columns
live in one (5, n) int64 tensor, so a scan copies a slice of rows to
the host in one transfer.  Views are cached by *group signature* (the
tuple of SSTable ids per run).

Invariants
----------
* **Immutability** — a published Version's ``levels`` lists are never
  mutated; every install builds fresh lists (``TieredLSM._publish``).
* **Refcounted pinning** — ``refs`` counts the engine's current pointer
  plus every frozen-immPC ``Superversion``.
* **Signature determinism** — SSTables are immutable and sids unique,
  so a group signature fully determines its ``GroupView``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .sstable import SSTable, bloom_index_host, bounds, lexsort


class Version:
    """Immutable snapshot of the level lists.

    ``levels`` is a list of per-level SSTable lists.  By contract nothing
    mutates these lists after construction: installs build fresh lists
    and publish a fresh Version.  ``refs`` counts pinners (the engine's
    current pointer plus any frozen immPC superversions).
    """

    __slots__ = ("levels", "vid", "refs", "_fences", "_sigs")

    def __init__(self, levels: list[list[SSTable]], vid: int):
        self.levels = levels
        self.vid = vid
        self.refs = 0
        self._fences: dict[int, tuple] = {}
        self._sigs: dict[tuple, tuple] = {}

    def ref(self) -> "Version":
        self.refs += 1
        return self

    def unref(self) -> None:
        self.refs -= 1

    # `acquire` is the pin verb the pin/release lint pass (tools/check)
    # recognises alongside `ref`
    acquire = ref
    release = unref

    # ------------------------------------------------------------------
    def level_fences(self, li: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(min_keys, max_keys, sids) host arrays of one sorted level —
        the fence pointers used for vectorized table location."""
        f = self._fences.get(li)
        if f is None:
            lst = self.levels[li]
            f = (np.array([s.min_key for s in lst], dtype=np.int64),
                 np.array([s.max_key for s in lst], dtype=np.int64),
                 np.array([s.sid for s in lst], dtype=np.int64))
            self._fences[li] = f
        return f

    def sd_touched_many(self, keys: np.ndarray, winner_sids: np.ndarray,
                        n_fd: int) -> list[list[int]]:
        """Vectorized §3.3 touched-SSTable lists for a batch of SD-served
        keys: for each key, every SD table ``get`` would have probed
        top-down before (and including) the winner's table.  One
        ``searchsorted`` per SD level above the last over the host
        fences, each level a column of sids (-1 where the key probes no
        table there).
        """
        nk = len(keys)
        if nk == 0:
            return []
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        winner_sids = np.asarray(winner_sids, dtype=np.int64)
        levels = [li for li in range(n_fd, len(self.levels))
                  if self.levels[li]]
        if not levels:
            return [[] for _ in range(nk)]
        done = np.zeros(nk, dtype=bool)
        cols = []
        for li in levels[:-1]:
            mins, maxs, sids = self.level_fences(li)
            idx = np.searchsorted(maxs, keys, "left")
            idxc = np.minimum(idx, len(sids) - 1)
            sid = sids[idxc]
            hit = ~done & (idx < len(sids)) & (mins[idxc] <= keys)
            cols.append(np.where(hit, sid, -1))
            done |= hit & (sid == winner_sids)
        # a key not yet done has its winner in the last level, and the
        # winner's table is the one table there that covers it
        cols.append(np.where(done, -1, winner_sids))
        mat = np.stack(cols, axis=1)
        touched = mat.tolist()
        # only the keys that skip a level (a gap in its fences, or a
        # winner above the last level) need their -1s taken out
        for j in np.flatnonzero((mat < 0).any(axis=1)).tolist():
            touched[j] = [s for s in touched[j] if s >= 0]
        return touched

    # ------------------------------------------------------------------
    def group_runs(self, group: str, n_fd: int) -> list[list[SSTable]]:
        """The runs of a level group in probe-priority order (newest
        first).  Each L0 table is its own run (they overlap); deeper
        levels are single sorted runs."""
        if group == "FD":
            runs = [[s] for s in self.levels[0]]
            runs += [self.levels[li] for li in range(1, min(n_fd, len(self.levels)))
                     if self.levels[li]]
            return runs
        return [self.levels[li] for li in range(n_fd, len(self.levels))
                if self.levels[li]]

    def group_signature(self, group: str, n_fd: int) -> tuple:
        """Tuple of per-run sid tuples — identifies the group's exact
        composition.  Cached on the (immutable) Version."""
        sig = self._sigs.get((group, n_fd))
        if sig is None:
            sig = tuple(tuple(s.sid for s in run)
                        for run in self.group_runs(group, n_fd))
            self._sigs[(group, n_fd)] = sig
        return sig

    def sid_levels(self) -> list[list[int]]:
        """Per-level sid lists — the durable manifest's Version-edit
        payload (core/wal.py): sids are stable across a crash, so a
        recovered manifest resolves them back to the same immutable
        SSTable objects."""
        return [[s.sid for s in lvl] for lvl in self.levels]

    def group_stats(self, group: str, n_fd: int) -> tuple[int, int]:
        """(records, bytes) held by one level group — sizes the pre-copy
        stream of a shard migration (core/shards.py) without building
        the group's view (host ints: no device read)."""
        if group == "FD":
            rng = range(0, min(n_fd, len(self.levels)))
        else:
            rng = range(n_fd, len(self.levels))
        n_rec = n_bytes = 0
        for li in rng:
            for s in self.levels[li]:
                n_rec += s.n
                n_bytes += s.size_bytes
        return n_rec, n_bytes


@dataclasses.dataclass
class Superversion:
    """The full frozen read view an immPC Checker consults (Fig. 5):
    the pinned Version plus the immutable memtables at freeze time."""
    version: Version
    imm_memtables: list[dict]
    _released: bool = False

    def release(self) -> None:
        """Drop the Version pin (idempotent: every checker exit path may
        call it without double-decrementing the refcount)."""
        if not self._released:
            self._released = True
            self.version.unref()


class GroupView:
    """REMIX-style persistent cross-run view of one level group.

    ``rows`` holds, in global key order, the *winning* (highest-priority)
    version of every distinct key in the group — tombstones included,
    since a tombstone winner shadows lower groups — as the columns
    (key, seq, vlen, src, blk); ``keys``/``seqs``/``vlens``/``src``/
    ``blks`` are views of its rows.  ``src``/``blks`` map each winner
    back to its (SSTable, data block) cursor so scans charge exactly the
    blocks that hold winners.  ``n_source_records`` records how many run
    entries the build folded.
    """

    __slots__ = ("sig", "rows", "keys", "seqs", "vlens", "src", "blks",
                 "ssts", "sids", "n_source_records", "sst_mins",
                 "sst_maxs", "sst_pris", "n")

    def __init__(self, sig: tuple, runs: list[list[SSTable]],
                 device: torch.device):
        self.sig = sig
        self.ssts: list[SSTable] = [s for run in runs for s in run]
        self.sids = [s.sid for s in self.ssts]
        # per-table fences + run priorities: which tables a per-level
        # probe walk would line up for a key, and in what order (the
        # point-get fast path's saved-probe accounting)
        pris = [pri for pri, run in enumerate(runs) for _ in run]
        meta = torch.tensor([[s.min_key for s in self.ssts],
                             [s.max_key for s in self.ssts], pris],
                            dtype=torch.int64).reshape(3, -1).to(device)
        self.sst_mins, self.sst_maxs, self.sst_pris = meta.unbind(0)
        counts = [s.n for s in self.ssts]
        self.n_source_records = sum(counts)
        if not self.n_source_records:
            self.rows = torch.zeros(5, 0, dtype=torch.int64, device=device)
        else:
            keys = torch.cat([s.keys for s in self.ssts])
            # each record's table: the count of table ends at or before it
            ends = torch.tensor(counts).cumsum(0).to(device)
            src = torch.searchsorted(
                ends, torch.arange(self.n_source_records, device=device),
                right=True)
            order = lexsort([self.sst_pris[src], keys])
            keys = keys[order]
            win = torch.ones(len(keys), dtype=torch.bool, device=device)
            win[1:] = keys[1:] != keys[:-1]
            sel = order[win]
            self.rows = torch.stack([
                keys[win],
                torch.cat([s.seqs for s in self.ssts])[sel],
                torch.cat([s.vlens for s in self.ssts])[sel],
                src[sel],
                torch.cat([s.block_of for s in self.ssts])[sel]])
        self.keys, self.seqs, self.vlens, self.src, self.blks = \
            self.rows.unbind(0)
        self.n = self.rows.shape[1]

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.rows, self.sst_mins)

    def range_bounds(self, lo: int, hi: int) -> tuple[int, int]:
        return bounds(self.keys, lo, hi)

    def live_arrays(self) -> tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
        """The view's winner rows as (keys, seqs, vlens) tensor copies on
        the view's device — the sequential-stream form a shard migration
        installs into its destination shard (tombstone winners
        included: they shadow lower groups and must keep doing so after
        the move)."""
        return self.keys.clone(), self.seqs.clone(), self.vlens.clone()

    def window(self, lo: int, hi: int, chunk: int):
        """(a, b, rows): the positions [a, b) of the keys within
        [lo, hi] and the (key, seq, vlen, src, blk) rows of the first
        `chunk` of them, in one device-to-host copy."""
        if not self.n:
            return 0, 0, []
        a = torch.searchsorted(self.keys, int(lo)).reshape(1)
        b = torch.searchsorted(self.keys, int(hi), right=True).reshape(1)
        idx = (a + torch.arange(chunk, device=a.device)).clamp(
            max=self.n - 1)
        flat = torch.cat([a, b, self.rows[:, idx].reshape(-1)]).tolist()
        a, b = flat[0], flat[1]
        m = max(min(chunk, b - a), 0)
        cols = [flat[2 + c * chunk:2 + c * chunk + m] for c in range(5)]
        return a, b, zip(*cols)

    def probes_replaced(self, key: int, winner_si: int | None) -> int:
        """How many table probes the per-level walk would have spent
        that the view's single binary search replaced.

        A run holds at most one table covering `key`, and the walk
        probes covering tables in run-priority order: on a hit it stops
        at the winner's run (probes = covering tables in strictly
        higher-priority runs, + the winner itself, vs 1 view search);
        on a miss every covering table is probed (vs 1 search, floored
        at 0 for the degenerate nothing-to-probe case)."""
        cover = (self.sst_mins <= key) & (key <= self.sst_maxs)
        if winner_si is None:
            return max(int(torch.count_nonzero(cover)) - 1, 0)
        above = cover & (self.sst_pris < self.sst_pris[winner_si])
        return int(torch.count_nonzero(above))

    def point_find(self, key: int):
        """Binary-search the view for `key`'s group-winning record.
        Returns (seq, vlen, sstable_index, block) or None if the key is
        absent from the whole group (tombstone winners are returned —
        they shadow lower groups, exactly like the per-level probe)."""
        if not self.n:
            return None
        i = torch.searchsorted(self.keys, int(key)).reshape(1)
        row = self.rows[:, i.clamp(max=self.n - 1)].reshape(5)
        i, k, seq, vlen, si, blk = torch.cat([i, row]).tolist()
        if i >= self.n or k != key:
            return None
        return seq, vlen, si, blk


class LevelIndex:
    """One sorted level's tables concatenated on the device: their
    records (the level is one sorted run) and their bloom bits, each
    table's at its offset with its own bit count.  A batch of keys, each
    with the one table whose fences cover it, is probed in one set of
    launches and one copy to the host (`probe`), answering exactly what
    a probe of each key's table would."""

    __slots__ = ("rows", "bits", "meta", "k")

    def __init__(self, sstables: list[SSTable], device: torch.device):
        self.k = sstables[0].bloom.k
        assert all(s.bloom.k == self.k for s in sstables)
        self.rows = torch.stack([torch.cat([getattr(s, name)
                                            for s in sstables])
                                 for name in ("keys", "seqs", "vlens",
                                              "block_of")])
        self.bits = torch.cat([s.bloom.bits for s in sstables])
        nbits = np.array([s.bloom.nbits for s in sstables], dtype=np.int64)
        ns = np.array([s.n for s in sstables], dtype=np.int64)
        # each table's bit count, bit offset and last record's position
        # in the level, on the host: probes hash their keys there
        self.meta = np.stack([nbits, np.cumsum(nbits) - nbits,
                              np.cumsum(ns) - 1])

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.rows, self.bits)

    def probe(self, keys: np.ndarray, tables: np.ndarray) -> np.ndarray:
        """(5, len(keys)) host rows for keys[i] probed in its table
        tables[i]: bloom says maybe, found, seq, vlen, block of the
        insertion point."""
        m = len(keys)
        nbits, bit_off, last = self.meta[:, tables]
        idx = bloom_index_host(keys, self.k, nbits) + bit_off[:, None]
        # the keys, their tables' last positions and their bloom bit
        # indices in one copy to the device
        d = torch.from_numpy(np.concatenate(
            [keys, last, idx.reshape(-1)])).to(self.rows.device)
        kd = d[:m]
        may = self.bits[d[2 * m:].view(m, self.k)].all(dim=1)
        # the key lies within its table's fences, so its position in the
        # level is its table's offset plus its position in the table
        pos = torch.minimum(torch.searchsorted(self.rows[0], kd),
                            d[m:2 * m])
        found = self.rows[0, pos] == kd
        return torch.cat([torch.stack([may, found]).long(),
                          self.rows[1:, pos]]).cpu().numpy()


class ViewCache:
    """Signature-keyed bounded cache of GroupViews.  Because SSTables
    are immutable and sids unique, a signature fully determines the
    view, so views survive Version installs that do not touch their
    group and are shared by every Version with the same composition."""

    def __init__(self, device: torch.device, capacity: int = 6):
        self.device = device
        self.capacity = capacity
        self._views: dict[tuple, GroupView] = {}
        self.builds = 0

    def views(self) -> list[GroupView]:
        return list(self._views.values())

    def peek(self, sig: tuple) -> GroupView | None:
        """The cached view for `sig`, or None — never builds.  A hit
        refreshes LRU order but does not count as a build."""
        view = self._views.pop(sig, None)
        if view is not None:
            self._views[sig] = view
        return view

    def get(self, sig: tuple, runs_thunk) -> GroupView:
        view = self._views.pop(sig, None)
        if view is None:
            view = GroupView(sig, runs_thunk(), self.device)
            self.builds += 1
            while len(self._views) >= self.capacity:
                self._views.pop(next(iter(self._views)))
        # (re)insert at the end: LRU order, so a stable SD view is not
        # evicted by a stream of churning FD signatures
        self._views[sig] = view
        return view
