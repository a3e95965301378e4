"""Range scans over the tiered LSM: merged iteration over a pinned
Version, REMIX-style by default.

The port of `repro.core.scan`.  The merge runs on the host, as in the
reference; a GroupView or SSTable cursor copies its rows from the device
one slice of up to 512 records at a time (one transfer each).  Keys are
int64, so the open end of a scan is ``MAX_KEY = 2**63 - 1`` instead of
the reference's ``2**64 - 1``.

Scan semantics vs. `get`
------------------------
`TieredLSM.get` resolves one key by probing sources *top-down* and
returning the first match (memtable, immutable memtables, FD levels,
mutable promotion cache, SD levels).  A range scan must produce the same
visible version for *every* key in the range, so the merged iterator
reproduces that rule positionally: each source is an ascending-key
cursor tagged with its probe priority, and for each distinct key only
the entry from the highest-priority (newest) source wins.  A winning
tombstone suppresses the key entirely (it shadows any older live
version below), mirroring `get`'s `None` for deleted keys.

Versioned sources
-----------------
All SSTable-backed sources come from a pinned immutable ``Version``
(core/version.py) captured at the top of the scan — installs racing the
scan publish new Versions and never perturb the cursors.  With
``LSMConfig.remix_views`` (the default) each level *group* (FD levels,
SD levels) is served by one REMIX-style ``GroupView``: a persistent
cross-run sorted array mapping global key order to the winning
(SSTable, block) cursor, reused across queries until a compaction
changes the group.  The per-query merge then degenerates to the
memtables + mutable promotion cache against two ordered views — most
scans run the 2-way fast path below instead of a k-way heap, and
shadowed versions / non-overlapping SSTables are never pulled at all.
With ``remix_views=False`` a per-query k-way heap over per-level
cursors is used instead (kept for the merge-cost ablation).

Merge-cost accounting
---------------------
``MergeCounters`` tallies the two quantities the REMIX view is built to
reduce: ``pulls`` (cursor-advance operations — every record drawn from
any source, winners and shadowed losers alike) and ``compares`` (heap
sift compares, modelled as ``bit_length(heap)`` per replace, or exactly
one compare per record on the 2-way fast path).  ``TieredLSM`` folds
them into ``Stats.scan_cursor_pulls`` / ``Stats.scan_merge_compares``;
the reference's scan benchmark reports ops-per-scanned-record for both
modes.

I/O accounting
--------------
Memtables and the mutable promotion cache are in memory — scanning them
is free.  Heap-mode SSTable cursors charge their tier one sequential
block read per data block entered (block-cache hits are free).  A
GroupView charges only the blocks that hold *winning* records — the
REMIX payoff: the precomputed order knows where the visible version
lives, so runs full of shadowed versions are not read.  Charging is
delegated to the engine via a callback so baselines can interpose
(e.g. SAS-Cache consults its FD secondary block cache for SD blocks).

Scan-side hotness (HotRAP extension)
------------------------------------
`TieredLSM._scan` batches the served records into
`RALT.record_range_access` (vectorized, scan-length-aware scoring) and
routes SD-served records into the promotion cache — per record when
only isolated keys are hot, or as one whole-range batch when
`RALT.range_hot_bytes` says the scanned SD range itself is hot (range
promotion; see `TieredLSM._record_scan_hotness`).

Invariants
----------
* **Get-equivalence** — for every key in the scanned range, the scan
  yields exactly the version a point `get` of that key would return
  against the same pinned Version (top-down-first-match; a tombstone
  winner hides the key).  The model-based oracle in
  the reference's tests/test_scan.py enforces this for every source
  combination.
* **Pinned snapshot** — all SSTable-backed sources of one scan come
  from the single Version captured at entry; installs racing the scan
  publish new Versions and never perturb live cursors.
* **View-cache signature** — a GroupView source is valid for exactly
  the group composition its signature names (tuple of per-run sid
  tuples); `ViewCache` may therefore serve one view to every query —
  and every Version — with that composition, and must never serve it
  after the group changed (a fresh signature simply misses).
* **Charging** — heap-mode cursors charge every data block they enter;
  view-mode cursors charge only blocks holding served winners; both
  charge a (sstable, block) pair at most once per scan, through the
  engine callback so baselines can interpose their caches.

Paper mapping: scans extend HotRAP's read path (the paper is
point-get only); the §3.3 touched-SSTable check runs per promoted
record via `Version.sd_touched_many`, and the merged-view design
follows REMIX (Zhong et al. 2020).
"""
from __future__ import annotations

import dataclasses
import heapq

from .sstable import SSTable
from .version import GroupView, Version

MAX_KEY = 2 ** 63 - 1

# tier classification of a source priority (see SourceMap.classify)
TIER_MEM, TIER_FD, TIER_PC, TIER_SD = "mem", "FD", "PC", "SD"


class MergeCounters:
    """Merge-cost tallies: cursor pulls + heap compares for scans, and
    the point-get view fast path's usage (``view_gets``: gets served by
    one binary search over a cached GroupView; ``probes_saved``: the
    per-level table probes that search replaced)."""

    __slots__ = ("pulls", "compares", "view_gets", "probes_saved")

    def __init__(self):
        self.pulls = 0
        self.compares = 0
        self.view_gets = 0
        self.probes_saved = 0


def _mem_source(table: dict, lo: int, hi: int):
    """Ascending-key cursor over an in-memory dict source (memtable or
    mutable promotion cache), or None when the range is empty.  Free of
    device I/O.  Yields (key, seq, vlen, sid) with sid = -1."""
    keys = sorted(k for k in table if lo <= k <= hi)
    if not keys:
        return None

    def gen():
        for key in keys:
            seq, vlen = table[key]
            yield key, seq, vlen, -1
    return gen()


def _sstable_source(sst: SSTable, lo: int, hi: int, charge_block):
    """Cursor over one SSTable; charges each entered block exactly once
    via `charge_block(sst, block_idx)`."""
    last_blk = -1
    for key, seq, vlen, blk in sst.block_iter(lo, hi):
        if blk != last_blk:
            last_blk = blk
            charge_block(sst, blk)
        yield key, seq, vlen, sst.sid


def _level_source(sstables: list[SSTable], lo: int, hi: int, charge_block):
    """Cursor over a non-overlapping sorted level: chains the per-SSTable
    cursors of the run in key order, lazily (early `scan(lo, n)` exits
    never touch later SSTables).  Seeks to the first overlapping table by
    binary search — levels can hold hundreds of tables."""
    a, b = 0, len(sstables)
    while a < b:                      # first table with max_key >= lo
        mid = (a + b) // 2
        if sstables[mid].max_key < lo:
            a = mid + 1
        else:
            b = mid
    for i in range(a, len(sstables)):
        sst = sstables[i]
        if sst.min_key > hi:
            break
        yield from _sstable_source(sst, lo, hi, charge_block)


_VIEW_CHUNK = 512


def _view_source(view: GroupView, lo: int, hi: int, charge_block):
    """Cursor over a GroupView slice: winners only, in global key order.

    Charges each (SSTable, block) pair holding a served winner exactly
    once per scan; shadowed versions and non-overlapping SSTables are
    never touched (REMIX + fence-pointer pruning).  The slice's bounds
    and its first chunk cross to the host in one copy."""
    a, b, first = view.window(lo, hi, _VIEW_CHUNK)
    if a >= b:
        return
    seen: set[int] = set()
    ssts = view.ssts
    # lint: allow-loop (chunked cursor: limit-bounded scans must not
    # materialise the whole view tail)
    for start in range(a, b, _VIEW_CHUNK):
        end = min(start + _VIEW_CHUNK, b)
        rows = first if start == a else zip(
            *view.rows[:, start:end].tolist())
        # lint: allow-loop (per-record yield — the merge consumes
        # cursors record-at-a-time; REMIX reduces how many are pulled)
        for key, seq, vlen, si, blk in rows:
            code = (si << 32) | blk
            if code not in seen:
                seen.add(code)
                charge_block(ssts[si], blk)
            yield key, seq, vlen, view.sids[si]


@dataclasses.dataclass
class SourceMap:
    """Ordered scan sources + the priority boundaries for tier stats."""
    sources: list                     # index == probe priority (0 = newest)
    n_mem: int                        # sources [0, n_mem) are memtables
    pc_pri: int                       # priority of the mPC source (-1: none)
    sd_start: int                     # first SD-level priority

    def classify(self, pri: int) -> str:
        # Classification is by *level position*, matching get's
        # served_fd/served_sd convention: a Mutant-migrated SSTable in an
        # SD-range level charges FD I/O but still counts as SD-served,
        # in both the point and scan hit-rate metrics.
        if pri < self.n_mem:
            return TIER_MEM
        if pri == self.pc_pri:
            return TIER_PC
        if pri >= self.sd_start:
            return TIER_SD
        return TIER_FD


def build_sources(db, version: Version, lo: int, hi: int,
                  charge_block) -> SourceMap:
    """Assemble the scan sources of a TieredLSM over a pinned Version,
    in probe-priority order.

    Mirrors `get`: memtable, immutable memtables (newest first), the FD
    level group, the mutable promotion cache, then the SD level group.
    In-memory sources with no key in range are pruned up front.  With
    remix_views each group is one GroupView source; otherwise each L0
    SSTable is its own cursor (newest first) and deeper levels are
    single chained cursors.
    """
    sources: list = []
    # lint: allow-loop (per-source assembly, bounded by memtable count)
    for table in [db.memtable, *db.imm_memtables]:
        src = _mem_source(table, lo, hi)
        if src is not None:
            sources.append(src)
    n_mem = len(sources)
    n_fd = min(db.cfg.n_fd_levels, len(version.levels))
    remix = db.cfg.remix_views
    if remix:
        view = db.group_view(version, "FD")
        if view is not None and view.n:
            sources.append(_view_source(view, lo, hi, charge_block))
    else:
        # lint: allow-loop (per-table/per-level source assembly — the
        # non-remix ablation path)
        for sst in version.levels[0]:  # L0 overlaps: one source each
            if sst.overlaps(lo, hi):
                sources.append(_sstable_source(sst, lo, hi, charge_block))
        # lint: allow-loop (per-level, bounded by level count)
        for li in range(1, n_fd):
            if version.levels[li]:
                sources.append(_level_source(version.levels[li], lo, hi,
                                             charge_block))
    pc_pri = -1
    if db.cfg.hotrap:
        src = _mem_source(db.mpc.data, lo, hi)
        if src is not None:
            pc_pri = len(sources)
            sources.append(src)
    sd_start = len(sources)
    if remix:
        view = db.group_view(version, "SD")
        if view is not None and view.n:
            sources.append(_view_source(view, lo, hi, charge_block))
    else:
        # lint: allow-loop (per-level, bounded by level count)
        for li in range(n_fd, len(version.levels)):
            if version.levels[li]:
                sources.append(_level_source(version.levels[li], lo, hi,
                                             charge_block))
    return SourceMap(sources, n_mem, pc_pri, sd_start)


def merge_scan(sources: list, counters: MergeCounters | None = None):
    """Priority-aware merge of ascending unique-key cursors.

    Yields (key, seq, vlen, priority, sid) for the *winning* version of
    each distinct key: ties on key resolve to the lowest priority (the
    newest source), matching `get`'s top-down-first-match rule.
    Tombstone winners are yielded too — the caller decides whether the
    key is visible (a tombstone shadows every older version).

    Every cursor yields strictly ascending, per-source-unique keys
    (dicts, sorted runs, and GroupView winners all do), so with <= 2
    active sources the merge is a plain 2-way pointer walk — one compare
    per emitted record.  Three or more sources fall back to the k-way
    heap.  `counters` tallies cursor pulls and (modelled) heap compares.
    """
    c = counters if counters is not None else MergeCounters()
    cursors = []
    # lint: allow-loop (per-source priming, bounded by source count)
    for pri, src in enumerate(sources):
        it = iter(src)
        first = next(it, None)
        c.pulls += 1
        if first is not None:
            cursors.append((first, pri, it))
    if not cursors:
        return
    if len(cursors) == 1:
        (key, seq, vlen, sid), pri, it = cursors[0]
        while True:
            yield key, seq, vlen, pri, sid
            nxt = next(it, None)
            c.pulls += 1
            if nxt is None:
                return
            key, seq, vlen, sid = nxt
    if len(cursors) == 2:
        yield from _merge_two(cursors, c)
        return
    yield from _merge_heap(cursors, c)


def _merge_two(cursors, c: MergeCounters):
    """2-way pointer merge (the REMIX fast path): one compare/record."""
    (a, pa, ita), (b, pb, itb) = cursors
    if pa > pb:                       # ensure a is the higher priority
        (a, pa, ita), (b, pb, itb) = (b, pb, itb), (a, pa, ita)

    def pull(it):
        c.pulls += 1
        return next(it, None)

    while a is not None and b is not None:
        c.compares += 1
        if a[0] < b[0]:
            yield a[0], a[1], a[2], pa, a[3]
            a = pull(ita)
        elif b[0] < a[0]:
            yield b[0], b[1], b[2], pb, b[3]
            b = pull(itb)
        else:                         # same key: higher priority wins
            yield a[0], a[1], a[2], pa, a[3]
            a = pull(ita)
            b = pull(itb)
    rest, pri, it = (a, pa, ita) if a is not None else (b, pb, itb)
    while rest is not None:
        yield rest[0], rest[1], rest[2], pri, rest[3]
        rest = pull(it)


def _merge_heap(cursors, c: MergeCounters):
    """k-way min-heap merge (the heap path; >2 active sources)."""
    heap = []
    # lint: allow-loop (per-source heap seeding, bounded by source count)
    for (key, seq, vlen, sid), pri, it in cursors:
        # (key, pri) is unique across the heap -> later fields never
        # participate in comparisons.
        heap.append((key, pri, seq, vlen, sid, it))
    heapq.heapify(heap)
    c.compares += len(heap)
    last_key = None
    while heap:
        key, pri, seq, vlen, sid, it = heap[0]
        nxt = next(it, None)
        c.pulls += 1
        c.compares += len(heap).bit_length()
        if nxt is not None:
            heapq.heapreplace(heap, (nxt[0], pri, nxt[1], nxt[2], nxt[3], it))
        else:
            heapq.heappop(heap)
        if key == last_key:           # older version of an emitted key
            continue
        last_key = key
        yield key, seq, vlen, pri, sid
