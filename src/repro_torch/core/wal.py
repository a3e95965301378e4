"""Durability subsystem: per-shard WAL + manifest, cluster topology log;
the port of `repro.core.wal`.

WAL records, manifest edits and topology records are host lists, as
the memtables are: only the SSTables the manifest's registry resolves
sids to hold tensors (on the engine's device).  The framing constants
and the bytes charged to `StorageSim`, and their order, are the
reference's.

The container has no real disks (core/storage.py *accounts* I/O), so
durability is simulated the same way: "durable" state is the set of
objects a crash cannot unwind — synced WAL records, committed manifest
edits, the SSTable registry (immutable objects standing in for on-disk
files), and committed topology records — and every append/sync is
byte-charged to the owning device like any other engine I/O
(``component="wal"``).  A crash (core/crashpoints.py) raises out of the
engine; recovery builds a fresh engine from the durable objects alone.

Write-ahead log
---------------
Seq-stamped ``(seq, key, vlen)`` records, group-committed: appends land
in a volatile buffer and every ``group_commit_records`` appends (or an
explicit ``sync()``) the buffer is flushed to the device as one
sequential foreground write — the classic group-commit amortisation of
fsync cost.  A crash loses the buffered tail: those acked-but-unsynced
records are *torn* — partially written at the device — and ``replay``
discards and counts them.  The recovered prefix therefore ends at
``durable_seq`` (the last synced record), which is exactly the contract
group commit gives a real client.

Manifest
--------
An append-only log of Version edits.  Every install (flush, compaction,
checker promotion, migration build) appends one edit carrying the full
per-level sid lists of the published Version — RocksDB's VersionEdit,
simplified to a snapshot because sids are cheap integers — plus the
cumulative ``flushed_through`` seq (valid as a WAL cut because memtable
rotation happens at put boundaries and flushes pop oldest-first, so
every flushed record's seq precedes every surviving memtable record's).
Edits are written in two steps (``begin_edit`` / ``commit_edit``) with
the crash injection site between them: a crash mid-edit leaves a *torn
tail* record that ``replay`` discards — the install never happened,
durably — while the SSTables it wrote remain as orphaned, unreferenced
files (exactly the debris a real LSM leaves and later garbage-collects).

Cluster topology log
--------------------
``ClusterDurability`` adds the cutover commit point: destination shards
are built durably first (their manifests record the build install and
their WALs are seeded with the inherited memtable records and synced),
then one topology record — the new bounds plus the shard uids — is
appended atomically.  The topology record IS the migration's commit:
torn ⇒ recovery returns the old topology and the sources' durable
state (the migration is abandoned, its destination debris orphaned);
complete ⇒ recovery returns the new topology.  Recovery of an
in-flight repartition therefore never needs to *repair* anything — it
lands on whichever side of the commit point the crash fell.

Recovery
--------
``recover_shard`` rebuilds one engine: manifest replay restores the
Version chain (re-targeting tiers and clearing compaction marks on the
recovered SSTables — placement bookkeeping the crash may have left
half-advanced), WAL replay rebuilds the memtable from records past
``flushed_through``, and the engine's seq resumes at the durability
horizon ``max(flushed_through, durable_seq)``.  Soft state — RALT
hotness, promotion caches, checker queues — restarts cold: placement
only, never visibility.  ``TieredLSM.recover`` and
``ShardedTieredLSM.recover`` are the public entry points.
"""
from __future__ import annotations

from .sstable import KEY_BYTES, TOMBSTONE_VLEN

__all__ = ["WriteAheadLog", "Manifest", "ShardDurability",
           "ClusterDurability", "recover_shard"]

# Simulated on-device record framing: seq (8) + key (8) + length/crc
# header (8) + value payload (tombstones carry none).
WAL_RECORD_OVERHEAD = 24
# One group-commit sync: framing + the fsync's journal/FTL touch.
WAL_SYNC_OVERHEAD = 512
# Manifest edit framing + per-sid entry cost.
MANIFEST_EDIT_OVERHEAD = 64
MANIFEST_SID_BYTES = 8


def _vbytes(vlen: int) -> int:
    return 0 if vlen == TOMBSTONE_VLEN else int(vlen)


class WriteAheadLog:
    """Group-committed, seq-stamped write-ahead log on one device."""

    def __init__(self, storage, group_commit_records: int = 64,
                 tier: str = "FD"):
        self.storage = storage
        self.tier = tier
        self.dur: ShardDurability | None = None   # instrumentation backref
        self.group_commit_records = max(1, group_commit_records)
        self._synced: list[tuple[int, int, int]] = []   # (seq, key, vlen)
        self._buffer: list[tuple[int, int, int]] = []
        self._buffer_bytes = 0
        self.durable_seq = 0
        # lifetime counters (RunResult / recovery_info)
        self.appended_records = 0
        self.syncs = 0
        self.synced_bytes = 0

    # -- write path ----------------------------------------------------
    def append(self, seq: int, key: int, vlen: int) -> int:
        """Buffer one record; returns bytes synced (0 unless this
        append filled the group-commit window)."""
        self._buffer.append((seq, key, vlen))
        self._buffer_bytes += WAL_RECORD_OVERHEAD + _vbytes(vlen)
        self.appended_records += 1
        if len(self._buffer) >= self.group_commit_records:
            return self.sync()
        return 0

    def append_columns(self, seqs, keys, vlens) -> int:
        """Columnar append of one batch (the `put_many` path): records
        enter the buffer in one extend, syncing once per full
        group-commit window crossed."""
        sl, kl, vl = seqs.tolist(), keys.tolist(), vlens.tolist()
        self._buffer.extend(zip(sl, kl, vl))
        self._buffer_bytes += (WAL_RECORD_OVERHEAD * len(sl)
                               + sum(map(_vbytes, vl)))
        self.appended_records += len(sl)
        synced = 0
        while len(self._buffer) >= self.group_commit_records:
            synced += self.sync()
        return synced

    def sync(self) -> int:
        """Group commit: one sequential foreground write of the buffer;
        every buffered record becomes durable."""
        if not self._buffer:
            return 0
        nbytes = self._buffer_bytes + WAL_SYNC_OVERHEAD
        owner = self.dur.owner if self.dur is not None else None
        obs = owner._obs if owner is not None else None
        if obs is not None and obs.enabled:
            obs.tracer.begin(owner._obs_track, "wal/group_commit",
                             {"records": len(self._buffer)})
        self.storage.seq_write(self.tier, nbytes, fg=True, component="wal")
        self._synced.extend(self._buffer)
        self.durable_seq = self._synced[-1][0]
        self._buffer = []
        self._buffer_bytes = 0
        self.syncs += 1
        self.synced_bytes += nbytes
        if obs is not None and obs.enabled:
            obs.tracer.end(owner._obs_track, "wal/group_commit",
                           {"bytes": nbytes})
        return nbytes

    def seed(self, records) -> int:
        """Durably adopt inherited records (destination-shard build at
        cutover: the sources' memtable fold must be durable *before*
        the topology commit).  Returns bytes synced."""
        self._buffer.extend((int(s), int(k), int(v)) for k, (s, v)
                            in records.items())
        self._buffer_bytes += sum(WAL_RECORD_OVERHEAD + _vbytes(v)
                                  for _, v in records.values())
        self.appended_records += len(records)
        self._buffer.sort()               # seq order within the log
        return self.sync()

    def truncate_through(self, seq: int) -> int:
        """Drop synced records with seq <= `seq` (their memtable was
        durably flushed; the manifest edit committed first).  Returns
        records dropped."""
        keep = [r for r in self._synced if r[0] > seq]
        dropped = len(self._synced) - len(keep)
        self._synced = keep
        return dropped

    # -- recovery ------------------------------------------------------
    @property
    def synced_records(self) -> int:
        return len(self._synced)

    def replay(self) -> tuple[list[tuple[int, int, int]], int]:
        """Read back the synced log in seq order, charging the
        sequential read; the unsynced buffer is the torn tail — counted,
        discarded, and cleared."""
        torn = len(self._buffer)
        self._buffer = []
        self._buffer_bytes = 0
        nbytes = (sum(WAL_RECORD_OVERHEAD + _vbytes(v)
                      for _, _, v in self._synced) + WAL_SYNC_OVERHEAD)
        self.storage.seq_read(self.tier, nbytes, fg=False, component="wal")
        return sorted(self._synced), torn


class Manifest:
    """Append-only Version-edit log with two-phase (torn-able) writes."""

    def __init__(self, storage, tier: str = "FD"):
        self.storage = storage
        self.tier = tier
        self.records: list[dict] = []
        self.sstables: dict[int, object] = {}       # sid -> SSTable
        self.flushed_through = 0                    # committed cut
        self.edits = 0

    def _edit_bytes(self, levels_sids) -> int:
        return (MANIFEST_EDIT_OVERHEAD
                + MANIFEST_SID_BYTES * sum(map(len, levels_sids)))

    def begin_edit(self, kind: str, version,
                   flushed_through: int | None = None) -> None:
        """First half of an edit write: the record exists on device but
        is torn until ``commit_edit`` — a crash between the two leaves
        a tail that replay discards.  ``version`` is the freshly
        published ``Version`` whose sid snapshot the edit carries."""
        for lvl in version.levels:
            for sst in lvl:
                self.sstables.setdefault(sst.sid, sst)
        sids = version.sid_levels()
        ft = self.flushed_through if flushed_through is None \
            else max(self.flushed_through, int(flushed_through))
        self.records.append({"kind": kind, "levels": sids,
                             "flushed_through": ft, "torn": True})
        self.storage.seq_write(self.tier, self._edit_bytes(sids) // 2,
                               fg=False, component="wal")

    def commit_edit(self) -> None:
        rec = self.records[-1]
        rec["torn"] = False
        self.storage.seq_write(
            self.tier,
            self._edit_bytes(rec["levels"]) - self._edit_bytes(
                rec["levels"]) // 2,
            fg=False, component="wal")
        self.flushed_through = rec["flushed_through"]
        self.edits += 1

    def log_edit(self, kind: str, version,
                 flushed_through: int | None = None) -> None:
        """An edit with no injection site between the halves."""
        self.begin_edit(kind, version, flushed_through)
        self.commit_edit()

    # -- recovery ------------------------------------------------------
    def replay(self) -> tuple[list | None, int, int, int]:
        """(levels | None, flushed_through, edits_applied, torn_dropped).

        Torn tail records are dropped from the log; the last complete
        edit's snapshot is the recovered Version (None when the shard
        never installed one — a fresh engine's empty levels stand)."""
        dropped = 0
        while self.records and self.records[-1]["torn"]:
            self.records.pop()
            dropped += 1
        nbytes = MANIFEST_EDIT_OVERHEAD + sum(
            self._edit_bytes(r["levels"]) for r in self.records)
        self.storage.seq_read(self.tier, nbytes, fg=False, component="wal")
        if not self.records:
            return None, 0, 0, dropped
        last = self.records[-1]
        levels = [[self.sstables[sid] for sid in lvl]
                  for lvl in last["levels"]]
        return levels, last["flushed_through"], len(self.records), dropped


class ShardDurability:
    """One shard's durable half: WAL + manifest on the shard's devices,
    plus the construction recipe recovery needs (engine class, config,
    seed, device).  ``owner`` points at the live engine so WAL/manifest
    instrumentation can reach its observability plane."""

    def __init__(self, storage, engine_cls, cfg, seed: int = 0,
                 group_commit_records: int = 64, device=None):
        self.storage = storage
        self.engine_cls = engine_cls
        self.cfg = cfg
        self.seed = seed
        # the engine's device: recovery rebuilds the engine there
        self.device = device
        self.wal = WriteAheadLog(storage, group_commit_records)
        self.wal.dur = self
        self.manifest = Manifest(storage)
        self.uid: int | None = None       # assigned by ClusterDurability
        self.owner = None
        self.retired = False
        # cutover-built shards inherit runs whose seqs exceed their own
        # WAL's: the cluster seq at build time floors the horizon
        # (everything routed to the range at or below it is durably in
        # the inherited image)
        self.inherited_seq = 0

    def horizon(self) -> int:
        """The recovery cut: every applied op with seq <= horizon is
        durable (via a committed flush, the synced WAL, or the durable
        image inherited at a cutover build); everything after it is
        legitimately lost to a crash."""
        return max(self.manifest.flushed_through, self.wal.durable_seq,
                   self.inherited_seq)


class ClusterDurability:
    """The sharded cluster's durable half: a registry of per-shard
    durability objects plus the topology log whose records are the
    atomic commit points of construction and every cutover."""

    def __init__(self):
        self.shards: dict[int, ShardDurability] = {}
        self._next_uid = 0
        self.topology: list[dict] = []

    def adopt(self, dur: ShardDurability) -> int:
        uid = self._next_uid
        self._next_uid += 1
        dur.uid = uid
        self.shards[uid] = dur
        return uid

    def _charge_storage(self, uids):
        return self.shards[uids[0]].storage if uids else None

    def begin_topology(self, bounds, uids) -> None:
        """First half of a topology record write (torn until commit —
        the mid-cutover injection site sits between the halves)."""
        self.topology.append({"bounds": [int(b) for b in bounds],
                              "uids": list(uids), "torn": True})
        st = self._charge_storage(uids)
        if st is not None:
            st.seq_write("FD", MANIFEST_EDIT_OVERHEAD, fg=False,
                         component="wal")

    def commit_topology(self) -> None:
        rec = self.topology[-1]
        rec["torn"] = False
        st = self._charge_storage(rec["uids"])
        if st is not None:
            st.seq_write("FD", MANIFEST_EDIT_OVERHEAD, fg=False,
                         component="wal")
        for uid, dur in self.shards.items():
            dur.retired = uid not in rec["uids"]

    def log_topology(self, bounds, uids) -> None:
        self.begin_topology(bounds, uids)
        self.commit_topology()

    def replay_topology(self) -> tuple[dict, int]:
        """(last committed topology record, torn records dropped)."""
        dropped = 0
        while self.topology and self.topology[-1]["torn"]:
            self.topology.pop()
            dropped += 1
        if not self.topology:
            raise RuntimeError("no committed topology record: the cluster "
                               "was never durably constructed")
        return self.topology[-1], dropped

    def storages(self) -> list:
        """Every device slice ever registered (retired sources
        included — their I/O history survives the crash)."""
        return [d.storage for d in self.shards.values()]


def recover_shard(dur: ShardDurability, obs=None, track: str = "db"):
    """Rebuild one engine from its durable half.  See module docstring
    for the algorithm; the recovered engine reuses the shard's
    ``StorageSim`` (devices survive a crash — their counters are the
    I/O history) and carries a ``recovery_info`` dict."""
    db = dur.engine_cls(dur.cfg, storage=dur.storage, seed=dur.seed,
                        device=dur.device)
    db.durability = dur
    dur.owner = db
    if obs is not None:
        obs.attach(db, name=track)
    o = db._obs
    if o.enabled:
        o.tracer.begin(db._obs_track, "recovery")
    levels, flushed_through, n_edits, torn_m = dur.manifest.replay()
    if levels is not None:
        for li, lvl in enumerate(levels):
            tier = "FD" if li < db.cfg.n_fd_levels else "SD"
            for sst in lvl:
                sst.recover_placement(tier, li)
        db._publish(levels)
    records, torn_w = dur.wal.replay()
    mem: dict[int, tuple[int, int]] = {}
    replayed = 0
    for seq, key, vlen in records:       # seq order: newest wins
        if seq > flushed_through:
            mem[key] = (seq, vlen)
            replayed += 1
    db.memtable = mem
    db.memtable_bytes = sum(KEY_BYTES + _vbytes(vlen)
                            for _, vlen in mem.values())
    db.seq = dur.horizon()
    db.recovery_info = {
        "replayed_records": replayed,
        "discarded_torn": torn_w + torn_m,
        "manifest_edits": n_edits,
        "flushed_through": flushed_through,
        "horizon": db.seq,
    }
    if o.enabled:
        o.tracer.end(db._obs_track, "recovery", dict(db.recovery_info))
    return db
