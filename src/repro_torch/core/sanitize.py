"""Runtime sanitizer, the port of `repro.core.sanitize`: the lint
suite's dynamic counterpart.

`tools/check` proves structural properties of the *source*; this module
checks the same contracts on a *running* engine.  `sanitize_db(db)`
wraps a `TieredLSM` or `ShardedTieredLSM` in a transparent proxy that
validates, op by op:

* **Monotone sequence numbers** — every `put`/`delete` returns a seq
  strictly greater than the previous one, across shard splits, merges,
  and live migrations (the cluster-wide ordering contract).
* **Zero Version-ref leaks** — the sanitizer tracks every `Version` the
  engine publishes (by wrapping each shard's `_make_version`) and
  periodically recomputes the *expected* refcount of each from engine
  state: one pin per live shard's current version, one per unreleased
  checker `Superversion`, one per in-flight migration pin.  Any
  discrepancy — in either direction — raises.  The check runs after
  every repartition cutover and at `close()`, where the expectation
  collapses to "live shard versions hold exactly one ref; everything
  else holds zero".
* **Stats conservation across migrations** — the repartitioner's
  migrated-byte ledger must equal the "migration" component charged to
  the cluster's devices (exact when every shard is a plain `TieredLSM`;
  a lower bound when baseline shards add their own migration charges),
  and the aggregate `puts`/`gets` counters must equal the ops that
  actually crossed the API, no matter how many shards retired in
  between.
* **Sampled oracle equality** — a shadow dict of every write through
  the proxy; every read is checked against it, and a periodic sampler
  issues extra reads of previously written keys.  Sampler reads go
  through the real `get` path, so they tick the engine clock and feed
  hotness tracking like any client read would (placement may shift
  under the sanitizer; results may not).

Enable via `make_system(..., sanitize=True)` /
`make_sharded_system(..., sanitize=True)`.  Everything the sanitizer
keeps (the shadow map, the tracked Versions, the counters) is host
state; the oracle sampler draws from a host numpy generator and reads
through the engine's real `get`, so a sanitized run ticks the engine
clock exactly as the reference's does.  Keys are int64, as everywhere
in the port.  The wrapper is a debug tool: it holds strong references
to retired Versions until they drain and is deliberately not
picklable.
"""
from __future__ import annotations

import numpy as np

from .lsm import TieredLSM, key_array
from .sstable import TOMBSTONE_VLEN

__all__ = ["SanitizeError", "Sanitizer", "SanitizedDB", "sanitize_db"]


class SanitizeError(AssertionError):
    """An engine invariant was violated at runtime."""


_DELETED = object()


class Sanitizer:
    """The invariant oracle; owned by a `SanitizedDB` proxy."""

    def __init__(self, db, *, check_every: int = 64,
                 oracle_samples: int = 4, seed: int = 0):
        self.db = db
        self.check_every = max(1, check_every)
        self.oracle_samples = oracle_samples
        self.rng = np.random.default_rng(seed)
        self.shadow: dict[int, object] = {}    # key -> vlen | _DELETED
        self._shadow_keys: list[int] = []      # sampling index (append-only)
        self._versions: dict[int, object] = {} # id(v) -> Version (strong)
        self._last_seq: int | None = None
        self._n_puts = 0
        self._n_gets = 0
        self._ops = 0
        self._events_seen = 0
        self.checks = {"seq": 0, "refs": 0, "oracle": 0, "migration": 0,
                       "op_conservation": 0, "cutovers_checked": 0}
        self._instrument()

    # -- wiring ---------------------------------------------------------
    def _shards(self) -> list:
        return list(self.db.shards) if hasattr(self.db, "shards") else [self.db]

    def _instrument(self) -> None:
        for sh in self._shards():
            self._instrument_shard(sh)
        rep = getattr(self.db, "repartitioner", None)
        if rep is not None:
            self._events_seen = len(rep.events)
            orig = self.db._new_shard

            def _new_shard(_orig=orig):
                sh = _orig()
                self._instrument_shard(sh)
                return sh

            self.db._new_shard = _new_shard

    def _instrument_shard(self, sh) -> None:
        self._track(sh.version)
        orig = sh._make_version

        def _make_version(levels, _orig=orig):
            v = _orig(levels)
            self._track(v)
            return v

        sh._make_version = _make_version

    def _track(self, v) -> None:
        self._versions[id(v)] = v

    # -- invariants -----------------------------------------------------
    def note_seq(self, seq: int) -> None:
        self.checks["seq"] += 1
        if self._last_seq is not None and seq <= self._last_seq:
            raise SanitizeError(
                f"sequence numbers not monotone: put returned {seq} after "
                f"{self._last_seq} (cutover must preserve cluster order)")
        self._last_seq = seq

    def check_refs(self) -> None:
        """Recompute every tracked Version's expected refcount from
        engine state; any mismatch is a leak (or a premature release)."""
        self.checks["refs"] += 1
        expected: dict[int, int] = {}

        def pin(v):
            self._track(v)
            expected[id(v)] = expected.get(id(v), 0) + 1

        for sh in self._shards():
            self._track(sh.version)
            pin(sh.version)
            seen: set[int] = set()
            immpcs = list(sh.immpcs) + [c[1] for c in sh._checker_queue]
            for immpc in immpcs:           # queue/immpcs dual membership
                if id(immpc) in seen:
                    continue
                seen.add(id(immpc))
                if not immpc.sv._released:
                    pin(immpc.sv.version)
        rep = getattr(self.db, "repartitioner", None)
        if rep is not None and rep._job is not None:
            for v in rep._job.pins:
                pin(v)
        bad = []
        for key, v in list(self._versions.items()):
            want = expected.get(key, 0)
            if v.refs != want:
                bad.append(f"vid={v.vid} refs={v.refs} expected={want}")
            elif v.refs == 0:
                del self._versions[key]    # fully drained: stop tracking
        if bad:
            raise SanitizeError(
                "Version refcount leak(s): " + "; ".join(bad))

    def check_migration_accounting(self) -> None:
        """Repartitioner byte ledger == device 'migration' component."""
        rep = getattr(self.db, "repartitioner", None)
        if rep is None:
            return
        self.checks["migration"] += 1
        charged = 0
        for st in self.db.storages:
            comp = st.by_component.get("migration")
            if comp:
                charged += int(comp["read_bytes"]) + int(comp["write_bytes"])
        ledger = rep.migrated_read_bytes + rep.migrated_write_bytes
        plain = all(type(sh) is TieredLSM for sh in self.db.shards)
        if plain and charged != ledger:
            raise SanitizeError(
                f"migration bytes not conserved: devices charged {charged} "
                f"but the repartitioner ledger says {ledger}")
        if not plain and charged < ledger:
            # baseline shards (e.g. Mutant) add their own 'migration'
            # charges, so only the lower bound is exact
            raise SanitizeError(
                f"migration bytes under-charged: devices {charged} < "
                f"repartitioner ledger {ledger}")

    def check_op_conservation(self) -> None:
        """Aggregate Stats must retain every op that crossed the API —
        shard retirement folds, split/merge surgery, and fan-out
        corrections included."""
        self.checks["op_conservation"] += 1
        st = self.db.stats
        if st.puts != self._n_puts:
            raise SanitizeError(
                f"puts not conserved across migrations: stats.puts="
                f"{st.puts}, {self._n_puts} crossed the API")
        if st.gets != self._n_gets:
            raise SanitizeError(
                f"gets not conserved across migrations: stats.gets="
                f"{st.gets}, {self._n_gets} crossed the API")

    # -- oracle ---------------------------------------------------------
    def record_put(self, key: int, vlen: int) -> None:
        if key not in self.shadow:
            self._shadow_keys.append(key)
        self.shadow[key] = _DELETED if vlen == TOMBSTONE_VLEN else vlen

    def record_delete(self, key: int) -> None:
        if key not in self.shadow:
            self._shadow_keys.append(key)
        self.shadow[key] = _DELETED

    def seed_shadow(self, expected: dict) -> None:
        """Prime the oracle with a pre-existing visible map — key ->
        vlen, or None for a deleted key — so a *recovered* engine can be
        wrapped and checked against the state its durable half promised
        (crash-recovery tests fold the op log at the recovery horizon
        into this map)."""
        for key, vlen in expected.items():
            if key not in self.shadow:
                self._shadow_keys.append(key)
            self.shadow[key] = _DELETED if vlen is None else vlen

    def check_get(self, key: int, got) -> None:
        want = self.shadow.get(key)
        if want is None:                   # key never written via proxy
            return
        if want is _DELETED:
            if got is not None:
                raise SanitizeError(
                    f"oracle divergence: get({key}) returned {got} for a "
                    f"deleted key")
        elif got is None or got[1] != want:
            raise SanitizeError(
                f"oracle divergence: get({key}) returned {got}, shadow "
                f"has vlen={want}")

    def sample_oracle(self, n: int | None = None) -> None:
        if not self._shadow_keys:
            return
        self.checks["oracle"] += 1
        n = self.oracle_samples if n is None else n
        idx = self.rng.integers(0, len(self._shadow_keys), size=n)
        for i in idx:
            key = self._shadow_keys[int(i)]
            got = self.db.get(int(key))    # real read path, on purpose
            self._n_gets += 1
            self.check_get(key, got)

    # -- cadence --------------------------------------------------------
    def _run_suite(self, kind: str, oracle: bool = False) -> None:
        """One invariant sweep, with its verdict mirrored onto the
        observability plane (when one is attached) as an instant on the
        sanitizer lane — pass or fail, so a trace shows exactly which
        sweep tripped."""
        obs = getattr(self.db, "_obs", None)
        track = f"{getattr(self.db, '_obs_track', 'db')}/sanitizer"
        try:
            self.check_refs()
            self.check_migration_accounting()
            self.check_op_conservation()
            if oracle:
                self.sample_oracle()
        except SanitizeError as e:
            if obs is not None and obs.enabled:
                obs.tracer.instant(track, "sanitize_fail",
                                   {"kind": kind, "ops": self._ops,
                                    "error": str(e)[:200]})
            raise
        if obs is not None and obs.enabled:
            obs.tracer.instant(track, "sanitize_ok",
                               {"kind": kind, "ops": self._ops})

    def after_op(self) -> None:
        self._ops += 1
        rep = getattr(self.db, "repartitioner", None)
        if rep is not None and len(rep.events) != self._events_seen:
            # a cutover landed inside the op that just returned: check
            # the books before anything else happens
            self._events_seen = len(rep.events)
            self.checks["cutovers_checked"] += 1
            self._run_suite("cutover")
        if self._ops % self.check_every == 0:
            self._run_suite("periodic", oracle=True)

    def on_reset_storage(self) -> None:
        # reset_storage() zeroes Stats and device books and cancels any
        # in-flight job; rebase the conservation counters to match
        self._n_puts = 0
        self._n_gets = 0
        rep = getattr(self.db, "repartitioner", None)
        if rep is not None:
            self._events_seen = len(rep.events)

    def final_check(self) -> None:
        """Drain the engine, then require the fully-quiesced refcount
        picture: live shard versions hold exactly one ref each, every
        other Version holds zero."""
        rep = getattr(self.db, "repartitioner", None)
        if rep is not None:
            rep.drain()
        self.db.flush_all()
        self.check_refs()
        if rep is not None and rep._job is not None:
            raise SanitizeError("migration still in flight after drain()")
        self.check_migration_accounting()
        self.check_op_conservation()
        self.sample_oracle(self.oracle_samples * 4)

    def report(self) -> dict:
        return {
            "ops": self._ops,
            "shadow_keys": len(self.shadow),
            "tracked_versions": len(self._versions),
            "last_seq": self._last_seq,
            **{f"checks_{k}": v for k, v in self.checks.items()},
        }


class SanitizedDB:
    """Transparent sanitizing proxy over a (Sharded)TieredLSM.

    Public ops are intercepted and validated; every other attribute
    (stats, storages, shards, cfg, ...) passes straight through, so the
    workload runner and benchmarks treat it as the engine itself."""

    _OWN = ("_db", "sanitizer")

    def __init__(self, db, **kw):
        object.__setattr__(self, "_db", db)
        object.__setattr__(self, "sanitizer", Sanitizer(db, **kw))

    def __getattr__(self, name):
        return getattr(self._db, name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self._db, name, value)

    def __repr__(self):
        return f"SanitizedDB({self._db!r})"

    def __reduce__(self):
        raise TypeError("SanitizedDB is not picklable (debug wrapper: "
                        "it holds live engine hooks); pickle the "
                        "underlying engine instead")

    # -- intercepted public API ----------------------------------------
    def put(self, key: int, vlen: int) -> int:
        seq = self._db.put(key, vlen)
        s = self.sanitizer
        s._n_puts += 1
        s.record_put(key, vlen)
        s.note_seq(seq)
        s.after_op()
        return seq

    def delete(self, key: int) -> int:
        seq = self._db.delete(key)
        s = self.sanitizer
        s._n_puts += 1                    # delete is a tombstone put
        s.record_delete(key)
        s.note_seq(seq)
        s.after_op()
        return seq

    def get(self, key: int):
        got = self._db.get(key)
        s = self.sanitizer
        s._n_gets += 1
        s.check_get(key, got)
        s.after_op()
        return got

    def multi_get(self, keys, lat_out=None) -> list:
        out = self._db.multi_get(keys, lat_out=lat_out)
        s = self.sanitizer
        s._n_gets += len(out)
        for key, got in zip(keys, out):
            s.check_get(int(key), got)
        s.after_op()
        return out

    def put_many(self, keys, vlens):
        seqs = self._db.put_many(keys, vlens)
        s = self.sanitizer
        s._n_puts += len(seqs)
        vl = (np.full(len(seqs), int(vlens), dtype=np.int64)
              if np.ndim(vlens) == 0
              else np.asarray(vlens, dtype=np.int64))
        for key, v in zip(key_array(keys).tolist(), vl.tolist()):
            s.record_put(int(key), int(v))
        for seq in np.asarray(seqs).tolist():
            s.note_seq(int(seq))
        s.after_op()
        return seqs

    def _check_scan_result(self, out, lo, hi=None) -> None:
        s = self.sanitizer
        prev = None
        for k, _seq, vlen in out:
            if prev is not None and k <= prev:
                raise SanitizeError(
                    f"scan keys not strictly ascending: {k} after {prev}")
            prev = k
            if k < lo or (hi is not None and k > hi):
                raise SanitizeError(
                    f"scan returned key {k} outside [{lo}, "
                    f"{hi if hi is not None else 'inf'}]")
            want = s.shadow.get(k)
            if want is _DELETED or (want is not None and vlen != want):
                raise SanitizeError(
                    f"oracle divergence: scan returned (key={k}, "
                    f"vlen={vlen}), shadow has "
                    f"{'DELETED' if want is _DELETED else want}")

    def scan(self, lo: int, n: int):
        out = self._db.scan(lo, n)
        self._check_scan_result(out, lo)
        self.sanitizer.after_op()
        return out

    def scan_range(self, lo: int, hi: int):
        out = self._db.scan_range(lo, hi)
        self._check_scan_result(out, lo, hi)
        # completeness, sampled: live shadow keys in range must appear
        s = self.sanitizer
        if s._shadow_keys:
            present = {k for k, _, _ in out}
            idx = s.rng.integers(0, len(s._shadow_keys),
                                 size=s.oracle_samples)
            for i in idx:
                key = s._shadow_keys[int(i)]
                if lo <= key <= hi and s.shadow[key] is not _DELETED \
                        and key not in present:
                    raise SanitizeError(
                        f"scan_range([{lo}, {hi}]) dropped live key {key}")
        s.after_op()
        return out

    # -- lifecycle ------------------------------------------------------
    def flush_all(self) -> None:
        self._db.flush_all()
        self.sanitizer.check_refs()
        self.sanitizer.check_migration_accounting()

    def reset_storage(self) -> None:
        self._db.reset_storage()
        self.sanitizer.on_reset_storage()

    def close(self) -> dict:
        """Drain, run the terminal invariant sweep, and return the
        sanitizer's report."""
        self.sanitizer.final_check()
        return self.sanitizer.report()


def sanitize_db(db, **kw) -> SanitizedDB:
    """Wrap an engine in the runtime sanitizer (see module docstring)."""
    return SanitizedDB(db, **kw)
