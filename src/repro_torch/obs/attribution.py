"""Latency attribution, the port of `repro.obs.attribution`: sampled
per-op "why was this slow" records.

The engine half (`TieredLSM.get`/`_scan`) calls `begin_get` on entry —
snapshotting block-cache hits, GroupView fast-path hits, and device
random-read counters — and `end_get` on exit with the tier that served
the op.  The runner half calls `commit` with the op's measured
device-time latency plus router-level context (did a repartition
cutover land during this op? was a migration streaming?).  Records go
into a fixed-capacity reservoir (Algorithm R), so memory is bounded
and the retained sample stays uniform over the whole run no matter
how long it is.

`table(q)` answers the headline question — *what do the ops above the
q-quantile have in common?* — by grouping the tail sample by serving
tier and reporting per-group mean latency, probe counts, fast-path /
cache hit rates, and how many were blocked behind a cutover.
`format_table` renders it; `summary()` is the JSON-safe digest stored
in `RunResult.attribution`.  The reservoir and its generator are host
numpy, so a run draws the reference's slots.
"""
from __future__ import annotations

import numpy as np

__all__ = ["AttributionSampler", "TIER_CODES", "TIER_NAMES"]

TIER_NAMES = ("mem", "FD", "PC", "SD", "miss", "scan")
TIER_CODES = {name: i for i, name in enumerate(TIER_NAMES)}


class AttributionSampler:
    """Bounded reservoir of per-op attribution records."""

    def __init__(self, capacity: int = 65536, seed: int = 0):
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self.lat = np.zeros(capacity)
        self.tier = np.zeros(capacity, dtype=np.int8)
        self.probes = np.zeros(capacity, dtype=np.int32)
        self.view_hit = np.zeros(capacity, dtype=bool)
        self.cache_hit = np.zeros(capacity, dtype=bool)
        self.cutover = np.zeros(capacity, dtype=bool)
        self.migrating = np.zeros(capacity, dtype=bool)
        self.n_kept = 0
        self.n_seen = 0
        self._pending: tuple | None = None
        # batched ops queue their (record, latency) pairs here until the
        # runner commits the whole batch at its edge
        self._stash: list[tuple[tuple, float]] = []
        # begin_get snapshots (single-threaded engine, one op in flight)
        self._s_bc = 0
        self._s_vh = 0
        self._s_rr = 0

    def reset(self) -> None:
        self.n_kept = 0
        self.n_seen = 0
        self._pending = None
        self._stash = []

    # -- engine half ---------------------------------------------------
    def begin_get(self, db) -> None:
        self._s_bc = db.block_cache.hits
        self._s_vh = db.stats.get_view_hits
        dev = db.storage.dev
        self._s_rr = dev["FD"].rand_reads + dev["SD"].rand_reads

    def end_get(self, db, tier: str) -> None:
        dev = db.storage.dev
        probes = (dev["FD"].rand_reads + dev["SD"].rand_reads - self._s_rr)
        cache_hits = db.block_cache.hits - self._s_bc
        view_hits = db.stats.get_view_hits - self._s_vh
        self._pending = (TIER_CODES.get(tier, TIER_CODES["miss"]),
                         probes + cache_hits, view_hits > 0, cache_hits > 0)

    # -- engine half, batched (vectorized batch execution) -------------
    def stash_record(self, tier: str, probes: int, view_hit: bool,
                     cache_hit: bool, lat: float) -> None:
        """Queue one op's record from inside a batched call.  The batch
        path replays I/O charges per key and computes the per-op deltas
        itself, so the record arrives fully formed — latency included —
        and waits for the runner's batch-edge `commit_stashed`."""
        self._stash.append(((TIER_CODES.get(tier, TIER_CODES["miss"]),
                             probes, view_hit, cache_hit), lat))

    def stash_pending(self, lat: float) -> None:
        """Move a scalar `begin_get`/`end_get` pending record into the
        batch queue (per-key fallback paths inside a batched call)."""
        if self._pending is not None:
            self._stash.append((self._pending, lat))
            self._pending = None

    def commit_stashed(self, cutover: bool = False,
                       migrating: bool = False) -> None:
        """Runner half, batch edge: commit every queued record.
        Repartition cutovers land at batched-call boundaries
        (`_account_ops`), so a batch-spanning cutover flag attaches to
        the batch's last op only."""
        stash = self._stash
        if not stash:
            return
        self._stash = []
        last = len(stash) - 1
        for i, (pend, lat) in enumerate(stash):
            self._pending = pend
            self.commit(lat, cutover=cutover and i == last,
                        migrating=migrating)

    # -- runner half ---------------------------------------------------
    def commit(self, lat: float, cutover: bool = False,
               migrating: bool = False) -> None:
        pend = self._pending
        self._pending = None
        if pend is None:
            return
        self.n_seen += 1
        if self.n_kept < self.capacity:
            slot = self.n_kept
            self.n_kept += 1
        else:
            slot = int(self._rng.integers(0, self.n_seen))
            if slot >= self.capacity:
                return
        tier, probes, view_hit, cache_hit = pend
        self.lat[slot] = lat
        self.tier[slot] = tier
        self.probes[slot] = probes
        self.view_hit[slot] = view_hit
        self.cache_hit[slot] = cache_hit
        self.cutover[slot] = cutover
        self.migrating[slot] = migrating

    # -- reporting -----------------------------------------------------
    def table(self, q: float = 0.99) -> dict:
        """Tail composition above the q-quantile of the *sampled* ops."""
        n = self.n_kept
        if n == 0:
            return {"q": q, "threshold": 0.0, "n_sampled": 0,
                    "n_tail": 0, "rows": []}
        lat = self.lat[:n]
        thresh = float(np.quantile(lat, q))
        tail = lat >= thresh
        rows = []
        for code, name in enumerate(TIER_NAMES):
            mask = tail & (self.tier[:n] == code)
            cnt = int(mask.sum())
            if cnt == 0:
                continue
            rows.append({
                "tier": name,
                "count": cnt,
                "share": cnt / max(1, int(tail.sum())),
                "mean_lat_us": float(lat[mask].mean()) * 1e6,
                "mean_probes": float(self.probes[:n][mask].mean()),
                "view_hit_frac": float(self.view_hit[:n][mask].mean()),
                "cache_hit_frac": float(self.cache_hit[:n][mask].mean()),
                "behind_cutover": int(self.cutover[:n][mask].sum()),
                "behind_migration": int(self.migrating[:n][mask].sum()),
            })
        rows.sort(key=lambda r: -r["count"])
        return {"q": q, "threshold_us": thresh * 1e6, "n_sampled": n,
                "n_seen": self.n_seen, "n_tail": int(tail.sum()),
                "rows": rows}

    def format_table(self, q: float = 0.99, title: str = "") -> str:
        t = self.table(q)
        head = (f"p{int(q * 1000) / 10:g} attribution"
                f"{' — ' + title if title else ''}: "
                f"threshold {t['threshold_us']:.1f}us, "
                f"{t['n_tail']}/{t['n_sampled']} sampled ops in tail")
        if not t["rows"]:
            return head + "\n  (no sampled ops)"
        cols = (f"  {'tier':<5} {'count':>6} {'share':>6} {'mean_us':>9} "
                f"{'probes':>7} {'view%':>6} {'cache%':>7} {'cutover':>8} "
                f"{'migr':>5}")
        lines = [head, cols]
        for r in t["rows"]:
            lines.append(
                f"  {r['tier']:<5} {r['count']:>6} {r['share']:>6.2f} "
                f"{r['mean_lat_us']:>9.1f} {r['mean_probes']:>7.2f} "
                f"{r['view_hit_frac'] * 100:>5.1f}% "
                f"{r['cache_hit_frac'] * 100:>6.1f}% "
                f"{r['behind_cutover']:>8} {r['behind_migration']:>5}")
        return "\n".join(lines)

    def summary(self, q: float = 0.99) -> dict:
        """JSON-safe digest stored on RunResult.attribution."""
        return self.table(q)
