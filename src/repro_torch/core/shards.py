"""Shared-nothing sharded engine: keyspace-partitioned ``TieredLSM``
shards, a batched router, a cluster-scope hot-budget arbiter, and
dynamic repartitioning with live migration — the port of
`repro.core.shards`.

On the port
-----------
Every shard is a port engine on the cluster's ``device`` (``cuda``
unless the caller passes ``device="cpu"``): all shards of a cluster
live on the one card, with no collectives between them.  The router's
state — the shard list, the boundary list, the arbiter's shares, the
repartitioner's plan and ledger — stays on the host, as does routing
(the reference's numpy uint64 arithmetic on the int64 keys).  A migration moves records as tensors on the card: each
source's GroupView winners (``GroupView.live_arrays``), cut at the
split key by one ``searchsorted``, concatenated for a merge, and
installed by ``split_into_sstables``; the RALT hot set handed to the
children comes from ``RALT.scan_hot`` on the card.  Keys are int64, so
the last shard's top fence is ``MAX_KEY = 2**63 - 1`` (the reference's
is 2**64 - 1); a key above it raises ``ValueError`` at the router.

Why sharding, and why here
--------------------------
Every read pins an immutable ``Version``, so no cross-request mutable
state is left on the read path and the single-mutator engine is safe
to replicate.  ``ShardedTieredLSM`` goes beyond the single-mutator
simulation: it hash- or range-partitions the keyspace
across N fully independent ``TieredLSM`` shards.  *Shared-nothing*
means exactly that — each shard owns its own memtables, Version chain,
RALT, promotion caches, and ``StorageSim`` slice (1/N of the FD and SD
byte budgets), and no object is ever shared between shards, so each
shard could run on its own core/machine with no locks.  The only
cluster-wide state is the router's monotonic sequence counter (so the
sharded store assigns the same seq a single engine would — results are
byte-identical to an unsharded oracle), the ``HotBudget`` arbiter, and
the ``Repartitioner`` below.

The router
----------
``get``/``put``/``delete`` route by key.  ``multi_get`` buckets a whole
key batch in one vectorized pass — ``np.searchsorted`` over the shard
boundary array for range partitioning, one multiply-shift hash for hash
partitioning — then drains each shard's bucket together, the shape a
batched RPC fan-out would take.  ``scan``/``scan_range`` fan out to the
(overlapping) shards and merge the per-shard results; per-shard scans
reuse the whole view-source machinery (each shard serves its slice
from its cached ``GroupView``s), and because the partitions are
disjoint the cross-shard merge is a trivial k-way interleave with no
version arbitration.

``HotBudget``: the paper's §3.7 autotuner at cluster scope
----------------------------------------------------------
HotRAP §3.7 (Alg. 1) tunes *one* store's hot-set threshold so the hot
set tracks the fast-disk budget.  At cluster scale the same problem
reappears one level up: a skewed workload concentrates hot bytes on few
shards, so a static 1/N fast-disk split starves exactly the shards
whose promotion pathways need headroom, while cold shards idle on
reserved FD.  ``HotBudget`` is the cross-shard analogue of Alg. 1: it
periodically reads each shard's demand signal — ``RALT.hot_set_bytes``
(the per-shard §3.2 hot-set size estimate) when the shard runs HotRAP,
FD occupancy otherwise — and reassigns FD capacity proportionally
(EMA-smoothed, clamped to [min_share, max_share] x fair-share).  A
shard's award is applied the same way Alg. 1 applies its limits inside
one store: the last-FD-level caps scale (more room before retention
must spill to SD), and the shard's RALT gets a proportionally scaled
``fd_size`` / hot-set / physical-size budget, so the per-shard §3.7
autotuner keeps running *within* the cluster-assigned envelope.
Relative scaling preserves whatever the per-shard autotuner has learned
between rebalances instead of resetting it.

``Repartitioner``: split/merge hot partitions with live migration
-----------------------------------------------------------------
Re-budgeting has a ceiling: ``HotBudget`` can hand a hot shard more FD
bytes, but all of that shard's traffic still funnels through *one*
device pair, so under contiguous skew (a hotspot that lives — or walks
— inside a single range partition) the cluster is gated by a single
shard while its neighbours idle.  The ``Repartitioner`` removes the
gate by changing the partition map itself, the workload-adaptive
reorganization move of Real-Time LSM-Trees (Saxena et al.) lifted to
cluster scope:

* **split** — when a shard's demand exceeds ``split_factor`` x the
  fair share, its range divides at the *median hot key* (from the
  shard's RALT), so the heat — not just the data — lands half on each
  child and two device pairs serve what one did before;
* **merge** — the coldest adjacent pair whose combined demand is below
  ``merge_factor`` x two fair shares collapses into one shard; paired
  with a split this keeps the shard count (and hence total simulated
  hardware) constant, and alone it keeps the count within
  ``[min_shards, max_shards]``.

Migration is *live*: starting a job pins the source shards' Versions
(refcounted, core/version.py) and streams their bytes in batches of
``migration_records_per_op`` per router op — sequential reads charged
against the source devices — while reads and writes keep routing
through the old partition map.  The cutover then happens atomically
between two router ops: destination shards are built from the sources'
*current* state (FD/SD ``GroupView`` winner streams via
``GroupView.live_arrays``, memtables folded newest-wins, the mutable
promotion cache carried over), the installed SSTable bytes are charged
as sequential writes on the destination devices, the source RALT's hot
set is transplanted (``RALT.seed_records``) so the children do not look
stone cold to the next trigger check, the new boundary list replaces
the old in one splice, and ``HotBudget`` shares are re-mapped onto the
new topology (a split share divides between the children by their
*measured heat* — transplanted RALT hot bytes via ``shard_demand``,
record count only as the no-signal fallback — and merged shares sum).
Bytes that landed on a source after its snapshot was pinned are charged
at cutover as sequential migration reads (the pre-copy stream covered
only the pinned snapshot).  Retired source shards stay visible to the
time accounting — their ``StorageSim`` slices and op ``Stats`` are
folded into the router's aggregate — so migration cost is never
dropped on the floor.

Invariants (tests/test_shards.py, tests/test_repartition.py)
------------------------------------------------------------
* **Oracle equivalence** — for any N and either partitioning, with or
  without the arbiter and across any number of splits/merges,
  ``put``/``delete`` return the same seq and ``get``/``scan``/
  ``scan_range``/``multi_get`` return byte-identical results to a
  single unsharded ``TieredLSM`` fed the same op stream.  Placement
  (which tier a record lives on, what HotBudget awards, where the
  partition boundaries sit) never leaks into visibility — only into
  the simulated I/O accounting.
* **Map atomicity** — every op observes a partition map with strictly
  increasing boundaries covering the whole keyspace; topology edits
  happen only between router ops, never inside one.
* **Accounting continuity** — retiring a shard folds its ``Stats``
  into the aggregate and parks its ``StorageSim`` in
  ``_retired_storages``; cluster totals are monotone across
  repartitions.
* **Hash no-op** — hash partitioning spreads contiguous skew by
  construction, so the ``Repartitioner`` deliberately declines to act
  on hash clusters (counted in ``incompatible_checks``) rather than
  splitting a range that hashing already scattered.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq

import numpy as np
import torch

from ..device import resolve_device
from ..obs import NULL_OBS
from . import crashpoints
from .lsm import LSMConfig, Stats, TieredLSM, key_array
from .ralt import _wall_span
from .scan import MAX_KEY
from .sstable import (KEY_BYTES, TOMBSTONE_VLEN, split_into_sstables,
                      storage_bytes)
from .wal import ClusterDurability, recover_shard

_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


@dataclasses.dataclass
class ClusterStats(Stats):
    """A cluster's `Stats` (`ShardedTieredLSM.stats`): the shards' summed
    fields, then what the router and the shards' WALs count.  Every
    field only grows while the cluster runs.  A single store's `Stats`
    keeps the reference's fields alone."""
    wal_syncs: int = 0               # group commits of every shard's WAL
    wal_bytes: int = 0               # bytes those group commits wrote
    router_batches: int = 0          # non-empty multi_get / put_many calls
    shard_calls: int = 0             # engine multi_get / put_many calls
                                     # the router made (non-empty buckets)
    hot_budget_rebalances: int = 0   # HotBudget arbitration rounds


@dataclasses.dataclass
class ShardConfig:
    """Cluster shape + hot-budget arbiter + repartitioner knobs."""
    n_shards: int = 4                    # initial shard count
    partitioning: str = "hash"           # "hash" | "range"
    key_space: int = 2 ** 62             # range partitioning: keys are
                                         # split evenly over [0, key_space)
    # --- HotBudget arbiter (paper §3.7 lifted to cluster scope) ---
    hot_budget: bool = True
    rebalance_interval_ops: int = 4096   # router ops between rebalances
    min_share: float = 0.5               # x fair share (1/N): floor
    max_share: float = 3.0               # x fair share (1/N): ceiling
    ema: float = 0.5                     # smoothing toward target shares
    # --- per-shard resource split floors ---
    memtable_floor: int = 64 * 1024
    block_cache_floor: int = 16 * 1024
    # --- dynamic repartitioning (range partitioning only) ---
    repartition: bool = False
    min_shards: int = 2                  # merges never go below
    max_shards: int = 8                  # splits never go above
    repartition_interval_ops: int = 8192  # ops between trigger checks
    repartition_cooldown_ops: int = 2048  # quiet period after a cutover
    split_factor: float = 2.0            # demand > factor x fair -> split
    merge_factor: float = 0.5            # pair demand < factor x 2 fair
    migration_records_per_op: int = 256  # pre-copy stream rate
    demand_signal: str = "auto"          # "auto" | "hot_bytes" | "fd_used"
                                         # | "fg_util"

    def __post_init__(self):
        if self.partitioning not in ("hash", "range"):
            raise ValueError(f"unknown partitioning {self.partitioning!r}")
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.min_shards < 1 or self.max_shards < self.min_shards:
            raise ValueError("need 1 <= min_shards <= max_shards")
        if self.demand_signal not in ("auto", "hot_bytes", "fd_used",
                                      "fg_util"):
            raise ValueError(f"unknown demand_signal "
                             f"{self.demand_signal!r}")


def shard_lsm_config(cfg: LSMConfig, scfg: ShardConfig) -> LSMConfig:
    """Split one store's resource budget into a per-shard LSMConfig.

    FD/SD bytes, memtable, and block cache divide by N (shared-nothing:
    the cluster's total hardware equals the unsharded store's) with
    small floors so tiny test configs stay runnable; structural knobs
    (size ratio, SSTable target, level count, HotRAP flags) are
    inherited unchanged.  The RALT budgets are fractions of fd_size and
    scale automatically.  N is the *initial* shard count: repartitioned
    shards are built from the same 1/N template, so a paired
    split+merge conserves the cluster's total simulated hardware.
    """
    n = scfg.n_shards
    if n == 1:
        return cfg
    return dataclasses.replace(
        cfg,
        fd_size=max(cfg.fd_size // n, 2 * cfg.target_sstable_bytes),
        sd_size=max(cfg.sd_size // n, 4 * cfg.target_sstable_bytes),
        memtable_bytes=max(cfg.memtable_bytes // n, scfg.memtable_floor),
        block_cache_bytes=max(cfg.block_cache_bytes // n,
                              scfg.block_cache_floor),
    )


def shard_demand(shard: TieredLSM, signal: str, state: dict) -> float:
    """One shard's fast-disk demand under the configured signal.

    "auto" is the paper-native choice: the RALT hot-set size estimate
    (§3.2's "does the hot set fit FD") when the shard runs HotRAP, FD
    occupancy otherwise.  "fg_util" is the engine-agnostic alternative
    the ROADMAP asks for — foreground device busy-time accumulated
    since the caller's previous probe (``state`` keys shards by id) —
    which also covers non-HotRAP baselines.
    """
    if signal == "fg_util":
        busy = sum(d.fg_time for d in shard.storage.dev.values())
        prev = state.get(id(shard), 0.0)
        state[id(shard)] = busy
        return max(busy - prev, 0.0)
    if shard.ralt is not None and signal in ("auto", "hot_bytes"):
        return float(shard.ralt.hot_set_bytes)
    if signal == "hot_bytes":
        return 0.0
    return float(shard.fd_used_bytes())


def _prune_probe_state(state: dict, shards: list) -> dict:
    """Drop fg_util baselines of shards that are no longer live.  The
    dict is id()-keyed; without pruning, a freed shard's entry could be
    inherited by a later allocation reusing the same address, making a
    fresh hot shard read as zero demand."""
    live = {id(s) for s in shards}
    return {k: v for k, v in state.items() if k in live}


class HotBudget:
    """Cluster-scope FD-budget arbiter (paper §3.7, Alg. 1 analogue).

    Tracks a share vector over shards (sum == 1, initialised to fair
    share).  ``rebalance`` reads per-shard demand, EMA-steps the shares
    toward the demand distribution (clamped to [min_share, max_share] x
    1/N), and applies each shard's new envelope *relatively*: FD level
    caps and RALT limits scale by (new_share / old_share), so the
    per-shard autotuner's adjustments between rebalances are preserved.
    ``retopology`` re-maps the state when the Repartitioner changes the
    shard set.
    """

    # observability plane (see TieredLSM._obs); attach() points the
    # track at "<name>/cluster" so arbiter events share the cluster lane
    _obs = NULL_OBS
    _obs_track = "cluster"

    def __init__(self, scfg: ShardConfig, shards: list[TieredLSM]):
        self.scfg = scfg
        self.shards = shards
        n = len(shards)
        self.shares = np.full(n, 1.0 / n)
        self._scale = np.ones(n)          # applied share * N per shard
        self._probe_state: dict = {}      # fg_util demand deltas
        self.n_rebalances = 0
        self.total_shift = 0.0            # cumulative |share| mass moved

    # ------------------------------------------------------------------
    def _demand(self, shard: TieredLSM) -> float:
        return shard_demand(shard, self.scfg.demand_signal,
                            self._probe_state)

    @_wall_span("hot_budget/rebalance")
    def rebalance(self) -> np.ndarray:
        """One arbitration round; returns the new share vector."""
        n = len(self.shards)
        if n == 1:
            return self.shares
        demand = np.array([self._demand(s) for s in self.shards])
        total = demand.sum()
        if total <= 0.0:
            return self.shares            # no signal yet: keep shares
        fair = 1.0 / n
        target = np.clip(demand / total,
                         self.scfg.min_share * fair,
                         self.scfg.max_share * fair)
        target /= target.sum()
        new = (1.0 - self.scfg.ema) * self.shares + self.scfg.ema * target
        new /= new.sum()
        shift = 0.5 * float(np.abs(new - self.shares).sum())
        self.total_shift += shift
        self.shares = new
        self.n_rebalances += 1
        for i, shard in enumerate(self.shards):
            self._apply(i, shard)
        if self._obs.enabled:
            self._obs.tracer.instant(
                self._obs_track, "hot_budget_rebalance",
                {"shares": [round(float(s), 4) for s in self.shares],
                 "shift": round(shift, 4)})
        return self.shares

    def _apply(self, i: int, shard: TieredLSM) -> None:
        """Scale shard i's FD envelope to its awarded share.

        scale == share * N (1.0 = fair share).  The finite FD level caps
        grow/shrink with it — the last FD level is where retention
        decides what stays on fast disk, so its cap *is* the shard's
        promotion headroom — and the RALT is told its fd_size changed,
        which moves the §3.7 clamp bounds [L_hs, R_hs] and tick cadence
        along with the award.
        """
        new_scale = float(self.shares[i]) * len(self.shards)
        old_scale = float(self._scale[i])
        if new_scale == old_scale:
            return
        ratio = new_scale / old_scale
        for li in range(1, shard.cfg.n_fd_levels):
            shard.caps[li] = shard.caps[li] * ratio
        ralt = shard.ralt
        if ralt is not None:
            ralt.cfg = dataclasses.replace(
                ralt.cfg, fd_size=max(int(ralt.cfg.fd_size * ratio), 1))
            lo, hi = ralt.cfg.l_hs, max(ralt.cfg.r_hs, ralt.cfg.l_hs + 1)
            ralt.hot_set_limit = int(
                np.clip(int(ralt.hot_set_limit * ratio), lo, hi))
            ralt.phys_limit = max(int(ralt.phys_limit * ratio),
                                  ralt.cfg.buffer_bytes)
        self._scale[i] = new_scale

    def retopology(self, shares: np.ndarray, scales: np.ndarray) -> None:
        """Re-map arbiter state onto a repartitioned shard list.

        The Repartitioner hands over per-shard shares (a split share
        divided between the children, merged shares summed, surviving
        shards unchanged) and applied scales (1.0 for freshly built
        shards — they start at the fair 1/N envelope — and the old
        applied scale for survivors).  Shares are re-clamped to the
        [min_share, max_share] x fair corridor, renormalised, and every
        shard's envelope is re-applied relative to its scale, so a hot
        child receives its FD award immediately instead of waiting one
        rebalance interval."""
        n = len(self.shards)
        fair = 1.0 / n
        shares = np.clip(np.asarray(shares, dtype=float),
                         self.scfg.min_share * fair,
                         self.scfg.max_share * fair)
        shares /= shares.sum()
        self.shares = shares
        self._scale = np.asarray(scales, dtype=float)
        # keep survivors' fg_util probe baselines (wiping them would
        # make the next rebalance read lifetime busy for survivors vs
        # near-zero for the fresh children); pruning dead ids also
        # prevents a recycled id() from inheriting a stale baseline
        self._probe_state = _prune_probe_state(self._probe_state,
                                               self.shards)
        for i, shard in enumerate(self.shards):
            self._apply(i, shard)

    def __getstate__(self):
        """Pickle without the id()-keyed probe baselines (ids do not
        survive the round-trip)."""
        state = self.__dict__.copy()
        state["_probe_state"] = {}
        state.pop("_obs", None)
        state.pop("_obs_track", None)
        return state

    def snapshot(self) -> dict:
        """Arbiter state for RunResult / benchmark JSON."""
        return {
            "n_shards": len(self.shards),
            "shares": [round(float(s), 4) for s in self.shares],
            "rebalances": self.n_rebalances,
            "total_shift": round(self.total_shift, 4),
            "min_share": self.scfg.min_share,
            "max_share": self.scfg.max_share,
            "rebalance_interval_ops": self.scfg.rebalance_interval_ops,
        }


@dataclasses.dataclass
class _MigrationJob:
    """One in-flight repartition: the op list, the pinned source
    Versions, and the pre-copy stream plan/progress."""
    ops: list                 # ("split", shard, key) | ("merge", a, b)
    pins: list                # pinned source Versions (refcounted)
    segments: list            # per-(shard, tier) stream segments
    plan_records: int
    done_records: int = 0


class Repartitioner:
    """Range split/merge of shards with batched live migration.

    Driven from the router's ``_account_ops`` (the same between-ops
    hook the HotBudget rebalance uses): every ``repartition_interval_
    ops`` it probes per-shard demand and may start a migration job; an
    active job streams ``migration_records_per_op`` records per router
    op (charging sequential reads on the source devices) and, once the
    pinned snapshot is fully streamed, performs the atomic cutover.
    See the module docstring for the full protocol and invariants.
    """

    # observability plane (see TieredLSM._obs)
    _obs = NULL_OBS
    _obs_track = "cluster"

    def __init__(self, scfg: ShardConfig, router: "ShardedTieredLSM"):
        self.scfg = scfg
        self.router = router
        self._job: _MigrationJob | None = None
        self._ops_since_check = 0
        self._cooldown = 0
        self._probe_state: dict = {}
        self.total_ops = 0
        self.n_checks = 0
        self.incompatible_checks = 0      # trigger checks on hash clusters
        self.n_splits = 0
        self.n_merges = 0
        self.migrated_records = 0
        self.migrated_read_bytes = 0
        self.migrated_write_bytes = 0
        self.events: list[dict] = []
        # per-cutover router-visible pause, seconds (see _cutover):
        # foreground busy delta on devices serving live shards, and the
        # total (fg+bg) serialized-work delta on the same devices
        self.cutover_stalls: list[float] = []
        self.cutover_busy: list[float] = []

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def on_ops(self, n: int) -> None:
        self.total_ops += n
        if self._job is not None:
            self._advance(n * self.scfg.migration_records_per_op)
            return
        if self._cooldown > 0:
            self._cooldown = max(0, self._cooldown - n)
            return
        self._ops_since_check += n
        if self._ops_since_check >= self.scfg.repartition_interval_ops:
            self._ops_since_check = 0
            self._check_triggers()

    def drain(self) -> None:
        """Run the active migration (if any) to completion (tests,
        stage boundaries in benchmarks)."""
        while self._job is not None:
            self._advance(max(self._job.plan_records, 1))

    def reset(self) -> None:
        """Fresh counters/events for run-phase-only measurement; keeps
        the current topology and cancels any in-flight job."""
        if self._job is not None:
            for v in self._job.pins:
                v.unref()
            self._job = None
            if self._obs.enabled:
                self._obs.tracer.end(self._obs_track, "migration")
        self.total_ops = 0
        self.n_checks = 0
        self.incompatible_checks = 0
        self.n_splits = 0
        self.n_merges = 0
        self.migrated_records = 0
        self.migrated_read_bytes = 0
        self.migrated_write_bytes = 0
        self.events = []
        self.cutover_stalls = []
        self.cutover_busy = []
        self._ops_since_check = 0
        self._cooldown = 0
        self._probe_state = {}            # storages were reset too

    def __getstate__(self):
        """Pickle without the id()-keyed probe baselines (ids do not
        survive the round-trip)."""
        state = self.__dict__.copy()
        state["_probe_state"] = {}
        state.pop("_obs", None)
        state.pop("_obs_track", None)
        return state

    # ------------------------------------------------------------------
    # triggers
    # ------------------------------------------------------------------
    def _demand(self, shard: TieredLSM) -> float:
        return shard_demand(shard, self.scfg.demand_signal,
                            self._probe_state)

    def _check_triggers(self) -> None:
        self.n_checks += 1
        r = self.router
        if r.scfg.partitioning != "range":
            # hash partitioning already scatters contiguous skew; range
            # surgery on a hashed keyspace would be meaningless.
            self.incompatible_checks += 1
            return
        n = len(r.shards)
        demands = np.array([self._demand(s) for s in r.shards], dtype=float)
        total = float(demands.sum())
        if total <= 0.0:
            return
        fair = total / n
        hot = int(np.argmax(demands))
        split_key = None
        # n == 1: any demand exceeds "fair" by definition (demand ==
        # total == fair would make the relative trigger unreachable);
        # a loaded single shard always benefits from a second device
        overloaded = (demands[hot] > 0.0 if n == 1
                      else demands[hot] > self.scfg.split_factor * fair)
        if overloaded:
            split_key = self._choose_split_key(hot)
        # coldest adjacent pair, excluding the split target
        merge_i = None
        if n >= 2:
            pair_sums = demands[:-1] + demands[1:]
            for i in np.argsort(pair_sums):
                i = int(i)
                if split_key is not None and hot in (i, i + 1):
                    continue
                if pair_sums[i] < self.scfg.merge_factor * 2.0 * fair:
                    merge_i = i
                break                     # only the coldest eligible pair
        ops = []
        if split_key is not None and merge_i is not None:
            # paired split+merge: shard count (= simulated hardware)
            # stays constant — the boundary moves toward the heat
            ops = [("split", r.shards[hot], split_key),
                   ("merge", r.shards[merge_i], r.shards[merge_i + 1])]
        elif split_key is not None and n + 1 <= self.scfg.max_shards:
            ops = [("split", r.shards[hot], split_key)]
        elif merge_i is not None and n - 1 >= self.scfg.min_shards:
            ops = [("merge", r.shards[merge_i], r.shards[merge_i + 1])]
        if ops:
            self._start(ops)

    def _choose_split_key(self, i: int) -> int | None:
        """Split point for shard i: the median *hot* key (halving the
        heat, not just the data, spreads the hot traffic over both
        children's devices), falling back to the median record key.
        Returns None when the shard cannot be split (fewer than two
        distinct keys)."""
        r = self.router
        lo, hi = r.shard_bounds(i)
        sh = r.shards[i]
        if sh.ralt is not None:
            hot_keys, _ = sh.ralt.scan_hot(lo, hi)
            if len(hot_keys) >= 8:
                return int(hot_keys[len(hot_keys) // 2])
        v = sh.version
        fd = sh.group_view(v, "FD")
        sd = sh.group_view(v, "SD")
        parts = [fd.keys, sd.keys]
        if sh.memtable or sh.imm_memtables:
            mem_keys = [k for m in (sh.memtable, *sh.imm_memtables)
                        for k in m]
            parts.append(torch.tensor(mem_keys, dtype=torch.int64).to(
                sh.device))
        keys = torch.unique(torch.cat(parts))       # sorted, as union1d
        if len(keys) < 2:
            return None
        return int(keys[len(keys) // 2])

    # ------------------------------------------------------------------
    # test / benchmark hooks
    # ------------------------------------------------------------------
    def force_split(self, i: int, split_key: int | None = None) -> bool:
        """Start a split of shard i immediately (deterministic tests)."""
        if self._job is not None or self.router.scfg.partitioning != "range":
            return False
        if split_key is None:
            split_key = self._choose_split_key(i)
        if split_key is None:
            return False
        lo, hi = self.router.shard_bounds(i)
        if not lo < split_key <= hi:
            return False
        self._start([("split", self.router.shards[i], split_key)])
        return True

    def force_merge(self, i: int) -> bool:
        """Start a merge of shards i and i+1 immediately."""
        r = self.router
        if (self._job is not None or r.scfg.partitioning != "range"
                or i + 1 >= len(r.shards)):
            return False
        self._start([("merge", r.shards[i], r.shards[i + 1])])
        return True

    # ------------------------------------------------------------------
    # migration job
    # ------------------------------------------------------------------
    def _sources(self, ops) -> list[TieredLSM]:
        out: list[TieredLSM] = []
        for op in ops:
            for sh in op[1:]:
                if isinstance(sh, TieredLSM) and sh not in out:
                    out.append(sh)
        return out

    def _start(self, ops: list) -> None:
        pins, segments, plan = [], [], 0
        for sh in self._sources(ops):
            v = sh.version.ref()          # pin: the pre-copy stream's
            pins.append(v)                # snapshot survives installs
            for group in ("FD", "SD"):
                n_rec, n_bytes = v.group_stats(group, sh.cfg.n_fd_levels)
                if n_rec:
                    segments.append({"storage": sh.storage, "tier": group,
                                     "bytes": n_bytes, "records": n_rec,
                                     "done": 0, "charged": 0})
                    plan += n_rec
        self._job = _MigrationJob(ops=ops, pins=pins, segments=segments,
                                  plan_records=plan)
        if self._obs.enabled:
            self._obs.tracer.begin(
                self._obs_track, "migration",
                {"ops": [op[0] for op in ops], "plan_records": plan})
        if plan == 0:                     # empty sources: cut over now
            self._cutover()

    def _advance(self, k: int) -> None:
        """Stream up to k records of the pinned snapshot: sequential
        reads charged against the source devices, proportional to the
        segment's bytes."""
        job = self._job
        remaining = k
        for seg in job.segments:
            if remaining <= 0:
                break
            take = min(remaining, seg["records"] - seg["done"])
            if take <= 0:
                continue
            seg["done"] += take
            target = int(seg["bytes"] * seg["done"] / seg["records"])
            delta = target - seg["charged"]
            if delta > 0:
                seg["charged"] = target
                seg["storage"].seq_read(seg["tier"], delta, fg=False,
                                        component="migration")
                self.migrated_read_bytes += delta
            remaining -= take
        crashpoints.hit("mid-migration-stream", self._obs, self._obs_track)
        job.done_records = min(job.done_records + k, job.plan_records)
        if job.done_records >= job.plan_records:
            self._cutover()

    # -- cutover -------------------------------------------------------
    def _charge_migration_delta(self, job: _MigrationJob) -> None:
        """Charge source bytes that landed *after* the snapshot pin.

        The pre-copy stream charged only the pinned Version's group
        bytes, but ``_extract`` reads the sources' *current* group
        views — so without this, writes absorbed mid-migration would
        travel to the destinations for free.  The positive growth of
        each (source, tier) group over what the stream already charged
        is read here sequentially under component="migration".  A
        compaction can shrink a group or move bytes across tiers
        between pin and cutover; negative deltas are clamped to zero
        (re-charging rewritten bytes would double-count work the
        compaction already paid for)."""
        streamed: dict[tuple[int, str], int] = {}
        for seg in job.segments:
            streamed[(id(seg["storage"]), seg["tier"])] = seg["charged"]
        for sh in self._sources(job.ops):
            for group in ("FD", "SD"):
                _, cur = sh.version.group_stats(group, sh.cfg.n_fd_levels)
                delta = cur - streamed.get((id(sh.storage), group), 0)
                if delta > 0:
                    sh.storage.seq_read(group, delta, fg=False,
                                        component="migration")
                    self.migrated_read_bytes += delta

    @staticmethod
    def _extract(shard: TieredLSM):
        """A shard's full visible state as sequential streams: the FD
        and SD group winner arrays (via the cached GroupViews), the
        memtables folded newest-wins into one dict, and the mPC."""
        v = shard.version
        fd = shard.group_view(v, "FD").live_arrays()
        sd = shard.group_view(v, "SD").live_arrays()
        mem: dict[int, tuple[int, int]] = {}
        for m in reversed(shard.imm_memtables):   # oldest first
            mem.update(m)
        mem.update(shard.memtable)
        return fd, sd, mem, dict(shard.mpc.data)

    @staticmethod
    def _partition(rec, mem, mpc, p: int):
        """Split extracted state at key p into (< p, >= p) halves (one
        device search for both groups, one copy of its two cuts)."""
        (fd, sd) = rec
        cuts = torch.stack([torch.searchsorted(fd[0], p),
                            torch.searchsorted(sd[0], p)]).tolist()
        out = []
        for (keys, seqs, vlens), i in zip((fd, sd), cuts):
            out.append(((keys[:i], seqs[:i], vlens[:i]),
                        (keys[i:], seqs[i:], vlens[i:])))
        mem_a = {k: v for k, v in mem.items() if k < p}
        mem_b = {k: v for k, v in mem.items() if k >= p}
        mpc_a = {k: v for k, v in mpc.items() if k < p}
        mpc_b = {k: v for k, v in mpc.items() if k >= p}
        return ((out[0][0], out[1][0], mem_a, mpc_a),
                (out[0][1], out[1][1], mem_b, mpc_b))

    @staticmethod
    def _concat(parts):
        """Concatenate extracted states of *adjacent* shards (disjoint
        ascending key ranges, so concatenation preserves sort order)."""
        fd = tuple(torch.cat([p[0][i] for p in parts]) for i in range(3))
        sd = tuple(torch.cat([p[1][i] for p in parts]) for i in range(3))
        mem: dict = {}
        mpc: dict = {}
        for p in parts:
            mem.update(p[2])
            mpc.update(p[3])
        return fd, sd, mem, mpc

    def _build(self, fd_rec, sd_rec, mem, mpc, key_range,
               sources: list[TieredLSM]) -> tuple[TieredLSM, int]:
        """Materialise one destination shard from extracted streams.

        Group winners install as single sorted runs — the FD stream in
        the last FD level, the SD stream in the last level — publishing
        one Version; install bytes are charged as sequential writes on
        the (fresh) destination devices.  The sources' RALT hot sets in
        the destination range are transplanted, then a compaction pass
        restores the level-cap invariants (with the seeded RALT, the
        boundary compaction retains the inherited hot set on FD)."""
        r = self.router
        sh = r._new_shard()
        levels: list[list] = [[] for _ in sh.caps]
        # last FD level (clamped: all-FD baselines have no SD levels)
        fd_li = min(sh.cfg.n_fd_levels, len(levels)) - 1
        wrote = 0
        if len(fd_rec[0]):
            ssts = split_into_sstables(*fd_rec, "FD", fd_li, sh.now,
                                       sh.cfg.target_sstable_bytes)
            levels[fd_li] = ssts
            nb = sum(s.size_bytes for s in ssts)
            sh.storage.seq_write("FD", nb, fg=False, component="migration")
            wrote += nb
        if len(sd_rec[0]):
            last = len(levels) - 1
            ssts = split_into_sstables(*sd_rec, "SD", last, sh.now,
                                       sh.cfg.target_sstable_bytes)
            levels[last] = ssts
            nb = sum(s.size_bytes for s in ssts)
            sh.storage.seq_write("SD", nb, fg=False, component="migration")
            wrote += nb
        sh._publish(levels)
        sh.memtable = dict(mem)
        sh.memtable_bytes = sum(
            KEY_BYTES + (0 if vlen == TOMBSTONE_VLEN else vlen)
            for _, vlen in mem.values())
        if sh.durability is not None:
            # destination durability *before* the topology commit: the
            # inherited memtable fold is WAL-seeded and synced, the run
            # install is a committed manifest edit, and the cluster seq
            # at build time floors the shard's recovery horizon — so
            # recovery on either side of the cutover record sees a
            # consistent image
            sh.durability.wal.seed(mem)
            sh.durability.manifest.log_edit("build", sh.version)
            sh.durability.inherited_seq = self.router.global_seq
        for k, (seq, vlen) in mpc.items():
            sh.mpc.insert(k, seq, vlen, KEY_BYTES)
        if sh.ralt is not None:
            lo, hi = key_range
            for src in sources:
                if src.ralt is None:
                    continue
                hot_keys, hot_vlens = src.ralt.scan_hot(lo, hi)
                if len(hot_keys):
                    sh.ralt.seed_records(hot_keys, hot_vlens)
        sh._maybe_compact()
        n_rec = len(fd_rec[0]) + len(sd_rec[0]) + len(mem)
        self.migrated_records += n_rec
        self.migrated_write_bytes += wrote
        return sh, n_rec

    def _retire(self, shard: TieredLSM) -> None:
        """Drop a source shard while keeping the books: pending checker
        superversions are released (their promotions are abandoned —
        placement only, never visibility), the engine's Version pin is
        dropped, and the shard's Stats/StorageSim stay in the cluster
        aggregate."""
        for immpc in shard.immpcs:
            immpc.sv.release()            # idempotent: queue dups are fine
        for _, immpc in shard._checker_queue:
            immpc.sv.release()
        shard.immpcs = []
        shard._checker_queue = []
        shard.version.unref()
        self.router._fold_retired(shard)

    def _cutover(self) -> None:
        """Atomic topology install: between two router ops, replace the
        source shards and boundary entries with the freshly built
        destinations and re-map the HotBudget shares.

        Router-visible pause accounting: the devices serving *live*
        shards at cutover start are snapshotted, and the stall is their
        busy delta across the surgery.  `cutover_stalls` keeps the
        foreground delta — time an op arriving during the cutover would
        actually wait on, which the contract says must be zero (surgery
        charges everything as background work; the smoke bench gates it
        at 10× median op latency).  `cutover_busy` keeps the total
        (fg+bg) delta — the serialized work the surgery put on serving
        devices (snapshot-delta reads, RALT hot-set scans).  Fresh
        destination devices are excluded: they start idle and only
        begin serving after the install, so their install writes
        overlap future serving rather than pausing the router."""
        job = self._job
        self._job = None
        r = self.router
        obs = self._obs
        base = [(st.dev[t], st.dev[t].fg_time,
                 st.dev[t].fg_time + st.dev[t].bg_time)
                for st in dict.fromkeys(sh.storage for sh in r.shards)
                for t in ("FD", "SD")]
        if obs.enabled:
            obs.tracer.begin(self._obs_track, "cutover_stall",
                             {"ops": [op[0] for op in job.ops]})
        try:
            self._charge_migration_delta(job)
            self._cutover_surgery(job, r)
        finally:
            # released on *every* exit path: an exception mid-surgery
            # must not leak the sources' Version refcounts (the runtime
            # sanitizer and tests/test_version.py exception-injection
            # tests hold this to zero)
            for v in job.pins:
                v.unref()
        stall_fg = max((d.fg_time - f0 for d, f0, _ in base), default=0.0)
        stall_busy = max((d.fg_time + d.bg_time - b0
                          for d, _, b0 in base), default=0.0)
        self.cutover_stalls.append(stall_fg)
        self.cutover_busy.append(stall_busy)
        if obs.enabled:
            obs.tracer.end(self._obs_track, "cutover_stall",
                           {"fg_us": round(stall_fg * 1e6, 3),
                            "busy_us": round(stall_busy * 1e6, 3),
                            "n_shards": len(r.shards)})
            obs.tracer.end(self._obs_track, "migration",
                           {"migrated_records": self.migrated_records})
        self._probe_state = _prune_probe_state(self._probe_state, r.shards)
        self._cooldown = self.scfg.repartition_cooldown_ops
        self._ops_since_check = 0

    def _cutover_surgery(self, job: _MigrationJob,
                         r: "ShardedTieredLSM") -> None:
        shares = scales = None
        if r.hot_budget is not None:
            shares = [float(s) for s in r.hot_budget.shares]
            scales = [float(s) for s in r.hot_budget._scale]
        detail = []
        remaining = list(job.ops)
        while remaining:
            # apply highest-index op first so lower indices stay valid
            op = max(remaining, key=lambda o: r.shards.index(o[1]))
            remaining.remove(op)
            idx = r.shards.index(op[1])
            if op[0] == "split":
                shard, p = op[1], op[2]
                lo, hi = r.shard_bounds(idx)
                fd, sd, mem, mpc = self._extract(shard)
                part_a, part_b = self._partition((fd, sd), mem, mpc, p)
                sh_a, n_a = self._build(*part_a, (lo, p - 1), [shard])
                sh_b, n_b = self._build(*part_b, (p, hi), [shard])
                self._retire(shard)
                r.shards[idx:idx + 1] = [sh_a, sh_b]
                r._bounds_list.insert(idx, p)
                if shares is not None:
                    s = shares.pop(idx)
                    scales.pop(idx)
                    # demand-weighted inheritance: the transplanted RALT
                    # heat (shard_demand hot bytes) decides how the
                    # parent's FD share divides, so the child that took
                    # the hot set takes the budget; record counts only
                    # when neither child reports heat (no RALT, or a
                    # stone-cold split)
                    w_a = shard_demand(sh_a, "hot_bytes", {})
                    w_b = shard_demand(sh_b, "hot_bytes", {})
                    if w_a + w_b <= 0.0:
                        w_a, w_b = float(n_a), float(n_b)
                    tot = max(w_a + w_b, 1.0)
                    shares[idx:idx] = [s * w_a / tot, s * w_b / tot]
                    scales[idx:idx] = [1.0, 1.0]
                self.n_splits += 1
                detail.append({"kind": "split", "at": idx, "key": int(p),
                               "records": n_a + n_b})
                if self._obs.enabled:
                    self._obs.tracer.instant(
                        self._obs_track, "repartition/split",
                        {"at": idx, "key": int(p), "records": n_a + n_b})
            else:
                a, b = op[1], op[2]
                assert r.shards[idx + 1] is b, "merge pair not adjacent"
                lo, _ = r.shard_bounds(idx)
                _, hi = r.shard_bounds(idx + 1)
                parts = [self._extract(a), self._extract(b)]
                fd, sd, mem, mpc = self._concat(parts)
                sh_c, n_c = self._build(fd, sd, mem, mpc, (lo, hi), [a, b])
                self._retire(a)
                self._retire(b)
                r.shards[idx:idx + 2] = [sh_c]
                del r._bounds_list[idx]
                if shares is not None:
                    s = shares.pop(idx) + shares.pop(idx)
                    scales.pop(idx)
                    scales.pop(idx)
                    shares.insert(idx, s)
                    scales.insert(idx, 1.0)
                self.n_merges += 1
                detail.append({"kind": "merge", "at": idx,
                               "records": n_c})
                if self._obs.enabled:
                    self._obs.tracer.instant(
                        self._obs_track, "repartition/merge",
                        {"at": idx, "records": n_c})
        r._bounds = np.array(r._bounds_list, dtype=np.int64)
        cdur = r.durability
        if cdur is not None:
            # the topology record IS the migration's durable commit:
            # torn (mid-cutover crash) ⇒ recovery lands on the previous
            # topology and the migration is abandoned
            cdur.begin_topology(r._bounds_list,
                                [sh.durability.uid for sh in r.shards])
            crashpoints.hit("mid-cutover", self._obs, self._obs_track)
            cdur.commit_topology()
        if r.hot_budget is not None:
            r.hot_budget.retopology(np.array(shares), np.array(scales))
        elif r.scfg.hot_budget and len(r.shards) > 1:
            # a cluster that *started* single-shard had no arbiter to
            # create at __init__; growing past one shard brings the
            # configured arbitration online (fair initial shares)
            r.hot_budget = HotBudget(r.scfg, r.shards)
            if self._obs.enabled:
                r.hot_budget._obs = self._obs
                r.hot_budget._obs_track = self._obs_track
        self.events.append({
            "ops": detail, "at_op": self.total_ops,
            "n_shards": len(r.shards),
            "bounds": [int(b) for b in r._bounds_list]})

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Repartitioner state for RunResult / benchmark JSON."""
        return {
            "n_splits": self.n_splits,
            "n_merges": self.n_merges,
            "n_checks": self.n_checks,
            "incompatible_checks": self.incompatible_checks,
            "migrated_records": self.migrated_records,
            "migrated_read_bytes": self.migrated_read_bytes,
            "migrated_write_bytes": self.migrated_write_bytes,
            "migrated_bytes": (self.migrated_read_bytes
                               + self.migrated_write_bytes),
            "cutover_stalls_fg_us": [round(s * 1e6, 3)
                                     for s in self.cutover_stalls],
            "max_cutover_stall_fg_us": round(
                max(self.cutover_stalls, default=0.0) * 1e6, 3),
            "max_cutover_busy_us": round(
                max(self.cutover_busy, default=0.0) * 1e6, 3),
            "active": self._job is not None,
            "n_shards": len(self.router.shards),
            "bounds": [int(b) for b in self.router._bounds_list],
            "events": self.events[-16:],
            "min_shards": self.scfg.min_shards,
            "max_shards": self.scfg.max_shards,
            "split_factor": self.scfg.split_factor,
            "merge_factor": self.scfg.merge_factor,
            "interval_ops": self.scfg.repartition_interval_ops,
        }


class ShardedTieredLSM:
    """N shared-nothing ``TieredLSM`` shards behind one router.

    Public API mirrors ``TieredLSM`` (`put`/`get`/`delete`/`scan`/
    `scan_range`/`flush_all`) plus the batched ``multi_get``.  ``stats``
    aggregates the per-shard ``Stats`` field-wise; ``storages`` exposes
    the per-shard ``StorageSim`` slices — including those of shards
    retired by repartitioning — for the runner's shared-nothing time
    accounting (shards run in parallel — the wall clock is the busiest
    shard's, see core/runner.py).  The shard list and boundary array
    are mutated only by the ``Repartitioner``'s cutover, between router
    ops.  Every shard is built on ``device``.
    """

    # observability plane (see TieredLSM._obs)
    _obs = NULL_OBS
    _obs_track = "cluster"

    # durability (core/wal.py): None unless cfg.wal
    durability = None

    def __init__(self, scfg: ShardConfig, cfg: LSMConfig,
                 factory=None, seed: int = 0, system: str | None = None,
                 *, device=None):
        self.device = resolve_device(device)
        self.scfg = scfg
        self.cfg = cfg                    # cluster-total config (template)
        self.shard_cfg = shard_lsm_config(cfg, scfg)
        # shard construction: a system name (picklable, survives the
        # DB_CACHE round-trip) or an explicit factory(sub_cfg, seed)
        self._system = system
        self._factory = factory
        self._had_factory = factory is not None
        self._seed_counter = seed
        self.shards: list[TieredLSM] = [self._new_shard()
                                        for _ in range(scfg.n_shards)]
        n = scfg.n_shards
        # range partitioning: shard i owns [i*key_space/N, (i+1)*key_space/N)
        self._bounds_list = [(i + 1) * scfg.key_space // n
                             for i in range(n - 1)]
        self._bounds = np.array(self._bounds_list, dtype=np.int64)
        self.global_seq = 0               # cluster-wide sequence numbers
        self.hot_budget = (HotBudget(scfg, self.shards)
                           if scfg.hot_budget and n > 1 else None)
        self.repartitioner = (Repartitioner(scfg, self)
                              if scfg.repartition else None)
        self._ops_since_rebalance = 0
        # the router's own counters (`ClusterStats`)
        self.router_batches = 0
        self.shard_calls = 0
        self.hot_budget_rebalances = 0
        self._retired_storages: list = []
        # Router-level stat corrections (negative counters folded into
        # the aggregate): a fan-out scan runs one shard-scan per
        # participating shard and may overfetch records the merge then
        # discards; the *served-record* metrics (scans, scanned_records,
        # scan_served_*) are corrected back to the client-visible result
        # so they stay comparable to an unsharded store.  The I/O spent
        # on speculative overfetch stays charged (it is real work), as
        # do the per-shard merge/pull counters and RALT hotness.
        # Retired shards' Stats also fold in here (accounting
        # continuity across repartitions).
        self._corrections = Stats()
        self.durability = None
        if cfg.wal and all(sh.durability is not None
                           for sh in self.shards):
            self.durability = ClusterDurability()
            for sh in self.shards:
                self.durability.adopt(sh.durability)
            # the construction topology record: the cluster exists
            # durably from here on
            self.durability.log_topology(
                self._bounds_list,
                [sh.durability.uid for sh in self.shards])

    def _new_shard(self) -> TieredLSM:
        seed = self._seed_counter
        self._seed_counter += 1
        if self._factory is not None:
            sh = self._factory(self.shard_cfg, seed)
        elif self._system is not None:
            from .baselines import make_system
            sh = make_system(self._system, self.shard_cfg, seed=seed,
                             device=self.device)
        elif self._had_factory:
            # the factory did not survive pickling and no system name
            # was given: refusing beats silently building a shard of
            # the wrong engine into a mixed cluster
            raise RuntimeError(
                "cannot build a shard after unpickling a factory-"
                "constructed ShardedTieredLSM; construct with system= "
                "(see make_sharded_system) to repartition after a "
                "pickle round-trip")
        else:
            sh = TieredLSM(self.shard_cfg, seed=seed, device=self.device)
        # shards built after construction (repartition destinations)
        # register with the cluster's durable half as they are born
        cdur = getattr(self, "durability", None)
        if cdur is not None and sh.durability is not None:
            cdur.adopt(sh.durability)
        return sh

    def __getstate__(self):
        """Pickle without the (possibly lambda) factory; unpickled
        clusters rebuild shards via the stored system name.  The
        observability plane (and its ``_new_shard`` hook closure) is
        session-scoped and reverts to the class-level null plane."""
        state = self.__dict__.copy()
        state["_factory"] = None
        state.pop("_obs", None)
        state.pop("_obs_track", None)
        state.pop("_new_shard", None)
        return state

    # ------------------------------------------------------------------
    # durability / recovery (core/wal.py, core/crashpoints.py)
    # ------------------------------------------------------------------
    @classmethod
    def recover(cls, crashed: "ShardedTieredLSM",
                obs=None) -> "ShardedTieredLSM":
        """Rebuild a cluster from its durable half.  The last committed
        topology record names the live shards and bounds; each shard
        recovers from its own WAL + manifest.  A torn topology record
        (mid-cutover crash) recovers the *previous* topology — the
        migration is abandoned, its destination shards left as orphaned
        debris whose device history still counts.  The migration ledger
        reseeds from the devices' component="migration" totals so byte
        conservation holds across the crash; soft state (hot-budget
        shares, repartition probes) restarts cold."""
        cdur = crashed.durability
        if cdur is None:
            raise ValueError("recover() needs a cluster built with "
                             "LSMConfig(wal=True)")
        topo, dropped = cdur.replay_topology()
        r = cls.__new__(cls)
        r.device = crashed.device
        r.scfg = crashed.scfg
        r.cfg = crashed.cfg
        r.shard_cfg = crashed.shard_cfg
        r._system = crashed._system
        r._factory = None
        r._had_factory = crashed._had_factory
        r._seed_counter = crashed._seed_counter
        r.durability = cdur
        r.shards = [recover_shard(cdur.shards[uid])
                    for uid in topo["uids"]]
        for sh in r.shards:
            sh.durability.retired = False
        r._bounds_list = [int(b) for b in topo["bounds"]]
        r._bounds = np.array(r._bounds_list, dtype=np.int64)
        r.global_seq = max((sh.seq for sh in r.shards), default=0)
        n = len(r.shards)
        r.hot_budget = (HotBudget(r.scfg, r.shards)
                        if r.scfg.hot_budget and n > 1 else None)
        r.repartitioner = (Repartitioner(r.scfg, r)
                           if r.scfg.repartition else None)
        r._ops_since_rebalance = 0
        # the router's counters run on across the crash, as the WALs' do
        r.router_batches = crashed.router_batches
        r.shard_calls = crashed.shard_calls
        r.hot_budget_rebalances = crashed.hot_budget_rebalances
        live = {id(sh.storage) for sh in r.shards}
        r._retired_storages = [st for st in cdur.storages()
                               if id(st) not in live]
        r._corrections = Stats()
        if r.repartitioner is not None:
            rep = r.repartitioner
            for st in cdur.storages():
                comp = st.by_component.get("migration")
                if comp:
                    rep.migrated_read_bytes += int(comp["read_bytes"])
                    rep.migrated_write_bytes += int(comp["write_bytes"])
        r.recovery_info = {
            "n_shards": n,
            "topology_discarded": dropped,
            "replayed_records": sum(sh.recovery_info["replayed_records"]
                                    for sh in r.shards),
            "discarded_torn": dropped + sum(
                sh.recovery_info["discarded_torn"] for sh in r.shards),
            "horizon": r.global_seq,
        }
        if obs is not None:
            obs.attach(r, name="db")
            if r._obs.enabled:
                t = r._obs.tracer
                t.begin(r._obs_track, "recovery")
                t.end(r._obs_track, "recovery", dict(r.recovery_info))
        return r

    @property
    def n_shards(self) -> int:
        """Current shard count (changes under repartitioning)."""
        return len(self.shards)

    def _fold_retired(self, shard: TieredLSM) -> None:
        """Keep a retired shard's op stats and device history in the
        cluster aggregate (called by Repartitioner._retire)."""
        for f in dataclasses.fields(Stats):
            setattr(self._corrections, f.name,
                    getattr(self._corrections, f.name)
                    + getattr(shard.stats, f.name))
        self._retired_storages.append(shard.storage)

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def shard_of(self, key: int) -> int:
        """Scalar key -> shard routing (per-op hot path: plain Python
        arithmetic, no numpy array round-trip; must agree with the
        vectorized `_shard_ids` bit-for-bit)."""
        if not 0 <= key <= MAX_KEY:
            raise ValueError(f"key {key} outside [0, {MAX_KEY}]")
        n = len(self.shards)
        if n == 1:
            return 0
        if self.scfg.partitioning == "range":
            return bisect.bisect_right(self._bounds_list, key)
        return (((key * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) >> 32) % n

    def _shard_ids(self, keys) -> np.ndarray:
        """Vectorized key -> shard bucketing (the router hot path): the
        reference's numpy uint64 arithmetic on the host keys."""
        n = len(self.shards)
        keys = key_array(keys)
        if n == 1:
            return np.zeros(len(keys), dtype=np.int64)
        if self.scfg.partitioning == "range":
            return np.searchsorted(self._bounds, keys,
                                   side="right").astype(np.int64)
        h = (keys.astype(np.uint64) * _HASH_MULT) >> np.uint64(32)
        return (h % np.uint64(n)).astype(np.int64)

    def shard_bounds(self, i: int) -> tuple[int, int]:
        """Inclusive key range [lo, hi] owned by shard i (range
        partitioning; the last shard is unbounded above)."""
        lo = 0 if i == 0 else int(self._bounds_list[i - 1])
        hi = (MAX_KEY if i == len(self.shards) - 1
              else int(self._bounds_list[i]) - 1)
        return lo, hi

    def _account_ops(self, n: int) -> None:
        if self.hot_budget is not None:
            self._ops_since_rebalance += n
            if self._ops_since_rebalance >= self.scfg.rebalance_interval_ops:
                self._ops_since_rebalance = 0
                self.hot_budget_rebalances += 1
                self.hot_budget.rebalance()
        if self.repartitioner is not None:
            self.repartitioner.on_ops(n)

    # ------------------------------------------------------------------
    # point ops
    # ------------------------------------------------------------------
    def put(self, key: int, vlen: int) -> int:
        shard = self.shards[self.shard_of(key)]
        # cluster-wide seq assignment: the shard's next put sees the
        # router's counter, so seqs match the unsharded oracle exactly
        # (and stay monotonic within each shard).
        self.global_seq += 1
        shard.seq = self.global_seq - 1
        seq = shard.put(key, vlen)
        self._account_ops(1)
        return seq

    def delete(self, key: int) -> int:
        shard = self.shards[self.shard_of(key)]
        self.global_seq += 1
        shard.seq = self.global_seq - 1
        seq = shard.delete(key)
        self._account_ops(1)
        return seq

    def get(self, key: int):
        out = self.shards[self.shard_of(key)].get(key)
        self._account_ops(1)
        return out

    def multi_get(self, keys, lat_out=None) -> list:
        """Batched point lookups: one vectorized bucketing pass, then
        each shard's whole bucket executes as a single engine
        `multi_get` batch; results scatter back to input order via the
        inverse bucket permutation.  ``lat_out`` rows (float (n, 2))
        receive each op's (fd, sd) fg-time delta from its serving
        shard — the runner's batched latency recovery."""
        ks = key_array(keys)
        n = len(ks)
        if n == 0:
            return []
        sids = self._shard_ids(ks)
        obs = self._obs
        if obs.enabled:
            obs.tracer.begin(f"{self._obs_track}/router", "router_batch",
                             {"keys": int(n),
                              "shards": int(len(np.unique(sids)))})
        order = np.argsort(sids, kind="stable")
        groups = np.split(order, np.flatnonzero(np.diff(sids[order])) + 1)
        flat: list = []
        # lint: allow-loop (per-shard bucket drain, bounded by n_shards
        # — each bucket is one vectorized engine batch)
        for grp in groups:
            sub_lat = (np.zeros((len(grp), 2))
                       if lat_out is not None else None)
            flat.extend(self.shards[int(sids[grp[0]])].multi_get(
                ks[grp], lat_out=sub_lat))
            if lat_out is not None:
                lat_out[grp] = sub_lat
        inv = np.empty(n, dtype=np.int64)
        inv[np.concatenate(groups)] = np.arange(n, dtype=np.int64)
        out = [flat[i] for i in inv.tolist()]
        if obs.enabled:
            obs.tracer.end(f"{self._obs_track}/router", "router_batch")
        self.router_batches += 1
        self.shard_calls += len(groups)
        self._account_ops(n)
        return out

    def put_many(self, keys, vlens) -> np.ndarray:
        """Batched writes: cluster-wide seqs are assigned in input
        order (byte-identical to n scalar `put`s), then each shard's
        bucket lands as one engine `put_many` carrying its pre-assigned
        ascending seq slice."""
        ks = key_array(keys)
        n = len(ks)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        # the wall-clock plane's `router_put` span: bucketing and the
        # shards' calls
        obs = self._obs
        if obs.wall:
            obs.tracer.begin(f"{self._obs_track}/router", "router_put",
                             {"keys": int(n)})
        vl = (np.full(n, int(vlens), dtype=np.int64)
              if np.ndim(vlens) == 0
              else np.ascontiguousarray(vlens, dtype=np.int64))
        seqs = np.arange(self.global_seq + 1, self.global_seq + 1 + n,
                         dtype=np.int64)
        self.global_seq = int(seqs[-1])
        sids = self._shard_ids(ks)
        buckets = np.unique(sids)
        # lint: allow-loop (per-shard bucket drain, bounded by n_shards
        # — each bucket is one vectorized engine batch)
        for si in buckets:
            sel = np.flatnonzero(sids == si)
            self.shards[int(si)].put_many(ks[sel], vl[sel],
                                          seqs=seqs[sel])
        if obs.wall:
            obs.tracer.end(f"{self._obs_track}/router", "router_put")
        self.router_batches += 1
        self.shard_calls += len(buckets)
        self._account_ops(n)
        return seqs

    # ------------------------------------------------------------------
    # range ops
    # ------------------------------------------------------------------
    _TIER_FIELD = {"mem": "scan_served_mem", "FD": "scan_served_fd",
                   "PC": "scan_served_pc", "SD": "scan_served_sd"}

    def _fold_fanout(self, n_shard_scans: int, dropped) -> None:
        """Fold one logical scan's fan-out back into honest aggregate
        stats: k shard-scans count as 1 scan, and overfetched records
        the merge discarded leave the served-record tallies."""
        corr = self._corrections
        corr.scans -= n_shard_scans - 1
        # lint: allow-loop (discarded-overfetch tail; usually empty)
        for _, _, _, tier in dropped:
            corr.scanned_records -= 1
            field = self._TIER_FIELD[tier]
            setattr(corr, field, getattr(corr, field) - 1)

    def scan(self, lo: int, n: int) -> list[tuple[int, int, int]]:
        """Up to `n` live records with key >= lo, cluster-wide order."""
        if n <= 0:
            return []
        self._account_ops(1)
        if self.scfg.partitioning == "range":
            # planned fan-out: every
            # candidate shard's sub-range is computed up front and
            # asked once — the scatter shape of a parallel RPC fan-out
            # (shards' devices serve concurrently; the runner's
            # busiest-device window models exactly that) — then one
            # merge pass truncates to n.  Shards own disjoint ascending
            # ranges, so the merge is concatenation; the speculative
            # overfetch keeps its I/O cost and is folded out of the
            # served-record stats, like the hash path below.
            parts = [self.shards[si].scan_tagged(
                        max(lo, self.shard_bounds(si)[0]), n)
                     for si in range(self.shard_of(lo), len(self.shards))]
            merged = [rec for part in parts for rec in part]
            self._fold_fanout(len(parts), merged[n:])
            return [(k, s, v) for k, s, v, _ in merged[:n]]
        # hash: every shard may hold part of the range — fan out, merge
        # the (disjoint-key, sorted) partials, keep the first n.  Each
        # shard must be asked for n (all n winners could live on one),
        # so the merge's discarded tail is corrected out of the stats.
        parts = [s.scan_tagged(lo, n) for s in self.shards]
        merged = list(heapq.merge(*parts))
        self._fold_fanout(len(parts), merged[n:])
        return [(k, s, v) for k, s, v, _ in merged[:n]]

    def scan_range(self, lo: int, hi: int) -> list[tuple[int, int, int]]:
        if hi < lo:
            return []
        self._account_ops(1)
        if self.scfg.partitioning == "range":
            # planned fan-out with exact per-shard sub-ranges: clipping
            # [lo, hi] to each shard's bounds makes the fan-out
            # overfetch-free, so the merge is pure concatenation.
            lo_si, hi_si = self.shard_of(lo), self.shard_of(hi)
            parts = [self.shards[si].scan_range(
                        max(lo, self.shard_bounds(si)[0]),
                        min(hi, self.shard_bounds(si)[1]))
                     for si in range(lo_si, hi_si + 1)]
            self._fold_fanout(hi_si - lo_si + 1, ())
            return [rec for part in parts for rec in part]
        parts = [s.scan_range(lo, hi) for s in self.shards]
        self._fold_fanout(len(parts), ())
        return list(heapq.merge(*parts))

    # ------------------------------------------------------------------
    # aggregation / runner plumbing
    # ------------------------------------------------------------------
    @property
    def stats(self) -> ClusterStats:
        """Field-wise sum of the per-shard Stats plus the router's
        fan-out corrections and retired-shard carryover (fresh object;
        derived rates recompute from the summed counters).  Served-
        record scan metrics match what the client saw; I/O and merge-
        work counters keep the full speculative fan-out cost.  On top,
        the router's counters and the group commits of every WAL the
        cluster durably adopted (retired and orphaned shards' too)."""
        agg = ClusterStats(
            router_batches=self.router_batches,
            shard_calls=self.shard_calls,
            hot_budget_rebalances=self.hot_budget_rebalances)
        for f in dataclasses.fields(Stats):
            total = getattr(self._corrections, f.name)
            for shard in self.shards:
                total += getattr(shard.stats, f.name)
            setattr(agg, f.name, total)
        if self.durability is not None:
            for dur in self.durability.shards.values():
                agg.wal_syncs += dur.wal.syncs
                agg.wal_bytes += dur.wal.synced_bytes
        return agg

    @property
    def storages(self) -> list:
        """All device slices carrying this cluster's I/O history: the
        live shards' plus those retired by repartitioning (so migration
        cost and pre-cutover traffic stay in the time accounting)."""
        return [s.storage for s in self.shards] + list(self._retired_storages)

    def flush_all(self) -> None:
        for shard in self.shards:
            shard.flush_all()

    def reset_storage(self) -> None:
        for shard in self.shards:
            shard.reset_storage()
        self._corrections = Stats()
        self._retired_storages = []
        if self.hot_budget is not None:
            self.hot_budget._probe_state = {}   # fresh devices: rebase
        if self.repartitioner is not None:
            self.repartitioner.reset()

    def fd_used_bytes(self) -> int:
        return sum(s.fd_used_bytes() for s in self.shards)

    def total_records(self) -> int:
        return sum(s.total_records() for s in self.shards)

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor of every live shard (`TieredLSM.tensors`)."""
        return [t for sh in self.shards for t in sh.tensors()]

    def device_bytes(self) -> int:
        """Bytes of the distinct storages behind `tensors()`."""
        return storage_bytes(self.tensors())

    def shard_knobs(self) -> dict:
        """Effective cluster/admission settings for RunResult output."""
        knobs = {
            "n_shards": len(self.shards),
            "partitioning": self.scfg.partitioning,
            "range_promo_frac": self.shard_cfg.range_promo_frac,
            "hot_budget": self.hot_budget is not None,
            "repartition": self.repartitioner is not None,
        }
        if self.hot_budget is not None:
            knobs.update(self.hot_budget.snapshot())
        return knobs
