"""HotRAP core on the device: the port of `repro.core`.

Public API:
    LSMConfig, TieredLSM      — the engine (core/lsm.py); point ops plus
                                `scan`/`scan_range` (core/scan.py) and
                                the batched `multi_get`/`put_many`
    Version, Superversion     — immutable read-path snapshots + REMIX
                                GroupViews (core/version.py)
    RALT, RaltConfig          — the hotness tracker (core/ralt.py)
    make_system, SYSTEMS      — paper baselines (core/baselines.py)
    make_sharded_system       — N-shard shared-nothing construction
    ShardConfig, ShardedTieredLSM, HotBudget, Repartitioner
                              — keyspace-partitioned cluster with the
                                cross-shard FD-budget arbiter and
                                dynamic split/merge repartitioning
                                (core/shards.py)
    StorageSim                — simulated tiered devices (core/storage.py)
    WriteAheadLog, Manifest, ShardDurability, ClusterDurability
                              — durability subsystem: group-committed
                                WAL + Version-edit manifest + cluster
                                topology log; `TieredLSM.recover` /
                                `ShardedTieredLSM.recover` rebuild an
                                engine from them (core/wal.py)
    crashpoints, CrashError   — deterministic crash injection: named
                                sites at mid-flush/-compaction/
                                -promotion-install/-migration-stream/
                                -cutover plus the `crash_recover`
                                harness (core/crashpoints.py)

Sorted runs, bloom filters, merged views and RALT records are tensors on
the engine's device; the entry points (`TieredLSM`, `make_system`,
`make_sharded_system`, `runner.bench_system`) take ``device=`` and run
on ``cuda`` unless it is ``"cpu"``.  The sanitizer and three baselines
are a later slice (ROADMAP Queue 1).
"""
from . import crashpoints                      # noqa: F401
from .crashpoints import (CRASH_SITES, CrashError,  # noqa: F401
                          crash_recover)
from .lsm import LSMConfig, TieredLSM          # noqa: F401
from .wal import (ClusterDurability, Manifest,  # noqa: F401
                  ShardDurability, WriteAheadLog)
from .version import GroupView, Superversion, Version  # noqa: F401
from .ralt import RALT, RaltConfig             # noqa: F401
from .baselines import (PORTED, SYSTEMS,  # noqa: F401
                        make_sharded_system, make_system)
from .shards import (HotBudget, Repartitioner, ShardConfig,  # noqa: F401
                     ShardedTieredLSM)
from .storage import StorageSim                # noqa: F401
