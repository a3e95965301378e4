"""HotRAP core on the device: the port of `repro.core` (single shard).

Public API:
    LSMConfig, TieredLSM      — the engine (core/lsm.py); point ops plus
                                `scan`/`scan_range` (core/scan.py) and
                                the batched `multi_get`/`put_many`
    Version, Superversion     — immutable read-path snapshots + REMIX
                                GroupViews (core/version.py)
    RALT, RaltConfig          — the hotness tracker (core/ralt.py)
    make_system, SYSTEMS      — paper baselines (core/baselines.py)
    StorageSim                — simulated tiered devices (core/storage.py)

Sorted runs, bloom filters, merged views and RALT records are tensors on
the engine's device; the entry points (`TieredLSM`, `make_system`,
`runner.bench_system`) take ``device=`` and run on ``cuda`` unless it is
``"cpu"``.  Shards, the WAL, the sanitizer and three baselines are later
slices (ROADMAP Queue 1).
"""
from .lsm import LSMConfig, TieredLSM                      # noqa: F401
from .version import GroupView, Superversion, Version      # noqa: F401
from .ralt import RALT, RaltConfig                         # noqa: F401
from .baselines import PORTED, SYSTEMS, make_system       # noqa: F401
from .storage import StorageSim                            # noqa: F401
