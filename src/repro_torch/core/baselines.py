"""Compared systems (paper §4.1), the port of `repro.core.baselines`.

Every baseline reuses the same LSM engine so that differences in the
benchmark come only from the tiering/promotion policy:

  rocksdb_fd       — everything on FD (upper bound)
  rocksdb_tiered   — plain tiered LSM, FD levels sized to the FD budget
  hotrap           — the paper's system
  hotrap_noretain  — Table 3 ablation (promotion only)
  hotrap_nohotcheck— Table 4 ablation (promote everything read from SD)

`make_sharded_system` builds N shared-nothing shards of one of them
behind the core/shards.py router, every shard on the cluster's device.

Not ported yet (ROADMAP Queue 1): `mutant`, `sas_cache` and `prismdb`
and the runtime sanitizer (`sanitize=True`) raise NotImplementedError
naming their item.
"""
from __future__ import annotations

import dataclasses

from .lsm import LSMConfig, TieredLSM
from .storage import StorageSim

SANITIZE_ITEM = ("ROADMAP Queue 1: core/sanitize.py + Mutant, SAS-Cache "
                 "and PrismDB")


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
SYSTEMS = ["hotrap", "rocksdb_fd", "rocksdb_tiered", "mutant", "sas_cache",
           "prismdb", "hotrap_noretain", "hotrap_nohotcheck"]
PORTED = ["hotrap", "rocksdb_fd", "rocksdb_tiered", "hotrap_noretain",
          "hotrap_nohotcheck"]


def make_system(name: str, cfg: LSMConfig | None = None,
                storage: StorageSim | None = None, seed: int = 0,
                sanitize: bool = False, *, device=None,
                **overrides) -> TieredLSM:
    """The engine of system `name` on `device` (``cuda`` unless the
    caller passes ``device="cpu"``)."""
    if sanitize:
        raise NotImplementedError(
            f"sanitize=True is not ported yet ({SANITIZE_ITEM})")
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
    if name in SYSTEMS:
        raise NotImplementedError(
            f"system {name!r} is not ported yet ({SANITIZE_ITEM}); "
            f"ported: {PORTED}")
    raise ValueError(f"unknown system {name!r} (choose from {SYSTEMS})")


def make_sharded_system(name: str, cfg: LSMConfig | None = None,
                        shard_cfg=None, seed: int = 0,
                        sanitize: bool = False, *, device=None,
                        **overrides):
    """Sharded construction for every ported system: N shared-nothing
    shards of `name`'s engine behind the core/shards.py router, each on
    `device` (``cuda`` unless the caller passes ``device="cpu"``).
    `cfg` is the *cluster-total* resource budget; each shard gets a 1/N
    slice (see shards.shard_lsm_config).  `shard_cfg` is a ShardConfig
    (defaults: 4 hash-partitioned shards with the HotBudget arbiter on).
    """
    from .shards import ShardConfig, ShardedTieredLSM
    if sanitize:
        raise NotImplementedError(
            f"sanitize=True is not ported yet ({SANITIZE_ITEM})")
    cfg = cfg or LSMConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    scfg = shard_cfg or ShardConfig()
    # construction by system *name* (not a factory closure) keeps the
    # cluster picklable and lets the Repartitioner build destination
    # shards after a pickle round-trip
    return ShardedTieredLSM(scfg, cfg, seed=seed, system=name,
                            device=device)
