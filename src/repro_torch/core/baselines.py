"""Compared systems (paper §4.1), the port of `repro.core.baselines`.

Every baseline reuses the same LSM engine so that differences in the
benchmark come only from the tiering/promotion policy:

  rocksdb_fd       — everything on FD (upper bound)
  rocksdb_tiered   — plain tiered LSM, FD levels sized to the FD budget
  hotrap           — the paper's system
  hotrap_noretain  — Table 3 ablation (promotion only)
  hotrap_nohotcheck— Table 4 ablation (promote everything read from SD)

Not ported yet (ROADMAP Queue 1): `mutant`, `sas_cache` and `prismdb`
and the runtime sanitizer (`sanitize=True`) raise NotImplementedError
naming their item; sharded systems are a later slice too.
"""
from __future__ import annotations

import dataclasses

from .lsm import LSMConfig, TieredLSM
from .storage import StorageSim

SANITIZE_ITEM = ("ROADMAP Queue 1: core/sanitize.py + Mutant, SAS-Cache "
                 "and PrismDB")
SHARDS_ITEM = "ROADMAP Queue 1: core/shards.py + configs/hotrap_kv.py"


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
