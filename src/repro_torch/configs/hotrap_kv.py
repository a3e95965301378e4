"""The paper's own configuration (HotRAP §4.1 testbed, scaled): the port
of `repro.configs.hotrap_kv`, field for field.

Not an LM architecture: this is the tiered key-value store the paper
evaluates.  The dataclass mirrors the paper's experimental setup (FD:SD
= 1:10, Table 1 device model, 16 KiB blocks, RALT initial limits 50% /
15% of FD) at laptop scale, and is consumed by `repro_torch.core`'s
runner and sharded cluster.  The serving analogue (tiered KV-cache /
expert / embedding caches) reads the same ratios via
`tiering_defaults()`.
"""
from __future__ import annotations

import dataclasses

from ..core import LSMConfig
from ..core.storage import MIB


@dataclasses.dataclass(frozen=True)
class HotrapKVConfig:
    fd_size: int = 16 * MIB
    sd_size: int = 160 * MIB          # paper ratio 1:10
    target_sstable_bytes: int = 256 * 1024
    value_len: int = 1000             # paper's 1 KiB records (24B keys)
    hot_set_init_frac: float = 0.50   # of FD (paper §4.1)
    ralt_phys_frac: float = 0.15      # of FD (paper §4.1)
    # --- sharded serving (core/shards.py) ---
    n_shards: int = 4                 # shared-nothing keyspace partitions
    partitioning: str = "hash"        # "hash" | "range"
    hot_budget: bool = True           # cluster-scope §3.7 FD arbiter
    # --- dynamic repartitioning (core/shards.py Repartitioner) ---
    repartition: bool = False         # split/merge hot partitions with
                                      # live migration (range only)
    min_shards: int = 2               # merges never shrink below
    max_shards: int = 8               # splits never grow above
    split_factor: float = 2.0         # demand > factor x fair -> split
    merge_factor: float = 0.5         # pair demand < factor x 2 fair
    demand_signal: str = "auto"       # "auto" | "hot_bytes" | "fd_used"
                                      # | "fg_util" (engine-agnostic)


CONFIG = HotrapKVConfig()


def lsm_config(c: HotrapKVConfig = CONFIG) -> LSMConfig:
    return LSMConfig(
        fd_size=c.fd_size, sd_size=c.sd_size,
        target_sstable_bytes=c.target_sstable_bytes,
        memtable_bytes=c.target_sstable_bytes,
        block_cache_bytes=max(c.fd_size // 64, 64 * 1024),
    )


def shard_config(c: HotrapKVConfig = CONFIG,
                 key_space: int | None = None):
    """The cluster shape for `make_sharded_system` (core/shards.py).

    Range partitioning needs boundaries that straddle the *actual* key
    universe — a huge default would silently route every real key to
    shard 0 — so when `key_space` is not given it is derived from the
    store's loaded record count (`db_key_count`), with headroom for
    workload inserts beyond the loaded range.  Hash partitioning
    ignores key_space.
    """
    from ..core.runner import db_key_count
    from ..core.shards import ShardConfig
    if key_space is None:
        if c.partitioning == "range":
            key_space = 2 * db_key_count(lsm_config(c), c.value_len)
        else:
            key_space = 2 ** 62
    return ShardConfig(n_shards=c.n_shards, partitioning=c.partitioning,
                       key_space=key_space, hot_budget=c.hot_budget,
                       repartition=c.repartition,
                       min_shards=c.min_shards, max_shards=c.max_shards,
                       split_factor=c.split_factor,
                       merge_factor=c.merge_factor,
                       demand_signal=c.demand_signal)


def tiering_defaults(fast_slots: int) -> dict:
    """Paper ratios mapped onto the tiered caches (`tiering/`)."""
    return dict(
        hot_limit_init=int(0.50 * fast_slots),
        hot_limit_lo=max(int(0.05 * fast_slots), 1),    # L_hs
        hot_limit_hi=int(0.70 * fast_slots),            # R_hs
        beta=0.10,                                      # eviction fraction
        gamma=0.001, alpha=0.999,                       # time slices
        delta_c=2.6, c_max=5,                           # Alg. 1
    )
