from .sharding import (set_mesh_axes, clear_mesh_axes, shard, logical_spec,
                       DP, TP)  # noqa: F401
