from .hotness import HotTracker, TrackerConfig     # noqa: F401
from .kvcache import KVTierConfig, SimClock, TieredKVCache  # noqa: F401
