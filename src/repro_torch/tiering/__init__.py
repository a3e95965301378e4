from .embedding import TieredEmbedding                       # noqa: F401
from .expert_cache import ExpertCache                        # noqa: F401
from .hotness import HotTracker, TrackerConfig               # noqa: F401
from .kvcache import KVTierConfig, SimClock, TieredKVCache   # noqa: F401
