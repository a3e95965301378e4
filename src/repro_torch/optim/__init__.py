from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    global_norm)
from .schedule import cosine_schedule, linear_warmup      # noqa: F401
