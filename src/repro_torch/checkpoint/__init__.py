from .ckpt import (latest_step, restore, save, CheckpointManager)  # noqa: F401
