"""Host syncs a call makes, counted by CUDA's sync debug mode: a copy
of the port's `chip_smoke.count_syncs`."""
from __future__ import annotations

import warnings

import torch


def count_syncs(fn):
    """(fn(), the host syncs it made), counted by CUDA's sync debug
    mode's warnings."""
    count = [0]

    def seen(message, *args, **kw):
        count[0] += "synchroniz" in str(message)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, count[0]
