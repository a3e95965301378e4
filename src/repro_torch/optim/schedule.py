"""Learning-rate schedules (port of `repro/optim/schedule.py`).

A step (int or 0-d tensor) in, a float32 0-d CPU tensor out.  The
schedule is a host scalar, so it is evaluated in numpy float32 with the
reference's operation order, and the cosine is the C library's `cosf`,
which is what the reference's XLA CPU backend calls: the values match the
reference bit for bit (torch's and numpy's float32 cos round otherwise in
the last place for some inputs).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch

F32 = np.float32


@functools.cache
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.cosf.argtypes = [ctypes.c_float]
    lib.cosf.restype = ctypes.c_float
    return lib


def _cosf(x: np.float32) -> np.float32:
    return F32(_libm().cosf(float(x)))


def _warm(step: int, warmup_steps: int) -> np.float32:
    return min(F32(1.0), F32(step + 1) / F32(max(warmup_steps, 1)))


def linear_warmup(step, warmup_steps: int) -> torch.Tensor:
    return torch.tensor(_warm(int(step), warmup_steps))


def cosine_schedule(step, warmup_steps: int, total_steps: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    step = int(step)
    t = F32(step - warmup_steps) / F32(max(total_steps - warmup_steps, 1))
    t = min(max(t, F32(0.0)), F32(1.0))
    cos = F32(min_frac) + F32((1 - min_frac) * 0.5) * (
        F32(1.0) + _cosf(F32(math.pi) * t))
    return torch.tensor(_warm(step, warmup_steps) * cos)
