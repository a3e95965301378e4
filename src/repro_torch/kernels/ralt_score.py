"""RALT exponential-smoothing score update: CUDA kernel for Hopper and
its plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/ralt_score.py:_ralt_kernel`
(`pl.pallas_call` at line 78).  For every tracked unit:

    score' = exp(ln(alpha) * (now - tick)) * score + hit
    tick'  = now
    hot    = score' >= threshold          (int8)

The kernel (`csrc/ralt_score.cu`) is one flat pass over N; the TPU's
(rows, 128)-lane padding is gone.  `now` and `threshold` may be device
scalars that the kernel reads through pointers, so a caller that keeps
them on the device never waits for the host.

Both versions evaluate exp with the Cephes single-precision polynomial,
fused multiply-adds and flush-to-zero, and fuse `score * decay + hit`
into one multiply-add — the sequence the reference's XLA CPU backend
evaluates — so the kernel, the plain version and the reference's Pallas
kernel agree bit for bit.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

F32 = torch.float32
_FLT_MIN = float(np.finfo(np.float32).tiny)
_LOG2E = float(np.float32(1.44269504088896341))
_C1 = float(np.float32(0.693359375))
_C2 = float(np.float32(-2.12194440e-4))
_P = tuple(float(np.float32(p)) for p in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
    4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))


def fma_f32(a, b, c):
    """float32 fused multiply-add: the product of two float32 values is
    exact in float64, so one float64 add and one rounding to float32
    give the fused result."""
    a, b, c = (x.double() if torch.is_tensor(x) else x for x in (a, b, c))
    return (a * b + c).float()


def _ftz(x):
    return torch.where(x.abs() < _FLT_MIN, torch.zeros_like(x), x)


def exp_f32(x):
    """float32 exp, Cephes polynomial (see the module docstring)."""
    x = x.clamp(-87.8, 88.8)
    n = torch.floor(fma_f32(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma_f32(n, -_C1, x)
    r = fma_f32(n, -_C2, r)
    z = r * r
    y = fma_f32(r, _P[0], _P[1])
    for p in _P[2:]:
        y = fma_f32(y, r, p)
    y = 1.0 + fma_f32(y, z, r)
    return _ftz((y.double() * torch.exp2(n.double())).float())


def _plain(ticks, scores, hits, now, threshold, log_alpha):
    dt = (now - ticks).to(F32)
    decay = exp_f32(dt * log_alpha)
    new_scores = _ftz(fma_f32(scores, decay, hits.to(F32)))
    new_ticks = torch.empty_like(ticks).fill_(now)
    return new_ticks, new_scores, (new_scores >= threshold).to(torch.int8)


def _lib():
    lib = _build.load("ralt_score")
    if lib.ralt_update.argtypes is None:
        P = ctypes.c_void_p
        lib.ralt_update.argtypes = [P, P, P, P, P, P, P, P,
                                    ctypes.c_longlong, ctypes.c_float,
                                    ctypes.c_int, P]
        lib.ralt_update.restype = ctypes.c_int
    return lib


def _cuda(ticks, scores, hits, now, threshold, log_alpha):
    dev = ticks.device
    n = ticks.numel()
    for name, t, dts in (("ticks", ticks, (torch.int32,)),
                         ("scores", scores, (F32,)),
                         ("hits", hits, (torch.int8, torch.bool)),
                         ("now", now, (torch.int32,)),
                         ("threshold", threshold, (F32,))):
        if t.device != dev or t.dtype not in dts:
            raise ValueError(f"ralt_update: {name} must be {dts} on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ralt_update: {name} must be contiguous")
    if scores.shape != (n,) or hits.shape != (n,) or ticks.dim() != 1:
        raise ValueError("ralt_update: ticks, scores, hits must be (N,)")
    if now.numel() != 1 or threshold.numel() != 1:
        raise ValueError("ralt_update: now and threshold must be scalars")
    out_t = torch.empty_like(ticks)
    out_s = torch.empty_like(scores)
    out_h = torch.empty(n, dtype=torch.int8, device=dev)
    wide = (ticks, scores, out_t, out_s)
    vec = int(all(t.data_ptr() % 16 == 0 for t in wide)
              and all(t.data_ptr() % 4 == 0 for t in (hits, out_h)))
    lib = _lib()
    rc = lib.ralt_update(
        ticks.data_ptr(), scores.data_ptr(), hits.data_ptr(),
        now.data_ptr(), threshold.data_ptr(), out_t.data_ptr(),
        out_s.data_ptr(), out_h.data_ptr(), n, log_alpha, vec,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "ralt_update")
    _build.LAUNCHES["ralt_update"] += 1
    return out_t, out_s, out_h


def ralt_update(ticks, scores, hits, now, threshold, alpha: float = 0.999):
    """ticks: (N,) int32; scores: (N,) f32; hits: (N,) bool/int8;
    now/threshold: scalars (Python numbers or 0-d tensors).
    Returns (new_ticks, new_scores, hot_i8).  A CUDA `ticks` launches the
    CUDA kernel; a CPU one runs the plain version."""
    dev = ticks.device
    now = torch.as_tensor(now, dtype=torch.int32, device=dev)
    threshold = torch.as_tensor(threshold, dtype=F32, device=dev)
    # the reference multiplies by ln(alpha) rounded to float32
    log_alpha = float(np.float32(math.log(alpha)))
    if dev.type == "cuda":
        return _cuda(ticks, scores, hits, now, threshold, log_alpha)
    if dev.type == "cpu":
        return _plain(ticks, scores, hits, now, threshold, log_alpha)
    raise ValueError(f"ralt_update: unsupported device {dev}")
