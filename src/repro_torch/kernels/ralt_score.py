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

`ralt_record_` is the tracker's whole record step (the RALT update with
the time-slice clock and Algorithm 1's counters around it) as one launch
of the same source's `ralt_record` kernel, in place.  Its plain version
is `tiering.hotness.record_accesses`.  The hit units travel as sorted
distinct ids: up to `param_ids()` of them by value in the launch's
parameters, so a record of a few ids costs neither a copy nor an
allocation (a pinned staging ring would cost an H2D copy a record and an
event to guard each slot); longer lists go through `to_device`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..device import to_device
from . import _build

F32 = torch.float32
I32 = torch.int32
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
        F = ctypes.c_float
        lib.ralt_record.argtypes = [P, P, P, P, P, P, ctypes.c_int,
                                    ctypes.c_longlong, P, P, ctypes.c_int,
                                    F, F, F, F, F, F, ctypes.c_int, P]
        lib.ralt_record.restype = ctypes.c_int
        lib.ralt_record_param_ids.restype = ctypes.c_int
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


# ----------------------------------------------------------------------
# ralt_record_: one tracker record, fused and in place
# ----------------------------------------------------------------------
STATE_ARRAYS = (("tick", I32), ("score", F32), ("c", F32),
                ("t", torch.bool), ("seen", torch.bool))


@functools.cache
def param_ids() -> int:
    """How many ids one launch takes by value (`kParamIds`)."""
    return _lib().ralt_record_param_ids()


def _clock(state):
    """(buffer, slot): the (2, 4) float32 clock buffer whose row `slot`
    the state's `now` (int32 bits), `accessed_bytes` and
    `accessed_bytes_r` are (the views in `buffer.clock_views`).  Where
    they are not (a state from `init_state` or from the plain version) a
    buffer is made and row 0 filled by three device copies."""
    acc = state["accessed_bytes"]
    views = getattr(acc._base, "clock_views", None)
    for slot, v in enumerate(views or ()):
        if all(state[k] is x for k, x in v.items()):
            return acc._base, slot
    buf = torch.zeros((2, 4), dtype=F32, device=acc.device)
    buf.clock_views = tuple(
        {"now": buf.view(I32)[s, 0], "accessed_bytes": buf[s, 1],
         "accessed_bytes_r": buf[s, 2]} for s in (0, 1))
    for k, x in buf.clock_views[0].items():
        x.copy_(state[k])
    return buf, 0


def sorted_ids(ids, n: int) -> np.ndarray:
    """Host ids (any order, repeats, negatives from the end, as a mask
    index takes them) as sorted distinct int32 ids in [0, n)."""
    a = np.asarray(ids.numpy() if torch.is_tensor(ids) else ids,
                   dtype=np.int64).ravel()
    if a.size and (a.min() < -n or a.max() >= n):
        raise IndexError(f"ralt_record_: unit id out of range for {n} units")
    a = a % n
    return (np.unique(a) if a.size > 1 else a).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _constants(cfg) -> tuple:
    """The record's float32 constants, rounded once as `record_accesses`'
    device scalars are: unit bytes, slice bytes, R, delta_c, c_max and
    ln(alpha)."""
    return tuple(float(np.float32(x)) for x in (
        cfg.unit_bytes, cfg.gamma * cfg.fast_bytes,
        cfg.hot_hi_frac * cfg.fast_bytes, cfg.delta_c, cfg.c_max,
        math.log(cfg.alpha)))


def ralt_record_(state, ids, cfg):
    """One tracker record on CUDA: the time-slice clock, the RALT update
    and Algorithm 1's counters (`tiering.hotness.record_accesses`) in
    one launch.  `state` is the tracker's state on one CUDA device; its
    tick, score, c, t and seen are updated in place, and the returned
    state's now / accessed_bytes / accessed_bytes_r view the other row of
    the two-slot clock buffer (an earlier state's views are overwritten
    by the record after next).  `ids`: the units hit, as host ids (list,
    numpy array or CPU tensor; any order, repeats count once) or as a
    CUDA integer tensor of sorted distinct ids (as `nonzero` gives).
    `cfg`: the tracker's `TrackerConfig`."""
    tick = state["tick"]
    dev, n = tick.device, tick.numel()
    if dev.type != "cuda":
        raise ValueError("ralt_record_: the state must be on a CUDA device; "
                         "the CPU runs hotness.record_accesses")
    for name, dt in STATE_ARRAYS:
        x = state[name]
        if x.device != dev or x.dtype != dt or x.shape != (n,):
            raise ValueError(f"ralt_record_: {name} must be ({n},) {dt} on "
                             f"{dev}, got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"ralt_record_: {name} must be contiguous")
    buf, cur = _clock(state)
    if buf.device != dev:
        raise ValueError("ralt_record_: the clock must be on the state's "
                         "device")
    lib = _lib()
    host, dev_ids = None, None
    if torch.is_tensor(ids) and ids.device.type == "cuda":
        if ids.device != dev or ids.dtype not in (I32, torch.int64):
            raise ValueError(f"ralt_record_: device ids must be int32/int64 "
                             f"on {dev}, got {ids.dtype} on {ids.device}")
        dev_ids = ids.reshape(-1).to(I32).contiguous()
        n_ids = dev_ids.numel()
    else:
        host = sorted_ids(ids, n)
        n_ids = host.size
        if n_ids > param_ids():
            dev_ids, host = to_device(host, dev), None
    arrays = [state[name] for name, _ in STATE_ARRAYS]
    vec = int(all(x.data_ptr() % 16 == 0 for x in arrays[:3])
              and all(x.data_ptr() % 4 == 0 for x in arrays[3:]))
    rc = lib.ralt_record(
        *(x.data_ptr() for x in arrays), buf.data_ptr(), cur, n,
        None if host is None else host.ctypes.data,
        None if dev_ids is None else dev_ids.data_ptr(), n_ids,
        *_constants(cfg), vec, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "ralt_record")
    _build.LAUNCHES["ralt_record"] += 1
    return {**state, **buf.clock_views[1 - cur]}
