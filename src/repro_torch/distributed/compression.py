"""Gradient compression for the data-parallel all-reduce (counterpart of
`repro/distributed/compression.py`), on `torch.distributed`.

int8 uniform quantization with **error feedback** (1-bit-Adam style):
the quantization residual is carried to the next step, so compression
error stays O(1) instead of growing O(T).  Per leaf, over the ranks of
`group`:

    x     = g + e                         (float32)
    scale = max(all_reduce_MAX(max|x|) / 127, 1e-12)
    q     = clip(round(x / scale), -127, 127)     int8 on the wire
    g'    = (sum over ranks of q) * scale / N
    e'    = x - q * scale

The sum of q is exact: every rank's int8 payload is all-gathered (int8
is what crosses the wire) and the N payloads are added in int32.  The
divisions take 0-dim float32 tensors, not Python numbers: on CUDA a
division by a number is a multiplication by its rounded reciprocal,
which need not round as the reference's division does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map

F32 = torch.float32


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                          device=g.device), grads)


def quantize(x, amax):
    """(int8 payload, float32 scale) of the float32 `x` under the
    group-wide max |x| `amax` (a 0-dim float32 tensor)."""
    scale = torch.clamp(amax / torch.tensor(127.0, device=x.device),
                        min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def _compress_one(g, e, group):
    x = g.to(F32) + e
    amax = x.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    q8, scale = quantize(x, amax)
    n = dist.get_world_size(group)
    parts = [torch.empty_like(q8) for _ in range(n)]
    dist.all_gather(parts, q8, group=group)
    qsum = parts[0].to(torch.int32)
    for part in parts[1:]:
        qsum += part
    out = qsum.to(F32) * scale / torch.tensor(float(n), device=x.device)
    err = x - q8.to(F32) * scale
    return out.to(g.dtype), err


def compressed_allreduce(grads, error_state, group=None):
    """Mean of `grads` over the ranks of `group` (default: every rank)
    with an int8 wire format and error feedback.  `grads` are this
    rank's unreduced gradients; `error_state` is `init_error_state`'s
    tree or the last call's.  Returns (mean grads in the gradients'
    dtypes, new error state)."""
    flat = [_compress_one(g, e, group)
            for g, e in zip(tree_leaves(grads), tree_leaves(error_state))]
    means, errs = iter([m for m, _ in flat]), iter([e for _, e in flat])
    return (tree_map(lambda _: next(means), grads),
            tree_map(lambda _: next(errs), grads))
