"""GPipe-style pipeline parallelism over a process group (counterpart of
`repro/distributed/pipeline.py`).

`gpipe_apply` runs S identical stages, stage s on the group's rank s,
over M microbatches with the classic (M + S - 1)-tick schedule: at tick
t stage s works on microbatch t - s, taking it from stage s - 1 (stage 0
from the input) and passing its output to stage s + 1 by point-to-point
send, so only adjacent stages exchange activations (bubble fraction
(S - 1) / (M + S - 1)).  The reference computes every stage at every
tick and masks the results; here a stage idles outside its M ticks.
Each tick's receive is posted before the stage computes, and every send
is waited on before the schedule ends, so the one-directional chain
cannot deadlock.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def gpipe_apply(stage_fn, stage_params, x_micro, group=None):
    """stage_fn(params, x) -> y with x/y of identical shape.

    `stage_params`: this rank's stage (the reference stacks all S
    stages on a leading dim sharded over the axis; each rank here holds
    its own slice).  `x_micro`: (M, ...) microbatches, the same on every
    rank.  Returns the (M, ...) outputs after all S stages, on every
    rank of `group` (default: every rank)."""
    S = dist.get_world_size(group)
    s = dist.get_rank(group)
    M = x_micro.shape[0]

    def peer(i):
        return dist.get_global_rank(group, i) if group is not None else i

    outs = torch.zeros_like(x_micro)
    sends = []
    for t in range(M + S - 1):
        m = t - s
        if not 0 <= m < M:
            continue
        if s == 0:
            x = x_micro[m]
        else:
            x = torch.empty_like(x_micro[m])
            dist.irecv(x, src=peer(s - 1), group=group).wait()
        y = stage_fn(stage_params, x)
        if s < S - 1:
            y = y.contiguous()
            sends.append((dist.isend(y, dst=peer(s + 1), group=group), y))
        else:
            outs[m] = y
    for work, _ in sends:
        work.wait()
    # results live on the last stage: share them with every rank
    dist.broadcast(outs, src=peer(S - 1), group=group)
    return outs


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
