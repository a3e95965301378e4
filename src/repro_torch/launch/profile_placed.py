"""Placed cells over NCCL, one rank a card (`launch/steps.py:plan_cell`,
`make_serve_step(plan=)`, `make_prefill_step(plan=)`), measured beside
the planner's estimate (`launch/plan.py`).

    PYTHONPATH=src python -c "from repro_torch.kernels import _build; \\
        _build.build()"
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.profile_placed --cell zamba2-long

Cells (`--mesh DATAxMODEL`, default 1x4; weights random bf16 from seed
0, each rank holding only its blocks):

  * `zamba2-long`: zamba2-7b's long_500k decode cell (batch 1, the KV
    caches of its 13 shared occurrences over 524,288 positions cut along
    the sequence over ("data", "model")); every rank's cache blocks are
    filled from a seeded normal draw (no prefill of half a million
    tokens), then `--steps` greedy decode steps at the last positions,
    ending at 524,287;
  * `mamba2-prefill`: mamba2-1.3b's prefill_32k cell under the dry run's
    "fsdp" recipe (`--batch`, default the cell's 32: pure data
    parallelism, 8 rows a rank at 1x4); one prefill to warm up, then
    `--steps` timed;
  * `llama3-decode`: llama3-8b serving at batch 4 over 168 slots (the
    `serve --mesh` CLI's shape) from a zeroed cache; `--steps` untimed
    warm-up and timed steps, then `--traced` steps under torch.profiler
    on every rank: a step's wall time split into device time in NCCL
    kernels (the collectives, their waits on the other ranks included),
    in the other kernels, and device idle time (the host not keeping the
    card fed), and the host time of the collective calls.

Each rank reports its resident bytes (weights, cache), memory_allocated,
max_memory_allocated and times; rank 0 adds the planner's record of the
cell and prints the card's name and power limit, then one JSON line
(also written to `--out`).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

CELLS = ("zamba2-long", "mamba2-prefill", "llama3-decode")


def _sync():
    torch.cuda.synchronize()


def _nbytes(tree) -> int:
    from ..tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _weights(plan, cfg, dev):
    """This rank's blocks of the seeded weights (the full tree is drawn on
    the card, placed and freed)."""
    from ..models.transformer import init_params
    from . import steps
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    full = init_params(cfg, g, dev)
    local = steps.place_params(plan, full, device=dev)
    del full
    torch.cuda.empty_cache()
    return local


def zamba2_long(mesh, mesh_name, dev, args) -> tuple[dict, dict]:
    from ..configs import get_config
    from ..configs.shapes import SHAPES
    from . import steps
    cfg, shape = get_config("zamba2-7b"), SHAPES["long_500k"]
    plan = steps.plan_cell(cfg, shape, mesh)
    params = _weights(plan, cfg, dev)
    cache = steps.init_placed_cache(plan, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1 + dist.get_rank())
    for c in cache:
        for t in c.values():
            t.copy_(torch.randn(t.shape, generator=g, device=dev) * 0.5)
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step = steps.make_serve_step(cfg, plan)
    tok = steps.local_rows(plan, torch.zeros(1, dtype=torch.int32)).to(dev)
    ms = []
    first = shape.seq - args.steps
    for pos in range(first, shape.seq):
        _sync()
        t0 = time.perf_counter()
        tok, cache = step(params, cache, tok, pos)
        _sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    out = dict(cell="zamba2-7b/long_500k", positions=[first, shape.seq - 1],
               weight_bytes=_nbytes(params), cache_bytes=_nbytes(cache),
               memory_allocated=resident,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               ms_each=ms, ms_per_step=statistics.median(ms[1:] or ms),
               traffic_per_step={k: v / len(ms) for k, v in
                                 step.placement.traffic.items()},
               tokens=[int(tok[0])])
    return out, dict(cfg=cfg, shape=shape, recipe="tp")


def mamba2_prefill(mesh, mesh_name, dev, args) -> tuple[dict, dict]:
    from ..configs import get_config
    from ..configs.shapes import SHAPES, ShapeSpec
    from . import steps
    cfg = get_config("mamba2-1.3b")
    base = SHAPES["prefill_32k"]
    shape = ShapeSpec(base.name, "prefill", base.seq,
                      args.batch or base.batch)
    plan = steps.plan_cell(cfg, shape, mesh, "fsdp")
    params = _weights(plan, cfg, dev)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (shape.batch,
                                                          shape.seq))
                              .astype(np.int32))
    batch = {k: v.to(dev) for k, v in
             steps.local_batch(plan, {"tokens": tokens}).items()}
    del tokens
    resident = torch.cuda.memory_allocated(dev)
    step = steps.make_prefill_step(cfg, plan)
    secs, peaks = [], []
    for _ in range(1 + args.steps):
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        _sync()
        t0 = time.perf_counter()
        logits, cache = step(params, batch)
        _sync()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated(dev))
        cache_bytes = _nbytes(cache)
        finite = bool(torch.isfinite(logits).all())
        del logits, cache
    out = dict(cell="mamba2-1.3b/prefill_32k", recipe="fsdp",
               batch=shape.batch, rows=int(batch["tokens"].shape[0]),
               seq=shape.seq, weight_bytes=_nbytes(params),
               cache_out_bytes=cache_bytes, memory_allocated=resident,
               max_memory_allocated=max(peaks), s_each=secs,
               s_per_prefill=statistics.median(secs[1:]),
               tokens_per_s=shape.batch * shape.seq
               / statistics.median(secs[1:]), finite=finite,
               traffic_per_prefill={k: v / len(secs) for k, v in
                                    step.placement.traffic.items()})
    return out, dict(cfg=cfg, shape=shape, recipe="fsdp")


def llama3_decode(mesh, mesh_name, dev, args) -> tuple[dict, dict]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..configs import get_config
    from ..configs.shapes import ShapeSpec
    from . import steps
    cfg = get_config("llama3-8b")
    shape = ShapeSpec("serve", "decode", 168, 4)
    plan = steps.plan_cell(cfg, shape, mesh)
    params = _weights(plan, cfg, dev)
    cache = steps.init_placed_cache(plan, dev)
    step = steps.make_serve_step(cfg, plan)
    tok = steps.local_rows(plan, torch.arange(shape.batch,
                                              dtype=torch.int32)).to(dev)
    pos = 0

    def one():
        nonlocal tok, cache, pos
        tok, cache = step(params, cache, tok, pos)
        pos += 1

    for _ in range(args.steps):                       # warm up
        one()
    ms = []
    for _ in range(args.steps):
        _sync()
        t0 = time.perf_counter()
        one()
        _sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            for _ in range(args.traced):
                one()
                _sync()
    events = prof.events()
    (window,) = [e for e in events if e.name == "window"
                 and e.device_type == DeviceType.CPU]
    w0, w1 = window.time_range.start, window.time_range.end
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name != "window"]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]

    def busy(evs):
        total, end = 0.0, w0
        for a, b in sorted((max(e.time_range.start, w0),
                            min(e.time_range.end, w1)) for e in evs):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    n, wall = args.traced, w1 - w0
    all_busy, nccl_busy = busy(kernels), busy(nccl)
    host_coll = sum(e.cpu_time_total for e in events
                    if e.device_type == DeviceType.CPU and e.name in (
                        "c10d::allgather_", "c10d::allreduce_",
                        "c10d::_allgather_base_", "c10d::_reduce_scatter_base_",
                        "nccl:all_gather", "nccl:all_reduce",
                        "nccl:_all_gather_base", "nccl:_reduce_scatter_base"))
    out = dict(cell="llama3-8b/serve", batch=shape.batch, slots=shape.seq,
               weight_bytes=_nbytes(params), cache_bytes=_nbytes(cache),
               memory_allocated=torch.cuda.memory_allocated(dev),
               ms_each=ms, ms_per_step=statistics.median(ms),
               traced_steps=n, traced_ms_per_step=wall / n / 1e3,
               device_nccl_ms_per_step=nccl_busy / n / 1e3,
               device_other_ms_per_step=(all_busy - nccl_busy) / n / 1e3,
               device_idle_ms_per_step=(wall - all_busy) / n / 1e3,
               device_idle_share=1 - all_busy / wall,
               nccl_kernels_per_step=len(nccl) / n,
               kernels_per_step=len(kernels) / n,
               host_collective_ms_per_step=host_coll / n / 1e3,
               traffic_per_step={k: v / (pos) for k, v in
                                 step.placement.traffic.items()})
    return out, dict(cfg=cfg, shape=shape, recipe="tp")


RUNS = {"zamba2-long": zamba2_long, "mamba2-prefill": mamba2_prefill,
        "llama3-decode": llama3_decode}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", choices=CELLS, required=True)
    ap.add_argument("--mesh", default="1x4", help="DATAxMODEL")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--traced", type=int, default=5)
    ap.add_argument("--batch", type=int, default=0,
                    help="mamba2-prefill: rows (default the cell's 32)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_placed needs CUDA cards, one a rank")
    torch.backends.cuda.matmul.allow_tf32 = False
    from .mesh import make_mesh
    from .plan import parse_mesh, plan_one
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", timeout=datetime.timedelta(seconds=600))
    try:
        desc = parse_mesh(args.mesh)
        if dist.get_world_size() != desc.size:
            raise ValueError(f"mesh {args.mesh} needs {desc.size} ranks")
        mesh = make_mesh(desc.sizes, desc.axis_names)
        t0 = time.perf_counter()
        mine, cell = RUNS[args.cell](mesh, args.mesh, dev, args)
        mine["rank"], mine["run_s"] = dist.get_rank(), time.perf_counter() - t0
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        if dist.get_rank() == 0:
            rec = plan_one(cell["cfg"], cell["shape"], args.mesh,
                           recipe=cell["recipe"])
            res = dict(cell=args.cell, mesh=args.mesh,
                       card=torch.cuda.get_device_name(dev), ranks=ranks,
                       planned=dict(bytes_per_device=rec["bytes_per_device"],
                                    collective_by_kind=rec[
                                        "collective_by_kind"],
                                    roofline_terms_s=rec["roofline_terms_s"]))
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True, timeout=60).stdout.strip().splitlines()[0],
                flush=True)
            line = json.dumps({"profile_placed": res})
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    f.write(line + "\n")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
