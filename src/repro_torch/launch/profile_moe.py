"""Device time of qwen3-moe-235b-a22b's dropless decode step and of a
4096-token prefill, by group.

    PYTHONPATH=src python -m repro_torch.launch.profile_moe

Needs one CUDA card.  The model is the `chip_smoke.py` `moe` run's: full
width, 8 of 94 layers, bf16 weights from seed 0, batch 4.  From
torch.profiler's CUDA (CUPTI) kernel records, after warm-up:

  * 4 decode steps at positions 128-131 (the cache holds 128 tokens),
    per step: device µs by group and the host's wall µs, whose gap is
    the device's idle share;
  * one 4096-token prefill at the published capacity factor (1.25).

A kernel's group is read from the aten operator that launched it: the
batched expert products (`aten::bmm`), the other weight products
(`aten::mm` / `aten::addmm` / `aten::matmul`), the routing sorts
(sort, argsort, searchsorted), the gathers of dispatch and combine
(indexing, gather, index_select), and the rest (elementwise passes,
norms, softmax); the hand-written decode and flash kernels, launched
outside any aten operator, by name.

Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from ..tree import tree_leaves

PEAK_BYTES = 3.35e12         # H100 SXM memory rate (NVIDIA data sheet)
LAYERS, BATCH, PROMPT, STEPS, PREFILL = 8, 4, 128, 4, 4096
OPS = (("expert products (bmm)", {"aten::bmm"}),
       ("other weight products", {"aten::mm", "aten::addmm",
                                  "aten::matmul", "aten::linear"}),
       ("routing sorts", {"aten::sort", "aten::argsort",
                          "aten::searchsorted"}),
       ("dispatch and combine gathers", {"aten::index", "aten::gather",
                                         "aten::index_select"}))
KERNELS = (("decode attention kernel", "decode_kernel"),
           ("flash attention kernel", "flash_fwd"))


def _group(event) -> str:
    names = set()
    while event is not None:
        names.add(event.name)
        event = event.cpu_parent
    return next((g for g, ops in OPS if names & ops), "rest")


def grouped(prof, reps: int) -> dict:
    """Device µs per repetition by group, and the top kernels."""
    from torch.autograd import DeviceType
    kernels = [(e.name, e.device_time_total) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    groups = defaultdict(float)
    for name, us in kernels:
        g = next((g for g, k in KERNELS if k in name), None)
        if g is not None:
            groups[g] += us
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        for k in e.kernels:
            if not any(sub in k.name for _, sub in KERNELS):
                groups[_group(e)] += k.duration
    total = sum(us for _, us in kernels)
    groups["rest"] += total - sum(groups.values())
    by_name = defaultdict(float)
    for n, us in kernels:
        by_name[n] += us
    return dict(device_us=total / reps,
                groups_us={g: us / reps for g, us in sorted(groups.items())},
                kernels=len(kernels) / reps,
                top=[dict(kernel=n[:100], us=us / reps) for n, us in
                     sorted(by_name.items(), key=lambda kv: -kv[1])[:10]])


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    from ..configs import get_config
    from ..launch.steps import make_prefill_step
    from ..models import transformer
    from ..models.config import Block

    if not torch.cuda.is_available():
        raise RuntimeError("profile_moe needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    full = get_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(full, stages=((LAYERS, (Block("moe"),)),))
    g = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(cfg, g, dev)
    rng = np.random.default_rng(0)
    cache = transformer.init_cache(cfg, BATCH, PROMPT + STEPS + 8, dev)

    def step(pos):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, BATCH)).to(dev)
        with torch.no_grad():
            return transformer.decode_step(params, cfg, cache, toks, pos)

    for pos in range(PROMPT):               # fill the cache, warm up
        step(pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(STEPS):
            step(PROMPT + i).argmax(dim=-1).cpu()   # the engine's sync
        wall = (time.perf_counter() - t0) * 1e6 / STEPS
    decode = grouped(prof, STEPS)
    decode.update(wall_us=wall, idle_share=1 - decode["device_us"] / wall,
                  note="wall under the profiler")
    prefill = make_prefill_step(cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (1, PREFILL))).to(dev)
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    pre = grouped(prof, 1)
    pre.update(wall_us=wall, idle_share=1 - pre["device_us"] / wall)
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       [params["lm_head"]] + tree_leaves(params["layers"]))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps({"profile_moe": dict(
        model=cfg.name, layers=LAYERS, batch=BATCH,
        decode_step=dict(position=PROMPT, weight_bytes=weight_bytes,
                         byte_bound_us=weight_bytes / PEAK_BYTES * 1e6,
                         **decode),
        prefill=dict(tokens=PREFILL, capacity_factor=cfg.capacity_factor,
                     **pre))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
