"""Serving launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.serve --arch llama3-8b --mesh 1x2
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --smoke --device cpu --mesh 2x2

Runs the batched engine with random weights drawn from `--seed`: the
full config on ``cuda`` by default, the reduced smoke config with
``--smoke``.  Prints requests, tokens, wall time and tokens/s with the
device they ran on.

With `--mesh DATAxMODEL` (under torchrun, one process a rank) the
requests are served by the placed decode step (`launch.steps.plan_cell`,
`make_serve_step(plan=...)`), for every architecture (mamba2-1.3b's SSM
heads and zamba2-7b's shared block included): each rank holds only its
blocks of the weights and of the cache, over NCCL with one rank a card
(``cuda:LOCAL_RANK``) or over gloo with ``--device cpu``.  Each rank
prints its resident weight and cache bytes beside the tokens/s (over
gloo the time is mostly host staging of the collectives, not a speed).
"""
from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import PORTED, get_config, smoke_config
from ..configs.shapes import ShapeSpec
from ..device import resolve_device
from ..models.transformer import decode_step, init_params
from ..serving.engine import Request, ServeEngine
from ..tree import tree_leaves
from . import steps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_placed(cfg, mesh, prompts, max_new: int, *, batch: int,
                 device, seed: int = 0, params=None, teacher=None) -> dict:
    """Serve `prompts` ((R, P) token ids, R a multiple of `batch`; every
    rank passes them all) through the placed decode step on `mesh` (a
    DeviceMesh, or a ("data", "model") description of the default
    process group's ranks), as `ServeEngine` schedules them: waves of
    `batch` requests from a zeroed cache of P + max_new + 8 slots, each
    prompt teacher-forced, then each step's greedy token fed back.  The
    weights are drawn from `seed` on `device` as the engine draws them
    (or given: `params`, the full tree), placed, and the full tree freed.
    -> this rank's {request id: new tokens}, steps, wall seconds, its
    resident weight and cache bytes (and on a card the bytes allocated
    once the first wave's cache is made) and its collectives' bytes.

    With `teacher` ((R, max_new) token ids) the continuation is forced:
    after the prompt each step is fed the teacher's token, and for each
    request the result also holds, per new token, the largest logit
    less the teacher token's logit (`gaps`: 0 where the argmax is the
    teacher's token)."""
    R, P = prompts.shape
    if R % batch:
        raise ValueError(f"{R} requests do not fill waves of {batch}")
    plan = steps.plan_cell(cfg, ShapeSpec("serve", "decode",
                                          P + max_new + 8, batch), mesh)
    if params is None:
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        params = init_params(cfg, g, device)
    local = steps.place_params(plan, params, device=device)
    del params
    step = steps.make_serve_step(cfg, plan)
    rows = steps.local_rows(plan, torch.arange(batch)).tolist()
    prompts = torch.as_tensor(prompts, dtype=torch.int32)
    if teacher is not None:
        teacher = torch.as_tensor(teacher, dtype=torch.int32)
    plc = step.placement
    out, gaps, n_steps, cache_bytes, allocated = {}, {}, 0, 0, None
    _sync(device)
    t0 = time.perf_counter()
    for w in range(0, R, batch):
        wave = steps.local_rows(plan, prompts[w:w + batch]).to(device)
        forced = None if teacher is None else steps.local_rows(
            plan, teacher[w:w + batch]).to(device)
        cache = steps.init_placed_cache(plan, device)
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(cache))
        if allocated is None and device.type == "cuda":
            allocated = torch.cuda.memory_allocated(device)
        tok, new, gap = wave[:, 0], [], []
        for t in range(P + max_new - 1):
            if forced is None:
                nxt, cache = step(local, cache, tok, t)
            else:
                with torch.no_grad():
                    logits = decode_step(local, cfg, cache, tok, t,
                                         place=plc)
                nxt = plc.argmax(logits, plan.vocab_entry)
                if t >= P - 1:
                    gap.append(plc.logit_gap(logits, forced[:, t - P + 1],
                                             plan.vocab_entry))
            n_steps += 1
            if t >= P - 1:
                new.append(nxt)
            if t + 1 < P:
                tok = wave[:, t + 1]
            else:
                tok = nxt if forced is None else forced[:, t - P + 1]
        toks = torch.stack(new, 1).tolist()
        out.update({w + r: toks[i] for i, r in enumerate(rows)})
        if gap:
            g = torch.stack(gap, 1).tolist()
            gaps.update({w + r: g[i] for i, r in enumerate(rows)})
    _sync(device)
    res = dict(tokens=out, steps=n_steps, wall_s=time.perf_counter() - t0,
               weight_bytes=sum(t.numel() * t.element_size()
                                for t in tree_leaves(local)),
               cache_bytes=cache_bytes, memory_allocated=allocated,
               traffic=dict(plc.traffic), plan=plan)
    if teacher is not None:
        res["gaps"] = gaps
    return res


def _mesh_main(args, cfg) -> dict:
    """`--mesh`: this rank's part of the placed serve, under torchrun."""
    from .mesh import make_mesh
    data, model = (int(x) for x in args.mesh.lower().split("x"))
    cpu = args.device == "cpu"
    if cpu:
        device = torch.device("cpu")
    else:                       # the rank's card, before NCCL starts
        resolve_device("cuda")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl",
                            timeout=datetime.timedelta(seconds=300))
    try:
        if dist.get_world_size() != data * model:
            raise ValueError(f"mesh {args.mesh} needs {data * model} ranks, "
                             f"got {dist.get_world_size()}")
        mesh = make_mesh((data, model), ("data", "model"))
        rng = np.random.default_rng(args.seed)
        prompts = np.stack([rng.integers(0, cfg.vocab, args.prompt_len)
                            for _ in range(args.requests)])
        res = serve_placed(cfg, mesh, prompts, args.max_new,
                           batch=args.batch, device=device, seed=args.seed)
        tokens = sum(len(v) for v in res["tokens"].values())
        where = "cpu (gloo: host-staged collectives)" if cpu \
            else torch.cuda.get_device_name(device)
        print(f"[serve] rank {dist.get_rank()} {cfg.name} mesh {args.mesh} "
              f"on {where}: weights {res['weight_bytes']} B, cache "
              f"{res['cache_bytes']} B resident; {len(res['tokens'])} "
              f"requests, {tokens} tokens in {res['wall_s']:.3f}s "
              f"({tokens / res['wall_s']:.1f} tok/s), {res['steps']} steps",
              flush=True)
        return res
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=PORTED)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL: serve placed across torchrun's ranks")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.mesh:
        return _mesh_main(args, cfg)
    device = resolve_device(args.device)
    eng = ServeEngine(cfg, batch=args.batch,
                      max_len=args.prompt_len + args.max_new + 8,
                      seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        eng.submit(Request(
            rid=rid,
            prompt=list(rng.integers(0, cfg.vocab, args.prompt_len)),
            max_new=args.max_new))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in done)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[serve] {cfg.name} on {where}: {len(done)} requests, {tokens} "
          f"tokens in {dt:.3f}s ({tokens / dt:.1f} tok/s), "
          f"{eng.steps_used} steps", flush=True)
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out[:8]}...", flush=True)
    return done


if __name__ == "__main__":
    main()
