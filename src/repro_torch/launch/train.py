"""Training launcher of the port: the training loop end to end, with
fault tolerance (counterpart of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --seq-len 4096 --global-batch 2 --microbatch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --device cpu --steps 20 --ckpt-dir /tmp/ckpt [--resume]
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch llama3-8b --smoke --mesh data=4,model=2 --recipe fsdp

Runs on ``cuda`` unless given ``--device cpu``, and raises without CUDA.
  * step-atomic rolling checkpoints in the reference's format and layout
    (host snapshot on the training thread, background write),
    resume-from-latest;
  * the deterministic data pipeline replays the exact stream after a
    restart, so a resumed run repeats the uninterrupted one;
  * straggler monitoring: steps slower than `deadline_factor` x the EMA
    are logged and counted;
  * failure injection for tests (`inject_failure_at`): raises after the
    step (and any checkpoint write) completes, like a preempted worker;
  * over a mesh (`--mesh`, under torchrun): data parallelism over the
    binding's dp ranks (NCCL on the cards, gloo with ``--device cpu``).
    Weights are replicated on every rank: the reference's SPMD placement
    of weights along `param_specs` (tensor parallelism over "model",
    FSDP over "data") is not ported, so both recipes differ only in
    which axes carry the batch.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import PORTED, get_config, smoke_config
from ..convert import (opt_state_from_reference, opt_state_to_reference,
                       params_from_reference, params_to_reference)
from ..data.lm_pipeline import DataConfig, LMPipeline
from ..device import resolve_device, to_device
from ..models.transformer import init_params
from ..optim import adamw_init
from ..tree import tree_map
from .mesh import axis_binding, axis_group, make_mesh
from .steps import TrainOptions, make_train_step

F32 = torch.float32


class StragglerMonitor:
    def __init__(self, deadline_factor: float = 3.0, warmup: int = 3):
        self.f = deadline_factor
        self.warmup = warmup
        self.ema = None
        self.strikes = 0
        self.events: list = []

    def observe(self, step: int, dt: float) -> bool:
        if self.ema is None:
            self.ema = dt
            return False
        slow = step > self.warmup and dt > self.f * self.ema
        if slow:
            self.strikes += 1
            self.events.append((step, dt, self.ema))
        self.ema = 0.9 * self.ema + 0.1 * dt
        return slow


def _state(params, opt, cfg) -> dict:
    """What a checkpoint holds, in the reference's layout."""
    return {"params": params_to_reference(params, cfg),
            "opt": opt_state_to_reference(opt, cfg)}


def dp_mean(group, n: int):
    """-> reduce(loss, grads): the mean of the loss and of every gradient
    over the `n` ranks of `group`, summed in float32 and divided by n,
    each gradient cast back to its dtype (with n = 1 the step's own
    numbers, bit for bit)."""
    def mean(t):
        x = t.to(F32, copy=True)
        dist.all_reduce(x, group=group)
        return (x / torch.tensor(float(n), device=x.device)).to(t.dtype)

    def reduce(loss, grads):
        return mean(loss), tree_map(mean, grads)

    return reduce


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          mesh=None, recipe: str = "tp", topts: TrainOptions | None = None,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          resume: bool = False, inject_failure_at: int | None = None,
          seed: int = 0, log_every: int = 10, async_ckpt: bool = True,
          deadline_factor: float = 3.0, device=None):
    """Returns (params, opt_state, history dict).

    With a `mesh` (a DeviceMesh over the default process group, which
    the caller has initialised: torchrun, or a test's launcher), every
    rank runs this function.  The binding is `launch.mesh.axis_binding`
    for `recipe` at the microbatch's rows, as the reference's
    `plan_cell` gives it.  The global batch is split in order over the
    binding's dp ranks (`LMPipeline.batch_at(step, shard, num_shards)`);
    ranks that differ only along the other axes compute the same rows
    (under "tp" on a model axis larger than 1 they repeat each other's
    work until weights are placed).
    Gradients and the loss are averaged over the dp ranks (`dp_mean`),
    so `history` holds the global batch's loss on every rank.  Weights
    and optimizer state are replicated: the reference's placement of a
    train cell's weights by `param_specs` (tp over "model", fsdp over
    "data") is not ported; only decode cells are placed
    (`launch.steps.plan_cell`).  A rank's MoE layers route its own rows as one token group
    (`models.moe.moe_ffn`).  Rank 0 writes checkpoints; every rank
    restores them.  A rank runs on ``cuda:LOCAL_RANK`` unless `device`
    says otherwise."""
    if mesh is not None and device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = resolve_device(device)
    topts = topts or TrainOptions(total_steps=steps)
    shard, num_shards, reduce, rank0 = 0, 1, None, True
    if mesh is not None:
        shard, num_shards, reduce = _data_parallel(
            cfg, mesh, recipe, global_batch // max(topts.microbatch, 1),
            device)
        rank0 = dist.get_rank() == 0
    step_fn = make_train_step(cfg, topts, reduce)
    data = LMPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                 global_batch=global_batch, seed=seed))
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = init_params(cfg, g, device)
    opt = adamw_init(params, topts.opt)
    start = 0
    mgr = None
    monitor = StragglerMonitor(deadline_factor)
    history = {"loss": [], "step_s": [], "straggler_steps": []}
    try:
        if ckpt_dir:
            mgr = CheckpointManager(ckpt_dir, keep=3, async_write=async_ckpt)
            if resume and mgr.latest() is not None:
                restored, extra = mgr.restore(_state(params, opt, cfg))
                params = params_from_reference(restored["params"], cfg,
                                               device)
                opt = opt_state_from_reference(restored["opt"], cfg, device,
                                               topts.opt.moment_dtype)
                start = extra["step"] + 1
                print(f"[train] resumed from step {start - 1}", flush=True)
            if mesh is not None:    # no rank writes before all have read
                dist.barrier()
        for step in range(start, steps):
            t0 = time.perf_counter()
            batch = {k: to_device(v, device) for k, v in
                     data.batch_at(step, shard, num_shards).items()}
            if cfg.frontend:
                batch["frontend_emb"] = torch.zeros(
                    (global_batch // num_shards, 8, cfg.d_model),
                    dtype=getattr(torch, cfg.dtype), device=device)
            params, opt, metrics = step_fn(params, opt, step, batch)
            loss = float(metrics["loss"])          # waits for the step
            dt = time.perf_counter() - t0
            if monitor.observe(step, dt):
                history["straggler_steps"].append(step)
                print(f"[train] straggler: step {step} took {dt:.2f}s "
                      f"(ema {monitor.ema:.2f}s)", flush=True)
            history["loss"].append(loss)
            history["step_s"].append(dt)
            if step % log_every == 0 and rank0:
                print(f"[train] step {step} loss {loss:.4f} gnorm "
                      f"{float(metrics['grad_norm']):.3f} ({dt:.2f}s)",
                      flush=True)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged @ {step}")
            if mgr and rank0 and (step + 1) % ckpt_every == 0:
                mgr.save(step, _state(params, opt, cfg),
                         extra={"step": step})
            if inject_failure_at is not None and step == inject_failure_at:
                raise RuntimeError(f"injected failure @ {step}")
        # the last step's checkpoint, unless the loop just wrote it (or
        # resumed from it): saving a step twice would rename onto it
        if mgr and rank0 and steps > start and steps % ckpt_every:
            mgr.save(steps - 1, _state(params, opt, cfg),
                     extra={"step": steps - 1})
    finally:
        if mgr:
            mgr.wait()
    return params, opt, history


def _data_parallel(cfg, mesh, recipe: str, batch: int, device):
    """The binding of `mesh` for `recipe` (as the reference's `plan_cell`
    gives it for a train cell of `batch` rows a microbatch) -> (this
    rank's dp index, the dp size, `dp_mean` over the dp group)."""
    if not dist.is_initialized():
        raise RuntimeError("train(mesh=...) needs torch.distributed "
                           "initialised on every rank")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    has_ssm = any(b.kind == "mamba2" for _, blocks in cfg.stages
                  for b in blocks)
    b = axis_binding(mesh, shape_kind="train", recipe=recipe, batch=batch,
                     allow_sp=not has_ssm)
    dp = axis_group(mesh, b["dp"])
    return dp.index, dp.size, dp_mean(dp.group, dp.size)


def parse_mesh(text: str) -> tuple[tuple, tuple]:
    """"data=4,model=2" -> (("data", "model"), (4, 2))."""
    pairs = [part.split("=") for part in text.split(",")]
    return tuple(k for k, _ in pairs), tuple(int(v) for _, v in pairs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b", choices=PORTED)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:LOCAL_RANK under --mesh) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--mesh", default=None,
                    help="e.g. data=4,model=2 (run under torchrun; the "
                         "sizes multiply to the world size)")
    ap.add_argument("--recipe", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    device = args.device
    if args.mesh and device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = resolve_device(device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    topts = TrainOptions(total_steps=args.steps, microbatch=args.microbatch)
    mesh = None
    if args.mesh:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        names, sizes = parse_mesh(args.mesh)
        mesh = make_mesh(sizes, names)
    try:
        _, _, hist = train(cfg, steps=args.steps,
                           global_batch=args.global_batch,
                           seq_len=args.seq_len, mesh=mesh,
                           recipe=args.recipe, topts=topts,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, resume=args.resume,
                           device=device)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    if hist["loss"] and (mesh is None or int(os.environ.get("RANK", 0)) == 0):
        print(f"[train] done on {where}: loss {hist['loss'][0]:.4f} -> "
              f"{hist['loss'][-1]:.4f} over {len(hist['loss'])} steps",
              flush=True)
    return hist


if __name__ == "__main__":
    main()
