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
  * over a mesh (`--mesh`, under torchrun; NCCL on the cards, gloo with
    ``--device cpu``): the train cell placed as the reference's
    `plan_cell` places it (`launch.steps.plan_cell`; recipes "tp",
    "fsdp", "ep"), each rank holding only its blocks of the weights, the
    gradients and both AdamW moments; checkpoints stay the reference's
    whole tree, so a run saved on one mesh resumes on another.
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
from ..configs.shapes import ShapeSpec
from ..convert import (opt_state_from_reference, opt_state_to_reference,
                       params_from_reference, params_to_reference)
from ..data.lm_pipeline import DataConfig, LMPipeline
from ..device import resolve_device, to_device
from ..models.transformer import init_params
from ..optim import adamw_init
from ..tree import tree_map
from .mesh import make_mesh
from .steps import (TrainOptions, local_batch, make_train_step,
                    place_opt_state, place_params, plan_cell)


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


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          mesh=None, recipe: str = "tp", topts: TrainOptions | None = None,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          resume: bool = False, inject_failure_at: int | None = None,
          seed: int = 0, log_every: int = 10, async_ckpt: bool = True,
          deadline_factor: float = 3.0, device=None):
    """Returns (params, opt_state, history dict).

    With a `mesh` (a DeviceMesh over the default process group, which
    the caller has initialised: torchrun, or a test's launcher), every
    rank runs this function on the train cell that `steps.plan_cell`
    places for `recipe` at the global batch and sequence (the binding of
    the microbatch's rows, as the reference's `train(mesh=)` gets it):
    the rank draws the whole seeded model, keeps its blocks of the
    parameters and of the AdamW moments (the reference's `device_put`
    onto the cell's shardings) and trains on its rows of each global
    batch (`steps.local_batch`) with the placed step
    (`make_train_step(plan=)`), whose `history` losses are the global
    batch's, the same on every rank.  It returns the rank's blocks.
    A checkpoint is the reference's whole tree: to save, every leaf is
    gathered whole, one at a time, and rank 0 writes; to restore, every
    rank reads the tree and keeps its blocks, so a run saved on one mesh
    resumes on another.  A rank runs on ``cuda:LOCAL_RANK`` unless
    `device` says otherwise."""
    if mesh is not None and device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = resolve_device(device)
    topts = topts or TrainOptions(total_steps=steps)
    plan, rank0 = None, True
    if mesh is not None:
        if not dist.is_initialized():
            raise RuntimeError("train(mesh=...) needs torch.distributed "
                               "initialised on every rank")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        plan = plan_cell(cfg, ShapeSpec("train", "train", seq_len,
                                        global_batch),
                         mesh, recipe, microbatch=topts.microbatch)
        rank0 = dist.get_rank() == 0
    step_fn = make_train_step(cfg, topts, plan)
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
        if plan is not None:        # keep this rank's blocks
            params = place_params(plan, params)
            opt = place_opt_state(plan, opt)
        for step in range(start, steps):
            t0 = time.perf_counter()
            batch = {k: to_device(v, device) for k, v in
                     data.batch_at(step).items()}
            if cfg.frontend:
                batch["frontend_emb"] = torch.zeros(
                    (global_batch, 8, cfg.d_model),
                    dtype=getattr(torch, cfg.dtype), device=device)
            if plan is not None:
                batch = local_batch(plan, batch)
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
            if mgr and (step + 1) % ckpt_every == 0:
                _save(mgr, step, params, opt, cfg, plan, step_fn, rank0)
            if inject_failure_at is not None and step == inject_failure_at:
                raise RuntimeError(f"injected failure @ {step}")
        # the last step's checkpoint, unless the loop just wrote it (or
        # resumed from it): saving a step twice would rename onto it
        if mgr and steps > start and steps % ckpt_every:
            _save(mgr, steps - 1, params, opt, cfg, plan, step_fn, rank0)
    finally:
        if mgr:
            mgr.wait()
    return params, opt, history


def _save(mgr, step, params, opt, cfg, plan, step_fn, rank0: bool):
    """Checkpoint `step`: over a mesh every rank gathers each leaf whole,
    one at a time, onto the host, and rank 0 writes the tree."""
    if plan is not None:
        plc = step_fn.placement

        def whole(t, spec):
            w = plc.gather_whole(t.detach(), spec)
            return w.to("cpu", copy=True) if rank0 else None

        params = tree_map(whole, params, plan.param_specs)
        opt = tree_map(whole, opt, plan.opt_specs)
    if rank0:
        mgr.save(step, _state(params, opt, cfg), extra={"step": step})


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
    ap.add_argument("--recipe", default="tp", choices=["tp", "fsdp", "ep"])
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
