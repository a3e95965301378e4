"""Training launcher of the port: the training loop end to end, with
fault tolerance (counterpart of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --seq-len 4096 --global-batch 2 --microbatch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --device cpu --steps 20 --ckpt-dir /tmp/ckpt [--resume]

Runs on ``cuda`` unless given ``--device cpu``, and raises without CUDA.
  * step-atomic rolling checkpoints in the reference's format and layout
    (host snapshot on the training thread, background write),
    resume-from-latest;
  * the deterministic data pipeline replays the exact stream after a
    restart, so a resumed run repeats the uninterrupted one;
  * straggler monitoring: steps slower than `deadline_factor` x the EMA
    are logged and counted;
  * failure injection for tests (`inject_failure_at`): raises after the
    step (and any checkpoint write) completes, like a preempted worker.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import PORTED, get_config, smoke_config
from ..convert import (opt_state_from_reference, opt_state_to_reference,
                       params_from_reference, params_to_reference)
from ..data.lm_pipeline import DataConfig, LMPipeline
from ..device import resolve_device, to_device
from ..models.transformer import init_params
from ..optim import adamw_init
from .steps import TrainOptions, make_train_step


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
          topts: TrainOptions | None = None, ckpt_dir: str | None = None,
          ckpt_every: int = 50, resume: bool = False,
          inject_failure_at: int | None = None, seed: int = 0,
          log_every: int = 10, async_ckpt: bool = True,
          deadline_factor: float = 3.0, device=None):
    """Returns (params, opt_state, history dict)."""
    device = resolve_device(device)
    topts = topts or TrainOptions(total_steps=steps)
    step_fn = make_train_step(cfg, topts)
    data = LMPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                 global_batch=global_batch, seed=seed))
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = init_params(cfg, g, device)
    opt = adamw_init(params, topts.opt)
    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3, async_write=async_ckpt)
        if resume and mgr.latest() is not None:
            restored, extra = mgr.restore(_state(params, opt, cfg))
            params = params_from_reference(restored["params"], cfg, device)
            opt = opt_state_from_reference(restored["opt"], cfg, device,
                                           topts.opt.moment_dtype)
            start = extra["step"] + 1
            print(f"[train] resumed from step {start - 1}", flush=True)
    monitor = StragglerMonitor(deadline_factor)
    history = {"loss": [], "step_s": [], "straggler_steps": []}
    try:
        for step in range(start, steps):
            t0 = time.perf_counter()
            batch = {k: to_device(v, device)
                     for k, v in data.batch_at(step).items()}
            if cfg.frontend:
                batch["frontend_emb"] = torch.zeros(
                    (global_batch, 8, cfg.d_model),
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
            if step % log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} gnorm "
                      f"{float(metrics['grad_norm']):.3f} ({dt:.2f}s)",
                      flush=True)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged @ {step}")
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save(step, _state(params, opt, cfg),
                         extra={"step": step})
            if inject_failure_at is not None and step == inject_failure_at:
                raise RuntimeError(f"injected failure @ {step}")
        if mgr:
            mgr.save(steps - 1, _state(params, opt, cfg),
                     extra={"step": steps - 1})
    finally:
        if mgr:
            mgr.wait()
    return params, opt, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b", choices=PORTED)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    topts = TrainOptions(total_steps=args.steps, microbatch=args.microbatch)
    _, _, hist = train(cfg, steps=args.steps,
                       global_batch=args.global_batch, seq_len=args.seq_len,
                       topts=topts, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, resume=args.resume,
                       device=device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    if hist["loss"]:
        print(f"[train] done on {where}: loss {hist['loss'][0]:.4f} -> "
              f"{hist['loss'][-1]:.4f} over {len(hist['loss'])} steps",
              flush=True)
    return hist


if __name__ == "__main__":
    main()
