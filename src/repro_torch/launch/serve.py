"""Serving launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b

Runs the batched engine with random weights drawn from `--seed`: the
full config on ``cuda`` by default, the reduced smoke config with
``--smoke``.  Prints requests, tokens, wall time and tokens/s with the
device they ran on.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import PORTED, get_config, smoke_config
from ..device import resolve_device
from ..serving.engine import Request, ServeEngine


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
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
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
