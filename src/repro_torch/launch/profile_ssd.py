"""Device time of the bf16 SSD scan's passes, and of one mamba2-1.3b
train step by group.

    PYTHONPATH=src python -m repro_torch.launch.profile_ssd

Needs one CUDA card.  From torch.profiler's CUDA (CUPTI) kernel records:

  * each pass of `ssd_scan_fwd` at mamba2-1.3b's prefill shape (bf16,
    B 1, 16 chunks of 256, 64 heads of 64, state 128), warm caches and
    no launch gaps;
  * one full-width mamba2-1.3b train step (48 layers, bf16 weights from
    seed 0, f32 AdamW moments; 2 x 4096 tokens in 2 microbatches, after
    one warm-up step), its device kernels grouped as: the ssd forward
    passes (forward and remat recompute), the plain chunk-scan backward
    (every kernel under autograd's `_SSDBackward` node), the weight
    products (the other GEMM kernels) and the rest; and the top kernels
    by device time.

Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import json
import re
import subprocess
from collections import defaultdict

import torch
import torch.nn.functional as F

from ..kernels import ops

SHAPE = (1, 16, 256, 64, 64, 128)          # B, nC, Q, nh, hp, ns
PASSES = {"ssd_cb_kernel": "1 C B^T", "ssd_state_kernel": "2 chunk states",
          "ssd_pass_kernel": "3 state passing",
          "ssd_out_kernel": "4 chunk outputs"}
GEMM = re.compile(r"gemm|nvjet|xmma|cutlass", re.IGNORECASE)
SEQ, BATCH, MICRO = 4096, 2, 2


def device_kernels(prof) -> list[tuple[str, float]]:
    """(name, device µs) of every CUDA kernel the profiler recorded."""
    from torch.autograd import DeviceType
    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def pass_times(dev, reps: int = 20) -> dict:
    """Device µs of each pass, per op call."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=dev).manual_seed(0)
    B, nC, Q, nh, hp, ns = SHAPE

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x, Bm, Cm = ((normal(*s) * 0.5).bfloat16() for s in (
        (B, nC, Q, nh, hp), (B, nC, Q, ns), (B, nC, Q, ns)))
    dt = F.softplus(normal(B, nC, Q, nh))
    A = -torch.exp(normal(nh) * 0.2)
    ops.ssd_scan_fwd(x, Bm, Cm, dt, A)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ops.ssd_scan_fwd(x, Bm, Cm, dt, A)
        torch.cuda.synchronize()
    out = defaultdict(float)
    for name, us in device_kernels(prof):
        key = next((v for k, v in PASSES.items() if k in name), None)
        if key is None:
            raise RuntimeError(f"unexpected kernel in the ssd call: {name}")
        out[key] += us / reps
    return dict(shape=dict(zip(("B", "nC", "Q", "nh", "hp", "ns"), SHAPE)),
                pass_us=dict(sorted(out.items())),
                total_us=sum(out.values()))


def train_step_groups(dev, top: int = 15) -> dict:
    """Device µs of one train step by group, and its top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..configs import get_config
    from ..data.lm_pipeline import DataConfig, LMPipeline
    from ..models import transformer
    from ..optim import adamw_init
    from . import steps

    cfg = get_config("mamba2-1.3b")
    topts = steps.TrainOptions(microbatch=MICRO)
    g = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(cfg, g, dev)
    opt = adamw_init(params, topts.opt)
    data = LMPipeline(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                 global_batch=BATCH, seed=0))
    step_fn = steps.make_train_step(cfg, topts)

    def batch_at(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_at(step).items()}

    params, opt, _ = step_fn(params, opt, 0, batch_at(0))
    torch.cuda.synchronize()
    batch = batch_at(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt, _ = step_fn(params, opt, 1, batch)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    total = sum(us for _, us in kernels)

    def under_ssd_backward(e) -> bool:
        while e is not None:
            if "_SSDBackward" in e.name:
                return True
            e = e.cpu_parent
        return False

    backward = [(k.name, k.duration) for e in prof.events()
                if e.device_type == DeviceType.CPU and e.kernels
                and under_ssd_backward(e) for k in e.kernels]
    fwd = sum(us for n, us in kernels if any(k in n for k in PASSES))
    bwd = sum(us for _, us in backward)
    gemm = (sum(us for n, us in kernels if GEMM.search(n))
            - sum(us for n, us in backward if GEMM.search(n)))
    by_name = defaultdict(float)
    for n, us in kernels:
        by_name[n] += us
    return dict(
        model=cfg.name, seq=SEQ, global_batch=BATCH, microbatch=MICRO,
        device_us=total,
        groups_us={"ssd forward passes": fwd,
                   "plain chunk-scan backward": bwd,
                   "weight products": gemm,
                   "rest": total - fwd - bwd - gemm},
        ssd_backward_kernels=len(backward),
        top=[dict(kernel=n[:120], us=us) for n, us in
             sorted(by_name.items(), key=lambda kv: -kv[1])[:top]])


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_ssd needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = dict(passes=pass_times(dev), train_step=train_step_groups(dev))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps({"profile_ssd": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
