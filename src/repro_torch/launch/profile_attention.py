"""Device time of the flash and decode kernels beside one PyTorch call.

    PYTHONPATH=src python -m repro_torch.launch.profile_attention

Needs one CUDA card.  Times each kernel and
`F.scaled_dot_product_attention` on the same bf16 inputs from
torch.profiler's CUDA (CUPTI) kernel records: the kernels' own
durations, with warm caches and no launch gaps, where `chip_smoke.py`
times whole calls with CUDA events after an L2 flush.  Shapes: the
decode kernel at llama3-8b's serving shape (batch 4, 129 of 168
tokens), on a 30,001-token cache (bf16, and int8 with per-token scales,
which no PyTorch call attends over) and at stablelm-3b's widths; the
flash forward at stablelm-3b's training and llama3-8b's prefill shapes
and at gemma3-4b's windowed prefill (D 256, window 1024; SDPA with the
same mask).  Prints the card's name and power limit, then one JSON
line.
"""
from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..models.attention import quantize_kv

# (B, H, KVH, D, S, valid_len, int8 cache)
DECODE = ((4, 32, 8, 128, 168, 129, False),
          (8, 32, 8, 128, 32_768, 30_001, False),
          (8, 32, 8, 128, 32_768, 30_001, True),
          (4, 32, 32, 80, 4096, 3001, False))
# (B, S, H, KVH, D, window)
FLASH = ((1, 4096, 32, 32, 80, None), (1, 4096, 32, 8, 128, None),
         (1, 4096, 8, 4, 256, 1024))


def device_us(fn, reps: int = 20) -> float:
    """Device time of one call of `fn` in µs: the CUDA kernels it
    launched, summed over `reps` calls, over `reps`."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_attention needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    rows = []
    for B, H, KVH, D, S, valid, int8 in DECODE:
        q = torch.randn(B, H, D, generator=g, device=dev).to(bf16)
        k, v = (torch.randn(B, KVH, S, D, generator=g, device=dev).to(bf16)
                for _ in range(2))
        q4, kv, vv = q[:, :, None], k[:, :, :valid], v[:, :, :valid]
        scales, library_us = {}, None
        if int8:
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            scales = dict(k_scale=ks, v_scale=vs)
        else:
            library_us = device_us(lambda: F.scaled_dot_product_attention(
                q4, kv, vv, enable_gqa=True))
        rows.append(dict(
            kernel="decode_attention_int8" if int8 else "decode_attention",
            B=B, H=H, KVH=KVH, D=D, valid_len=valid,
            kernel_us=device_us(lambda: ops.decode_attention_head_major(
                q, k, v, valid, **scales)),
            library_us=library_us))
    for B, S, H, KVH, D, window in FLASH:
        q = torch.randn(B, S, H, D, generator=g, device=dev).to(bf16)
        k, v = (torch.randn(B, S, KVH, D, generator=g, device=dev).to(bf16)
                for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pos = torch.arange(S, device=dev)
        keep = (pos[None, :] <= pos[:, None]) & (
            pos[:, None] - pos[None, :] < (window or S))
        rows.append(dict(
            kernel="flash_attention", B=B, S=S, H=H, KVH=KVH, D=D,
            window=window,
            kernel_us=device_us(lambda: ops.flash_attention_fwd(
                q, k, v, window=window)),
            library_us=device_us(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=window is None,
                attn_mask=None if window is None else keep,
                enable_gqa=True))))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps({"profile": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
