"""GQA attention block: single-token decode (port of
`repro/models/attention.py:17-41,94-178`).

The decode cache is head-major (B, KV, S_max, hd), the layout of the
reference's `init_cache`; the attention core is the hand-written decode
kernel (`kernels.ops.decode_attention_head_major`), which reads that
layout in place.  The sliding window and the int8 cache are later
slices and raise here.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .common import F32, rms_norm, rope, swiglu


# the parameters of one attention(+MLP) block
WEIGHTS = ("norm1", "wq", "wk", "wv", "wo", "norm2", "w_gate", "w_up",
           "w_down")


def init_attn_block(cfg, d_ff: int, generator: torch.Generator, device):
    """Params of one attention(+MLP) block, drawn on `device` from
    `generator` (normal, scaled by fan_in ** -0.5, then cast)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)

    def mk(*shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=F32, device=device)
        return (w * fan_in ** -0.5).to(dt)

    return {
        "norm1": torch.zeros(d, dtype=dt, device=device),
        "wq": mk(d, H, hd, fan_in=d),
        "wk": mk(d, KV, hd, fan_in=d),
        "wv": mk(d, KV, hd, fan_in=d),
        "wo": mk(H, hd, d, fan_in=H * hd),
        "norm2": torch.zeros(d, dtype=dt, device=device),
        "w_gate": mk(d, d_ff, fan_in=d),
        "w_up": mk(d, d_ff, fan_in=d),
        "w_down": mk(d_ff, d, fan_in=d_ff),
    }


def attn_decode(p, x, cache_k, cache_v, pos: int, cfg,
                window: int | None = None):
    """Single-token decode.  x: (B, d); caches head-major (B, KV, S_max,
    hd), updated in place at `pos`; attention covers positions
    [0, pos].  Returns the block output (B, d)."""
    if window is not None:
        raise NotImplementedError("sliding-window decode is not ported yet")
    if cache_k.dtype == torch.int8:
        raise NotImplementedError("int8 KV decode is not ported yet")
    B, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["norm1"])
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = (h @ p["wq"].reshape(d, H * hd)).view(B, 1, H, hd)
    k = (h @ p["wk"].reshape(d, KV * hd)).view(B, 1, KV, hd)
    v = (h @ p["wv"].reshape(d, KV * hd)).view(B, KV, hd)
    q = rope(q, positions, cfg.rope_theta)[:, 0]
    k_new = rope(k, positions, cfg.rope_theta)[:, 0]
    # in-place write of the new token (replaces the reference's
    # dynamic_update_slice, which returns a new cache)
    cache_k[:, :, pos] = k_new.to(cache_k.dtype)
    cache_v[:, :, pos] = v.to(cache_v.dtype)
    o = ops.decode_attention_head_major(q, cache_k, cache_v, pos + 1)
    x = x + o.reshape(B, H * hd) @ p["wo"].reshape(H * hd, d)
    h = rms_norm(x, p["norm2"])
    return x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
