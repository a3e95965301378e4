"""GQA attention block: train/prefill forward and single-token decode
(port of `repro/models/attention.py`).

The forward's attention core is `common.flash_attention`, whose forward
is the hand-written flash kernel.  The decode cache is head-major
(B, KV, S_max, hd), the layout of the reference's `init_cache`; the
decode core is the hand-written decode kernel
(`kernels.ops.decode_attention_head_major`), which reads that layout in
place.  Sliding-window and int8 decode are later slices and raise here.
Both take an `mlp_fn` in place of the block's SwiGLU (the `moe` block's
expert MLP, `models/moe.py`).
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .common import F32, flash_attention, rms_norm, rope, swiglu


# the parameters of one attention(+MLP) block; ATTN_WEIGHTS without the
# SwiGLU's, which a `moe` block replaces with its nested "moe" dict
ATTN_WEIGHTS = ("norm1", "wq", "wk", "wv", "wo", "norm2")
WEIGHTS = ATTN_WEIGHTS + ("w_gate", "w_up", "w_down")


def init_attn_block(cfg, d_ff: int | None, generator: torch.Generator,
                    device):
    """Params of one attention(+MLP) block, drawn on `device` from
    `generator` (normal, scaled by fan_in ** -0.5, then cast); with
    `d_ff` None, the attention half only."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)

    def mk(*shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=F32, device=device)
        return (w * fan_in ** -0.5).to(dt)

    p = {
        "norm1": torch.zeros(d, dtype=dt, device=device),
        "wq": mk(d, H, hd, fan_in=d),
        "wk": mk(d, KV, hd, fan_in=d),
        "wv": mk(d, KV, hd, fan_in=d),
        "wo": mk(H, hd, d, fan_in=H * hd),
        "norm2": torch.zeros(d, dtype=dt, device=device),
    }
    if d_ff is not None:
        p.update(w_gate=mk(d, d_ff, fan_in=d), w_up=mk(d, d_ff, fan_in=d),
                 w_down=mk(d_ff, d, fan_in=d_ff))
    return p


def _mlp(p, h, mlp_fn):
    if mlp_fn is not None:
        return mlp_fn(h)
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def _qkv(p, x, positions, cfg):
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].reshape(d, H * hd)).view(B, S, H, hd)
    k = (x @ p["wk"].reshape(d, KV * hd)).view(B, S, KV, hd)
    v = (x @ p["wv"].reshape(d, KV * hd)).view(B, S, KV, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attn_block(p, x, cfg, window: int | None = None, positions=None,
               mlp_fn=None):
    """Training/prefill forward.  x: (B, S, d).  Returns (y, (k, v)) with
    k/v (B, S, KV, hd) after RoPE."""
    B, S, d = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    h = rms_norm(x, p["norm1"])
    q, k, v = _qkv(p, h, positions, cfg)
    c = min(cfg.flash_chunk, S)
    o = flash_attention(q, k, v, causal=True, window=window, q_chunk=c,
                        kv_chunk=c)
    x = x + o.reshape(B, S, -1) @ p["wo"].reshape(-1, d)
    h = rms_norm(x, p["norm2"])
    return x + _mlp(p, h, mlp_fn), (k, v)


def attn_decode(p, x, cache_k, cache_v, pos: int, cfg,
                window: int | None = None, mlp_fn=None):
    """Single-token decode.  x: (B, d); caches head-major (B, KV, S_max,
    hd), updated in place at `pos`; attention covers positions
    [0, pos].  Returns the block output (B, d)."""
    if window is not None:
        raise NotImplementedError("sliding-window decode is not ported yet")
    if cache_k.dtype == torch.int8:
        raise NotImplementedError("int8 KV decode is not ported yet")
    B, d = x.shape
    h = rms_norm(x, p["norm1"])
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = (t[:, 0] for t in _qkv(p, h[:, None], positions, cfg))
    # in-place write of the new token (replaces the reference's
    # dynamic_update_slice, which returns a new cache)
    cache_k[:, :, pos] = k.to(cache_k.dtype)
    cache_v[:, :, pos] = v.to(cache_v.dtype)
    o = ops.decode_attention_head_major(q, cache_k, cache_v, pos + 1)
    x = x + o.reshape(B, -1) @ p["wo"].reshape(-1, d)
    h = rms_norm(x, p["norm2"])
    return x + _mlp(p, h, mlp_fn)
