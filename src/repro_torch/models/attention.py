"""GQA attention block: train/prefill forward and single-token decode
(port of `repro/models/attention.py`).

The forward's attention core is `common.flash_attention`, whose forward
is the hand-written flash kernel.  The decode cache is head-major
(B, KV, S_max, hd), the layout of the reference's `init_cache`; the
decode core is the hand-written decode kernel
(`kernels.ops.decode_attention_head_major`), which reads that layout in
place, and an int8 cache (`cfg.kv_quant`) with its per-(token, head)
float32 scales: with a bf16 model one call
(`kernels.ops.decode_attention_int8_append`) quantizes the new token
(`quantize_kv`, kept in `kernels/ref.py`), writes it and attends.  A
windowed layer's decode cache is a ring buffer of its window
(`models/transformer.py:decode_step` passes the write slot and the valid
length), so decode needs no window mask.  Both take an
`mlp_fn` in place of the block's SwiGLU (the `moe` block's expert MLP,
`models/moe.py`).
"""
from __future__ import annotations

import torch

from ..distributed.sharding import FSDP, TP
from ..kernels import ops
from ..kernels.ref import quantize_kv
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


def attn_specs() -> dict:
    """Logical dims of each leaf of `init_attn_block`'s tree, one layer
    (the reference's `attn_specs(stacked=False)`)."""
    return {
        "norm1": (None,),
        "wq": (FSDP, TP, None),
        "wk": (FSDP, TP, None),      # falls back to None if KV % tp != 0
        "wv": (FSDP, TP, None),
        "wo": (TP, None, FSDP),
        "norm2": (None,),
        "w_gate": (FSDP, TP),
        "w_up": (FSDP, TP),
        "w_down": (TP, FSDP),
    }


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


def attn_decode(p, x, cache_k, cache_v, pos: int, cfg, mlp_fn=None, *,
                slot: int, valid_len: int, k_scale=None, v_scale=None):
    """Single-token decode.  x: (B, d); caches head-major (B, KV, S, hd),
    updated in place at `slot` (`pos`, or a windowed layer's ring slot);
    attention covers the cache's first `valid_len` entries.  `pos` is the
    token's position (RoPE).  An int8 cache takes float32 `k_scale` /
    `v_scale` (B, KV, S), written at `slot` with the payload.  Returns
    the block output (B, d)."""
    B, d = x.shape
    h = rms_norm(x, p["norm1"])
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = (t[:, 0] for t in _qkv(p, h[:, None], positions, cfg))
    if cache_k.dtype == torch.int8 and q.dtype == torch.bfloat16:
        # quantize, write at `slot` and attend: one launch on the card
        o = ops.decode_attention_int8_append(q, k, v, cache_k, cache_v,
                                             k_scale, v_scale, slot,
                                             valid_len)
    else:
        if cache_k.dtype == torch.int8:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            k_scale[:, :, slot] = ks
            v_scale[:, :, slot] = vs
        # in-place write of the new token (replaces the reference's
        # dynamic_update_slice, which returns a new cache)
        cache_k[:, :, slot] = k.to(cache_k.dtype)
        cache_v[:, :, slot] = v.to(cache_v.dtype)
        o = ops.decode_attention_head_major(q, cache_k, cache_v, valid_len,
                                            k_scale=k_scale, v_scale=v_scale)
    x = x + o.reshape(B, -1) @ p["wo"].reshape(-1, d)
    h = rms_norm(x, p["norm2"])
    return x + _mlp(p, h, mlp_fn)
