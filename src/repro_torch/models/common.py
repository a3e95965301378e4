"""Shared model primitives of the decode path (port of
`repro/models/common.py:16-40,256-290`): RMSNorm, RoPE, SwiGLU and the
decode-attention partials with their log-sum-exp merge.  Blocked flash
attention and the cross-entropy losses come with the prefill/training
slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e30


def rms_norm(x, scale, eps: float = 1e-6):
    var = x.to(F32).square().mean(dim=-1, keepdim=True)
    out = x.to(F32) * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(F32))).to(x.dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    half = d // 2
    log_theta = torch.log(torch.full((), theta, dtype=F32, device=x.device))
    freqs = torch.exp(-log_theta * torch.arange(0, half, dtype=F32,
                                                device=x.device) / half)
    ang = positions[..., :, None].to(F32) * freqs           # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]                   # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return h @ w_down


def decode_attention_partial(q, k_cache, v_cache, valid_len,
                             pos_offset: int = 0, window: int | None = None):
    """One-token attention partials over a (possibly sharded) cache slice.

    q: (B, H, D); caches: (B, S_slice, KVH, D); valid_len: scalar count of
    globally-valid tokens; pos_offset: absolute position of slice[0].
    Returns (o, l, m) — combinable across slices with `merge_partials`.
    """
    B, H, D = q.shape
    _, S, KVH, _ = k_cache.shape
    qg = q.reshape(B, KVH, H // KVH, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.to(F32),
                     k_cache.to(F32)) * (D ** -0.5)
    pk = pos_offset + torch.arange(S, device=q.device)
    mask = pk < valid_len
    if window is not None:
        mask &= pk >= (valid_len - window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)                                 # (B, KVH, G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).to(F32),
                     v_cache.to(F32))
    return o, l, m


def merge_partials(parts):
    """Merge [(o, l, m), ...] partial attentions (log-sum-exp algebra)."""
    os, ls, ms = zip(*parts)
    m = torch.stack(ms).amax(dim=0)
    corr = [torch.exp(mi - m) for mi in ms]
    l = sum(li * ci for li, ci in zip(ls, corr))
    o = sum(oi * ci[..., None] for oi, ci in zip(os, corr))
    return o / torch.clamp(l, min=1e-30)[..., None]
