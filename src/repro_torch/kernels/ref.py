"""Plain PyTorch oracles of the ported kernels (counterparts of
`repro/kernels/ref.py:15,37,52`).

Deliberately naive — the semantics contract, not the fast path.  The
decode oracle is also the CPU path of `ops.decode_attention` and the
plain version that `chip_smoke.py` holds the CUDA kernel against; the
flash oracle materialises the whole score matrix.  The SSD oracle comes
with its kernel.
"""
from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B, Sq, H, D); k/v: (B, Skv, KVH, D) -> (B, Sq, H, D).
    GQA: query head h reads KV head h // (H // KVH)."""
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    qg = q.reshape(B, Sq, KVH, H // KVH, D).to(F32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(F32)) * (D ** -0.5)
    pq = torch.arange(Sq, device=q.device)[:, None]
    pk = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pk <= pq
    if window is not None:
        mask &= (pq - pk) < window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(F32))
    return o.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, valid_len):
    """q: (B, H, D); caches: (B, S, KVH, D); valid_len: scalar int.
    -> (B, H, D).  GQA: query head h reads KV head h // (H // KVH)."""
    B, H, D = q.shape
    _, S, KVH, _ = k_cache.shape
    qg = q.reshape(B, KVH, H // KVH, D).to(F32)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.to(F32)) * (D ** -0.5)
    mask = torch.arange(S, device=q.device) < valid_len
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, v_cache.to(F32))
    return o.reshape(B, H, D).to(q.dtype)


def ralt_update_ref(ticks, scores, hits, now, alpha):
    """The paper's exponential-smoothing score update (RALT §3.2):
    score' = alpha^(now - tick) * score + hit; tick' = now."""
    dt = (torch.as_tensor(now, device=ticks.device) - ticks).to(F32)
    decay = torch.pow(torch.tensor(alpha, dtype=F32, device=ticks.device),
                      dt)
    new_scores = scores.to(F32) * decay + hits.to(F32)
    new_ticks = torch.empty_like(ticks).fill_(now)
    return new_ticks, new_scores
