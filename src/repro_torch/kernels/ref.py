"""Plain PyTorch oracles of the ported kernels (counterparts of
`repro/kernels/ref.py:15,37,52,66`), and the int8 KV quantizer that
the reference computes in its attention block.

Deliberately naive — the semantics contract, not the fast path.  The
decode oracle is also the CPU path of `ops.decode_attention` and the
plain version that `chip_smoke.py` holds the CUDA kernel against; the
flash oracle materialises the whole score matrix; the SSD oracle scans
the chunks with the whole (Q, Q, nh) decay tensor of a chunk.
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


def decode_attention_ref(q, k_cache, v_cache, valid_len, k_scale=None,
                         v_scale=None, return_lse: bool = False):
    """q: (B, H, D); caches: (B, S, KVH, D); valid_len: scalar int.
    -> (B, H, D).  GQA: query head h reads KV head h // (H // KVH).
    An int8 cache comes with float32 per-(token, head) `k_scale` and
    `v_scale` (B, KVH, S), folded in as the reference's einsum does
    (`repro/models/attention.py:146-166`): the scores times k_scale after
    the dot, the probabilities times v_scale before the V product, all in
    float32 from the int8 payload.  With `return_lse` also each row's
    float32 log-sum-exp (B, H) of the masked scaled scores; valid_len 0
    (an empty shard of a sequence-sharded cache) gives output 0 and lse
    -inf."""
    B, H, D = q.shape
    _, S, KVH, _ = k_cache.shape
    qg = q.reshape(B, KVH, H // KVH, D).to(F32)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.to(F32)) * (D ** -0.5)
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    mask = torch.arange(S, device=q.device) < valid_len
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    if v_scale is not None:
        w = w * v_scale[:, :, None, :]
    o = torch.einsum("bhgs,bshd->bhgd", w, v_cache.to(F32))
    o = o.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return o
    if valid_len == 0:
        return torch.zeros_like(o), torch.full((B, H), -torch.inf,
                                               dtype=F32, device=q.device)
    return o, torch.logsumexp(s, dim=-1).reshape(B, H)


def quantize_kv(x):
    """Per-(token, head) int8 quantization of a new token's k or v, in the
    reference's order of operations (`repro/models/attention.py:123-130`):
    the scale is max(|x|.max(-1), 1e-8) in x's dtype, then float32 / 127;
    the payload round(x.float() / scale), half to even, clipped to +-127.
    x: (..., hd) -> (int8 payload (..., hd), float32 scale (...)).  The
    plain version of the int8 decode kernel's append.  The 127 is a
    tensor: PyTorch's CUDA division by a Python number multiplies by its
    rounded reciprocal, one bit off the reference's division."""
    floor = torch.full((), 1e-8, dtype=x.dtype, device=x.device)
    d127 = torch.full((), 127.0, dtype=F32, device=x.device)
    scale = torch.maximum(x.abs().amax(dim=-1), floor).to(F32) / d127
    q = torch.round(x.to(F32) / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def ralt_update_ref(ticks, scores, hits, now, alpha):
    """The paper's exponential-smoothing score update (RALT §3.2):
    score' = alpha^(now - tick) * score + hit; tick' = now."""
    dt = (torch.as_tensor(now, device=ticks.device) - ticks).to(F32)
    decay = torch.pow(torch.tensor(alpha, dtype=F32, device=ticks.device),
                      dt)
    new_scores = scores.to(F32) * decay + hits.to(F32)
    new_ticks = torch.empty_like(ticks).fill_(now)
    return new_ticks, new_scores


def ssd_chunk_ref(x, Bm, Cm, dt, A, h0):
    """Mamba2 SSD over chunks (oracle for the ssd_scan kernel).

    x: (B, nC, Q, nh, hp); Bm/Cm: (B, nC, Q, ns); dt: (B, nC, Q, nh);
    A: (nh,) negative decay rates; h0: (B, nh, ns, hp).
    Returns (y: (B, nC, Q, nh, hp) float32, h_final float32).
    """
    Q = x.shape[2]
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    A = A.to(F32)
    h = h0.to(F32)
    ys = []
    for c in range(x.shape[1]):
        xq, Bq, Cq, dtq = (t[:, c].to(F32) for t in (x, Bm, Cm, dt))
        La = torch.cumsum(dtq * A, dim=1)                    # (B, Q, nh)
        seg = La[:, :, None, :] - La[:, None, :, :]          # (B, Q, Q, nh)
        M = torch.where(causal[None, :, :, None], torch.exp(seg), 0.0)
        CB = torch.einsum("bqn,bsn->bqs", Cq, Bq)
        W = CB[..., None] * M * dtq[:, None, :, :]
        y_intra = torch.einsum("bqsh,bshp->bqhp", W, xq)
        y_inter = torch.einsum("bqn,bqh,bhnp->bqhp", Cq, torch.exp(La), h)
        w = torch.exp(La[:, -1:, :] - La) * dtq              # (B, Q, nh)
        h = (h * torch.exp(La[:, -1, :])[:, :, None, None]
             + torch.einsum("bqn,bqh,bqhp->bhnp", Bq, w, xq))
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1), h
