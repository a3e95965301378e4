"""Shared model primitives (port of `repro/models/common.py`): RMSNorm,
RoPE, SwiGLU, blocked flash attention with its tile-recomputing backward,
the decode-attention partials with their log-sum-exp merge, and the
(chunked) cross-entropy losses.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..kernels.flash_attention import tile_mask, tile_visible

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


# ----------------------------------------------------------------------
# blocked ("flash") attention: the forward is the hand-written kernel
# (`ops.flash_attention_fwd`; its plain scan on the CPU), the backward the
# port of the reference's tile-recomputing VJP
# ----------------------------------------------------------------------
def _flash_bwd(q, k, v, out, lse, dout, opts):
    """Port of `repro/models/common.py:_flash_bwd` on the grouped layout:
    K/V stay (B, KVH, Skv, D) and dK/dV sum over each group of G query
    heads, which is what the VJP of the reference's `jnp.repeat` does.
    Tiles wholly outside the masks are skipped (their probabilities are
    0).  -> (dq, dk, dv) in the inputs' dtypes."""
    causal, window, q_offset, q_chunk, kv_chunk, kv_len = opts
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = D ** -0.5
    dev = q.device

    def grouped(x):                       # (B, S, H, D) -> (B, KVH, G, S, D)
        return x.permute(0, 2, 1, 3).reshape(B, KVH, G, -1, D).to(F32)

    qg, dog = grouped(q), grouped(dout)
    kh, vh = (x.permute(0, 2, 1, 3).to(F32) for x in (k, v))
    drow = (dog * grouped(out)).sum(dim=-1)            # (B, KVH, G, Sq)
    lse = lse.reshape(B, KVH, G, Sq)
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    for q0 in range(0, Sq, q_chunk):
        qs = slice(q0, q0 + q_chunk)
        qc, doc = qg[:, :, :, qs], dog[:, :, :, qs]
        lc, dc = lse[..., qs], drow[..., qs]
        nq = qc.shape[3]
        pq = q_offset + q0 + torch.arange(nq, device=dev)
        for k0 in range(0, Skv, kv_chunk):
            nk = min(kv_chunk, Skv - k0)
            if not tile_visible(q_offset + q0, q_offset + q0 + nq - 1, k0,
                                k0 + nk - 1, causal, window, kv_len):
                continue
            ks = slice(k0, k0 + nk)
            kc, vc = kh[:, :, ks], vh[:, :, ks]
            pk = k0 + torch.arange(nk, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
            mask = tile_mask(pq, pk, causal, window, kv_len)
            p = torch.where(mask, torch.exp(s - lc[..., None]), 0.0)
            dv[:, :, ks] += torch.einsum("bhgqk,bhgqd->bhkd", p, doc)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", doc, vc)
            ds = p * (dp - dc[..., None]) * scale
            dq[:, :, :, qs] += torch.einsum("bhgqk,bhkd->bhgqd", ds, kc)
            dk[:, :, ks] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qc)
    dq = dq.reshape(B, H, Sq, D).permute(0, 2, 1, 3)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _Flash(torch.autograd.Function):
    """Forward: the kernel, keeping (q, k, v, out, lse) — O(S) residuals.
    Backward: `_flash_bwd`, which recomputes each tile from `lse`."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        causal, window, q_offset, q_chunk, kv_chunk, kv_len = opts
        out, lse = ops.flash_attention_fwd(
            q, k, v, causal=causal, window=window, kv_len=kv_len,
            q_offset=q_offset, q_chunk=q_chunk, kv_chunk=kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, out, lse, dout, ctx.opts), None)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    kv_len: int | None = None):
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) -> (B, Sq, H, D).

    The reference's signature.  GQA reads KV head h // G in place (the
    reference expands KV with `jnp.repeat`).  `q_offset` is the absolute
    position of q[0]; the chunk sizes tile the backward (and the forward's
    plain CPU version), and any Sq and Skv are allowed."""
    kv_len = k.shape[1] if kv_len is None else kv_len
    opts = (causal, window, q_offset, q_chunk, kv_chunk, kv_len)
    return _Flash.apply(q, k, v, opts)


# ----------------------------------------------------------------------
# cross-entropy
# ----------------------------------------------------------------------
def _token_losses(logits, labels, z_loss):
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """logits: (..., V) in any dtype; labels: (...) int."""
    return _token_losses(logits, labels, z_loss).mean()


def _ce_sum(x, head, labels, z_loss):
    return _token_losses(x @ head, labels, z_loss).sum()


def chunked_cross_entropy(x, head, labels, *, chunk: int = 1024,
                          z_loss: float = 1e-4, denom: int | None = None):
    """CE without materialising (B, S, V) logits.

    x: (B, S, d) final hidden; head: (d, V); labels: (B, S) int.  Walks S
    in chunks; under autograd each chunk is checkpointed, so its logits
    are transient and recomputed in the backward.  Returns the mean loss
    over B*S tokens (over the padded vocab, as the reference), or the
    sum over them divided by `denom`."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S                      # odd sizes: single chunk
    total = torch.zeros((), dtype=F32, device=x.device)
    for s0 in range(0, S, chunk):
        args = (x[:, s0:s0 + chunk], head, labels[:, s0:s0 + chunk], z_loss)
        if torch.is_grad_enabled():
            total = total + checkpoint(_ce_sum, *args, use_reentrant=False)
        else:
            total = total + _ce_sum(*args)
    return total / (B * S if denom is None else denom)
