"""Causal / sliding-window GQA flash-attention forward: CUDA kernel for
Hopper and its plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py:_flash_kernel`
(`pl.pallas_call` at line 111).  q (B, Sq, H, D) attends to k/v
(B, Skv, KVH, D) with scale D**-0.5; query head h reads KV head h // G in
place (G = H / KVH).  Besides the output, both versions return the
float32 row log-sum-exp ``lse`` (B, H, Sq), the residual the backward in
`models/common.py` recomputes tiles from.

  * `csrc/flash_attention.cu`: one block per (64-row q tile, head,
    batch), looping over 64-key tiles between the window's and the
    causal/kv_len limits, online softmax in float32 (see the source's
    header for the design and what bounds it);
  * `flash_attention_plain`: the port of the reference's chunked scan
    `repro/models/common.py:_flash_fwd_scan`, on the unexpanded KV, with
    tiles wholly outside the masks skipped.  A CPU tensor runs it; a CUDA
    tensor launches the kernel or raises.

Unlike the Pallas kernel both take any Sq and Skv (ragged tails are
masked).  Masked keys get probability exactly 0, so a row with no
visible key returns 0, as the Pallas kernel's `_finish` does for a row
whose tiles were all skipped; in the reference's scan such a row would
average V.  Rows with a visible key agree with the reference exactly in
exact arithmetic.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

F32 = torch.float32
NEG_INF = -1e30
_DTYPES = {F32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # csrc instantiations
_BQ = _BK = 64                           # csrc BQ, BK
SMEM_OPTIN = 232_448                     # a block's shared-memory limit


def smem_bytes(D: int) -> int:
    """Dynamic shared memory of one block (csrc `smem_bytes`)."""
    return 4 * (D * (_BQ + 1) + D * (_BK + 1) + _BK * D + _BQ * (_BK + 1))


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [P, P, P, P, P] + [I] * 11 + [
            ctypes.c_float, P]
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def tile_visible(q_lo, q_hi, k_lo, k_hi, causal, window, kv_len) -> bool:
    """Whether any (query, key) pair of absolute query positions
    [q_lo, q_hi] and keys [k_lo, k_hi] passes the masks."""
    if k_lo >= kv_len or (causal and k_lo > q_hi):
        return False
    return window is None or q_lo - k_hi < window


def tile_mask(pq, pk, causal, window, kv_len):
    """`repro/models/common.py:_tile_mask`: (q, k) pairs that count."""
    mask = (pk < kv_len)[None, :]
    if causal:
        mask = mask & (pk[None, :] <= pq[:, None])
    if window is not None:
        mask = mask & ((pq[:, None] - pk[None, :]) < window)
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=None, kv_len=None,
                          q_offset=0, q_chunk=1024, kv_chunk=1024):
    """The reference's chunked online-softmax scan on the grouped layout.
    -> (out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) float32)."""
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    kv_len = Skv if kv_len is None else kv_len
    scale = D ** -0.5
    dev = q.device
    qg = q.permute(0, 2, 1, 3).reshape(B, KVH, G, Sq, D)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)  # (B, KVH, S, D)
    out = torch.zeros(B, KVH, G, Sq, D, dtype=F32, device=dev)
    lse = torch.empty(B, KVH, G, Sq, dtype=F32, device=dev)
    for q0 in range(0, Sq, q_chunk):
        qc = qg[:, :, :, q0:q0 + q_chunk].to(F32)
        nq = qc.shape[3]
        pq = q_offset + q0 + torch.arange(nq, device=dev)
        m = torch.full((B, KVH, G, nq), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, KVH, G, nq, D, dtype=F32, device=dev)
        for k0 in range(0, Skv, kv_chunk):
            nk = min(kv_chunk, Skv - k0)
            if not tile_visible(q_offset + q0, q_offset + q0 + nq - 1, k0,
                                k0 + nk - 1, causal, window, kv_len):
                continue
            kc = kh[:, :, k0:k0 + nk].to(F32)
            vc = vh[:, :, k0:k0 + nk]
            pk = k0 + torch.arange(nk, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
            mask = tile_mask(pq, pk, causal, window, kv_len)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bhkd->bhgqd",
                              p.to(v.dtype).to(F32), vc.to(F32))
            acc = acc * corr[..., None] + pv
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        out[:, :, :, q0:q0 + nq] = acc / l_safe[..., None]
        lse[:, :, :, q0:q0 + nq] = m + torch.log(l_safe)
    out = out.reshape(B, H, Sq, D).permute(0, 2, 1, 3).to(q.dtype)
    return out, lse.reshape(B, H, Sq)


def _check(q, k, v, window, kv_len):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or KVH < 1 or H % KVH:
        raise ValueError("flash_attention: q and k/v disagree on B, D or "
                         "the head grouping")
    if Sq < 1 or Skv < 1:
        raise ValueError("flash_attention: empty sequence")
    if not 0 <= kv_len <= Skv:
        raise ValueError(f"flash_attention: kv_len {kv_len} not in "
                         f"[0, {Skv}]")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")


def flash_attention_fwd(q, k, v, *, causal=True, window=None, kv_len=None,
                        q_offset=0, q_chunk=1024, kv_chunk=1024):
    """q: (B, Sq, H, D); k/v: (B, Skv, KVH, D).  -> (out (B, Sq, H, D) in
    q's dtype, lse (B, H, Sq) float32).  `q_offset`: absolute position of
    q row 0; `kv_len`: keys at or past it are masked.  The chunk sizes
    apply to the plain version only."""
    Skv = k.shape[1]
    kv_len = Skv if kv_len is None else int(kv_len)
    _check(q, k, v, window, kv_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_len=kv_len, q_offset=q_offset,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    lib = _lib()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=F32, device=q.device)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPES[q.dtype], B, Sq, Skv, H, KVH, D,
        int(causal), 0 if window is None else int(window), kv_len,
        int(q_offset), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention(q, k, v, *, causal=True, window=None, kv_len=None):
    """The reference's `ops.flash_attention` signature (its TPU tiling
    arguments have no counterpart): -> out (B, Sq, H, D)."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               kv_len=kv_len)[0]
