"""One-token GQA decode attention: CUDA kernel for Hopper (flash-decoding)
and its dispatch.

Replaces the Pallas TPU kernel
`repro/kernels/decode_attention.py:_decode_kernel` (`pl.pallas_call` at
line 106).  The TPU kernel walks the sequence as the innermost,
sequential grid axis of a (B, KVH, n_s) grid; on a card with 132 SMs a
(B, KVH) grid alone leaves most of them idle, so `csrc/decode_attention.cu`
splits the valid part of the cache across blocks and merges the
per-split partials (o, l, m) with the log-sum-exp algebra of
`models/common.py:merge_partials` in a second small kernel.

Two entry points share the kernel:
  * `decode_attention`              caches (B, S, KVH, D) — the reference's
                                    signature;
  * `decode_attention_head_major`   caches (B, KVH, S, D) — the layout of
                                    the model's decode cache.
The kernel takes the caches' strides, so neither layout is copied.
A CPU tensor runs the plain version `ref.decode_attention_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import decode_attention_ref

F32 = torch.float32
_DTYPES = {F32: 0, torch.bfloat16: 1}
_NT = 256               # threads per block (csrc NT)
_MAX_G = 16             # query heads per KV head (csrc MAXG)
_MAX_D = 256            # head_dim (csrc: G * D <= NT * MAXJ)
_SMEM_LIMIT = 48 * 1024  # static limit without an opt-in attribute
_BLOCKS_PER_SM = 4


def _lib():
    lib = _build.load("decode_attention")
    if lib.decode_attention.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.decode_attention.argtypes = [P, P, P, P, P, P,
                                         I, I, I, I, I, I, I, I, I,
                                         L, L, L, L, L, L,
                                         ctypes.c_float, P]
        lib.decode_attention.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tile(G: int, D: int) -> int:
    """Tokens per shared-memory tile: the largest of 64, 32, ... whose
    q, V tile and score buffers fit the static shared-memory limit."""
    tile = 64
    while tile > 8 and 4 * (G * D + tile * D + G * tile + 3 * G) \
            > _SMEM_LIMIT:
        tile //= 2
    return tile


def plan_splits(B: int, KVH: int, valid_len: int, tile: int,
                n_sm: int) -> tuple[int, int]:
    """(split_len, n_splits): enough (b, kv_head, split) blocks for about
    `_BLOCKS_PER_SM` per SM, each split a whole number of tiles, and no
    split at or past `valid_len`."""
    n_tiles = -(-valid_len // tile)
    want = max(1, (_BLOCKS_PER_SM * n_sm) // (B * KVH))
    n = min(want, n_tiles)
    split_len = -(-n_tiles // n) * tile
    return split_len, -(-valid_len // split_len)


def _cuda(q, k, v, valid_len, KVH, strides):
    """`strides`: element strides of the caches' (batch, kv head, token)
    axes; the head_dim axis is contiguous."""
    B, H, D = q.shape
    dev = q.device
    G = H // KVH
    lib = _lib()
    tile = _tile(G, D)
    split_len, n_splits = plan_splits(B, KVH, valid_len, tile,
                                      _sm_count(dev.index or 0))
    out = torch.empty_like(q)
    o_part = torch.empty(B * KVH * n_splits * G * D, dtype=F32, device=dev)
    ml_part = torch.empty(B * KVH * n_splits * G * 2, dtype=F32, device=dev)
    rc = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        o_part.data_ptr(), ml_part.data_ptr(), _DTYPES[q.dtype],
        B, H, KVH, D, valid_len, split_len, n_splits, tile,
        *strides, *strides, D ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out


def _check(q, k, v, valid_len, kvh_dim):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    B, H, D = q.shape
    S = k.shape[3 - kvh_dim]
    KVH = k.shape[kvh_dim]
    if k.shape[0] != B or k.shape[3] != D or H % KVH:
        raise ValueError("decode_attention: q and caches disagree on B, D "
                         "or the head grouping")
    if not 1 <= valid_len <= S:
        raise ValueError(f"decode_attention: valid_len {valid_len} not in "
                         f"[1, {S}]")
    if q.device.type == "cpu":
        return S
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported")
    if H // KVH > _MAX_G or D > _MAX_D:
        raise ValueError(f"decode_attention: needs H/KVH <= {_MAX_G} and "
                         f"D <= {_MAX_D}, got {H // KVH} and {D}")
    return S


def decode_attention(q, k_cache, v_cache, valid_len):
    """q: (B, H, D); caches: (B, S, KVH, D); valid_len: scalar int in
    [1, S].  -> (B, H, D) in q's dtype."""
    valid_len = int(valid_len)
    S = _check(q, k_cache, v_cache, valid_len, kvh_dim=2)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, valid_len)
    _, _, KVH, D = k_cache.shape
    return _cuda(q, k_cache, v_cache, valid_len, KVH,
                 (S * KVH * D, D, KVH * D))


def decode_attention_head_major(q, k_cache, v_cache, valid_len):
    """q: (B, H, D); caches: (B, KVH, S, D) (the model's decode cache);
    valid_len: scalar int in [1, S].  -> (B, H, D) in q's dtype."""
    valid_len = int(valid_len)
    S = _check(q, k_cache, v_cache, valid_len, kvh_dim=1)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache.transpose(1, 2),
                                    v_cache.transpose(1, 2), valid_len)
    _, KVH, _, D = k_cache.shape
    return _cuda(q, k_cache, v_cache, valid_len, KVH,
                 (KVH * S * D, S * D, D))
