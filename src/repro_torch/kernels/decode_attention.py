"""One-token GQA decode attention: CUDA kernel for Hopper (flash-decoding)
and its dispatch.

Replaces the Pallas TPU kernel
`repro/kernels/decode_attention.py:_decode_kernel` (`pl.pallas_call` at
line 106).  The TPU kernel walks the sequence as the innermost,
sequential grid axis of a (B, KVH, n_s) grid; on a card with 132 SMs a
(B, KVH) grid alone leaves most of them idle, so `csrc/decode_attention.cu`
splits the valid part of the cache across blocks, streams K and V rows in
16-byte loads, and has the last block of each (batch, kv head) merge the
per-split partials (o, l, m) with the log-sum-exp algebra of
`models/common.py:merge_partials`, in the same launch; with one split the
block writes the output itself.

Three entry points:
  * `decode_attention`              caches (B, S, KVH, D) — the reference's
                                    signature;
  * `decode_attention_head_major`   caches (B, KVH, S, D) — the layout of
                                    the model's decode cache;
  * `decode_attention_int8_append`  the model's int8 cache (`kv_quant`):
                                    quantizes the new token's k and v,
                                    writes them at `slot` and attends, in
                                    one launch.
The float kernel takes the caches' strides, so neither layout is copied.
The head-major entry point also takes the int8 cache with its float32
`k_scale` and `v_scale` of shape (B, KVH, S), read in place where the
reference upcasts the whole cache in einsum
(`repro/models/attention.py:146-166`), by one of two kernels chosen by
q's dtype: bf16 q (every serving config) takes
`csrc/decode_attention_int8.cu` (tensor cores, a ring of bulk copies;
counted as `decode_attention_int8`), float32 q the float kernel's int8
instantiation on the CUDA cores (`decode_attention_int8_f32`).
A CPU tensor runs the plain version `ref.decode_attention_ref` (after
`ref.quantize_kv` and the writes, for the append).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import decode_attention_ref, quantize_kv

F32 = torch.float32
_DTYPES = {F32: 0, torch.bfloat16: 1}      # q, out and a float cache
_INT8 = 2               # csrc cache_dtype of an int8 cache
_NW = 4                 # warps per block (csrc NT / 32)
_MAX_G = 16             # query heads per KV head (csrc MAXG)
_MAX_D = 256            # head_dim (csrc MAXD)
_DPL = 8                # dims a lane holds (csrc DPL)
_DPL_INT8 = 16          # ... of an int8 cache at hg <= 4 (csrc DPL_INT8)
_SMEM_LIMIT = 48 * 1024  # static limit without an opt-in attribute
_MAX_SPLITS = 256       # csrc MAX_SPLITS
# csrc/decode_attention_int8.cu: consumer warps, tokens a warp takes of a
# stage (TILE = NCW * WT), the ring's stages, shared memory a block may
# opt into; an SM has 228 KB, of which the card reserves 1 KB a block
_INT8_NCW, _INT8_WT = 4, 16
INT8_TILE = _INT8_NCW * _INT8_WT
_INT8_STAGES = (2, 4)
_INT8_SMEM_LIMIT = 232448
_SM_SMEM, _SMEM_RESERVED = 233472, 1024
# the quantizer's 1e-8 floor in bf16, the dtype the int8 kernel's q takes
_BF16_FLOOR = float(torch.tensor(1e-8, dtype=torch.bfloat16))
# (device, stream) -> int32 arrival counters of the fused merge.  The
# last block of each (batch, kv head) resets its counter, so one zeroed
# buffer serves every launch on that stream without a memset launch;
# launches on one stream run one after another, while two streams' may
# overlap and so never share a buffer.
_COUNTERS: dict = {}


def _lib():
    lib = _build.load("decode_attention")
    if lib.decode_attention.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.decode_attention.argtypes = [P] * 10 + [I] * 13 + [L] * 6 + [
            ctypes.c_float, P]
        lib.decode_attention.restype = ctypes.c_int
        lib.decode_blocks_per_sm.argtypes = [I, I, I]
        lib.decode_blocks_per_sm.restype = I
    return lib


def _lib_int8():
    lib = _build.load("decode_attention_int8")
    if lib.decode_attention_int8.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_int8.argtypes = [P] * 12 + [I] * 11 + [
            ctypes.c_float, ctypes.c_float, P]
        lib.decode_attention_int8.restype = I
        lib.decode_int8_blocks_per_sm.argtypes = [I, I]
        lib.decode_int8_blocks_per_sm.restype = I
    return lib


def head_slice(G: int) -> int:
    """Query heads a thread holds (csrc template HG): G rounded up to 1,
    2, 4 or 8; G > 8 takes two slices of 8."""
    return next(hg for hg in (1, 2, 4, 8) if hg >= min(G, 8))


def dims_per_lane(cache_dtype, hg: int) -> int:
    """Dims of a K/V row a lane holds (csrc `dims_per_lane`): 8 (one
    16-byte load in bf16, two in float32), or 16 int8 (one 16-byte load)
    while the hg heads' q and accumulators leave the registers."""
    return _DPL_INT8 if cache_dtype == torch.int8 and hg <= 4 else _DPL


def lanes(D: int, dpl: int = _DPL) -> int:
    """Lanes that share a K/V row, `dpl` dims each: D / dpl rounded up to
    a power of two."""
    n = 1
    while n * dpl < D:
        n *= 2
    return n


def tile(G: int, D: int, dtype, cache_dtype=None) -> int:
    """Tokens a block reads per step of its loop: warps of a head slice
    x tokens per warp load x tokens a lane loads at once (csrc
    `tokens_per_load`).  `cache_dtype` defaults to `dtype`."""
    cache_dtype = dtype if cache_dtype is None else cache_dtype
    hg = head_slice(G)
    wps = _NW // -(-G // hg)
    if cache_dtype == torch.int8:
        per_load = 2 if hg == 4 else 4
    elif cache_dtype == torch.bfloat16:
        per_load = 2 if hg >= 8 else 4
    else:
        per_load = 1 if hg >= 4 else 2
    return wps * (32 // lanes(D, dims_per_lane(cache_dtype, hg))) * per_load


def smem_bytes(G: int) -> int:
    """Static shared memory of one block (csrc red_o, red_m, red_l,
    is_last)."""
    hg = head_slice(G)
    return 4 * (_NW * hg * _MAX_D + 2 * _NW * hg) + 4


def plan_splits(B: int, KVH: int, valid_len: int, tile: int,
                slots: int) -> tuple[int, int]:
    """(split_len, n_splits): at most one wave of `slots` resident
    (b, kv_head, split) blocks, at most `_MAX_SPLITS` splits, each a whole
    number of tiles, and no split at or past `valid_len`; an empty shard
    (valid_len 0) takes one split of one tile."""
    if valid_len == 0:
        return tile, 1
    n_tiles = -(-valid_len // tile)
    n = max(1, min(slots // (B * KVH), _MAX_SPLITS, n_tiles))
    split_len = -(-n_tiles // n) * tile
    return split_len, -(-valid_len // split_len)


def int8_smem_bytes(D: int, G: int, stages: int) -> int:
    """Dynamic shared memory of one block of the int8 kernel (csrc
    `layout`): the ring of `stages` stages (K and V tiles of INT8_TILE rows
    padded to 16 bytes, two scales a row), which is also the merges'
    scratch; the warps' bf16 V tiles (rows padded by 16 bytes); Q's
    fragments; the appended rows; the barriers and a flag."""
    pd = -(-D // 16) * 16
    stage = 2 * INT8_TILE * pd + 2 * INT8_TILE * 4
    ring = max(stages * stage, _INT8_NCW * G * pd * 4 + 2 * _INT8_NCW * G * 4,
               _MAX_SPLITS * G * 4)
    return (ring + _INT8_NCW * _INT8_WT * (2 * pd + 16) + -(-D // 64) * 2048
            + 2 * pd + 16 + 2 * stages * 8 + 16)


def int8_blocks(D: int) -> int:
    """Blocks an SM the int8 kernel's registers are bounded for at head_dim
    D (csrc `min_blocks`): three at D 64 and 128, two at other D up to
    128, one above."""
    return 1 if -(-D // 16) * 16 > 128 else 3 if D in (64, 128) else 2


def int8_stages(D: int, G: int) -> int:
    """Stages of the int8 kernel's ring: the most that leave room for
    `int8_blocks(D)` blocks an SM."""
    lo, hi = _INT8_STAGES
    blocks = int8_blocks(D)
    for n in range(hi, lo - 1, -1):
        if blocks * (int8_smem_bytes(D, G, n) + _SMEM_RESERVED) <= _SM_SMEM:
            return n
    raise ValueError(f"decode_attention_int8: D {D}, G {G} leave no room for "
                     f"{blocks} blocks an SM")


def _cache_code(cache_dtype) -> int:
    return _INT8 if cache_dtype == torch.int8 else _DTYPES[cache_dtype]


@functools.cache
def _slots(index: int, dtype, cache_dtype, hg: int) -> int:
    """Blocks the card holds at once: SMs x resident blocks of the
    (dtype, cache dtype, hg) kernel."""
    n = _lib().decode_blocks_per_sm(_DTYPES[dtype], _cache_code(cache_dtype),
                                    hg)
    if n < 1:
        raise RuntimeError(f"decode_attention: occupancy query failed ({n})")
    return n * torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _int8_slots(index: int, D: int, smem: int) -> int:
    """Blocks of the int8 kernel the card holds at once."""
    n = _lib_int8().decode_int8_blocks_per_sm(D, smem)
    if n < 1:
        raise RuntimeError(f"decode_attention_int8: occupancy query failed "
                           f"({n})")
    return n * torch.cuda.get_device_properties(index).multi_processor_count


def _counters(dev, stream: int, n: int) -> torch.Tensor:
    """The zeroed counters of launches on `stream` (a cudaStream_t), made
    on that stream."""
    have = _COUNTERS.get((dev, stream))
    if have is None or have.numel() < n:
        have = _COUNTERS[dev, stream] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=dev)
    return have


def _cuda(q, k, v, valid_len, KVH, strides, k_scale, v_scale, lse=None):
    """`strides`: element strides of the caches' (batch, kv head, token)
    axes; the head_dim axis is contiguous.  `lse`: None, or float32 (B, H)
    that takes each row's log-sum-exp."""
    B, H, D = q.shape
    dev = q.device
    G = H // KVH
    lib = _lib()
    hg = head_slice(G)
    dpl = dims_per_lane(k.dtype, hg)
    split_len, n_splits = plan_splits(
        B, KVH, valid_len, tile(G, D, q.dtype, k.dtype),
        _slots(dev.index or 0, q.dtype, k.dtype, hg))
    vec = int(D % dpl == 0 and all(s % dpl == 0 for s in strides)
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(q)
    n_part = B * KVH * n_splits if n_splits > 1 else 0
    o_part = torch.empty(n_part * G * D, dtype=F32, device=dev)
    ml_part = torch.empty(n_part * G * 2, dtype=F32, device=dev)
    quant = k_scale is not None
    rc = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        o_part.data_ptr(), ml_part.data_ptr(),
        _counters(dev, stream, B * KVH).data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, _DTYPES[q.dtype],
        _cache_code(k.dtype), B, H, KVH, D, hg, lanes(D, dpl), valid_len,
        split_len, n_splits, vec, k_scale.shape[2] if quant else 0,
        *strides, *strides, D ** -0.5, stream)
    name = "decode_attention_int8_f32" if quant else "decode_attention"
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return out


def _cuda_int8(q, k, v, valid_len, k_scale, v_scale, k_new=None, v_new=None,
               slot=-1, lse=None):
    """The int8 kernel over the head-major (B, KVH, S, D) cache, bf16 q;
    with `slot` >= 0 it first writes the quantized `k_new` / `v_new` at
    `slot`; `lse` as `_cuda`'s."""
    B, H, D = q.shape
    _, KVH, S, _ = k.shape
    G = H // KVH
    dev = q.device
    lib = _lib_int8()
    stages = int8_stages(D, G)
    smem = int8_smem_bytes(D, G, stages)
    split_len, n_splits = plan_splits(
        B, KVH, valid_len, INT8_TILE, _int8_slots(dev.index or 0, D, smem))
    caches = (k, v, k_scale, v_scale)
    bulk = int(D % 16 == 0 and S % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in caches))
    if D % 4 or any(t.data_ptr() % 4 for t in caches):
        raise ValueError(f"decode_attention_int8: needs D % 4 == 0 and "
                         f"4-byte aligned caches, got D {D}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(q)
    n_part = B * KVH * n_splits if n_splits > 1 else 0
    o_part = torch.empty(n_part * G * D, dtype=F32, device=dev)
    ml_part = torch.empty(n_part * G * 2, dtype=F32, device=dev)
    rc = lib.decode_attention_int8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), o_part.data_ptr(),
        ml_part.data_ptr(), _counters(dev, stream, B * KVH).data_ptr(),
        None if k_new is None else k_new.data_ptr(),
        None if v_new is None else v_new.data_ptr(), B, H, KVH, D, S,
        valid_len, split_len, n_splits, stages, bulk, slot, _BF16_FLOOR,
        D ** -0.5, stream)
    _build.check(lib, rc, "decode_attention_int8")
    _build.LAUNCHES["decode_attention_int8"] += 1
    return out


def _check(q, k, v, valid_len, kvh_dim, k_scale, v_scale, lo: int = 1):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    B, H, D = q.shape
    S = k.shape[3 - kvh_dim]
    KVH = k.shape[kvh_dim]
    if k.shape[0] != B or k.shape[3] != D or H % KVH:
        raise ValueError("decode_attention: q and caches disagree on B, D "
                         "or the head grouping")
    if not lo <= valid_len <= S:
        raise ValueError(f"decode_attention: valid_len {valid_len} not in "
                         f"[{lo}, {S}]")
    quant = k.dtype == torch.int8 or v.dtype == torch.int8
    scales = [t for t in (k_scale, v_scale) if t is not None]
    if len(scales) != (2 if quant else 0):
        raise ValueError("decode_attention: an int8 cache takes both "
                         "k_scale and v_scale, and scales only an int8 cache")
    for name, t in zip(("k_scale", "v_scale"), scales):
        if t.shape != (B, KVH, S) or t.dtype != F32:
            raise ValueError(f"decode_attention: {name} must be float32 of "
                             f"shape {(B, KVH, S)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if q.device.type in ("cpu", "meta"):
        return S
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    cache_dtype = torch.int8 if quant else q.dtype
    for name, t, want in (("q", q, q.dtype), ("k", k, cache_dtype),
                          ("v", v, cache_dtype),
                          *((n, t, F32) for n, t in zip(
                              ("k_scale", "v_scale"), scales))):
        if t.device != q.device or t.dtype != want:
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


def _meta(q, valid_len: int, return_lse: bool):
    """The plain version's shapes on the meta device; the kernel's work,
    q.k and p.v over `valid_len` rows, goes to `_build.META_FLOPS` (a
    planner's dry run)."""
    B, H, D = q.shape
    _build.META_FLOPS["decode_attention"] += 4 * B * H * valid_len * D
    out = torch.empty_like(q)
    if not return_lse:
        return out
    return out, torch.empty(q.shape[:2], dtype=F32, device=q.device)


def decode_attention(q, k_cache, v_cache, valid_len):
    """q: (B, H, D); caches: (B, S, KVH, D); valid_len: scalar int in
    [1, S].  -> (B, H, D) in q's dtype."""
    valid_len = int(valid_len)
    S = _check(q, k_cache, v_cache, valid_len, 2, None, None)
    if q.device.type == "meta":
        return _meta(q, valid_len, False)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, valid_len)
    _, _, KVH, D = k_cache.shape
    return _cuda(q, k_cache, v_cache, valid_len, KVH,
                 (S * KVH * D, D, KVH * D), None, None)


def _lse_out(q, return_lse: bool):
    return torch.empty(q.shape[:2], dtype=F32, device=q.device) \
        if return_lse else None


def decode_attention_head_major(q, k_cache, v_cache, valid_len,
                                k_scale=None, v_scale=None,
                                return_lse: bool = False):
    """q: (B, H, D); caches: (B, KVH, S, D) (the model's decode cache), in
    q's dtype or int8 with float32 `k_scale` / `v_scale` (B, KVH, S);
    valid_len: scalar int in [0, S].  -> (B, H, D) in q's dtype, and with
    `return_lse` each row's float32 log-sum-exp (B, H) of the scaled
    scores, which a sequence shard's partial needs for the cross-rank
    merge; valid_len 0 (an empty shard) gives output 0 and lse -inf.  On
    the card an int8 cache goes by q's dtype: bf16 q to the int8 kernel,
    float32 q to the float kernel's int8 instantiation."""
    valid_len = int(valid_len)
    S = _check(q, k_cache, v_cache, valid_len, 1, k_scale, v_scale, lo=0)
    if q.device.type == "meta":
        return _meta(q, valid_len, return_lse)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache.transpose(1, 2),
                                    v_cache.transpose(1, 2), valid_len,
                                    k_scale, v_scale, return_lse=return_lse)
    lse = _lse_out(q, return_lse)
    if k_scale is not None and q.dtype == torch.bfloat16:
        out = _cuda_int8(q, k_cache, v_cache, valid_len, k_scale, v_scale,
                         lse=lse)
    else:
        _, KVH, _, D = k_cache.shape
        out = _cuda(q, k_cache, v_cache, valid_len, KVH,
                    (KVH * S * D, S * D, D), k_scale, v_scale, lse)
    return (out, lse) if return_lse else out


def decode_attention_int8_append(q, k_new, v_new, cache_k, cache_v, k_scale,
                                 v_scale, slot, valid_len,
                                 return_lse: bool = False):
    """The model's int8 decode step: quantizes the new token's `k_new` /
    `v_new` ((B, KVH, D) in q's dtype, after RoPE) as `ref.quantize_kv`
    does, writes payloads and float32 scales at cache row `slot` (in
    place), then attends q (B, H, D) over the first `valid_len` rows of
    the head-major int8 caches (B, KVH, S, D) with their `k_scale` /
    `v_scale` (B, KVH, S); `slot` in [0, valid_len), or None where this
    cache (a sequence shard) does not hold the new token's row: then
    nothing is written and valid_len may be 0.  -> (B, H, D) in q's
    dtype [, lse (B, H) float32, as `decode_attention_head_major`'s].  On
    the card one launch of the int8 kernel (bf16 q only); on the CPU the
    quantizer, the four writes and the plain version."""
    valid_len = int(valid_len)
    if cache_k.dtype != torch.int8:
        raise ValueError("decode_attention_int8_append: takes an int8 cache")
    _check(q, cache_k, cache_v, valid_len, 1, k_scale, v_scale, lo=0)
    B, KVH, _, D = cache_k.shape
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (B, KVH, D) or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention_int8_append: {name} must be "
                             f"contiguous {q.dtype} of shape {(B, KVH, D)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if slot is not None:
        slot = int(slot)
        if not 0 <= slot < valid_len:
            raise ValueError(f"decode_attention_int8_append: slot {slot} not "
                             f"in [0, {valid_len})")
    if q.device.type == "meta":
        return _meta(q, valid_len, return_lse)
    if q.device.type == "cpu":
        if slot is not None:
            k8, ks = quantize_kv(k_new)
            v8, vs = quantize_kv(v_new)
            k_scale[:, :, slot] = ks
            v_scale[:, :, slot] = vs
            cache_k[:, :, slot] = k8
            cache_v[:, :, slot] = v8
        return decode_attention_head_major(q, cache_k, cache_v, valid_len,
                                           k_scale, v_scale,
                                           return_lse=return_lse)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"decode_attention_int8_append: the card's kernel "
                         f"takes a bfloat16 q, got {q.dtype}")
    lse = _lse_out(q, return_lse)
    out = _cuda_int8(q, cache_k, cache_v, valid_len, k_scale, v_scale,
                     k_new, v_new, -1 if slot is None else slot, lse)
    return (out, lse) if return_lse else out
