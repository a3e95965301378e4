"""Kernel parity of the PyTorch port: its plain versions of `ralt_update`
and `decode_attention` (what a CPU tensor runs) against the reference's
Pallas kernels in interpret mode, at every shape of `tests/test_kernels.py`
and with that file's tolerances, and the tiles of the CUDA kernels against
the card's shared-memory limits.  Inputs come from numpy seeds and reach
both packages as the same numbers.  The hand-written CUDA kernels are
held against these plain versions in `tests/test_torch_gpu.py`; the
flash-attention plain version is held to the reference in
`tests/test_torch_training.py`."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DECODE_SHAPES = [(2, 256, 8, 2, 64, 256),
                 (2, 256, 8, 2, 64, 130),       # partial cache
                 (1, 512, 4, 1, 128, 17),
                 (4, 128, 4, 4, 128, 128),
                 (1, 1024, 8, 4, 256, 700)]
RALT_N = [1, 100, 128, 1000, 4096, 5000]


def both(x, dtype):
    """One numpy float32 array as a jax and a torch array of `dtype`
    (both round to nearest even when narrowing to bfloat16)."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def decode_inputs(B, S, H, KVH, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), np.float32)
    k = rng.standard_normal((B, S, KVH, D), np.float32)
    v = rng.standard_normal((B, S, KVH, D), np.float32)
    return [both(x, dtype) for x in (q, k, v)]


def ralt_inputs(N):
    rng = np.random.default_rng(N)
    ticks = rng.integers(0, 50, N).astype(np.int32)
    scores = (rng.random(N) * 5).astype(np.float32)
    hits = rng.integers(0, 2, N).astype(np.int8)
    return ticks, scores, hits


# ----------------------------------------------------------------------
# decode attention
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KVH,D,valid", DECODE_SHAPES)
def test_decode_attention_matches_reference(B, S, H, KVH, D, valid, dtype):
    (jq, tq), (jk, tk), (jv, tv) = decode_inputs(B, S, H, KVH, D, dtype)
    want = jops.decode_attention(jq, jk, jv, jnp.int32(valid), block_s=128,
                                 interpret=True)
    got = ops.decode_attention(tq, tk, tv, valid)
    assert got.dtype == tq.dtype and got.shape == (B, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])
    # the oracles agree too
    np.testing.assert_allclose(
        ref.decode_attention_ref(tq, tk, tv, valid).float().numpy(),
        np.asarray(jref.decode_attention_ref(jq, jk, jv, valid), np.float32),
        **TOL[dtype])
    # the model's head-major entry point computes the same function (its
    # einsum may sum in another order)
    hm = ops.decode_attention_head_major(
        tq, tk.transpose(1, 2).contiguous(), tv.transpose(1, 2).contiguous(),
        valid)
    np.testing.assert_allclose(hm.float().numpy(), got.float().numpy(),
                               **TOL[dtype])


@pytest.mark.parametrize("valid", [0, 257])
def test_decode_attention_rejects_valid_len_out_of_range(valid):
    (_, q), (_, k), (_, v) = decode_inputs(1, 256, 4, 2, 64, "float32")
    with pytest.raises(ValueError, match="valid_len"):
        ops.decode_attention(q, k, v, valid)


@pytest.mark.parametrize("B,KVH,G,D,valid,dtype", [
    (4, 8, 4, 128, 1, torch.bfloat16), (4, 8, 4, 128, 129, torch.bfloat16),
    (4, 8, 4, 128, 160, torch.float32), (8, 8, 4, 128, 30001, torch.bfloat16),
    (4, 32, 1, 80, 3001, torch.bfloat16), (4, 2, 7, 64, 3001, torch.bfloat16),
    (1, 1, 16, 256, 17, torch.float32), (1, 4, 2, 16, 700, torch.float32),
    # an int8 cache (the tile counts the cache's element type)
    (8, 8, 4, 128, 30001, torch.int8), (4, 8, 6, 128, 129, torch.int8)])
def test_plan_splits_covers_valid_len(B, KVH, G, D, valid, dtype):
    """Splits are whole tiles of the kernel's loop, cover [0, valid_len)
    and none starts at or past it, whatever the card holds at once; the
    grid is at most one wave of resident blocks; one split (no merge)
    where the (batch, kv head) blocks alone fill the card."""
    tile = tdecode.tile(G, D, dtype)
    for slots in (1, 132, 4 * 132, 16 * 132):
        split_len, n_splits = tdecode.plan_splits(B, KVH, valid, tile,
                                                  slots)
        assert split_len % tile == 0
        assert (n_splits - 1) * split_len < valid <= n_splits * split_len
        assert B * KVH * n_splits <= max(slots, B * KVH)
        assert n_splits <= tdecode._MAX_SPLITS
        if B * KVH >= slots or valid <= tile:
            assert n_splits == 1


@pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (16, 128), (1, 256),
                                 (16, 256), (1, 80), (7, 64), (2, 16),
                                 (6, 128), (2, 256)])
def test_decode_tile_fits_static_shared_memory(G, D):
    """The block's merge buffers fit the 48 KB of static shared memory; a
    power-of-two lane group of the dims a lane holds (8, or 16 of an int8
    cache at up to 4 heads a slice) covers D; at most two head slices
    cover G; the constants agree with the CUDA source."""
    assert tdecode.smem_bytes(G) <= tdecode._SMEM_LIMIT
    hg = tdecode.head_slice(G)
    assert hg in (1, 2, 4, 8) and hg >= min(G, 8) and -(-G // hg) <= 2
    for cache in (torch.float32, torch.bfloat16, torch.int8):
        dpl = tdecode.dims_per_lane(cache, hg)
        assert dpl == (16 if cache == torch.int8 and hg <= 4 else 8)
        n = tdecode.lanes(D, dpl)
        assert n & (n - 1) == 0 and n <= 32
        assert n * dpl >= D > n * dpl // 2
        for dtype in (torch.float32, torch.bfloat16):
            tile = tdecode.tile(G, D, dtype, cache if cache == torch.int8
                                else dtype)
            assert tile >= 1 and tile & (tile - 1) == 0
    src = (_build.CSRC / "decode_attention.cu").read_text()
    for name, want in (("NT", 32 * tdecode._NW), ("MAXG", tdecode._MAX_G),
                       ("MAXD", tdecode._MAX_D), ("DPL", tdecode._DPL),
                       ("DPL_INT8", tdecode._DPL_INT8),
                       ("MAX_SPLITS", tdecode._MAX_SPLITS)):
        got = re.search(rf"constexpr int {name} = (\d+);", src).group(1)
        assert int(got) == want, name
    assert "merge_kernel" not in src     # the merge is fused: one launch
    # the last block's merge weights (MAX_SPLITS x G) fit in red_o
    assert tdecode._MAX_SPLITS * G <= tdecode._NW * hg * tdecode._MAX_D
    # dims a lane holds, as the wrapper's dims_per_lane counts them
    assert re.search(r"return sizeof\(C\) == 1 && HG <= 4 \? DPL_INT8 : "
                     r"DPL;", src)
    # tokens a lane loads at once, as the wrapper's tile counts them
    assert re.search(r"if \(sizeof\(C\) == 1\) return HG == 4 \? 2 : 4;\s+"
                     r"return sizeof\(C\) == 2 \? \(HG >= 8 \? 2 : 4\) "
                     r": \(HG >= 4 \? 1 : 2\);", src)


@pytest.mark.parametrize("D", tflash.HEAD_DIMS)
def test_flash_tile_fits_shared_memory(D):
    """The bf16 block's q tile and STAGES stages of K and V tiles (and
    the float32 block's q, K, V and probability tiles) fit the 227 KB a
    block may opt in to; above the 48 KB static limit the kernel opts in
    (cudaFuncSetAttribute)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for dtype in (torch.bfloat16, torch.float32):
        assert tflash.smem_bytes(D, dtype) <= tflash.SMEM_OPTIN
        if tflash.smem_bytes(D, dtype) > 48 * 1024:
            assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    rows, keys = tflash.bf16_tile(D)
    assert tflash.smem_bytes(D) == (1024 + 2 * D * (
        rows + 2 * tflash.STAGES * keys) + 8 * (2 * tflash.STAGES + 1))
    # D's column chunks (112 = 64 + 32 + 16): each a TMA box as wide as
    # a swizzle span, each starting on its swizzle atom (8 rows of the
    # span) in the q tile, in each K/V tile and in each warpgroup's rows
    chunks = tflash.bf16_chunks(D)
    assert sum(chunks) == D and list(chunks) == sorted(chunks, reverse=True)
    assert set(chunks) <= {16, 32, 64} and chunks.count(32) <= 1 \
        and chunks.count(16) <= 1
    for n in (rows, keys, 64):
        offset = 0
        for w in chunks:
            assert offset % (8 * 2 * w) == 0 and n * 2 * w % (8 * 2 * w) == 0
            offset += n * 2 * w
        assert offset == n * 2 * D


def test_flash_wrapper_agrees_with_its_source():
    """No compiler here: the wrapper's head dims, tile sizes and ring
    depth are read back from the CUDA source, so the two cannot drift
    apart; the bf16 kernel issues wgmma for both products and loads K/V
    by TMA into a ring of at least 2 stages."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    cases = tuple(sorted(int(d) for d in re.findall(r"case (\d+):", src)))
    assert cases == tflash.HEAD_DIMS
    for name in ("F32_BQ", "F32_BK"):
        got = re.search(rf"constexpr int {name} = (\d+);", src).group(1)
        assert int(got) == 64 == tflash._F32_BQ == tflash._F32_BK
    stages = int(re.search(r"constexpr int STAGES = (\d+);", src).group(1))
    assert stages == tflash.STAGES >= 2
    for fn, i in (("rows_per_block", 0), ("keys_per_tile", 1)):
        op, cut, big, small = re.search(
            rf"constexpr int {fn}\(int D\) {{\s*return D (>=?) (\d+) \? "
            r"(\d+) : (\d+);\s*}", src).groups()
        for D in tflash.HEAD_DIMS:
            above = D >= int(cut) if op == ">=" else D > int(cut)
            assert tflash.bf16_tile(D)[i] == int(big if above else small)
    # the chunk cut, as the wrapper's bf16_chunks states it
    w32 = re.search(r"constexpr int cols32\(int D\) {\s*return D % 64 >= "
                    r"32 \? 32 : 0;\s*}", src)
    w16 = re.search(r"constexpr int cols16\(int D\) { return D % 32; }", src)
    assert w32 and w16
    for D in tflash.HEAD_DIMS:
        tail = (32 if D % 64 >= 32 else 0, D % 32)
        assert tflash.bf16_chunks(D) == (64,) * (D // 64) + tuple(
            w for w in tail if w)
    assert re.search(r"CUtensorMap q, k, v, q32, k32, v32, q16, k16, v16;",
                     src)
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier"):
        assert ptx in src
    assert "flash_attention" in _build.KERNELS
    assert "flash_attention" in _build.LAUNCHES


# ----------------------------------------------------------------------
# RALT score update
# ----------------------------------------------------------------------
@pytest.mark.parametrize("N", RALT_N)
@pytest.mark.parametrize("alpha", [0.999, 0.9])
def test_ralt_update_matches_reference(N, alpha):
    ticks, scores, hits = ralt_inputs(N)
    now, thresh = 57, 1.0
    jt, js, jh = jops.ralt_update(jnp.asarray(ticks), jnp.asarray(scores),
                                  jnp.asarray(hits), now, thresh,
                                  alpha=alpha, interpret=True)
    tt, ts, th = ops.ralt_update(torch.from_numpy(ticks),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(hits), now, thresh,
                                 alpha=alpha)
    assert (tt.dtype, ts.dtype, th.dtype) == (torch.int32, torch.float32,
                                              torch.int8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the plain version evaluates exp as the reference's kernel does on
    # the CPU, so the scores and hence the hot bitmap agree bit for bit
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    # the pow-based oracles, within tests/test_kernels.py's tolerance
    rt, rs = ref.ralt_update_ref(torch.from_numpy(ticks),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(hits), now, alpha)
    wt, ws = jref.ralt_update_ref(jnp.asarray(ticks), jnp.asarray(scores),
                                  jnp.asarray(hits), now, alpha)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(rs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), rs.numpy(), rtol=1e-5, atol=1e-6)


def test_ralt_update_reads_device_scalars():
    """`now` and `threshold` may be 0-d tensors (the tracker keeps them
    on the device); the result equals the one from Python numbers."""
    ticks, scores, hits = (torch.from_numpy(x) for x in ralt_inputs(1000))
    a = ops.ralt_update(ticks, scores, hits, 57, 1.0)
    b = ops.ralt_update(ticks, scores, hits,
                        torch.tensor(57, dtype=torch.int32),
                        torch.tensor(1.0))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
