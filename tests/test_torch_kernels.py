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


@pytest.mark.parametrize("B,KVH,valid,tile", [
    (4, 8, 1, 64), (4, 8, 129, 64), (4, 8, 160, 64), (8, 8, 30001, 64),
    (4, 32, 3001, 32), (4, 2, 3001, 64), (1, 1, 17, 64), (1, 4, 700, 16)])
def test_plan_splits_covers_valid_len(B, KVH, valid, tile):
    """Splits are whole tiles, cover [0, valid_len) and none starts at
    or past it, whatever the SM count."""
    for n_sm in (1, 132):
        split_len, n_splits = tdecode.plan_splits(B, KVH, valid, tile, n_sm)
        assert split_len % tile == 0
        assert (n_splits - 1) * split_len < valid <= n_splits * split_len
        assert B * KVH * n_splits <= max(tdecode._BLOCKS_PER_SM * n_sm,
                                         B * KVH)


@pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (16, 128), (1, 256),
                                 (16, 256), (1, 80)])
def test_decode_tile_fits_static_shared_memory(G, D):
    tile = tdecode._tile(G, D)
    assert tile >= 8 and tile & (tile - 1) == 0
    assert 4 * (G * D + tile * D + G * tile + 3 * G) <= tdecode._SMEM_LIMIT


@pytest.mark.parametrize("D", tflash.HEAD_DIMS)
def test_flash_tile_fits_shared_memory(D):
    """The flash block's q, K, V and probability tiles (float32) fit the
    227 KB a block may opt in to; above the 48 KB static limit the
    kernel opts in (cudaFuncSetAttribute)."""
    assert tflash.smem_bytes(D) <= tflash.SMEM_OPTIN
    src = (_build.CSRC / "flash_attention.cu").read_text()
    if tflash.smem_bytes(D) > 48 * 1024:
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src


def test_flash_wrapper_agrees_with_its_source():
    """No compiler here: the wrapper's head dims and tile sizes are read
    back from the CUDA source, so the two cannot drift apart."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    cases = tuple(sorted(int(d) for d in re.findall(r"case (\d+):", src)))
    assert cases == tflash.HEAD_DIMS
    for name in ("BQ", "BK"):
        got = re.search(rf"constexpr int {name} = (\d+);", src).group(1)
        assert int(got) == 64 == tflash._BQ == tflash._BK
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
