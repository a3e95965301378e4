"""SSD-scan parity of the PyTorch port against the JAX reference: the
plain chunk scan (what a CPU tensor runs, and what the CUDA kernels are
held to in `tests/test_torch_gpu.py`) and the naive oracle against the
Pallas kernel in interpret mode and the reference's oracle, at every
shape and dtype of `tests/test_kernels.py` and with its tolerances; the
four passes of the bf16 kernel in plain PyTorch, unrounded against the
same, and with the kernel's bf16 roundings against the plain scan at the
kernel tolerances; the autograd path through the plain scan; and the
kernels' tiles against the card's shared-memory limit.  Inputs come from
numpy seeds and reach both packages as the same numbers."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import ssd_scan as tssd

# tests/test_kernels.py:81-104
SSD_SHAPES = [(1, 4, 32, 2, 64, 16), (2, 2, 64, 4, 64, 128),
              (1, 8, 16, 1, 128, 64)]
TOL_Y = {"float32": dict(rtol=5e-4, atol=5e-4),
         "bfloat16": dict(rtol=5e-2, atol=5e-2)}
TOL_H = dict(rtol=5e-3, atol=5e-3)


def ssd_inputs(B, nC, Q, nh, hp, ns, seed=0):
    """numpy float32 x, B, C (scaled by 0.5), dt = softplus(N(0, 1)) and
    A = -exp(N(0, 0.2)), as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, Bm, Cm = (normal(*s) * 0.5 for s in ((B, nC, Q, nh, hp),
                                            (B, nC, Q, ns), (B, nC, Q, ns)))
    dt = np.logaddexp(normal(B, nC, Q, nh), 0.0).astype(np.float32)
    A = -np.exp(normal(nh) * 0.2)
    return x, Bm, Cm, dt, A


def both(x, dtype):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nC,Q,nh,hp,ns", SSD_SHAPES)
def test_ssd_scan_matches_pallas_and_oracle(B, nC, Q, nh, hp, ns, dtype):
    x, Bm, Cm, dt, A = ssd_inputs(B, nC, Q, nh, hp, ns)
    (jx, tx), (jb, tb), (jc, tc) = (both(v, dtype) for v in (x, Bm, Cm))
    jdt, jA = jnp.asarray(dt), jnp.asarray(A)
    tdt, tA = torch.from_numpy(dt), torch.from_numpy(A)
    want_y, want_h = jops.ssd_scan(jx, jb, jc, jdt, jA, interpret=True)
    y, h = ops.ssd_scan(tx, tb, tc, tdt, tA)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    assert h.dtype == torch.float32 and h.shape == (B, nh, ns, hp)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y, np.float32), **TOL_Y[dtype])
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL_H)
    # the mixer's float32 form: the same scan, y not rounded
    y32, h32 = ops.ssd_scan_fwd(tx, tb, tc, tdt, tA)
    assert y32.dtype == torch.float32
    np.testing.assert_allclose(y32.to(tx.dtype).float().numpy(),
                               y.float().numpy(), rtol=0, atol=0)
    assert torch.equal(h32, h)
    # the oracles, on the inputs widened to float32 as the reference test
    h0 = np.zeros((B, nh, ns, hp), np.float32)
    jwant = jref.ssd_chunk_ref(jx.astype(jnp.float32), jb.astype(jnp.float32),
                               jc.astype(jnp.float32), jdt, jA, h0)
    got = ref.ssd_chunk_ref(tx.float(), tb.float(), tc.float(), tdt, tA,
                            torch.from_numpy(h0))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jwant[0]),
                               **TOL_Y[dtype])
    for g, w in zip(got, jwant):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **TOL_Y["float32"])



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nC,Q,nh,hp,ns", SSD_SHAPES)
def test_ssd_passes_match_plain_pallas_and_oracle(B, nC, Q, nh, hp, ns,
                                                  dtype):
    """The bf16 kernel's decomposition (C B^T per chunk, chunk states,
    state passing, chunk outputs) unrounded: the plain chunk scan's
    numbers to float32 rounding, and the Pallas kernel's and the oracle's
    within tests/test_kernels.py's tolerances."""
    x, Bm, Cm, dt, A = ssd_inputs(B, nC, Q, nh, hp, ns)
    (jx, tx), (jb, tb), (jc, tc) = (both(v, dtype) for v in (x, Bm, Cm))
    jdt, jA = jnp.asarray(dt), jnp.asarray(A)
    tdt, tA = torch.from_numpy(dt), torch.from_numpy(A)
    y, h = tssd.ssd_scan_passes_plain(tx, tb, tc, tdt, tA)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == tx.shape and h.shape == (B, nh, ns, hp)
    want_y, want_h = tssd.ssd_scan_plain(tx, tb, tc, tdt, tA)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), **TOL_Y["float32"])
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), **TOL_Y["float32"])
    pal_y, pal_h = jops.ssd_scan(jx, jb, jc, jdt, jA, interpret=True)
    np.testing.assert_allclose(y.to(tx.dtype).float().numpy(),
                               np.asarray(pal_y, np.float32), **TOL_Y[dtype])
    np.testing.assert_allclose(h.numpy(), np.asarray(pal_h), **TOL_H)
    h0 = np.zeros((B, nh, ns, hp), np.float32)
    oy, oh = jref.ssd_chunk_ref(jx.astype(jnp.float32), jb.astype(jnp.float32),
                                jc.astype(jnp.float32), jdt, jA, h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(oy), **TOL_Y["float32"])
    np.testing.assert_allclose(h.numpy(), np.asarray(oh), **TOL_Y["float32"])


def excess(got, want, tol):
    """max over elements of (|got - want| - tol |want|) / tol: at most 1
    inside allclose(rtol=atol=tol)."""
    return float(((got - want).abs() - tol * want.abs()).max() / tol)


@pytest.mark.parametrize("B,nC,Q,nh,hp,ns,dt_scale", [
    (1, 4, 256, 64, 64, 128, 1.0),    # mamba2-1.3b's widths, 4 of 16 chunks
    (1, 4, 256, 64, 64, 128, 40.0),   # large decay: La near -8,000
    (2, 3, 100, 4, 32, 48, 1.0),      # ragged Q, narrow widths
])
def test_ssd_passes_rounded_fit_kernel_tolerances(B, nC, Q, nh, hp, ns,
                                                   dt_scale):
    """With bf16 inputs and the kernel's roundings (B o u as a high and a
    low part, W and h_in once each), the decomposition stays within the
    tolerances the card's kernel is held to against the plain scan: y
    5e-2, h_final 5e-3; finite under large decay, where exp(La_i - La_j)
    above the diagonal would overflow.  Inputs drawn as chip_smoke.py
    draws them, at a reduced chunk count."""
    x, Bm, Cm, dt, A = ssd_inputs(B, nC, Q, nh, hp, ns, seed=7)
    tx, tb, tc = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, Bm, Cm))
    tdt, tA = torch.from_numpy(dt * np.float32(dt_scale)), torch.from_numpy(A)
    want_y, want_h = tssd.ssd_scan_plain(tx, tb, tc, tdt, tA)
    y, h = tssd.ssd_scan_passes_plain(tx, tb, tc, tdt, tA, rounded=True)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert excess(y, want_y, TOL_Y["bfloat16"]["atol"]) <= 1.0
    assert excess(h, want_h, TOL_H["atol"]) <= 1.0
    # the roundings are really taken: unrounded, the passes agree to
    # float32 rounding
    y32, _ = tssd.ssd_scan_passes_plain(tx, tb, tc, tdt, tA)
    assert (y - y32).abs().max() > 1e3 * (y32 - want_y).abs().max()

def test_ssd_chunk_ref_carries_h0_as_reference():
    """The oracle's initial state, which the op does not take."""
    x, Bm, Cm, dt, A = ssd_inputs(2, 3, 16, 2, 32, 8, seed=1)
    h0 = np.random.default_rng(2).standard_normal((2, 2, 8, 32)).astype(
        np.float32)
    want = jref.ssd_chunk_ref(*(jnp.asarray(v) for v in (x, Bm, Cm, dt, A,
                                                         h0)))
    got = ref.ssd_chunk_ref(*(torch.from_numpy(v) for v in (x, Bm, Cm, dt, A,
                                                            h0)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **TOL_Y["float32"])


def test_ssd_plain_masks_before_exp():
    """dt large enough that La_i - La_j above the diagonal overflows exp:
    the plain scan and its gradients stay finite (the masked entries are
    -inf before the exp, so no inf * 0 makes a NaN) and agree with the
    oracle.  The reference, which masks after the exp, gets a non-finite
    dt gradient there (on record, not a target)."""
    x, Bm, Cm, dt, A = ssd_inputs(1, 2, 32, 2, 32, 8, seed=3)
    dt = dt * 40.0                   # La spans about -1,000 over a chunk
    ts = [torch.from_numpy(v).requires_grad_() for v in (x, Bm, Cm, dt, A)]
    y, h = tssd.ssd_scan_plain(*ts)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    (y.square().sum() + h.sum()).backward()
    for t in ts:
        assert torch.isfinite(t.grad).all()
    want = ref.ssd_chunk_ref(*(t.detach() for t in ts),
                             torch.zeros(1, 2, 8, 32))
    np.testing.assert_allclose(y.detach().numpy(), want[0].numpy(),
                               **TOL_Y["float32"])
    h0 = np.zeros((1, 2, 8, 32), np.float32)
    jgrad = jax.grad(lambda dt: jnp.sum(jref.ssd_chunk_ref(
        x, Bm, Cm, dt, A, h0)[0] ** 2))(dt)
    assert not bool(jnp.isfinite(jgrad).all())


def test_ssd_rejects_mismatched_shapes():
    x, Bm, Cm, dt, A = (torch.from_numpy(v) for v in
                        ssd_inputs(1, 2, 16, 2, 32, 8))
    with pytest.raises(ValueError, match="disagree"):
        ops.ssd_scan(x, Bm, Cm, dt[..., :1], A)
    with pytest.raises(ValueError, match="disagree"):
        ops.ssd_scan(x, Bm[:, :1], Cm[:, :1], dt, A)
    with pytest.raises(ValueError, match="bad shapes"):
        ops.ssd_scan(x, Bm, Cm[..., :4], dt, A)


@pytest.mark.parametrize("Q,ns", [(16, 16), (32, 16), (64, 128), (256, 128),
                                  (256, 256), (1024, 256)])
def test_ssd_tile_fits_shared_memory(Q, ns):
    """The float32 kernel's tiles, state and per-chunk vectors, and each
    bf16 pass's tiles and rings at every head_dim it takes, fit the 227 KB
    a block may opt in to; above the 48 KB static limit the kernels opt in
    (cudaFuncSetAttribute)."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    need = [tssd.smem_bytes(Q, ns)]
    for hp in tssd.HP_BF16:
        need += tssd.pass_smem_bytes(Q, ns, hp).values()
    assert max(need) <= tssd.SMEM_OPTIN
    if max(need) > 48 * 1024:
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src


def test_ssd_wrapper_agrees_with_its_source():
    """No compiler here: the wrapper's tile sizes and limits are read back
    from the CUDA source, so the two cannot drift apart."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    # the float32 kernel
    assert const("TQ") == const("TK") == tssd._TQ == tssd._TK
    assert const("P") == tssd._P
    assert const("NS_MAX") == tssd.NS_MAX
    assert tssd.smem_bytes(256, 128) == 110_848      # the source's header
    # the bf16 passes
    assert const("MT") == tssd._MT and const("MPAD") == tssd._MPAD
    assert "constexpr int CBS = MT + 8;" in src and tssd._CBS == tssd._MT + 8
    assert const("HP_MAX") == max(tssd.HP_BF16)
    assert tuple(int(c) for c in re.findall(
        r"case (\d+):\s+return launch_bf16<", src)) == tssd.HP_BF16
    assert tssd.pass_smem_bytes(256, 128, 64) == {   # the source's header
        "cb": 34_816, "states": 56_320, "outputs": 65_536}
    for n in ("34,816", "56,320", "65,536"):
        assert n in src
    assert "ssd_scan" in _build.KERNELS and "ssd_scan" in _build.LAUNCHES
