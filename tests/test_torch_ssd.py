"""SSD-scan parity of the PyTorch port against the JAX reference: the
plain chunk scan (what a CPU tensor runs, and what the CUDA kernel is
held to in `tests/test_torch_gpu.py`) and the naive oracle against the
Pallas kernel in interpret mode and the reference's oracle, at every
shape and dtype of `tests/test_kernels.py` and with its tolerances; the
autograd path through the plain scan; and the kernel's tiles against the
card's shared-memory limit.  Inputs come from numpy seeds and reach both
packages as the same numbers."""
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
    """The block's tiles, state and per-chunk vectors fit the 227 KB a
    block may opt in to; above the 48 KB static limit the kernel opts in
    (cudaFuncSetAttribute)."""
    assert tssd.smem_bytes(Q, ns) <= tssd.SMEM_OPTIN
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    if tssd.smem_bytes(Q, ns) > 48 * 1024:
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src


def test_ssd_wrapper_agrees_with_its_source():
    """No compiler here: the wrapper's tile sizes and limits are read back
    from the CUDA source, so the two cannot drift apart."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert const("TQ") == const("TK") == tssd._TQ == tssd._TK
    assert const("P") == tssd._P
    assert const("NS_MAX") == tssd.NS_MAX
    assert tssd.smem_bytes(256, 128) == 110_848      # the source's header
    assert "ssd_scan" in _build.KERNELS and "ssd_scan" in _build.LAUNCHES
