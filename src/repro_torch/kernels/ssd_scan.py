"""Mamba2 SSD chunked scan: CUDA kernel for Hopper and its plain PyTorch
version.

Replaces the Pallas TPU kernel `repro/kernels/ssd_scan.py:_ssd_kernel`
(`pl.pallas_call` at line 89).  x (B, nC, Q, nh, hp), B and C
(B, nC, Q, ns) shared by every head, dt (B, nC, Q, nh) and one negative
decay rate A per head; h0 = 0.  Per (batch, head) the chunks run in
order and carry the state h (ns, hp):

    La = cumsum(dt * A)
    y  = (C B^T o causal exp(La_i - La_j) o dt_j) x + (C o exp(La)) h
    h <- h exp(La_last) + (B o exp(La_last - La) dt)^T x

  * `csrc/ssd_scan.cu`: the chunk loop inside one block per (32 columns
    of hp, head, batch), the state in shared memory, the Q x Q term in
    64 x 64 tiles masked before the exp (see the source's header);
  * `ssd_scan_plain`: the chunk loop of `_ssd_kernel` in float32, over
    every (batch, head) at once.  A CPU tensor runs it; a CUDA tensor
    launches the kernel or raises.  Its masked entries are -inf before
    the exp, so autograd through it (the mixer's backward) sees no inf.

`ssd_scan_fwd` returns y in float32, the form the mixer adds D x to;
`ssd_scan` is the reference op's signature and rounds y to x's type.  The
TPU's 128-lane broadcast of dt is gone.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

F32 = torch.float32
_DTYPES = {F32: 0, torch.bfloat16: 1}
_TQ = _TK = 64                 # csrc TQ, TK
_P = 32                        # csrc P: columns of hp per block
NS_MAX = 256                   # csrc NS_MAX
SMEM_OPTIN = 232_448           # a block's shared-memory limit


def smem_bytes(Q: int, ns: int) -> int:
    """Dynamic shared memory of one block (csrc `smem_bytes`)."""
    qp = -(-Q // _TK) * _TK
    return 4 * (ns * (2 * (_TQ + 1) + _P) + _TK * _P + _TQ * (_TK + 1)
                + 3 * qp)


def _lib():
    lib = _build.load("ssd_scan")
    if lib.ssd_scan_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_fwd.argtypes = [P] * 7 + [I] * 8 + [P]
        lib.ssd_scan_fwd.restype = ctypes.c_int
    return lib


def ssd_scan_plain(x, Bm, Cm, dt, A):
    """The chunk loop of `_ssd_kernel` in float32.  -> (y (B, nC, Q, nh,
    hp) float32, h_final (B, nh, ns, hp) float32)."""
    Bsz, nC, Q, nh, hp = x.shape
    ns = Bm.shape[-1]
    dev = x.device
    A = A.to(F32)[:, None]
    above = ~torch.ones(Q, Q, dtype=torch.bool, device=dev).tril()
    h = torch.zeros(Bsz, nh, ns, hp, dtype=F32, device=dev)
    ys = []
    for c in range(nC):
        xq = x[:, c].to(F32).transpose(1, 2)            # (B, nh, Q, hp)
        Bq, Cq = Bm[:, c].to(F32), Cm[:, c].to(F32)     # (B, Q, ns)
        dtq = dt[:, c].to(F32).transpose(1, 2)          # (B, nh, Q)
        La = torch.cumsum(dtq * A, dim=-1)
        seg = (La[..., :, None] - La[..., None, :]).masked_fill(
            above, float("-inf"))
        W = (Cq @ Bq.transpose(1, 2))[:, None] * torch.exp(seg) \
            * dtq[..., None, :]                         # (B, nh, Q, Q)
        y = W @ xq + (Cq[:, None] * torch.exp(La)[..., None]) @ h
        w = torch.exp(La[..., -1:] - La) * dtq          # (B, nh, Q)
        h = h * torch.exp(La[..., -1])[..., None, None] \
            + (Bq[:, None] * w[..., None]).transpose(-1, -2) @ xq
        ys.append(y.transpose(1, 2))
    return torch.stack(ys, dim=1), h


def _check(x, Bm, Cm, dt, A):
    if x.dim() != 5 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan: bad shapes x {tuple(x.shape)} B "
                         f"{tuple(Bm.shape)} C {tuple(Cm.shape)}")
    Bsz, nC, Q, nh, hp = x.shape
    if tuple(Bm.shape[:3]) != (Bsz, nC, Q) \
            or tuple(dt.shape) != (Bsz, nC, Q, nh) or tuple(A.shape) != (nh,):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, B/C "
                         f"{tuple(Bm.shape)}, dt {tuple(dt.shape)} and A "
                         f"{tuple(A.shape)} disagree")
    if min(x.shape) < 1 or Bm.shape[-1] < 1:
        raise ValueError("ssd_scan: empty input")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    for name, t, want in (("B", Bm, x.dtype), ("C", Cm, x.dtype),
                          ("dt", dt, F32), ("A", A, F32)):
        if t.device != x.device or t.dtype != want:
            raise ValueError(f"ssd_scan: {name} is {t.dtype} on {t.device}; "
                             f"want {want} on {x.device}")
    for name, t in (("x", x), ("B", Bm), ("C", Cm), ("dt", dt), ("A", A)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: dtype {x.dtype} not supported")
    ns = Bm.shape[-1]
    if hp % _P or ns > NS_MAX:
        raise ValueError(f"ssd_scan: head_dim {hp} must be a multiple of "
                         f"{_P} and ssm_state {ns} at most {NS_MAX}")
    if smem_bytes(Q, ns) > SMEM_OPTIN:
        raise ValueError(f"ssd_scan: chunk {Q} with ssm_state {ns} needs "
                         f"{smem_bytes(Q, ns)} bytes of shared memory")


def _scan(x, Bm, Cm, dt, A, out_dtype):
    _check(x, Bm, Cm, dt, A)
    if x.device.type == "cpu":
        y, h = ssd_scan_plain(x, Bm, Cm, dt, A)
        return y.to(out_dtype), h
    Bsz, nC, Q, nh, hp = x.shape
    ns = Bm.shape[-1]
    lib = _lib()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    h = torch.empty(Bsz, nh, ns, hp, dtype=F32, device=x.device)
    rc = lib.ssd_scan_fwd(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
        A.data_ptr(), y.data_ptr(), h.data_ptr(), _DTYPES[x.dtype],
        _DTYPES[out_dtype], Bsz, nC, Q, nh, hp, ns,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "ssd_scan")
    _build.LAUNCHES["ssd_scan"] += 1
    return y, h


def ssd_scan_fwd(x, Bm, Cm, dt, A):
    """x: (B, nC, Q, nh, hp); Bm/Cm: (B, nC, Q, ns) in x's type; dt:
    (B, nC, Q, nh) float32; A: (nh,) float32.  -> (y like x in float32,
    h_final (B, nh, ns, hp) float32)."""
    return _scan(x, Bm, Cm, dt, A, F32)


def ssd_scan(x, Bm, Cm, dt, A):
    """The reference's `ops.ssd_scan` signature (its `interpret` argument
    has no counterpart): -> (y like x in x's type, h_final float32)."""
    return _scan(x, Bm, Cm, dt, A, x.dtype)
