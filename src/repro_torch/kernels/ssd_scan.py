"""Mamba2 SSD chunked scan: CUDA kernels for Hopper and their plain
PyTorch versions.

Replaces the Pallas TPU kernel `repro/kernels/ssd_scan.py:_ssd_kernel`
(`pl.pallas_call` at line 89).  x (B, nC, Q, nh, hp), B and C
(B, nC, Q, ns) shared by every head, dt (B, nC, Q, nh) and one negative
decay rate A per head; h0 = 0.  Per (batch, head) the chunks run in
order and carry the state h (ns, hp):

    La = cumsum(dt * A)
    y  = (C B^T o causal exp(La_i - La_j) o dt_j) x + (C o exp(La)) h
    h <- h exp(La_last) + (B o exp(La_last - La) dt)^T x

  * bfloat16 on the card, `csrc/ssd_scan.cu:ssd_scan_bf16`: four
    launches per op call, parallel over chunks, every product on the
    tensor cores: C B^T once per chunk; La and the chunk states; the
    state passing over the chunks (float32); the chunk outputs, masked
    before the exp (see the source's header).  The wrapper allocates
    their scratch;
  * float32 on the card, `csrc/ssd_scan.cu:ssd_scan_fwd`: one launch, the
    chunk loop inside one block per (32 columns of hp, head, batch),
    products on the CUDA cores;
  * `ssd_scan_plain`: the chunk loop of `_ssd_kernel` in float32, over
    every (batch, head) at once.  A CPU tensor runs it; a CUDA tensor
    launches a kernel or raises.  Its masked entries are -inf before
    the exp, so autograd through it (the mixer's backward) sees no inf;
  * `ssd_scan_passes_plain`: the four bf16 passes in plain PyTorch, with
    the kernel's bf16 roundings on request; for the tests only.

`LAUNCHES["ssd_scan"]` counts op calls, one per call of `ssd_scan_fwd` or
`ssd_scan`, whichever kernel runs.  `ssd_scan_fwd` returns y in float32,
the form the mixer adds D x to; `ssd_scan` is the reference op's
signature and rounds y to x's type.  The TPU's 128-lane broadcast of dt
is gone.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

F32, BF16 = torch.float32, torch.bfloat16
_DTYPES = {F32: 0, BF16: 1}
_TQ = _TK = 64                 # csrc TQ, TK
_P = 32                        # csrc P: columns of hp per block (float32)
NS_MAX = 256                   # csrc NS_MAX
_MT = 64                       # csrc MT: tile rows of the bf16 passes
_MPAD = 8                      # csrc MPAD: bf16 padding per shared row
_CBS = _MT + 8                 # csrc CBS: floats per staged C B^T row
HP_BF16 = (32, 64, 128)        # csrc dispatch_hp; HP_MAX = 128
SMEM_OPTIN = 232_448           # a block's shared-memory limit


def smem_bytes(Q: int, ns: int) -> int:
    """Dynamic shared memory of one block of the float32 kernel (csrc
    `smem_bytes`)."""
    qp = -(-Q // _TK) * _TK
    return 4 * (ns * (2 * (_TQ + 1) + _P) + _TK * _P + _TQ * (_TK + 1)
                + 3 * qp)


def pass_smem_bytes(Q: int, ns: int, hp: int) -> dict:
    """Dynamic shared memory of one block of each bf16 pass (csrc
    `cb_smem`, `state_smem`, `out_smem`; the state passing takes none)."""
    qt = -(-Q // _MT) * _MT
    stage = 2 * _MT * (hp + _MPAD) + 4 * _MT * _CBS
    head = 2 * (_MT * (ns + _MPAD) + ns * (hp + _MPAD))
    return {"cb": 2 * 2 * _MT * (ns + _MPAD),
            "states": 2 * 2 * _MT * (ns + hp + 2 * _MPAD) + 4 * 3 * qt,
            "outputs": max(head, stage) + stage + 4 * 2 * qt}


def _lib():
    lib = _build.load("ssd_scan")
    if lib.ssd_scan_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_fwd.argtypes = [P] * 7 + [I] * 6 + [P]
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_bf16.argtypes = [P] * 11 + [I] * 7 + [P]
        lib.ssd_scan_bf16.restype = ctypes.c_int
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


def ssd_scan_passes_plain(x, Bm, Cm, dt, A, rounded: bool = False):
    """The four passes of `ssd_scan_bf16` in plain PyTorch, for the tests:
    C B^T per chunk; La and the chunk states S_c = (B o u)^T x; the state
    passing h_in[c] = h, h <- h exp(La_last[c]) + S_c; the chunk outputs.
    With `rounded`, the operands round to bf16 where the kernel rounds
    them: B o u and W each as a high and a low part, h_in once.  -> (y
    (B, nC, Q, nh, hp) float32, h_final (B, nh, ns, hp) float32)."""
    Q = x.shape[2]

    def bf(t):
        return t.to(BF16).to(F32) if rounded else t

    def hi_lo(t):
        return bf(t) + bf(t - bf(t))

    xh = x.to(F32).permute(0, 1, 3, 2, 4)               # (B, nC, nh, Q, hp)
    Bf, Cf = Bm.to(F32), Cm.to(F32)                     # (B, nC, Q, ns)
    CB = Cf @ Bf.transpose(-1, -2)                      # (B, nC, Q, Q)
    dtq = dt.to(F32).permute(0, 1, 3, 2)                # (B, nC, nh, Q)
    La = torch.cumsum(dtq * A.to(F32)[:, None], dim=-1)
    u = torch.exp(La[..., -1:] - La) * dtq
    Bu = Bf[:, :, None] * u[..., None]                  # (B, nC, nh, Q, ns)
    S = hi_lo(Bu).transpose(-1, -2) @ xh
    h = torch.zeros_like(S[:, 0])
    h_in = []
    for c in range(x.shape[1]):
        h_in.append(h)
        h = h * torch.exp(La[:, c, :, -1])[..., None, None] + S[:, c]
    h_in = torch.stack(h_in, dim=1)
    above = ~torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = (La[..., :, None] - La[..., None, :]).masked_fill(
        above, float("-inf"))
    W = hi_lo(CB[:, :, None] * torch.exp(seg) * dtq[..., None, :])
    y = W @ xh + torch.exp(La)[..., None] * (Cf[:, :, None] @ bf(h_in))
    return y.permute(0, 1, 3, 2, 4), h


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
    if x.device.type in ("cpu", "meta"):
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
    if x.dtype == BF16:
        if hp not in HP_BF16:
            raise ValueError(f"ssd_scan: bfloat16 needs head_dim in "
                             f"{HP_BF16}, not {hp}")
        if ns % 16 or ns > NS_MAX:
            raise ValueError(f"ssd_scan: bfloat16 needs ssm_state a "
                             f"multiple of 16 up to {NS_MAX}, not {ns}")
        for name, t in (("x", x), ("B", Bm), ("C", Cm)):
            if t.data_ptr() % 16:
                raise ValueError(f"ssd_scan: {name} must be 16-byte "
                                 f"aligned")
        need = max(pass_smem_bytes(Q, ns, hp).values())
    else:
        if hp % _P or ns > NS_MAX:
            raise ValueError(f"ssd_scan: head_dim {hp} must be a multiple "
                             f"of {_P} and ssm_state {ns} at most {NS_MAX}")
        need = smem_bytes(Q, ns)
    if need > SMEM_OPTIN:
        raise ValueError(f"ssd_scan: chunk {Q} with ssm_state {ns} needs "
                         f"{need} bytes of shared memory")


def _scan(x, Bm, Cm, dt, A, out_dtype):
    _check(x, Bm, Cm, dt, A)
    if x.device.type == "meta":     # shapes only (a planner's dry run)
        Bsz, nC, Q, nh, hp = x.shape
        ns = Bm.shape[-1]
        # C B^T once a chunk; per head and chunk W x, C h and the update
        _build.META_FLOPS["ssd_scan"] += 2 * Bsz * nC * (
            Q * Q * ns + nh * (Q * Q * hp + 2 * Q * ns * hp))
        return (torch.empty(x.shape, dtype=out_dtype, device=x.device),
                torch.empty(Bsz, nh, Bm.shape[-1], hp, dtype=F32,
                            device=x.device))
    if x.device.type == "cpu":
        y, h = ssd_scan_plain(x, Bm, Cm, dt, A)
        return y.to(out_dtype), h
    Bsz, nC, Q, nh, hp = x.shape
    ns = Bm.shape[-1]
    dev = x.device
    lib = _lib()
    y = torch.empty(x.shape, dtype=out_dtype, device=dev)
    h = torch.empty(Bsz, nh, ns, hp, dtype=F32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if x.dtype == BF16:
        qt = -(-Q // _MT) * _MT
        cb = torch.empty(Bsz, nC, qt, qt, dtype=F32, device=dev)
        la = torch.empty(Bsz, nC, nh, qt, dtype=F32, device=dev)
        states = torch.empty(Bsz, nC, nh, ns, hp, dtype=F32, device=dev)
        h_in = torch.empty(states.shape, dtype=BF16, device=dev)
        rc = lib.ssd_scan_bf16(
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
            A.data_ptr(), y.data_ptr(), h.data_ptr(), cb.data_ptr(),
            la.data_ptr(), states.data_ptr(), h_in.data_ptr(),
            _DTYPES[out_dtype], Bsz, nC, Q, nh, hp, ns, stream)
    else:
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
            A.data_ptr(), y.data_ptr(), h.data_ptr(), Bsz, nC, Q, nh, hp,
            ns, stream)
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
