"""Mamba2 mixer (SSD — state-space duality, arXiv:2405.21060), port of
`repro/models/mamba2.py`.

Training/prefill uses the chunked SSD form: the within-chunk quadratic
term and the cross-chunk state recurrence, computed by the hand-written
scan kernel (`kernels.ops.ssd_scan_fwd`; its plain chunk loop on the
CPU).  Its backward recomputes the plain chunk scan under autograd: the
reference has no SSD backward kernel either (it differentiates through
`jax.lax.scan`).  Decode is the O(1) recurrent update.

As the reference: ngroups 1, no (B, C) activation norm, the depthwise
causal conv over the concatenated [x, B, C] stream.

One deliberate difference: the reference's mixer hands decode the last
K-1 rows of the *post-conv, post-SiLU* stream (`mamba2.py:144-146`),
while its decode step keeps the *raw pre-conv* projections as its conv
window (`:158-159`), so decoding from a prefilled cache goes wrong.  The
port's mixer hands off the raw window, the one decode builds.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ssd_scan import ssd_scan_plain
from .common import F32, rms_norm

# the parameters of one mamba2 block, and those kept in float32 whatever
# the model's dtype (as the reference's `init_mamba2` keeps them)
WEIGHTS = ("norm", "wx", "wz", "wB", "wC", "wdt", "conv_w", "A_log", "D",
           "dt_bias", "gated_norm", "wout")
F32_WEIGHTS = ("A_log", "D", "dt_bias")


def init_mamba2(cfg, generator: torch.Generator, device):
    """Params of one mamba2 block, drawn on `device` from `generator`
    (normal, scaled by fan_in ** -0.5, then cast); A = -1, D = 1, as the
    reference's `init_mamba2`."""
    d = cfg.d_model
    nh, hp, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = nh * hp
    dt = getattr(torch, cfg.dtype)

    def mk(*shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=F32, device=device)
        return (w * fan_in ** -0.5).to(dt)

    def full(val, n, dtype=F32):
        return torch.full((n,), val, dtype=dtype, device=device)

    return {
        "norm": full(0.0, d, dt),
        "wx": mk(d, di, fan_in=d),
        "wz": mk(d, di, fan_in=d),
        "wB": mk(d, ns, fan_in=d),
        "wC": mk(d, ns, fan_in=d),
        "wdt": mk(d, nh, fan_in=d),
        "conv_w": mk(di + 2 * ns, cfg.ssm_conv, fan_in=cfg.ssm_conv),
        "A_log": full(0.0, nh),          # A = -exp(A_log) = -1
        "D": full(1.0, nh),
        "dt_bias": full(0.0, nh),
        "gated_norm": full(0.0, di, dt),
        "wout": mk(di, d, fan_in=di),
    }


def _proj(p, h):
    x = h @ p["wx"]
    z = h @ p["wz"]
    Bm = h @ p["wB"]
    Cm = h @ p["wC"]
    dt = F.softplus((h @ p["wdt"]).to(F32) + p["dt_bias"].to(F32))
    return x, z, Bm, Cm, dt


def _causal_conv(stream, w):
    """Depthwise causal conv as the sum of K shifted slices in float32
    (no cuDNN, whose float32 convolution runs in TF32 on the card), then
    SiLU.  stream: (B, L, C); w: (C, K) -> (B, L, C) in stream's type."""
    L, K = stream.shape[1], w.shape[-1]
    pad = F.pad(stream.to(F32), (0, 0, K - 1, 0))
    w = w.to(F32)
    out = sum(pad[:, k:k + L] * w[:, k] for k in range(K))
    return F.silu(out).to(stream.dtype)


class _SSD(torch.autograd.Function):
    """Forward: the scan kernel (y in float32).  Backward: autograd
    through the plain chunk scan, recomputed from the inputs."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, dt, A):
        y, h = ops.ssd_scan_fwd(x, Bm, Cm, dt, A)
        ctx.save_for_backward(x, Bm, Cm, dt, A)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, h = ssd_scan_plain(*inputs)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad((y, h), wrt, (dy, dh)))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs)


def mamba2_mixer(p, xin, cfg):
    """Training/prefill forward.  xin: (B, L, d) -> (B, L, d), and the
    final (ssm (B, nh, ns, hp) float32, conv (B, K-1, conv_dim)) state for
    the cache hand-off; conv is the raw window `mamba2_step` keeps."""
    B, L, _ = xin.shape
    nh, hp, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = nh * hp
    Q = min(cfg.ssm_chunk, L)
    if L % Q:
        raise ValueError(f"mamba2: sequence length {L} is not a multiple "
                         f"of the chunk {Q}")
    nC = L // Q
    h = rms_norm(xin, p["norm"])
    x, z, Bm, Cm, dt = _proj(p, h)
    raw = torch.cat([x, Bm, Cm], dim=-1)
    stream = _causal_conv(raw, p["conv_w"])
    x, Bm, Cm = stream.split([di, ns, ns], dim=-1)
    A = -torch.exp(p["A_log"].to(F32))
    y, h_last = _SSD.apply(x.reshape(B, nC, Q, nh, hp).contiguous(),
                           Bm.reshape(B, nC, Q, ns).contiguous(),
                           Cm.reshape(B, nC, Q, ns).contiguous(),
                           dt.reshape(B, nC, Q, nh), A)
    y = y.reshape(B, L, nh, hp) \
        + p["D"].to(F32)[:, None] * x.reshape(B, L, nh, hp).to(F32)
    y = y.reshape(B, L, di).to(xin.dtype)
    y = y * F.silu(z.to(F32)).to(xin.dtype)                 # gate
    y = rms_norm(y, p["gated_norm"])
    out = y @ p["wout"]
    K = cfg.ssm_conv
    conv_tail = F.pad(raw, (0, 0, K - 1, 0))[:, -(K - 1):]   # zeros if L < K-1
    return xin + out, (h_last, conv_tail.to(xin.dtype))


def mamba2_step(p, xin, state, cfg):
    """Decode step.  xin: (B, d); state = (ssm (B, nh, ns, hp) float32,
    conv (B, K-1, conv_dim)).  Returns (out (B, d), (ssm, conv)), the new
    state as new tensors."""
    ssm, conv = state
    B = xin.shape[0]
    nh, hp, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = nh * hp
    h = rms_norm(xin, p["norm"])
    x, z, Bm, Cm, dt = _proj(p, h)
    new_col = torch.cat([x, Bm, Cm], dim=-1)                # (B, conv_dim)
    win = torch.cat([conv, new_col[:, None].to(conv.dtype)], dim=1)
    conv_out = F.silu(torch.einsum("bkc,ck->bc", win.to(F32),
                                   p["conv_w"].to(F32)))
    x = conv_out[:, :di].reshape(B, nh, hp)
    Bv = conv_out[:, di:di + ns]
    Cv = conv_out[:, di + ns:]
    A = -torch.exp(p["A_log"].to(F32))
    dec = torch.exp(dt * A)                                 # (B, nh)
    ssm_new = (ssm * dec[:, :, None, None]
               + Bv[:, None, :, None] * (dt[:, :, None] * x)[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", Cv, ssm_new)
    y = y + p["D"].to(F32)[None, :, None] * x
    y = y.reshape(B, di).to(xin.dtype)
    y = y * F.silu(z.to(F32)).to(xin.dtype)
    y = rms_norm(y, p["gated_norm"])
    out = y @ p["wout"]
    return xin + out, (ssm_new, win[:, 1:])
