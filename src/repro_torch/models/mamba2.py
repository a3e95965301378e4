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

Placed (`place=`, a `distributed.placement.LayerPlace`): each rank runs
the heads that `mamba2_specs` gives it (A_log's entry: "model" where the
heads divide it), see `_mixer_placed` and `_step_placed`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import FSDP, TP
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


def mamba2_specs() -> dict:
    """Logical dims of each leaf of `init_mamba2`'s tree, one layer."""
    return {
        "norm": (None,), "wx": (FSDP, TP), "wz": (FSDP, TP),
        "wB": (FSDP, None), "wC": (FSDP, None), "wdt": (FSDP, TP),
        "conv_w": (TP, None), "A_log": (TP,), "D": (TP,),
        "dt_bias": (TP,), "gated_norm": (TP,), "wout": (TP, FSDP),
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


def mamba2_mixer(p, xin, cfg, place=None):
    """Training/prefill forward.  xin: (B, L, d) -> (B, L, d), and the
    final (ssm (B, nh, ns, hp) float32, conv (B, K-1, conv_dim)) state for
    the cache hand-off; conv is the raw window `mamba2_step` keeps.  With
    `place` see `_mixer_placed`."""
    if place is not None:
        return _mixer_placed(p, xin, cfg, place)
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
    # zeros if L < K-1; a copy, since a view would keep the whole
    # (B, L, conv_dim) stream alive in the prefill's cache
    conv_tail = F.pad(raw, (0, 0, K - 1, 0))[:, -(K - 1):].clone()
    return xin + out, (h_last, conv_tail.to(xin.dtype))


def mamba2_step(p, xin, state, cfg, place=None):
    """Decode step.  xin: (B, d); state = (ssm (B, nh, ns, hp) float32,
    conv (B, K-1, conv_dim)).  Returns (out (B, d), (ssm, conv)), the new
    state as new tensors.  With `place` see `_step_placed`."""
    if place is not None:
        return _step_placed(p, xin, state, cfg, place)
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


# ----------------------------------------------------------------------
# placed: this rank's heads
# ----------------------------------------------------------------------
def _heads(lp, cfg):
    """(entry the heads are split over: A_log's, unless it also cuts the
    batch (`Placement.split`); this rank's first x channel, its x
    channels, its heads)."""
    hx = lp.plc.split(tuple(lp.spec["A_log"])[0])
    nl = cfg.ssm_heads // lp.plc.count(hx)
    dl = nl * cfg.ssm_head_dim
    return hx, lp.plc.index(hx) * dl, dl, nl


def _proj_placed(p, h, lp, hx):
    """`_proj` for this rank's heads: x and z of its heads (the columns of
    wx, wz), dt of every head cut to its heads, B and C whole; every
    weight's fsdp dim gathered first."""
    plc, s = lp.plc, lp.spec

    def mm(name, cols):
        return h @ plc.take(p[name], s[name], (None, cols))

    # dt of every head, then this rank's: a product of another width
    # rounds differently, and the scan's decays magnify dt's rounding
    dt = mm("wdt", None).to(F32) \
        + plc.take(p["dt_bias"], s["dt_bias"], (None,)).to(F32)
    dt = plc.block(F.softplus(dt), hx, dt.dim() - 1).contiguous()
    return mm("wx", hx), mm("wz", hx), mm("wB", None), mm("wC", None), dt


def _gated_norm_placed(y, p, lp, hx, di: int):
    """`rms_norm(y, gated_norm)` over the whole d_inner of which `y` holds
    this rank's channels: the float32 sum of squares all-reduced over
    the heads' axes, the mean over d_inner, eps 1e-6, scale 1 + g."""
    plc = lp.plc
    g = plc.take(p["gated_norm"], lp.spec["gated_norm"], (hx,))
    ss = plc.all_reduce(y.to(F32).square().sum(dim=-1, keepdim=True), hx)
    out = y.to(F32) * torch.rsqrt(ss / di + 1e-6)
    return (out * (1.0 + g.to(F32))).to(y.dtype)


def _conv_rows(w, cfg, c0: int, dl: int):
    """The rows of the depthwise conv's whole weight `w` (conv_dim, K)
    for this rank's x channels [c0, c0 + dl) and the B and C channels.
    -> (channel index, rows (n, K))."""
    di, ns = cfg.d_inner, cfg.ssm_state
    idx = torch.cat([torch.arange(c0, c0 + dl, device=w.device),
                     torch.arange(di, di + 2 * ns, device=w.device)])
    return idx, w[idx]


def _mixer_placed(p, xin, cfg, lp):
    """`mamba2_mixer` on one rank of a placed prefill.  xin: this rank's
    rows (B, L_local, d), its sequence block under `plc.seq` (gathered
    whole first: the scan runs over the whole sequence).  The rank runs
    its heads (`_heads`): their x and z columns, dt, B and C whole, the
    conv over its channels and the chunk scan kernel on (B, nC, Q,
    nh_local, hp).  Then the gated output of every head is all-gathered
    (B L d_inner elements, a row-parallel `wout`'s all-reduce's bytes
    where d_inner = 2 d_model) and normed and projected whole on every
    rank, so the residual stream is one process's bit for bit: the
    scan's decays are differences of chunk-long cumulative sums of dt,
    whose rounding a one-ulp change in the next layer's input flips,
    which moves its state by about 1e-5 relative (a row-parallel `wout`
    did, on the card, at mamba2-1.3b's width).  The cache: this
    rank's heads' final state and its block of the raw conv window (the
    last K-1 rows of [x, B, C], x's channels all-gathered), each fitted
    to the cache's spec; a train step's layer (no cache specs) returns
    None for them.  The scan is `_SSD` (the kernel forward, the plain
    chunk scan's backward) and every collective differentiates, so the
    replicated residual's gradient is each model rank's share: the loss
    weighs a token held by r ranks 1/r (`transformer.loss_placed`)."""
    plc = lp.plc
    nh, hp, ns, K = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_conv
    hx, c0, dl, nl = _heads(lp, cfg)
    seq = plc.seq
    h = rms_norm(xin, p["norm"])
    if seq is not None:
        h = plc.all_gather(h, seq, 1)
    B, L, _ = h.shape
    Q = min(cfg.ssm_chunk, L)
    if L % Q:
        raise ValueError(f"mamba2: sequence length {L} is not a multiple "
                         f"of the chunk {Q}")
    nC = L // Q
    x, z, Bm, Cm, dt = _proj_placed(p, h, lp, hx)
    # conv_w is cut over "model" as one contiguous block of conv_dim,
    # which does not line up with the heads: gathered whole
    _, w = _conv_rows(plc.take(p["conv_w"], lp.spec["conv_w"],
                               (None, None)), cfg, c0, dl)
    raw = torch.cat([x, Bm, Cm], dim=-1)
    stream = _causal_conv(raw, w)
    xs, Bs, Cs = stream.split([dl, ns, ns], dim=-1)
    A = -torch.exp(plc.take(p["A_log"], lp.spec["A_log"], (hx,)).to(F32))
    y, h_last = _SSD.apply(xs.reshape(B, nC, Q, nl, hp).contiguous(),
                           Bs.reshape(B, nC, Q, ns).contiguous(),
                           Cs.reshape(B, nC, Q, ns).contiguous(),
                           dt.reshape(B, nC, Q, nl), A)
    D = plc.take(p["D"], lp.spec["D"], (hx,)).to(F32)
    y = y.reshape(B, L, nl, hp) + D[:, None] * xs.reshape(B, L, nl, hp) \
        .to(F32)
    y = y.reshape(B, L, dl).to(xin.dtype)
    y = y * F.silu(z.to(F32)).to(xin.dtype)
    # the whole d_inner on every rank, normed and projected whole: the
    # next layer's dt must see one process's residual bit for bit
    if hx is not None:
        y = plc.all_gather(y, hx, 2)
    y = rms_norm(y, plc.take(p["gated_norm"], lp.spec["gated_norm"],
                             (None,)))
    out = y @ plc.take(p["wout"], lp.spec["wout"], (None, None))
    if seq is not None:
        out = plc.block(out, seq, 1)
    cs = lp.cache
    if cs is None:                                 # a train step
        return xin + out, None
    # the raw window: the last K-1 rows of [x, B, C] (zeros if L < K-1)
    tail = F.pad(raw, (0, 0, K - 1, 0))[:, -(K - 1):]
    xt, rest = tail.split([dl, 2 * ns], dim=-1)
    tail = torch.cat([plc.all_gather(xt, hx, 2) if hx is not None else xt,
                      rest], dim=-1)
    conv = plc.block(tail, cs["conv"][2], 2).to(xin.dtype).contiguous()
    ssm = plc.take(h_last, (cs["ssm"][0], hx), cs["ssm"][:2]).contiguous()
    return xin + out, (ssm, conv)


def _step_placed(p, xin, state, cfg, lp):
    """`mamba2_step` on one rank of a placed decode cell (the reference's
    `mamba2_step` under `plan_cell`'s decode shardings).  xin: this
    rank's rows (B, d); state: its blocks, the ssm state's heads and the
    conv window's contiguous block of conv_dim (`cache_specs`).

    The rank runs its heads (`_heads`): x, z, dt of their columns, B and
    C whole.  The conv window's blocks (and `conv_w`'s) do not line up
    with the heads, so the old window's blocks, `conv_w`'s and the new
    token's x channels are all-gathered over the heads' axes in one
    collective (B ((K-1) conv_dim + d_inner) + K conv_dim elements); the
    rank convolves its own channels
    and B, C, keeps its block of the new window, updates its heads' ssm
    state, norms over the whole d_inner (`_gated_norm_placed`), and
    `wout` is row-parallel (an all-reduce)."""
    plc = lp.plc
    ssm, conv = state
    B = xin.shape[0]
    nh, hp, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    hx, c0, dl, nl = _heads(lp, cfg)
    ce = lp.cache["conv"][2]
    h = rms_norm(xin, p["norm"])
    x, z, Bm, Cm, dt = _proj_placed(p, h, lp, hx)
    we = tuple(lp.spec["conv_w"])[0]
    if hx is not None and ce == hx and we == hx:     # one all-gather
        x_all, win, w = plc.all_gather_many(
            [x, conv.to(x.dtype), p["conv_w"].to(x.dtype)], hx, (1, 2, 0))
    else:
        x_all = plc.all_gather(x, hx, 1) if hx is not None else x
        win = plc.all_gather(conv, ce, 2) if ce is not None else conv
        w = plc.take(p["conv_w"], lp.spec["conv_w"], (None, None))
    col = torch.cat([x_all, Bm, Cm], dim=-1)                # (B, conv_dim)
    win = torch.cat([win.to(conv.dtype), col[:, None].to(conv.dtype)], dim=1)
    idx, w = _conv_rows(w, cfg, c0, dl)
    conv_out = F.silu(torch.einsum("bkc,ck->bc", win[:, :, idx].to(F32),
                                   w.to(F32)))
    xs = conv_out[:, :dl].reshape(B, nl, hp)
    Bv = conv_out[:, dl:dl + ns]
    Cv = conv_out[:, dl + ns:]
    A = -torch.exp(plc.take(p["A_log"], lp.spec["A_log"], (hx,)).to(F32))
    dec = torch.exp(dt * A)                                 # (B, nl)
    ssm_new = (ssm * dec[:, :, None, None]
               + Bv[:, None, :, None] * (dt[:, :, None] * xs)[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", Cv, ssm_new)
    D = plc.take(p["D"], lp.spec["D"], (hx,)).to(F32)
    y = y + D[None, :, None] * xs
    y = y.reshape(B, dl).to(xin.dtype)
    y = y * F.silu(z.to(F32)).to(xin.dtype)
    y = _gated_norm_placed(y, p, lp, hx, nh * hp)
    out = plc.all_reduce(y @ plc.take(p["wout"], lp.spec["wout"], (hx, None)),
                         hx)
    return xin + out, (ssm_new, plc.block(win[:, 1:], ce, 2))
