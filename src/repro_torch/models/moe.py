"""Mixture-of-Experts MLP with token-choice top-k routing and fixed expert
capacity (port of `repro/models/moe.py`).

One call is one token group (`moe_ffn`).  Dispatch is the reference's
argsort-based slotting: assignments are sorted by expert (stable), each
expert's slots c < C pull the c-th of its assignments through
`searchsorted` offsets into a dense (E, C, d) buffer, and the expert
products run over that buffer as batched matmuls.
Overflow beyond C = int(T * K / E * capacity_factor) (at least 1, at
most T) is dropped in that sorted order; `dropless=True` sets C = T.

The reference combines with a scatter-add over the expert-major (E * C)
slots, which on CUDA would be `index_add_`, whose atomics make a bf16
sum depend on arrival order.  The port gathers instead: each token finds
its K slots through the inverse of the sort and adds the gated outputs
from zeros in ascending expert order, in the model's dtype, which is the
order the reference's scatter-add follows.  Top-k is a stable descending
sort, so a tie at the K boundary goes to the lower expert id, as
`jax.lax.top_k` breaks it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import FSDP, TP
from .common import F32

WEIGHTS = ("router", "w_gate", "w_up", "w_down")


def init_moe(cfg, generator: torch.Generator, device):
    """Router (d, E) and expert weights (E, d, ff), (E, d, ff), (E, ff,
    d), drawn on `device` (normal, scaled by fan_in ** -0.5, then
    cast)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = getattr(torch, cfg.dtype)

    def mk(*shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=F32, device=device)
        return (w * fan_in ** -0.5).to(dt)

    return {"router": mk(d, E, fan_in=d),
            "w_gate": mk(E, d, ff, fan_in=d),
            "w_up": mk(E, d, ff, fan_in=d),
            "w_down": mk(E, ff, d, fan_in=ff)}


def moe_specs(ff_sharded: bool = False) -> dict:
    """Logical dims of each leaf of `init_moe`'s tree, one layer.  TP
    names both the expert dim and the ff dim: `param_specs`' first
    divisible dim takes it (experts when E divides the model axis, as
    qwen3's 128; the ff dim otherwise, as mixtral's 8 on a 16-way axis).
    `ff_sharded` (decode) is the weight-stationary layout: FSDP on the ff
    dim instead of d_model; "tp_fsdp" binds the model then the data
    axes."""
    if ff_sharded:
        return {"router": (None, None),
                "w_gate": (TP, None, "tp_fsdp"),
                "w_up": (TP, None, "tp_fsdp"),
                "w_down": (TP, "tp_fsdp", None)}
    return {"router": (FSDP, None),
            "w_gate": (TP, FSDP, TP),
            "w_up": (TP, FSDP, TP),
            "w_down": (TP, TP, FSDP)}


def capacity(T: int, cfg, dropless: bool = False) -> int:
    """Slots per expert for T tokens (`moe.py:89-90` of the reference)."""
    C = T if dropless else max(int(T * cfg.top_k / cfg.n_experts
                                   * cfg.capacity_factor), 1)
    return min(C, T)


def route(router, xf, cfg):
    """xf: (T, d) -> (gates (T, K) float32, renormalised; experts (T, K)
    int64).  The logits are computed in the model's dtype, then cast."""
    probs = torch.softmax((xf @ router).to(F32), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.top_k
    gates, eidx = top.values[:, :K], top.indices[:, :K]
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), eidx


def dispatch(eidx, E: int, C: int):
    """The reference's slotting of (T, K) expert choices.  Returns
    (order, starts, a_idx, valid): the stable sort of the flat
    assignments by expert, each expert's first position in it, and for
    each of the E * C slots (expert-major) the assignment it pulls and
    whether that assignment belongs to the slot's expert."""
    n = eidx.numel()
    dev = eidx.device
    e_flat = eidx.reshape(n)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    experts = torch.arange(E, device=dev)
    starts = torch.searchsorted(e_sorted, experts)
    pos = (starts[:, None] + torch.arange(C, device=dev)).reshape(E * C)
    pos_c = pos.clamp(0, n - 1)
    valid = (pos < n) & (e_sorted[pos_c] == experts.repeat_interleave(C))
    return order, starts, order[pos_c], valid


def ranks(eidx, order, starts):
    """(T, K): each assignment's place among its expert's assignments in
    the stable sort; it has a slot iff its rank is below C."""
    return (torch.argsort(order) - starts[eidx.reshape(-1)]).reshape(
        eidx.shape)


def kept(eidx, E: int, C: int) -> torch.Tensor:
    """(T, K) bool: which assignments found a slot."""
    order, starts, _, _ = dispatch(eidx, E, C)
    return ranks(eidx, order, starts) < C


def moe_ffn(p, x, cfg, dropless: bool = False):
    """x: (B, S, d) or (B, d) -> the same shape.

    Token groups: the reference views the step's T tokens as G = |moe_g|
    groups, one per data shard (`repro/models/moe.py:85-94`), and slots
    and drops within each; capacity is per group.  Here all of `x` is
    one group (G = 1), the reference on one device; a placed cell routes
    in the cell's |moe_g| groups (`moe_ffn_prefill_placed`, which the
    placed prefill and train steps run)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg, dropless)
    gates, eidx = route(p["router"], xf, cfg)

    # ---- dispatch: slot (e, c) pulls its token; empty slots are zero ----
    order, starts, a_idx, valid = dispatch(eidx, E, C)
    tok = torch.where(valid, a_idx // K, 0)
    eb = (xf[tok] * valid[:, None].to(xf.dtype)).reshape(E, C, d)

    # ---- expert FFN over the dense (E, C, d) buffer ----
    g = torch.bmm(eb, p["w_gate"])
    u = torch.bmm(eb, p["w_up"])
    h = F.silu(g.to(F32)).to(x.dtype) * u
    yb = torch.bmm(h, p["w_down"]).reshape(E * C, d)

    # ---- combine: each token gathers its K slots, ascending expert ----
    e_t, by_expert = torch.sort(eidx, dim=-1, stable=True)   # (T, K)
    rank = torch.gather(ranks(eidx, order, starts), 1, by_expert)
    hit = rank < C
    slot = torch.where(hit, e_t * C + rank, 0)
    w = (torch.gather(gates, 1, by_expert) * hit).to(yb.dtype)
    contrib = yb[slot] * w[..., None]                       # (T, K, d)
    y = torch.zeros_like(xf)
    for k in range(K):
        y = y + contrib[:, k]
    return y.reshape(orig_shape)


def aux_load_balance_loss(p, x, cfg):
    """Switch-style auxiliary loss (fraction * probability per expert)."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax((xf @ p["router"]).to(F32), dim=-1)
    top1 = probs.argmax(dim=-1)
    frac = F.one_hot(top1, cfg.n_experts).to(F32).mean(dim=0)
    imp = probs.mean(dim=0)
    return cfg.n_experts * torch.sum(frac * imp)


def moe_ffn_placed(p, x, cfg, plc, spec):
    """Dropless decode `moe_ffn` on one rank of a placed cell, in the
    reference's weight-stationary layout (`moe_specs(ff_sharded=True)`,
    `repro/models/moe.py:36-60`): experts over "model" where E divides
    it, ff over what "tp_fsdp" leaves; the router replicated.  No expert
    weight moves.  x: this rank's rows (B, d).

    Every rank of the layer's group (the axes the expert weights are
    split over) routes the same tokens: where that group spans the batch
    axis, the rows are all-gathered first.  Each rank runs every token
    through its experts' slice of ff (the dropless buffer is T tokens an
    expert, as `moe_ffn`'s with C = T), weighs each output by the token's
    gate on that expert (0 where the token did not choose it), sums over
    its experts in float32, and the partial sums are all-reduced over the
    group; this rank's rows are taken back at the end."""
    from ..distributed.placement import axes_of
    w_spec = tuple(spec["w_gate"])
    group = axes_of(w_spec[0]) + axes_of(w_spec[2])
    rows = bool(set(group) & set(axes_of(plc.batch_entry)))
    xa = plc.all_gather(x, plc.batch_entry, 0) if rows else x
    T, d = xa.shape
    gates, eidx = route(p["router"], xa, cfg)
    E = p["w_gate"].shape[0]
    local = eidx - plc.index(w_spec[0]) * E
    on = (local >= 0) & (local < E)
    w = torch.zeros(T, E, dtype=F32, device=x.device).scatter_add_(
        1, local.clamp(0, E - 1), gates * on)
    xe = xa.expand(E, T, d)
    g = torch.bmm(xe, p["w_gate"])
    u = torch.bmm(xe, p["w_up"])
    h = F.silu(g.to(F32)).to(x.dtype) * u
    yb = torch.bmm(h, p["w_down"])                       # (E, T, d)
    y = torch.einsum("te,etd->td", w, yb.to(F32))
    y = plc.all_reduce(y, tuple(a for a in ("data", "model") if a in group))
    if rows:
        n = x.shape[0]
        y = y[plc.index(plc.batch_entry) * n:][:n]
    return y.to(x.dtype)


def moe_ffn_prefill_placed(p, h, cfg, plc, spec):
    """`moe_ffn` of a placed prefill (capacity-dropping, the reference's
    token groups), in the prefill layout (`moe_specs(ff_sharded=False)`):
    experts over tp where E divides it, else the ff dim; d_model over
    fsdp, gathered before use.  h: this rank's tokens (B, S_local, d),
    rows over `plc.batch_entry`, the sequence over `plc.seq`.

    The reference cuts the step's T tokens, in (row, position) order, into
    G = `plc.moe_groups` groups of T / G and slots and drops within each
    (`repro/models/moe.py:85-94`).  The ranks that split the expert work
    (the tp axes) must see the same tokens, and a group must be whole:
    the rank all-gathers its tokens along the sequence (`plc.seq`) and
    along the rows over the batch axes that the experts are split over,
    which leaves a contiguous run of whole groups.  Each group routes,
    takes its slots of this rank's experts (`dispatch`, C = `capacity`
    of the group), runs them on this rank's slice of the weights, and
    each token gathers its kept slots in ascending expert order; the
    float32 partial sums go back to the rank's tokens by a reduce-scatter
    over the tp axes (an all-reduce and a cut where two dims were
    gathered)."""
    from ..distributed.placement import AXES, axes_of
    ws = tuple(spec["w_gate"])
    e_entry, f_entry = ws[0], ws[2]
    split = set(axes_of(e_entry) + axes_of(f_entry))
    split_entry = tuple(a for a in AXES if a in split) or None
    batch = axes_of(plc.batch_entry)
    rows = tuple(a for a in batch if a in split)
    if rows and batch[len(batch) - len(rows):] != rows:
        raise ValueError(f"experts over {rows} do not gather contiguous "
                         f"rows of a batch over {batch}")
    gathered = []
    x = h
    if rows:
        gathered.append((0, rows))
        x = plc.all_gather(x, rows, 0)
    if plc.seq is not None:
        gathered.append((1, plc.seq))
        x = plc.all_gather(x, plc.seq, 1)
    Bg, Sg, d = x.shape
    T = h.shape[0] * plc.count(plc.batch_entry) * h.shape[1] \
        * plc.count(plc.seq)
    G = plc.moe_groups if T % plc.moe_groups == 0 else 1
    if (Bg * Sg * G) % T:
        raise ValueError(f"{Bg * Sg} gathered tokens are no whole number "
                         f"of the step's {G} groups of {T // G}")
    n_groups = Bg * Sg * G // T
    xf = x.reshape(n_groups, -1, d)
    Tg = xf.shape[1]
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(Tg, cfg)
    router = plc.take(p["router"], spec["router"], (None, None))
    w_gate = plc.take(p["w_gate"], spec["w_gate"], (e_entry, None, f_entry))
    w_up = plc.take(p["w_up"], spec["w_up"], (e_entry, None, f_entry))
    w_down = plc.take(p["w_down"], spec["w_down"], (e_entry, f_entry, None))
    El = w_gate.shape[0]
    e0 = plc.index(e_entry) * El
    ys = []
    for xg in xf:
        gates, eidx = route(router, xg, cfg)
        order, starts, a_idx, valid = dispatch(eidx, E, C)
        a_idx, valid = a_idx[e0 * C:(e0 + El) * C], valid[e0 * C:(e0 + El)
                                                          * C]
        tok = torch.where(valid, a_idx // K, 0)
        eb = (xg[tok] * valid[:, None].to(xg.dtype)).reshape(El, C, d)
        g = torch.bmm(eb, w_gate)
        u = torch.bmm(eb, w_up)
        hh = F.silu(g.to(F32)).to(h.dtype) * u
        yb = torch.bmm(hh, w_down).reshape(El * C, d)
        e_t, by_expert = torch.sort(eidx, dim=-1, stable=True)
        rank = torch.gather(ranks(eidx, order, starts), 1, by_expert)
        hit = (rank < C) & (e_t >= e0) & (e_t < e0 + El)
        slot = torch.where(hit, (e_t - e0) * C + rank, 0)
        w = torch.gather(gates, 1, by_expert) * hit
        contrib = yb[slot].to(F32) * w[..., None]            # (Tg, K, d)
        y = torch.zeros(Tg, d, dtype=F32, device=h.device)
        for k in range(K):
            y = y + contrib[:, k]
        ys.append(y)
    y = torch.stack(ys).reshape(Bg, Sg, d)
    if len(gathered) == 1 and split_entry is not None \
            and set(axes_of(gathered[0][1])) == split:
        y = plc.reduce_scatter(y, split_entry, gathered[0][0])
    else:
        y = plc.all_reduce(y, split_entry)
        for dim, entry in gathered:
            y = plc.block(y, entry, dim)
    return y.to(h.dtype)
