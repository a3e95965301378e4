"""GQA attention block: train/prefill forward and single-token decode
(port of `repro/models/attention.py`).

The forward's attention core is `common.flash_attention`, whose forward
is the hand-written flash kernel.  The decode cache is head-major
(B, KV, S_max, hd), the layout of the reference's `init_cache`; the
decode core is the hand-written decode kernel
(`kernels.ops.decode_attention_head_major`), which reads that layout in
place, and an int8 cache (`cfg.kv_quant`) with its per-(token, head)
float32 scales: with a bf16 model one call
(`kernels.ops.decode_attention_int8_append`) quantizes the new token
(`quantize_kv`, kept in `kernels/ref.py`), writes it and attends.  A
windowed layer's decode cache is a ring buffer of its window
(`models/transformer.py:decode_step` passes the write slot and the valid
length), so decode needs no window mask.  Both take an
`mlp_fn` in place of the block's SwiGLU (the `moe` block's expert MLP,
`models/moe.py`).
"""
from __future__ import annotations

import torch

from ..distributed.placement import axes_of
from ..distributed.sharding import FSDP, TP
from ..kernels import ops
from ..kernels.ref import quantize_kv
from .common import F32, flash_attention, rms_norm, rope, swiglu


# the parameters of one attention(+MLP) block; ATTN_WEIGHTS without the
# SwiGLU's, which a `moe` block replaces with its nested "moe" dict
ATTN_WEIGHTS = ("norm1", "wq", "wk", "wv", "wo", "norm2")
WEIGHTS = ATTN_WEIGHTS + ("w_gate", "w_up", "w_down")


def init_attn_block(cfg, d_ff: int | None, generator: torch.Generator,
                    device):
    """Params of one attention(+MLP) block, drawn on `device` from
    `generator` (normal, scaled by fan_in ** -0.5, then cast); with
    `d_ff` None, the attention half only."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)

    def mk(*shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=F32, device=device)
        return (w * fan_in ** -0.5).to(dt)

    p = {
        "norm1": torch.zeros(d, dtype=dt, device=device),
        "wq": mk(d, H, hd, fan_in=d),
        "wk": mk(d, KV, hd, fan_in=d),
        "wv": mk(d, KV, hd, fan_in=d),
        "wo": mk(H, hd, d, fan_in=H * hd),
        "norm2": torch.zeros(d, dtype=dt, device=device),
    }
    if d_ff is not None:
        p.update(w_gate=mk(d, d_ff, fan_in=d), w_up=mk(d, d_ff, fan_in=d),
                 w_down=mk(d_ff, d, fan_in=d_ff))
    return p


def attn_specs() -> dict:
    """Logical dims of each leaf of `init_attn_block`'s tree, one layer
    (the reference's `attn_specs(stacked=False)`)."""
    return {
        "norm1": (None,),
        "wq": (FSDP, TP, None),
        "wk": (FSDP, TP, None),      # falls back to None if KV % tp != 0
        "wv": (FSDP, TP, None),
        "wo": (TP, None, FSDP),
        "norm2": (None,),
        "w_gate": (FSDP, TP),
        "w_up": (FSDP, TP),
        "w_down": (TP, FSDP),
    }


def _mlp(p, h, mlp_fn):
    if mlp_fn is not None:
        return mlp_fn(h)
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def _qkv(p, x, positions, cfg):
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].reshape(d, H * hd)).view(B, S, H, hd)
    k = (x @ p["wk"].reshape(d, KV * hd)).view(B, S, KV, hd)
    v = (x @ p["wv"].reshape(d, KV * hd)).view(B, S, KV, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attn_block(p, x, cfg, window: int | None = None, positions=None,
               mlp_fn=None, place=None):
    """Training/prefill forward.  x: (B, S, d).  Returns (y, (k, v)) with
    k/v (B, S, KV, hd) after RoPE.  With `place` (a
    `distributed.placement.LayerPlace`) see `_attn_block_placed`."""
    if place is not None:
        return _attn_block_placed(p, x, cfg, window, mlp_fn, place)
    B, S, d = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    h = rms_norm(x, p["norm1"])
    q, k, v = _qkv(p, h, positions, cfg)
    c = min(cfg.flash_chunk, S)
    o = flash_attention(q, k, v, causal=True, window=window, q_chunk=c,
                        kv_chunk=c)
    x = x + o.reshape(B, S, -1) @ p["wo"].reshape(-1, d)
    h = rms_norm(x, p["norm2"])
    return x + _mlp(p, h, mlp_fn), (k, v)


def attn_decode(p, x, cache_k, cache_v, pos: int, cfg, mlp_fn=None, *,
                slot: int, valid_len: int, k_scale=None, v_scale=None,
                place=None):
    """Single-token decode.  x: (B, d); caches head-major (B, KV, S, hd),
    updated in place at `slot` (`pos`, or a windowed layer's ring slot);
    attention covers the cache's first `valid_len` entries.  `pos` is the
    token's position (RoPE).  An int8 cache takes float32 `k_scale` /
    `v_scale` (B, KV, S), written at `slot` with the payload.  Returns
    the block output (B, d).  With `place` (a
    `distributed.placement.LayerPlace`) `p` and the caches are this
    rank's blocks and `slot` / `valid_len` the whole cache's: see
    `_attn_decode_placed`."""
    if place is not None:
        return _attn_decode_placed(p, x, cache_k, cache_v, pos, cfg, mlp_fn,
                                   slot, valid_len, k_scale, v_scale, place)
    B, d = x.shape
    h = rms_norm(x, p["norm1"])
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = (t[:, 0] for t in _qkv(p, h[:, None], positions, cfg))
    if cache_k.dtype == torch.int8 and q.dtype == torch.bfloat16:
        # quantize, write at `slot` and attend: one launch on the card
        o = ops.decode_attention_int8_append(q, k, v, cache_k, cache_v,
                                             k_scale, v_scale, slot,
                                             valid_len)
    else:
        if cache_k.dtype == torch.int8:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            k_scale[:, :, slot] = ks
            v_scale[:, :, slot] = vs
        # in-place write of the new token (replaces the reference's
        # dynamic_update_slice, which returns a new cache)
        cache_k[:, :, slot] = k.to(cache_k.dtype)
        cache_v[:, :, slot] = v.to(cache_v.dtype)
        o = ops.decode_attention_head_major(q, cache_k, cache_v, valid_len,
                                            k_scale=k_scale, v_scale=v_scale)
    x = x + o.reshape(B, -1) @ p["wo"].reshape(-1, d)
    h = rms_norm(x, p["norm2"])
    return x + _mlp(p, h, mlp_fn)


def _attn_decode_placed(p, x, cache_k, cache_v, pos, cfg, mlp_fn, slot,
                        valid_len, k_scale, v_scale, lp):
    """`attn_decode` on one rank of a placed decode cell (the reference's
    `attn_decode` under `plan_cell`'s decode shardings).  x: this rank's
    rows (B, d), the same on every rank of its "model" group.

    Weights: a dim bound to "data" (fsdp: d_model) is all-gathered before
    use.  q heads are local where `param_specs` splits `wq` over "model"
    (H % tp == 0), k/v heads where it splits `wk`/`wv` (KV % tp == 0);
    otherwise every rank computes them all.  The cache holds every KV
    head of this rank's sequence shard, so q and the new token's k/v are
    all-gathered over "model" (B x heads x hd elements).  The rank whose
    shard holds `slot` writes the token; each attends over its shard's
    filled rows, a local valid length clamp(valid_len - offset, 0,
    S_local), by the decode kernel with its row lse, and the shards merge
    across the sequence group (`Placement.merge_seq`).  Then `wo` is
    row-parallel over the heads it holds (an all-reduce over "model"),
    and the SwiGLU column-parallel `w_gate`/`w_up`, row-parallel
    `w_down` (an all-reduce)."""
    plc, s = lp.plc, lp.spec
    B, d = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, p["norm1"])
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)

    def proj(name, rotate):
        w = plc.gather_axis(p[name], s[name])            # (d, heads, hd)
        y = (h @ w.reshape(d, -1)).view(B, 1, w.shape[1], hd)
        return (rope(y, positions, cfg.rope_theta) if rotate else y)[:, 0]

    qkv = {n: proj(n, n != "wv") for n in ("wq", "wk", "wv")}
    split = [n for n in qkv if s[n][1] is not None]      # heads over tp
    if split:                                            # one all-gather
        qkv.update(zip(split, plc.all_gather_many(
            [qkv[n] for n in split], s[split[0]][1], 1)))
    q, k, v = (qkv[n].contiguous() for n in ("wq", "wk", "wv"))
    S = cache_k.shape[2]
    off = plc.index(lp.seq) * S
    mine = slot - off if 0 <= slot - off < S else None
    valid = min(max(valid_len - off, 0), S)
    if cache_k.dtype == torch.int8 and q.dtype == torch.bfloat16:
        o, lse = ops.decode_attention_int8_append(
            q, k, v, cache_k, cache_v, k_scale, v_scale, mine, valid,
            return_lse=True)
    else:
        if mine is not None:
            if cache_k.dtype == torch.int8:
                k, ks = quantize_kv(k)
                v, vs = quantize_kv(v)
                k_scale[:, :, mine] = ks
                v_scale[:, :, mine] = vs
            cache_k[:, :, mine] = k.to(cache_k.dtype)
            cache_v[:, :, mine] = v.to(cache_v.dtype)
        o, lse = ops.decode_attention_head_major(
            q, cache_k, cache_v, valid, k_scale=k_scale, v_scale=v_scale,
            return_lse=True)
    o = plc.merge_seq(o, lse, lp.seq)                    # (B, H, hd)
    wo = plc.gather_axis(p["wo"], s["wo"])               # (H_local, hd, d)
    n = wo.shape[0]
    o = o[:, plc.index(s["wo"][0]) * n:][:, :n]
    x = x + plc.all_reduce(o.reshape(B, -1) @ wo.reshape(-1, d), s["wo"][0])
    h = rms_norm(x, p["norm2"])
    if mlp_fn is not None:
        return x + mlp_fn(h)
    y = swiglu(h, plc.gather_axis(p["w_gate"], s["w_gate"]),
               plc.gather_axis(p["w_up"], s["w_up"]),
               plc.gather_axis(p["w_down"], s["w_down"]))
    return x + plc.all_reduce(y, s["w_down"][0])


def _kv_of_heads(k, v, cfg, h0: int, n_q: int):
    """The KV heads that q heads [h0, h0 + n_q) read (head h reads KV
    head h // G), from k/v holding every KV head: a contiguous slice
    where each KV head serves the same number of them, else one KV head
    per q head (G = 1)."""
    G = cfg.n_heads // cfg.n_kv_heads
    idx = [h // G for h in range(h0, h0 + n_q)]
    lo, hi = idx[0], idx[-1] + 1
    if n_q % (hi - lo) == 0 and idx == [lo + i // (n_q // (hi - lo))
                                        for i in range(n_q)]:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    at = torch.tensor(idx, device=k.device)
    return k.index_select(2, at), v.index_select(2, at)


def _attn_block_placed(p, x, cfg, window, mlp_fn, lp):
    """`attn_block` on one rank of a placed prefill (the reference's
    `attn_block` under `plan_cell`'s prefill shardings).  x: this rank's
    rows (B, S_local, d), its block of the sequence under `plc.seq`.

    Each weight's fsdp dims are gathered before use (`Placement.take`).
    Where `param_specs` splits the q heads over an axis (tp) that does not
    also cut the batch (`Placement.split`; else the heads are gathered
    and the layer is local to the rank's rows), the rank
    runs its heads over the whole sequence: with a sequence-sharded
    residual (sp = tp, Megatron-style) the normed input is all-gathered
    along the sequence first and `wo`'s row-parallel product
    reduce-scattered back to the rank's block, else all-reduced.  Its KV
    heads are its block where `wk` splits (KV % tp == 0), else the ones
    its q heads read, by global head index (`_kv_of_heads`).  Where the
    heads are whole and the sequence is cut (context parallelism), the
    rank computes q, k, v of its own tokens, all-gathers k and v along
    the sequence and runs its query block through the flash kernel at
    its q_offset.  The SwiGLU is column- then row-parallel over the ff
    dim where that is split (with the same gather and reduce-scatter),
    else local to the rank's tokens; `mlp_fn` (the MoE MLP) takes the
    rank's tokens.  The K/V handed to the cache are the whole sequence's
    (B, S, heads, hd), fitted to the cache's spec of the KV-head dim;
    a train step's layer (no cache specs) returns None for them.  Under
    autograd every collective differentiates (`distributed/placement.py`):
    the gathers of the weights and of K/V reduce-scatter their
    gradients, the all-reduces all-reduce them."""
    plc, s = lp.plc, lp.spec
    seq = plc.seq
    B, Sl, d = x.shape
    hd = cfg.head_dim
    hq, hk = plc.split(tuple(s["wq"])[1]), plc.split(tuple(s["wk"])[1])
    if hq is None and hk is not None:
        raise ValueError("KV heads split where the q heads are not")
    h = rms_norm(x, p["norm1"])
    whole = seq is not None and hq is not None     # gather the sequence
    if whole:
        if axes_of(hq) != axes_of(seq):
            raise ValueError(f"heads over {hq} and sequence over {seq}")
        h = plc.all_gather(h, seq, 1)
    off = 0 if whole or seq is None else plc.index(seq) * Sl
    Sq = h.shape[1]
    positions = (off + torch.arange(Sq, device=x.device)).expand(B, Sq)

    def proj(name, heads):
        w = plc.take(p[name], s[name], (None, heads, None))
        return (h @ w.reshape(d, -1)).view(B, Sq, w.shape[1], hd)

    q = rope(proj("wq", hq), positions, cfg.rope_theta)
    k = rope(proj("wk", hk), positions, cfg.rope_theta)
    v = proj("wv", hk)
    if seq is not None and not whole:              # context parallelism
        k, v = plc.all_gather_many([k, v], seq, 1)
    if hq is not None and hk is None:
        kq, vq = _kv_of_heads(k, v, cfg, plc.index(hq) * q.shape[2],
                              q.shape[2])
    else:
        kq, vq = k, v
    c = min(cfg.flash_chunk, k.shape[1])
    o = flash_attention(q, kq.contiguous(), vq.contiguous(), causal=True,
                        window=window, q_offset=off, q_chunk=c, kv_chunk=c)
    wo = plc.take(p["wo"], s["wo"], (hq, None, None))
    y = o.reshape(B, Sq, -1) @ wo.reshape(-1, d)
    x = x + _row_out(plc, y, hq, seq if whole else None)
    h = rms_norm(x, p["norm2"])
    if mlp_fn is not None:
        x = x + mlp_fn(h)
    else:
        hf = plc.split(tuple(s["w_gate"])[1])
        wide = seq is not None and hf is not None
        if wide:
            h = plc.all_gather(h, seq, 1)
        y = swiglu(h, plc.take(p["w_gate"], s["w_gate"], (None, hf)),
                   plc.take(p["w_up"], s["w_up"], (None, hf)),
                   plc.take(p["w_down"], s["w_down"], (hf, None)))
        x = x + _row_out(plc, y, hf, seq if wide else None)
    cs = lp.cache
    if cs is None:                                 # a train step
        return x, None
    k, v = (plc.take(t, (cs["k"][0], None, hk), tuple(cs["k"])[:3])
            for t in (k, v))
    return x, (k.contiguous(), v.contiguous())


def _row_out(plc, y, split, seq):
    """A row-parallel product's partial sums `y` over `split` (None:
    whole) on tokens gathered along `seq` (None: not gathered) -> this
    rank's tokens, summed."""
    if split is None:
        return y if seq is None else plc.block(y, seq, 1)
    if seq is None:
        return plc.all_reduce(y, split)
    return plc.reduce_scatter(y, split, 1)
