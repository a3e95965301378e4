"""Model assembly (port of `repro/models/transformer.py`): parameters,
the train/prefill forward and loss, the decode cache and one decode step,
for architectures built of `attn` and `moe` blocks (windowed or not, with
a float or an int8 KV cache), of `mamba2` blocks and of zamba2's
`shared_attn` block.  A windowed layer's decode cache is a ring buffer of
min(window, s_max) slots, as the reference's (`_cache_len`).

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``lm_head`` (d, V) unless embeddings are tied, and ``layers``, one dict
per layer in execution order, holding that block kind's weights (the
reference stacks each stage's layers along a leading repeat axis instead;
`convert.params_from_reference` maps one onto the other).  A `moe` layer
holds the attention weights and a nested ``moe`` dict (`models/moe.py`)
in place of the SwiGLU's; its forward routes with the configured
capacity and its decode step dropless (`moe_ffn(dropless=True)`).  A
`shared_attn` layer's entry is None: the block's weights are held once,
in ``shared`` (an attention block with a SwiGLU of `shared_attn_d_ff`),
and every occurrence applies them, so that each tensor is one leaf of
the tree (one gradient, one AdamW update, one checkpoint entry); each
occurrence keeps its own KV cache, as the reference's `init_cache` gives.
Vocab sizes are padded to a multiple of 256.

Placed (`distributed/placement.py`): `decode_step(place=)`,
`prefill_placed` and `loss_placed` run one rank's blocks of a cell
`launch/steps.py:plan_cell` placed, every block kind through its placed
branch.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..tree import tree_map

from ..distributed.sharding import (EMBED_D, FSDP, TP, VOCAB, P,
                                    describe_mesh)
from .attention import attn_block, attn_decode, attn_specs, init_attn_block
from .common import F32, chunked_cross_entropy, rms_norm
from .config import ModelConfig
from . import moe
from .mamba2 import init_mamba2, mamba2_mixer, mamba2_specs, mamba2_step

KINDS = ("attn", "mamba2", "moe", "shared_attn")   # block kinds


def padded_vocab(cfg: ModelConfig) -> int:
    return (cfg.vocab + 255) // 256 * 256


def layer_blocks(cfg: ModelConfig) -> list:
    """The blocks of every layer in execution order; raises for a kind
    the port does not know."""
    blocks = [b for repeat, bs in cfg.stages for _ in range(repeat)
              for b in bs]
    for b in blocks:
        if b.kind not in KINDS:
            raise NotImplementedError(f"{b.kind} blocks are not ported")
    return blocks


def layer_params(params, cfg: ModelConfig):
    """(block, weights) of every layer in execution order: a
    `shared_attn` layer gets the one shared block."""
    return [(b, params["shared"] if b.kind == "shared_attn" else p)
            for b, p in zip(layer_blocks(cfg), params["layers"])]


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Random parameters drawn layer by layer on `device` from
    `generator` (which must live on `device`)."""
    V, d = padded_vocab(cfg), cfg.d_model
    dt = getattr(torch, cfg.dtype)
    blocks = layer_blocks(cfg)

    def normal(*shape):
        w = torch.randn(shape, generator=generator, dtype=F32, device=device)
        return (w * d ** -0.5).to(dt)

    params = {"embed": normal(V, d),
              "final_norm": torch.zeros(d, dtype=dt, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(d, V)
    # drawn only when the config has the block: every other architecture
    # draws the numbers it always drew
    if any(b.kind == "shared_attn" for b in blocks):
        params["shared"] = init_attn_block(cfg, cfg.shared_attn_d_ff,
                                           generator, device)
    params["layers"] = [_init_layer(cfg, b, generator, device)
                        for b in blocks]
    return params


def param_shapes(cfg: ModelConfig) -> dict:
    """`init_params`' tree on the meta device: shapes and dtypes, no
    memory."""
    return init_params(cfg, None, torch.device("meta"))


def _init_layer(cfg, block, generator, device):
    if block.kind == "shared_attn":
        return None                 # in params["shared"]
    if block.kind == "mamba2":
        return init_mamba2(cfg, generator, device)
    if block.kind == "moe":
        p = init_attn_block(cfg, None, generator, device)
        p["moe"] = moe.init_moe(cfg, generator, device)
        return p
    return init_attn_block(cfg, cfg.d_ff, generator, device)


def _block_specs(block, moe_ff_sharded: bool = False):
    if block.kind == "shared_attn":
        return None                 # in specs["shared"]
    if block.kind == "mamba2":
        return mamba2_specs()
    s = attn_specs()
    if block.kind == "moe":
        for w in ("w_gate", "w_up", "w_down"):
            del s[w]
        s["moe"] = moe.moe_specs(ff_sharded=moe_ff_sharded)
    return s


def logical_param_specs(cfg: ModelConfig, moe_ff_sharded: bool = False):
    """The tree of `init_params` with each leaf's logical dims (a tuple
    of `distributed.sharding` axis names and None); a shared layer's
    entry is None, as its parameters'.  `convert.specs_to_reference`
    gives the reference's stacked tree."""
    specs = {"embed": (VOCAB, EMBED_D), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (EMBED_D, VOCAB)
    blocks = layer_blocks(cfg)
    if any(b.kind == "shared_attn" for b in blocks):
        specs["shared"] = attn_specs()
    specs["layers"] = [_block_specs(b, moe_ff_sharded) for b in blocks]
    return specs


def param_specs(params, cfg: ModelConfig, mesh, dp_axes=("data",),
                tp_axes=("model",), fsdp_axes=("data",),
                vocab_axes=("model",), embed_d_axes=("data",),
                moe_ff_sharded: bool = False):
    """Concrete `P`s of `params` (any tree of tensors with its shapes,
    e.g. `param_shapes`): a logical axis applies only where the dim
    divides the bound mesh axes (gemma3's 8 heads skip a 16-way model
    axis, but the FSDP dim still shards), and an axis claimed by an
    earlier dim is not used again."""
    sizes = describe_mesh(mesh).shape
    binding = {TP: tuple(tp_axes), "dp": tuple(dp_axes),
               FSDP: tuple(fsdp_axes), VOCAB: tuple(vocab_axes),
               EMBED_D: tuple(embed_d_axes),
               "tp_fsdp": tuple(tp_axes) + tuple(fsdp_axes)}

    def one(arr, spec):
        out = []
        used: set = set()
        for dim, s in zip(arr.shape, spec):
            axes = tuple(a for a in binding.get(s, ()) if a not in used)
            n = 1
            for a in axes:
                n *= sizes[a]
            if axes and dim % n == 0:
                used.update(axes)
                out.append(axes[0] if len(axes) == 1 else axes)
            else:
                out.append(None)
        return P(*out)

    return tree_map(one, params, logical_param_specs(cfg, moe_ff_sharded))


def _moe_mlp(p, cfg, dropless: bool = False):
    return lambda h: moe.moe_ffn(p["moe"], h, cfg, dropless=dropless)


def _apply_block(block, p, x, cfg):
    """One layer's forward -> (y, its cache): {"k", "v"} (B, S, KV, hd)
    for attention (masked to the block's window), {"ssm", "conv"} for
    mamba2."""
    if block.kind == "mamba2":
        y, (ssm, conv) = mamba2_mixer(p, x, cfg)
        return y, {"ssm": ssm, "conv": conv}
    mlp_fn = _moe_mlp(p, cfg) if block.kind == "moe" else None
    y, (k, v) = attn_block(p, x, cfg, window=block.window, mlp_fn=mlp_fn)
    return y, {"k": k, "v": v}


def forward_hidden(params, cfg: ModelConfig, tokens, *, frontend_emb=None,
                   return_cache: bool = False):
    """tokens: (B, S) int -> final normed hidden (B, S, d) [, cache].
    The cache has one entry per layer: {"k", "v"} (B, S, KV, hd) for
    attention, {"ssm" (B, nh, ns, hp) float32, "conv" (B, K-1, conv_dim)}
    for mamba2.  With ``cfg.remat == "block"`` and autograd on, each layer
    is checkpointed (its activations are recomputed in the backward)."""
    x = params["embed"][tokens.long()]
    if frontend_emb is not None:   # vision/audio stub: replace a prefix
        n = frontend_emb.shape[1]
        x = torch.cat([frontend_emb.to(x.dtype), x[:, n:]], dim=1)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    caches = []
    for b, p in layer_params(params, cfg):
        if remat:       # p reaches the checkpointed call as an argument
            x, c = checkpoint(_apply_block, b, p, x, cfg,
                              use_reentrant=False)
        else:
            x, c = _apply_block(b, p, x, cfg)
        if return_cache:
            caches.append(c)
    x = rms_norm(x, params["final_norm"])
    return (x, caches) if return_cache else x


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params, cfg: ModelConfig, tokens, *, frontend_emb=None,
            return_cache: bool = False):
    """tokens: (B, S) int -> logits (B, S, V) [, cache]."""
    out = forward_hidden(params, cfg, tokens, frontend_emb=frontend_emb,
                         return_cache=return_cache)
    x, caches = out if return_cache else (out, None)
    logits = x @ _head(params, cfg)
    return (logits, caches) if return_cache else logits


def loss_fn(params, cfg: ModelConfig, tokens, labels, frontend_emb=None,
            ce_chunk: int = 1024):
    """Chunked CE: (B, S, V) logits are never materialised."""
    x = forward_hidden(params, cfg, tokens, frontend_emb=frontend_emb)
    return chunked_cross_entropy(x, _head(params, cfg), labels,
                                 chunk=ce_chunk)


def _cache_len(block, s_max: int) -> int:
    """Decode-cache length of an attention layer: a ring buffer of the
    window for a windowed layer (the reference's `_cache_len`)."""
    return min(block.window, s_max) if block.window else s_max


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> list:
    """Zeroed decode cache, one entry per layer: attention (every
    `shared_attn` occurrence its own) {"k", "v"} of
    shape (batch, n_kv_heads, S, head_dim) (head-major), S = s_max, or
    min(window, s_max) for a windowed layer's ring buffer; with
    `cfg.kv_quant` int8 "k"/"v" and float32 "k_scale"/"v_scale" (batch,
    n_kv_heads, S); mamba2 {"ssm" (batch, nh, ns, hp) float32, "conv"
    (batch, K-1, d_inner + 2 ns)} (no s_max: the state is O(1) per
    sequence)."""
    dt = getattr(torch, cfg.dtype)
    nh, hp, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def layer(b):
        if b.kind == "mamba2":
            return {"ssm": zeros((batch, nh, ns, hp), F32),
                    "conv": zeros((batch, cfg.ssm_conv - 1,
                                   cfg.d_inner + 2 * ns))}
        kv = (batch, cfg.n_kv_heads, _cache_len(b, s_max), cfg.head_dim)
        if cfg.kv_quant:
            return {"k": zeros(kv, torch.int8), "v": zeros(kv, torch.int8),
                    "k_scale": zeros(kv[:-1], F32),
                    "v_scale": zeros(kv[:-1], F32)}
        return {"k": zeros(kv), "v": zeros(kv)}

    return [layer(b) for b in layer_blocks(cfg)]


def prefill_cache_shapes(cfg: ModelConfig, batch: int, seq: int) -> list:
    """The shapes of `forward(..., return_cache=True)`'s cache on the meta
    device (the reference's `_prefill_cache_shape`): {"k", "v"} (batch,
    seq, n_kv_heads, head_dim) for every attention layer (every shared
    occurrence its own), mamba2 {"ssm" (batch, nh, ns, hp) float32,
    "conv" (batch, K-1, conv_dim)}."""
    dt = getattr(torch, cfg.dtype)
    meta = torch.device("meta")

    def layer(b):
        if b.kind == "mamba2":
            return {"ssm": torch.empty(batch, cfg.ssm_heads, cfg.ssm_state,
                                       cfg.ssm_head_dim, dtype=F32,
                                       device=meta),
                    "conv": torch.empty(batch, cfg.ssm_conv - 1,
                                        cfg.d_inner + 2 * cfg.ssm_state,
                                        dtype=dt, device=meta)}
        kv = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.empty(kv, dtype=dt, device=meta),
                "v": torch.empty(kv, dtype=dt, device=meta)}

    return [layer(b) for b in layer_blocks(cfg)]


def cache_specs(cache, mesh, dp_axes=("data",), tp_axes=("model",),
                seq_axes=None) -> list:
    """Concrete `P`s of a cache, the reference's rule dim for dim: "k" and
    "v" (and the int8 scales) batch over dp on dim 0 and dim 2 over
    `seq_axes` (default tp; long_500k binds ("data", "model")), which in
    a decode cache (`init_cache`: (B, KV, S, hd)) is the sequence and in
    a prefill's (`prefill_cache_shapes`: (B, S, KV, hd)) the KV heads;
    SSM states batch over dp, heads (ssm) or channels (conv) over tp.  An
    axis applies only where it divides the dim."""
    sizes = describe_mesh(mesh).shape
    seq_axes = tuple(seq_axes if seq_axes is not None else tp_axes)

    def ax(axes, dim):
        n = 1
        for a in axes:
            n *= sizes[a]
        if not axes or dim % n != 0:
            return None
        return axes[0] if len(axes) == 1 else axes

    dp, tp = tuple(dp_axes), tuple(tp_axes)

    def one(name, t):
        sh = t.shape
        if name in ("k", "v"):                # (B, KV, S, hd) / (B, S, KV, hd)
            return P(ax(dp, sh[0]), None, ax(seq_axes, sh[2]), None)
        if name in ("k_scale", "v_scale"):    # (B, KV, S)
            return P(ax(dp, sh[0]), None, ax(seq_axes, sh[2]))
        if name == "ssm":                     # (B, nh, ns, hp)
            return P(ax(dp, sh[0]), ax(tp, sh[1]), None, None)
        if name == "conv":                    # (B, K-1, conv_dim)
            return P(ax(dp, sh[0]), None, ax(tp, sh[2]))
        return P()

    return [{name: one(name, t) for name, t in layer.items()}
            for layer in cache]


def decode_step(params, cfg: ModelConfig, cache, tokens, pos: int,
                place=None):
    """One decode step.  tokens: (B,) int; pos: the position being
    written (the current length).  Updates `cache` in place (the new
    token's K/V, or the mamba2 layer's ssm and conv state) and returns
    logits (B, V_padded).  A windowed layer writes ring slot pos % W and
    attends its min(pos + 1, W) filled slots (the reference's
    `decode_step`); keys enter the ring after RoPE, and the softmax does
    not depend on their order.  With `place` (a
    `distributed.placement.Placement`) see `_decode_step_placed`."""
    if place is not None:
        return _decode_step_placed(params, cfg, cache, tokens, pos, place)
    x = params["embed"][tokens]                          # (B, d)
    for (b, p), c in zip(layer_params(params, cfg), cache):
        if b.kind == "mamba2":
            x, (ssm, conv) = mamba2_step(p, x, (c["ssm"], c["conv"]), cfg)
            c["ssm"].copy_(ssm)
            c["conv"].copy_(conv)
        else:
            mlp_fn = _moe_mlp(p, cfg, dropless=True) if b.kind == "moe" \
                else None
            W = c["k"].shape[2]
            x = attn_decode(p, x, c["k"], c["v"], pos, cfg, mlp_fn=mlp_fn,
                            slot=pos % W if b.window else pos,
                            valid_len=min(pos + 1, W),
                            k_scale=c.get("k_scale"),
                            v_scale=c.get("v_scale"))
    x = rms_norm(x, params["final_norm"])
    return x @ _head(params, cfg)


def _decode_step_placed(params, cfg, cache, tokens, pos, plc):
    """`decode_step` on one rank of a placed decode cell: `params`,
    `cache` and `tokens` are this rank's blocks (`placement.place` by the
    plan's specs).  The embedding lookup is vocab-parallel
    (`Placement.embed`); each layer runs under its `LayerPlace` (a shared
    occurrence gets the shared block's weights and specs, its own
    cache): `attn_decode`, a windowed ring's slot and valid length taken
    on the whole ring (its length the local one times the sequence
    shards), a `moe` layer's MLP `moe.moe_ffn_placed`; a mamba2 layer
    `mamba2_step` on the rank's heads.  The final norm is replicated and
    the head's d_model dim gathered, so the logits come back
    vocab-sharded over "model": (B_local, V_padded / tp)."""
    specs = plc.param_specs
    x = plc.embed(params["embed"], tokens, specs["embed"])
    for i, ((b, p), c) in enumerate(zip(layer_params(params, cfg), cache)):
        lp = plc.layer(i)
        if b.kind == "mamba2":
            x, (ssm, conv) = mamba2_step(p, x, (c["ssm"], c["conv"]), cfg,
                                         place=lp)
            c["ssm"].copy_(ssm)
            c["conv"].copy_(conv)
            continue
        mlp_fn = None
        if b.kind == "moe":
            def mlp_fn(h, p=p, spec=lp.spec["moe"]):
                return moe.moe_ffn_placed(p["moe"], h, cfg, plc, spec)
        W = c["k"].shape[2] * plc.count(lp.seq)
        x = attn_decode(p, x, c["k"], c["v"], pos, cfg, mlp_fn=mlp_fn,
                        slot=pos % W if b.window else pos,
                        valid_len=min(pos + 1, W), k_scale=c.get("k_scale"),
                        v_scale=c.get("v_scale"), place=lp)
    x = rms_norm(x, params["final_norm"])
    if cfg.tie_embeddings:
        head, spec = params["embed"].T, P(*reversed(specs["embed"]))
    else:
        head, spec = params["lm_head"], specs["lm_head"]
    return x @ plc.gather_axis(head, spec)


def _placed_block(b, p, x, cfg, lp):
    """One layer of a placed prefill or train step on this rank -> (x,
    its cache blocks, or None in a train step)."""
    if b.kind == "mamba2":
        x, c = mamba2_mixer(p, x, cfg, place=lp)
        return x, None if c is None else {"ssm": c[0], "conv": c[1]}
    mlp_fn = None
    if b.kind == "moe":
        def mlp_fn(h):
            return moe.moe_ffn_prefill_placed(p["moe"], h, cfg, lp.plc,
                                              lp.spec["moe"])
    x, kv = attn_block(p, x, cfg, window=b.window, mlp_fn=mlp_fn, place=lp)
    return x, None if kv is None else {"k": kv[0], "v": kv[1]}


def _forward_placed(params, cfg, tokens, frontend_emb, plc):
    """`forward_hidden` on one rank of a placed prefill or train step:
    `params` this rank's blocks, `tokens` its rows (B_local, S) whole
    along the sequence (the reference's batch spec), `frontend_emb` its
    rows of the stub prefix.  The rank takes its block of the sequence
    under `plc.seq` (the residual stream's sequence sharding) and looks
    its tokens up in the embedding table, gathered whole (a prefill's
    tokens outnumber the table's rows a rank would otherwise gather).
    Each layer runs under its `LayerPlace`: the attention block
    (`attention._attn_block_placed`) with a `moe` layer's MLP
    `moe.moe_ffn_prefill_placed`, or the mamba2 mixer on the rank's heads
    (`mamba2._mixer_placed`).  A train step's placement has no cache
    specs: its layers hand back no cache, and with ``cfg.remat ==
    "block"`` under autograd each is checkpointed, as `forward_hidden`
    does (its collectives run again in the recompute).  -> (the final
    normed hidden of the rank's tokens (B_local, S_local, d), this
    rank's cache blocks (None in a train step), the table)."""
    specs = plc.param_specs
    S = tokens.shape[1]
    n = plc.count(plc.seq)
    if S % n:
        raise ValueError(f"a prompt of {S} tokens does not split {n} ways")
    Sl = S // n
    off = plc.index(plc.seq) * Sl
    table = plc.take(params["embed"], specs["embed"], (None, None))
    x = table[tokens[:, off:off + Sl].long()]
    if frontend_emb is not None:      # this block's part of the prefix
        m = min(max(frontend_emb.shape[1] - off, 0), Sl)
        x = torch.cat([frontend_emb[:, off:off + m].to(x.dtype), x[:, m:]],
                      dim=1)
    train = plc.cache_specs is None
    remat = train and cfg.remat == "block" and torch.is_grad_enabled()
    caches = []
    for i, (b, p) in enumerate(layer_params(params, cfg)):
        if remat:       # p reaches the checkpointed call as an argument
            x, c = checkpoint(_placed_block, b, p, x, cfg, plc.layer(i),
                              use_reentrant=False)
        else:
            x, c = _placed_block(b, p, x, cfg, plc.layer(i))
        caches.append(c)
    return (rms_norm(x, params["final_norm"]), None if train else caches,
            table)


def loss_placed(params, cfg: ModelConfig, tokens, labels, plc,
                frontend_emb=None, ce_chunk: int = 1024):
    """This rank's share of `loss_fn` in a placed train step
    (`_forward_placed` with no cache specs): the chunked cross-entropy
    of its tokens against the head taken whole (a tied embedding's
    gathered table, the one leaf for both uses), summed and divided by
    its token count times the mesh's size.  Ranks that hold the same
    tokens (the axes neither the batch nor the sequence is cut over: a
    residual replicated over "model") each count them, so the sum of
    every rank's share is the mean over the global batch, each token
    once, and its gradient, summed over the ranks by the collectives'
    transposes, is the one-process gradient.  `tokens` and `labels` are
    the rank's rows (B_local, S), whole along the sequence."""
    x, _, table = _forward_placed(params, cfg, tokens, frontend_emb, plc)
    if cfg.tie_embeddings:
        head = table.T
    else:
        del table
        head = plc.take(params["lm_head"], plc.param_specs["lm_head"],
                        (None, None))
    B, Sl = x.shape[:2]
    return chunked_cross_entropy(x, head, plc.block(labels, plc.seq, 1),
                                 chunk=ce_chunk,
                                 denom=B * Sl * plc.desc.size)


def prefill_placed(params, cfg: ModelConfig, tokens, plc, frontend_emb=None):
    """A placed prefill on one rank (`_forward_placed`) -> (the last
    position's logits of the rank's rows (B_local, V_padded), whole over
    the vocab, the same on every rank holding those rows; this rank's
    cache blocks).  The last position lives on the last sequence block:
    its hidden is all-gathered along the sequence; the head is gathered
    whole."""
    x, caches, table = _forward_placed(params, cfg, tokens, frontend_emb,
                                       plc)
    last = x[:, -1]
    if plc.seq is not None:
        last = plc.all_gather(last[None], plc.seq, 0)[-1]
    if cfg.tie_embeddings:
        head = table.T
    else:
        del table
        head = plc.take(params["lm_head"], plc.param_specs["lm_head"],
                        (None, None))
    return last @ head, caches
