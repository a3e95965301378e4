"""Model assembly (port of `repro/models/transformer.py`): parameters,
the train/prefill forward and loss, the decode cache and one decode step,
for architectures built of `attn` blocks without a window and of
`mamba2` blocks.

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``lm_head`` (d, V) unless embeddings are tied, and ``layers``, one dict
per layer in execution order, holding that block kind's weights (the
reference stacks each stage's layers along a leading repeat axis instead;
`convert.params_from_reference` maps one onto the other).  Vocab sizes
are padded to a multiple of 256.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import attn_block, attn_decode, init_attn_block
from .common import F32, chunked_cross_entropy, rms_norm
from .config import ModelConfig
from .mamba2 import init_mamba2, mamba2_mixer, mamba2_step

KINDS = ("attn", "mamba2")      # block kinds the port runs


def padded_vocab(cfg: ModelConfig) -> int:
    return (cfg.vocab + 255) // 256 * 256


def layer_blocks(cfg: ModelConfig) -> list:
    """The blocks of every layer in execution order; raises for what the
    port cannot run yet."""
    if cfg.kv_quant:
        raise NotImplementedError("int8 KV decode is not ported yet")
    blocks = [b for repeat, bs in cfg.stages for _ in range(repeat)
              for b in bs]
    for b in blocks:
        if b.kind not in KINDS:
            raise NotImplementedError(f"{b.kind} blocks are not ported yet")
        if b.window is not None:
            raise NotImplementedError(
                "sliding-window layers are not ported yet")
    return blocks


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Random parameters drawn layer by layer on `device` from
    `generator` (which must live on `device`)."""
    V, d = padded_vocab(cfg), cfg.d_model
    dt = getattr(torch, cfg.dtype)

    def normal(*shape):
        w = torch.randn(shape, generator=generator, dtype=F32, device=device)
        return (w * d ** -0.5).to(dt)

    params = {"embed": normal(V, d),
              "final_norm": torch.zeros(d, dtype=dt, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(d, V)
    params["layers"] = [
        init_mamba2(cfg, generator, device) if b.kind == "mamba2"
        else init_attn_block(cfg, cfg.d_ff, generator, device)
        for b in layer_blocks(cfg)]
    return params


def _apply_block(kind, p, x, cfg):
    """One layer's forward -> (y, its cache): {"k", "v"} (B, S, KV, hd)
    for attention, {"ssm", "conv"} for mamba2."""
    if kind == "mamba2":
        y, (ssm, conv) = mamba2_mixer(p, x, cfg)
        return y, {"ssm": ssm, "conv": conv}
    y, (k, v) = attn_block(p, x, cfg)
    return y, {"k": k, "v": v}


def forward_hidden(params, cfg: ModelConfig, tokens, *, frontend_emb=None,
                   return_cache: bool = False):
    """tokens: (B, S) int -> final normed hidden (B, S, d) [, cache].
    The cache has one entry per layer: {"k", "v"} (B, S, KV, hd) for
    attention, {"ssm" (B, nh, ns, hp) float32, "conv" (B, K-1, conv_dim)}
    for mamba2.  With ``cfg.remat == "block"`` and autograd on, each layer
    is checkpointed (its activations are recomputed in the backward)."""
    blocks = layer_blocks(cfg)              # raises for unported kinds
    x = params["embed"][tokens.long()]
    if frontend_emb is not None:   # vision/audio stub: replace a prefix
        n = frontend_emb.shape[1]
        x = torch.cat([frontend_emb.to(x.dtype), x[:, n:]], dim=1)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    caches = []
    for b, p in zip(blocks, params["layers"]):
        if remat:
            x, c = checkpoint(_apply_block, b.kind, p, x, cfg,
                              use_reentrant=False)
        else:
            x, c = _apply_block(b.kind, p, x, cfg)
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


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> list:
    """Zeroed decode cache, one entry per layer: attention {"k", "v"} of
    shape (batch, n_kv_heads, s_max, head_dim) (head-major); mamba2
    {"ssm" (batch, nh, ns, hp) float32, "conv" (batch, K-1, d_inner +
    2 ns)} (no s_max: the state is O(1) per sequence)."""
    dt = getattr(torch, cfg.dtype)
    nh, hp, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    kv = (batch, cfg.n_kv_heads, s_max, cfg.head_dim)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    return [{"ssm": zeros((batch, nh, ns, hp), F32),
             "conv": zeros((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * ns))}
            if b.kind == "mamba2" else {"k": zeros(kv), "v": zeros(kv)}
            for b in layer_blocks(cfg)]


def decode_step(params, cfg: ModelConfig, cache, tokens, pos: int):
    """One decode step.  tokens: (B,) int; pos: the position being
    written (the current length).  Updates `cache` in place (the new
    token's K/V, or the mamba2 layer's ssm and conv state) and returns
    logits (B, V_padded)."""
    x = params["embed"][tokens]                          # (B, d)
    for b, p, c in zip(layer_blocks(cfg), params["layers"], cache):
        if b.kind == "mamba2":
            x, (ssm, conv) = mamba2_step(p, x, (c["ssm"], c["conv"]), cfg)
            c["ssm"].copy_(ssm)
            c["conv"].copy_(conv)
        else:
            x = attn_decode(p, x, c["k"], c["v"], pos, cfg)
    x = rms_norm(x, params["final_norm"])
    return x @ _head(params, cfg)
