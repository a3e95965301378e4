"""Model assembly (port of `repro/models/transformer.py`): parameters,
the train/prefill forward and loss, the head-major decode cache and one
decode step, for architectures built of `attn` blocks without a window.

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``lm_head`` (d, V) unless embeddings are tied, and ``layers``, one dict
per layer in execution order (the reference stacks each stage's layers
along a leading repeat axis instead; `convert.params_from_reference`
maps one onto the other).  Vocab sizes are padded to a multiple of 256.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import attn_block, attn_decode, init_attn_block
from .common import F32, chunked_cross_entropy, rms_norm
from .config import ModelConfig


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
        if b.kind != "attn":
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
    params["layers"] = [init_attn_block(cfg, cfg.d_ff, generator, device)
                        for _ in layer_blocks(cfg)]
    return params


def forward_hidden(params, cfg: ModelConfig, tokens, *, frontend_emb=None,
                   return_cache: bool = False):
    """tokens: (B, S) int -> final normed hidden (B, S, d) [, cache].
    The cache is one {"k", "v"} per layer, each (B, S, KV, hd).  With
    ``cfg.remat == "block"`` and autograd on, each layer is checkpointed
    (its activations are recomputed in the backward)."""
    layer_blocks(cfg)                       # raises for unported kinds
    x = params["embed"][tokens.long()]
    if frontend_emb is not None:   # vision/audio stub: replace a prefix
        n = frontend_emb.shape[1]
        x = torch.cat([frontend_emb.to(x.dtype), x[:, n:]], dim=1)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    caches = []
    for p in params["layers"]:
        if remat:
            x, (k, v) = checkpoint(attn_block, p, x, cfg,
                                   use_reentrant=False)
        else:
            x, (k, v) = attn_block(p, x, cfg)
        if return_cache:
            caches.append({"k": k, "v": v})
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
    """Zeroed decode cache: per layer {"k", "v"} of shape
    (batch, n_kv_heads, s_max, head_dim) (head-major)."""
    dt = getattr(torch, cfg.dtype)
    shape = (batch, cfg.n_kv_heads, s_max, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in layer_blocks(cfg)]


def decode_step(params, cfg: ModelConfig, cache, tokens, pos: int):
    """One decode step.  tokens: (B,) int; pos: the position being
    written (the current length).  Writes the new token's K/V into
    `cache` in place and returns logits (B, V_padded)."""
    x = params["embed"][tokens]                          # (B, d)
    for p, c in zip(params["layers"], cache):
        x = attn_decode(p, x, c["k"], c["v"], pos, cfg)
    x = rms_norm(x, params["final_norm"])
    return x @ _head(params, cfg)
