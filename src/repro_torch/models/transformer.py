"""Model assembly for decode (port of `repro/models/transformer.py`):
parameters, the head-major decode cache and one decode step, for
architectures built of `attn` blocks without a window.

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``lm_head`` (d, V) unless embeddings are tied, and ``layers``, one dict
per layer in execution order (the reference stacks each stage's layers
along a leading repeat axis instead; `convert.params_from_reference`
maps one onto the other).  Vocab sizes are padded to a multiple of 256.
"""
from __future__ import annotations

import torch

from .attention import attn_decode, init_attn_block
from .common import F32, rms_norm
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
                "sliding-window decode is not ported yet")
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
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head
