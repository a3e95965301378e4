"""Assigned input shapes and meta-device stand-ins of a cell's inputs
(counterpart of `repro/configs/shapes.py`).

The four LM shapes (seq_len x global_batch).  ``train_4k`` is a train
step's input; ``prefill_32k`` a prefill step's; ``decode_32k`` /
``long_500k`` a serve step's (one new token against a KV cache of
seq_len).  ``long_500k`` requires a sub-quadratic architecture
(``cfg.subquadratic``); a pure full-attention one skips it.

`input_specs` returns tensors on the ``meta`` device where the reference
returns `jax.ShapeDtypeStruct`s: the same shapes and dtypes, and no
memory behind them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig

# frontend stub prefix lengths (precomputed frame/patch embeddings)
FRONTEND_LEN = {"audio": 64, "vision": 256}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k is only defined for sub-quadratic architectures."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-device stand-ins for every model input of this cell: int32
    tokens (and labels for train), a scalar int32 ``pos`` for decode,
    and ``frontend_emb`` in ``cfg.dtype`` for a train or prefill cell of
    a model with a frontend stub."""
    def meta(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    B, S = shape.batch, shape.seq
    if shape.kind == "train":
        specs = {"tokens": meta((B, S)), "labels": meta((B, S))}
    elif shape.kind == "prefill":
        specs = {"tokens": meta((B, S))}
    elif shape.kind == "decode":
        specs = {"tokens": meta((B,)), "pos": meta(())}
    else:
        raise ValueError(shape.kind)
    if cfg.frontend and shape.kind in ("train", "prefill"):
        specs["frontend_emb"] = meta((B, FRONTEND_LEN[cfg.frontend],
                                      cfg.d_model), getattr(torch, cfg.dtype))
    return specs
