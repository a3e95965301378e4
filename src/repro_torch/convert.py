"""Load the reference's parameters into the port.

torch cannot reproduce `jax.random`, so tests that compare the two
packages initialise the reference (`repro.models.transformer.init_params`),
turn its tree into numpy, and load it here.  This module reads only
numpy: it never imports jax or `repro`.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.attention import WEIGHTS
from .models.transformer import layer_blocks


def _tensor(arr, dtype, device):
    # ml_dtypes' bfloat16 has no torch.from_numpy path: go through f32
    # (exact for every floating leaf the reference makes)
    return torch.from_numpy(np.array(arr, np.float32)).to(
        dtype=dtype, device=device)


def params_from_reference(np_tree, cfg, device) -> dict:
    """`np_tree`: the reference's `init_params` tree with numpy leaves
    (stages stacked along the repeat axis).  Returns the port's params
    (see `models.transformer`).  Raises if any leaf is left unused."""
    dt = getattr(torch, cfg.dtype)
    layer_blocks(cfg)                       # raises for unported kinds
    left = {}
    for name in ("embed", "final_norm", "lm_head"):
        if np_tree.get(name) is not None:
            left[(name,)] = np_tree[name]
    if np_tree.get("shared") is not None:
        left[("shared",)] = np_tree["shared"]
    for si, stage in enumerate(np_tree["stages"]):
        for bname, block in stage.items():
            for wname, w in block.items():
                left[("stages", si, bname, wname)] = w

    def take(path):
        if path not in left:
            raise KeyError(f"reference tree lacks {path}")
        return _tensor(left.pop(path), dt, device)

    params = {"embed": take(("embed",)),
              "final_norm": take(("final_norm",))}
    if not cfg.tie_embeddings:
        params["lm_head"] = take(("lm_head",))
    params["layers"] = []
    for si, (repeat, blocks) in enumerate(cfg.stages):
        stage = [{w: take(("stages", si, f"b{bi}", w)) for w in WEIGHTS}
                 for bi in range(len(blocks))]
        for r in range(repeat):
            params["layers"] += [{w: t[r] for w, t in block.items()}
                                 for block in stage]
    if left:
        raise ValueError(f"unconsumed reference leaves: {sorted(left)}")
    return params
