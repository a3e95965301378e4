"""Move parameters and optimizer state between the port's layout and the
reference's.

torch cannot reproduce `jax.random`, so tests that compare the two
packages initialise the reference (`repro.models.transformer.init_params`),
turn its tree into numpy, and load it here.  The reference stacks each
stage's layers along a leading repeat axis (`stages[i]["b<j>"][w]`); the
port keeps one dict per layer in execution order.  The `_to_reference`
functions give the reference's layout back (torch CPU tensors, dtypes
kept), which is also the layout the port's checkpoints are written in,
so a checkpoint written by either package restores in the other.  Each
block kind has its own leaves (`attention.WEIGHTS`, `mamba2.WEIGHTS`).
This module never imports jax or `repro`.
"""
from __future__ import annotations

import numpy as np
import torch

from .models import attention, mamba2
from .models.transformer import layer_blocks


def _tensor(arr, dtype, device):
    if torch.is_tensor(arr):
        return arr.to(dtype=dtype, device=device)
    # ml_dtypes' bfloat16 has no torch.from_numpy path: go through f32
    # (exact for every floating leaf the reference makes)
    return torch.from_numpy(np.array(arr, np.float32)).to(
        dtype=dtype, device=device)


def _weights(block):
    return mamba2.WEIGHTS if block.kind == "mamba2" else attention.WEIGHTS


def _layer_index(cfg):
    """[(stage, block, repeat, layer)] for every layer of `cfg`."""
    out, layer = [], 0
    for si, (repeat, blocks) in enumerate(cfg.stages):
        for r in range(repeat):
            for bi in range(len(blocks)):
                out.append((si, bi, r, layer))
                layer += 1
    return out


def params_from_reference(np_tree, cfg, device, dtype=None) -> dict:
    """`np_tree`: the reference's `init_params` tree with numpy (or
    torch) leaves (stages stacked along the repeat axis).  Returns the
    port's params (see `models.transformer`) in `dtype`; by default in
    `cfg.dtype`, except the mamba2 leaves that the reference keeps in
    float32 (`mamba2.F32_WEIGHTS`).  Raises if any leaf is left unused."""
    dt = getattr(torch, dtype or cfg.dtype)
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

    def take(path, dtype=dt):
        if path not in left:
            raise KeyError(f"reference tree lacks {path}")
        return _tensor(left.pop(path), dtype, device)

    def leaf_dtype(block, w):
        if dtype is None and block.kind == "mamba2" \
                and w in mamba2.F32_WEIGHTS:
            return torch.float32
        return dt

    params = {"embed": take(("embed",)),
              "final_norm": take(("final_norm",))}
    if not cfg.tie_embeddings:
        params["lm_head"] = take(("lm_head",))
    stacked = {}
    for si, (_, blocks) in enumerate(cfg.stages):
        for bi, block in enumerate(blocks):
            stacked[si, bi] = {w: take(("stages", si, f"b{bi}", w),
                                       leaf_dtype(block, w))
                               for w in _weights(block)}
    # each layer its own tensor (not a view of the stack), so it can be
    # updated in place and freed on its own
    params["layers"] = [{w: t[r].clone() for w, t in stacked[si, bi].items()}
                        for si, bi, r, _ in _layer_index(cfg)]
    if left:
        raise ValueError(f"unconsumed reference leaves: {sorted(left)}")
    return params


def params_to_reference(params, cfg) -> dict:
    """The inverse of `params_from_reference`: the reference's tree, each
    stage's layers stacked along the repeat axis, as detached CPU tensors
    in the parameters' dtypes (``shared`` is None: no `shared_attn`)."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    tree = {"embed": host(params["embed"]),
            "final_norm": host(params["final_norm"]),
            "stages": [], "shared": None}
    if not cfg.tie_embeddings:
        tree["lm_head"] = host(params["lm_head"])
    layers = params["layers"]
    index = _layer_index(cfg)
    for si, (_, blocks) in enumerate(cfg.stages):
        tree["stages"].append({
            f"b{bi}": {w: torch.stack([host(layers[n][w])
                                       for s, b, _, n in index
                                       if (s, b) == (si, bi)])
                       for w in _weights(block)}
            for bi, block in enumerate(blocks)})
    return tree


def opt_state_to_reference(state, cfg) -> dict:
    """AdamW state {"m", "v", "count"} in the reference's layout."""
    return {"m": params_to_reference(state["m"], cfg),
            "v": params_to_reference(state["v"], cfg),
            "count": state["count"].detach().to("cpu", copy=True)}


def opt_state_from_reference(tree, cfg, device,
                             moment_dtype: str = "float32") -> dict:
    """The inverse of `opt_state_to_reference`."""
    return {"m": params_from_reference(tree["m"], cfg, device, moment_dtype),
            "v": params_from_reference(tree["v"], cfg, device, moment_dtype),
            "count": _tensor(tree["count"], torch.int32, device)}
