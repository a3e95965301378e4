"""Move parameters and optimizer state between the port's layout and the
reference's.

torch cannot reproduce `jax.random`, so tests that compare the two
packages initialise the reference (`repro.models.transformer.init_params`),
turn its tree into numpy, and load it here.  The reference stacks each
stage's layers along a leading repeat axis (`stages[i]["b<j>"][w]`); the
port keeps one dict per layer in execution order.  zamba2's shared
attention block is ``shared`` in both layouts, held once; its stage
entries have no ``b<j>`` for it and its layers are None in the port's
(`models.transformer`), so each shared tensor, and each optimizer moment
of one, is a single leaf on both sides.  The `_to_reference`
functions give the reference's layout back (torch CPU tensors, dtypes
kept), which is also the layout the port's checkpoints are written in,
so a checkpoint written by either package restores in the other.  Each
block kind has its own leaves (`attention.WEIGHTS`, `mamba2.WEIGHTS`; a
`moe` block the attention leaves and a nested ``moe`` dict of
`moe.WEIGHTS`), named by their path in the layer's dict.
This module never imports jax or `repro`.
"""
from __future__ import annotations

import numpy as np
import torch

from .distributed.sharding import P
from .models import attention, mamba2, moe
from .models.transformer import layer_blocks


def _tensor(arr, dtype, device):
    if torch.is_tensor(arr):
        return arr.to(dtype=dtype, device=device)
    # ml_dtypes' bfloat16 has no torch.from_numpy path: go through f32
    # (exact for every floating leaf the reference makes)
    return torch.from_numpy(np.array(arr, np.float32)).to(
        dtype=dtype, device=device)


def _weights(block) -> list[tuple]:
    """The paths of one layer's leaves in its dict (none for a
    `shared_attn` layer, whose leaves are ``shared``'s)."""
    if block.kind == "shared_attn":
        return []
    if block.kind == "mamba2":
        return [(w,) for w in mamba2.WEIGHTS]
    if block.kind == "moe":
        return [(w,) for w in attention.ATTN_WEIGHTS] + \
            [("moe", w) for w in moe.WEIGHTS]
    return [(w,) for w in attention.WEIGHTS]


def _nest(flat: dict) -> dict:
    """{path: leaf} -> the nested dict the paths name."""
    out = {}
    for path, leaf in flat.items():
        d = out
        for key in path[:-1]:
            d = d.setdefault(key, {})
        d[path[-1]] = leaf
    return out


def _leaf(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


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
    every = layer_blocks(cfg)               # raises for unknown kinds
    left = {}
    for name in ("embed", "final_norm", "lm_head"):
        if np_tree.get(name) is not None:
            left[(name,)] = np_tree[name]

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, sub in node.items():
                walk(prefix + (k,), sub)
        elif node is not None:
            left[prefix] = node

    walk(("shared",), np_tree.get("shared"))
    for si, stage in enumerate(np_tree["stages"]):
        walk(("stages", si), stage)

    def take(path, dtype=dt):
        if path not in left:
            raise KeyError(f"reference tree lacks {path}")
        return _tensor(left.pop(path), dtype, device)

    def leaf_dtype(block, path):
        if dtype is None and block.kind == "mamba2" \
                and path[-1] in mamba2.F32_WEIGHTS:
            return torch.float32
        return dt

    params = {"embed": take(("embed",)),
              "final_norm": take(("final_norm",))}
    if not cfg.tie_embeddings:
        params["lm_head"] = take(("lm_head",))
    if any(b.kind == "shared_attn" for b in every):
        params["shared"] = {w: take(("shared", w))
                            for w in attention.WEIGHTS}
    stacked = {}
    for si, (_, blocks) in enumerate(cfg.stages):
        for bi, block in enumerate(blocks):
            stacked[si, bi] = {path: take(("stages", si, f"b{bi}", *path),
                                          leaf_dtype(block, path))
                               for path in _weights(block)}
    # each layer its own tensor (not a view of the stack), so it can be
    # updated in place and freed on its own
    params["layers"] = [
        None if b.kind == "shared_attn" else
        _nest({path: t[r].clone() for path, t in stacked[si, bi].items()})
        for b, (si, bi, r, _) in zip(every, _layer_index(cfg))]
    if left:
        raise ValueError(f"unconsumed reference leaves: {sorted(left)}")
    return params


def params_to_reference(params, cfg) -> dict:
    """The inverse of `params_from_reference`: the reference's tree, each
    stage's layers stacked along the repeat axis, as detached CPU tensors
    in the parameters' dtypes (``shared`` is None without a
    `shared_attn` block)."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    tree = {"embed": host(params["embed"]),
            "final_norm": host(params["final_norm"]),
            "stages": [], "shared": None}
    if not cfg.tie_embeddings:
        tree["lm_head"] = host(params["lm_head"])
    if params.get("shared") is not None:
        tree["shared"] = {w: host(t) for w, t in params["shared"].items()}
    layers = params["layers"]
    index = _layer_index(cfg)
    for si, (_, blocks) in enumerate(cfg.stages):
        tree["stages"].append({
            f"b{bi}": _nest({path: torch.stack([host(_leaf(layers[n], path))
                                                for s, b, _, n in index
                                                if (s, b) == (si, bi)])
                             for path in _weights(block)})
            for bi, block in enumerate(blocks)
            if block.kind != "shared_attn"})
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


def _stacked_spec(specs: list):
    """The reference's spec of a stage's stacked leaf from its layers'
    (which must agree): a logical spec gains the leading "stack" dim, a
    concrete `P` a leading None (the stack dim binds to nothing)."""
    first = specs[0]
    if any(s != first for s in specs):
        raise ValueError(f"the layers of one stage disagree: {specs}")
    if isinstance(first, P):
        return P(None, *first)
    return ("stack", *first)


def _stack_specs(layers: list, cfg, with_shared: bool) -> list:
    """Per-layer spec dicts -> the reference's stages, each (stage,
    block) stacked over its repeats; a `shared_attn` block's entry only
    `with_shared` (caches have one per occurrence, parameters none)."""
    index = _layer_index(cfg)
    stages = []
    for si, (_, blocks) in enumerate(cfg.stages):
        stage = {}
        for bi, block in enumerate(blocks):
            if block.kind == "shared_attn" and not with_shared:
                continue
            per = [layers[n] for s, b, _, n in index if (s, b) == (si, bi)]
            flat = {}

            def walk(prefix, node):
                for k, sub in node.items():
                    if isinstance(sub, dict):
                        walk(prefix + (k,), sub)
                    else:
                        flat[prefix + (k,)] = [_leaf(lay, prefix + (k,))
                                               for lay in per]
            walk((), per[0])
            stage[f"b{bi}"] = _nest({path: _stacked_spec(leaves)
                                     for path, leaves in flat.items()})
        stages.append(stage)
    return stages


def specs_to_reference(specs, cfg) -> dict:
    """A parameter spec tree in the port's layout
    (`transformer.logical_param_specs` or `param_specs`) in the
    reference's: each stage's layers stacked, ``shared`` None without a
    `shared_attn` block."""
    tree = {k: specs[k] for k in ("embed", "final_norm", "lm_head")
            if k in specs}
    tree["shared"] = specs.get("shared")
    tree["stages"] = _stack_specs(specs["layers"], cfg, with_shared=False)
    return tree


def cache_specs_to_reference(specs: list, cfg) -> list:
    """`transformer.cache_specs`' per-layer list in the reference's
    layout: a list of stages, each block (every `shared_attn`
    occurrence's cache included) stacked over the stage's repeats."""
    return _stack_specs(specs, cfg, with_shared=True)
