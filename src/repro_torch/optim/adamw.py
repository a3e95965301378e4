"""AdamW with global-norm clipping (port of `repro/optim/adamw.py`).

The update is the reference's formula step for step: clip by the global
norm, bias corrections in float32, ``p - lr * (step + wd * p)`` in
float32, cast back to the parameter's dtype, moments kept in
`moment_dtype` (float32 by default).  Unlike the reference, which returns
new trees, the parameters and moments are updated in place: at full
width a second copy of each would not fit beside the first.
`torch.optim.AdamW` is not used: it orders the update differently.
A placed train step (`launch/steps.py`) hands each rank's blocks of the
parameters, gradients and moments to the same update, with the global
clip norm.
"""
from __future__ import annotations

import dataclasses

import torch

from ..tree import tree_leaves, tree_map

F32 = torch.float32
CHUNK = 1 << 24                # elements a slice of the update (64 MB f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments shaped like `params`, and a step count (int32, 0-d)
    on the parameters' device."""
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(g.to(F32).square().sum()
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0,
                 gnorm=None):
    """Returns (params, new_state, metrics); `params` and the moments of
    `state` are updated in place.  `gnorm` is the clip norm where the
    caller has it (a placed step's blocks: the norm over every rank's,
    `Placement.grad_norm`); by default `global_norm(grads)`."""
    count = state["count"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    cnt = count.to(F32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=cnt.device), cnt)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=cnt.device), cnt)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=F32, device=cnt.device)
    for p, g, m, v in zip(*(tree_leaves(t) for t in
                            (params, grads, state["m"], state["v"]))):
        # a slice of CHUNK elements at a time: elementwise, so the same
        # numbers, with temporaries of a slice's size, not a leaf's (the
        # leaves updated in place are views: a copy would be updated)
        p, m, v, g = p.view(-1), m.view(-1), v.view(-1), g.reshape(-1)
        for i in range(0, p.numel(), CHUNK):
            p_, g_, m_, v_ = (t[i:i + CHUNK] for t in (p, g, m, v))
            g_ = g_.to(F32) * scale
            m_new = b1 * m_.to(F32) + (1 - b1) * g_
            v_new = b2 * v_.to(F32) + (1 - b2) * g_.square()
            step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            pf = p_.to(F32)
            p_.copy_(pf - lr * (step + cfg.weight_decay * pf))
            m_.copy_(m_new)
            v_.copy_(v_new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        metrics
