"""Step functions of the port (counterpart of `repro/launch/steps.py`):
train and prefill on one card.  There is no mesh, sharding or cell
planner: the reference's `plan_cell` / `lower_cell` lower a step for a
TPU mesh, which one H100 does not need.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.transformer import forward, loss_fn
from ..optim import AdamWConfig, adamw_update, cosine_schedule
from ..tree import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    microbatch: int = 1              # grad-accumulation factor
    warmup_steps: int = 100
    total_steps: int = 10_000
    opt: AdamWConfig = AdamWConfig()


def value_and_grad(params, cfg, batch, microbatch: int = 1):
    """(loss, grads) of `loss_fn` over `batch` (dict of tokens, labels and
    optionally frontend_emb).  With `microbatch` M > 1 the batch is cut
    into M row blocks whose losses and gradients are summed in float32
    and divided by M, as the reference's accumulation scan does; with
    M = 1 the gradients keep the parameters' dtypes."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def one(b):
        loss = loss_fn(params, cfg, b["tokens"], b["labels"],
                       b.get("frontend_emb"))
        return loss, torch.autograd.grad(loss, leaves)

    if microbatch == 1:
        loss, grads = one(batch)
        loss = loss.detach()
    else:
        M = microbatch
        rows = batch["tokens"].shape[0]
        if rows % M:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{M} microbatches")
        n = rows // M
        loss = torch.zeros((), dtype=F32, device=leaves[0].device)
        grads = [torch.zeros(p.shape, dtype=F32, device=p.device)
                 for p in leaves]
        for i in range(M):
            loss_i, g_i = one({k: x[i * n:(i + 1) * n]
                               for k, x in batch.items()})
            loss += loss_i.detach()
            for a, g in zip(grads, g_i):
                a += g.to(F32)
            del g_i
        loss = loss / M
        for g in grads:
            g /= M
    it = iter(grads)
    return loss, tree_map(lambda _: next(it), params)


def make_train_step(cfg, topts: TrainOptions):
    """-> train_step(params, opt_state, step, batch) -> (params,
    opt_state, metrics); the parameters and moments are updated in
    place (see `optim.adamw`)."""
    def train_step(params, opt_state, step, batch):
        loss, grads = value_and_grad(params, cfg, batch, topts.microbatch)
        lr_scale = cosine_schedule(step, topts.warmup_steps,
                                   topts.total_steps)
        params, opt_state, metrics = adamw_update(
            params, grads, opt_state, topts.opt, lr_scale)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg):
    """-> prefill_step(params, batch) -> (last logits (B, V), cache): the
    cache has one entry per layer, by block kind: {"k", "v"} (B, S, KV,
    hd) for attention; for mamba2 {"ssm", "conv"}, the state decode
    continues from (`transformer.init_cache`'s layout)."""
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, cache = forward(params, cfg, batch["tokens"],
                                    frontend_emb=batch.get("frontend_emb"),
                                    return_cache=True)
        return logits[:, -1, :], cache

    return prefill_step
