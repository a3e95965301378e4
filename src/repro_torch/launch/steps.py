"""Step functions of the port (counterpart of `repro/launch/steps.py`):
train, prefill and serve, and the cell planner.  `plan_cell` places a
train, prefill or decode cell's weights (a train cell's AdamW moments
too), cache and batch on a ("data", "model") mesh as the reference's
does (`repro/launch/steps.py:144-207`); `make_train_step(cfg, topts,
plan=...)` trains, `make_prefill_step(cfg, plan=...)` prefills and
`make_serve_step(cfg, plan=...)` serves, each rank holding only its
blocks.  Without a plan each step runs on one device.  The reference's
`lower_cell` (XLA lowering) has no counterpart: `launch/plan.py` sizes
a cell from the same specs instead.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from ..configs.shapes import ShapeSpec
from ..distributed.placement import (AXES, Placement, dedupe,
                                     local_shape, mesh_coords, place,
                                     shard_count, spec_leaves)
from ..distributed.sharding import P, describe_mesh
from ..models.config import ModelConfig
from ..models.transformer import (cache_specs, decode_step, forward,
                                  init_cache, layer_blocks, loss_fn,
                                  loss_placed, param_shapes, param_specs,
                                  prefill_cache_shapes, prefill_placed)
from ..optim import AdamWConfig, adamw_update, cosine_schedule
from ..tree import tree_leaves, tree_map
from .mesh import axis_binding

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    microbatch: int = 1              # grad-accumulation factor
    warmup_steps: int = 100
    total_steps: int = 10_000
    opt: AdamWConfig = AdamWConfig()


def value_and_grad(params, cfg, batch, microbatch: int = 1, place=None):
    """(loss, grads) of `loss_fn` over `batch` (dict of tokens, labels and
    optionally frontend_emb).  With `microbatch` M > 1 the batch is cut
    into M row blocks whose losses and gradients are summed in float32
    and divided by M, as the reference's accumulation scan does; with
    M = 1 the gradients keep the parameters' dtypes.  With `place` (a
    train cell's `Placement`) `params` and `batch` are this rank's
    blocks and rows (`local_batch`: block i of its rows is its share of
    microbatch i) and the loss is the rank's share
    (`transformer.loss_placed`), the gradients its local ones."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def one(b):
        if place is None:
            loss = loss_fn(params, cfg, b["tokens"], b["labels"],
                           b.get("frontend_emb"))
        else:
            loss = loss_placed(params, cfg, b["tokens"], b["labels"], place,
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


def make_train_step(cfg, topts: TrainOptions, plan: "CellPlan | None" = None,
                    placement: Placement | None = None):
    """-> train_step(params, opt_state, step, batch) -> (params,
    opt_state, metrics); the parameters and moments are updated in
    place (see `optim.adamw`).

    With `plan` (`plan_cell`'s of a train cell, on a mesh over the
    default process group; every rank must call this, as it creates the
    mesh's process groups, unless `placement` is given: the planner's
    dry one) the step's arguments are this rank's blocks of the
    parameters and moments (`place_params`, `place_opt_state`) and its
    rows (`local_batch`).  It differentiates its share of the loss
    through the placed forward's collectives (`value_and_grad(place=)`),
    sums each leaf's gradient over the ranks that hold the same block
    (`Placement.reduce_grads`: the data-parallel sum), clips by the
    global norm (`Placement.grad_norm`) and updates its blocks in place.
    metrics["loss"] is the global batch's loss on every rank (its
    shares all-reduced), metrics["rank_loss"] the mean over this rank's
    own tokens.  The step's `placement` attribute holds the rank's
    `Placement` (its collectives' `traffic`; None without a plan)."""
    plc = None
    if plan is not None:
        if plan.shape.kind != "train" or plan.microbatch != topts.microbatch:
            raise ValueError(f"a {plan.shape.kind} cell of microbatch "
                             f"{plan.microbatch} does not train with "
                             f"microbatch {topts.microbatch}")
        plc = placement if placement is not None else placement_of(plan)
        specs = [spec for _, spec in spec_leaves(plan.param_specs)]

    def train_step(params, opt_state, step, batch):
        loss, grads = value_and_grad(params, cfg, batch, topts.microbatch,
                                     place=plc)
        gnorm = None
        if plc is not None:
            leaves = plc.reduce_grads(tree_leaves(grads), specs)
            gnorm = plc.grad_norm(leaves, specs)
            it = iter(leaves)
            grads = tree_map(lambda _: next(it), params)
        lr_scale = cosine_schedule(step, topts.warmup_steps,
                                   topts.total_steps)
        params, opt_state, metrics = adamw_update(
            params, grads, opt_state, topts.opt, lr_scale, gnorm=gnorm)
        if plc is None:
            metrics["loss"] = loss
        else:                       # the rank's share of the loss
            metrics["loss"] = plc.all_reduce(loss, AXES)
            metrics["rank_loss"] = loss * plc.desc.size
        return params, opt_state, metrics

    train_step.placement = plc
    return train_step


def make_prefill_step(cfg, plan: "CellPlan | None" = None):
    """-> prefill_step(params, batch) -> (last logits (B, V), cache): the
    cache has one entry per layer, by block kind: {"k", "v"} (B, S, KV,
    hd) for attention; for mamba2 {"ssm", "conv"}, the state decode
    continues from (`transformer.init_cache`'s layout).

    With `plan` (`plan_cell`'s of a prefill cell, on a mesh over the
    default process group; every rank must call this) the step's
    arguments are this rank's blocks (`place_params`, `local_batch`) and
    it returns its rows' last logits (B_local, V), whole over the vocab,
    and its blocks of the cache (`plan.cache_specs`), what the
    one-device step gives for them (`transformer.prefill_placed`).  The
    step's `placement` attribute holds the rank's `Placement`."""
    if plan is not None:
        plc = placement_of(plan)

        def placed_prefill(params, batch):
            with torch.no_grad():
                return prefill_placed(params, cfg, batch["tokens"], plc,
                                      frontend_emb=batch.get("frontend_emb"))

        placed_prefill.placement = plc
        return placed_prefill

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, cache = forward(params, cfg, batch["tokens"],
                                    frontend_emb=batch.get("frontend_emb"),
                                    return_cache=True)
        return logits[:, -1, :], cache

    return prefill_step


def make_serve_step(cfg, plan: "CellPlan | None" = None):
    """-> serve_step(params, cache, tokens, pos) -> (next tokens (B,)
    int32, cache): one `decode_step` (which writes the new token into
    `cache` in place) and the greedy choice of each row; an argmax tie
    goes to the lower token id, as `jnp.argmax` breaks it.

    With `plan` (`plan_cell`'s, on a mesh over the default process
    group; every rank must call this, as it creates the mesh's process
    groups) the step's arguments are this rank's blocks (`place_params`,
    `place_cache`, `local_rows`) and it returns this rank's rows' next
    tokens (B_local,), the ones the one-device step gives for those
    rows; the argmax runs across the vocab shards.  The step's
    `placement` attribute holds the rank's `Placement` (its collectives'
    `traffic`)."""
    if plan is None:
        def serve_step(params, cache, tokens, pos):
            with torch.no_grad():
                logits = decode_step(params, cfg, cache, tokens, pos)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

        return serve_step
    plc = placement_of(plan)

    def placed_step(params, cache, tokens, pos):
        with torch.no_grad():
            logits = decode_step(params, cfg, cache, tokens, pos, place=plc)
        return plc.argmax(logits, plan.vocab_entry), cache

    placed_step.placement = plc
    return placed_step


# ----------------------------------------------------------------------
# cell planner
# ----------------------------------------------------------------------
@dataclasses.dataclass
class CellPlan:
    """What a placed cell's ranks share: the binding of the logical axes,
    the `P` of every parameter and cache leaf (a prefill's: of the cache
    it returns; a train cell has none), the batch's entry (its rows over
    dp, or None: replicated), the vocab shards' entry of the logits
    (None: whole, as a prefill returns them), the residual stream's
    sequence entry (a prefill or train step under context or sequence
    parallelism), the number of MoE token groups and a train cell's
    microbatch count.  `mesh` is a DeviceMesh (or a description whose
    ranks are 0..n-1 row-major)."""
    cfg: ModelConfig
    shape: ShapeSpec
    mesh: object
    binding: dict
    param_specs: object
    cache_specs: list | None
    batch_entry: object
    vocab_entry: object
    recipe: str = "tp"
    seq_entry: object = None
    moe_groups: int = 1
    microbatch: int = 1

    @property
    def opt_specs(self) -> dict:
        """A train cell's AdamW state's specs: both moments placed like
        the parameters, the count replicated (the reference's
        `ospecs`)."""
        return {"m": self.param_specs, "v": self.param_specs, "count": P()}


def placement_of(plan: CellPlan, dry: bool = False,
                 rank: int = 0) -> Placement:
    """The rank's `Placement` of a planned cell (collective unless `dry`;
    a dry one is global rank `rank`)."""
    return Placement(plan.mesh, plan.param_specs, plan.cache_specs,
                     plan.batch_entry, seq=plan.seq_entry,
                     moe_groups=plan.moe_groups, dry=dry, rank=rank)


def cell_binding(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 recipe: str = "tp", microbatch: int = 1) -> dict:
    """The reference's `plan_cell` binding (`repro/launch/steps.py:
    153-161`): long_500k spreads the KV sequence over ("data", "model");
    an SSM architecture keeps context parallelism off."""
    has_ssm = any(b.kind == "mamba2" for b in layer_blocks(cfg))
    binding = axis_binding(mesh, shape_kind=shape.kind,
                           seq_over_all=shape.name == "long_500k",
                           recipe=recipe,
                           batch=shape.batch // max(microbatch, 1),
                           allow_sp=not has_ssm)
    binding["mesh"] = describe_mesh(mesh)
    return binding


@functools.lru_cache(maxsize=16)
def _shapes(cfg: ModelConfig):
    """`param_shapes`, kept: the specs only read it."""
    return param_shapes(cfg)


def cell_param_specs(cfg: ModelConfig, shape: ShapeSpec, binding: dict,
                     params=None):
    """`param_specs` of the cell's parameters (`param_shapes` unless
    given) under `binding`; decode takes the weight-stationary expert
    layout, as the reference's `plan_cell` does."""
    return param_specs(params if params is not None else _shapes(cfg),
                       cfg, binding["mesh"], dp_axes=binding["dp"],
                       tp_axes=binding["tp"], fsdp_axes=binding["fsdp"],
                       vocab_axes=binding["vocab"],
                       embed_d_axes=binding["embed_d"],
                       moe_ff_sharded=shape.kind == "decode")


def batch_entry(rows: int, binding: dict):
    """The spec entry of a batch dim of `rows` (`_batch_specs`): the dp
    axes where they divide it, else None."""
    dp = tuple(binding["dp"])
    n = 1
    for a in dp:
        n *= binding["mesh"].shape[a]
    if not dp or rows % n:
        return None
    return dp[0] if len(dp) == 1 else dp


def _entry(axes: tuple, dim: int, mesh):
    """`axes` as a spec entry where they divide `dim` (else None)."""
    if not axes or dim % shard_count(tuple(axes), mesh):
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def plan_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
              recipe: str = "tp", *, microbatch: int = 1) -> CellPlan:
    """Place a cell on a ("data", "model") mesh as the reference's
    `plan_cell` does (`repro/launch/steps.py:144-206`): the binding of
    `cell_binding` (at a train cell's microbatch rows; decode ignores
    the recipe; long_500k binds the KV sequence over ("data",
    "model")), `param_specs` (decode's weight-stationary experts,
    `moe_ff_sharded`), and the batch over dp where it divides.

    A train cell's moments go like the parameters (`CellPlan.opt_specs`)
    and it has no cache; with `microbatch` M > 1 a rank's rows of
    microbatch i are the dp block of microbatch i's rows (`local_batch`),
    as the reference's accumulation scan shards them, so the dp size
    must divide the rows of a microbatch.  A decode or prefill cell's
    cache is `cache_specs(seq_axes=binding["seq"])` over a decode's
    (batch, seq) `init_cache` or a prefill's output
    (`prefill_cache_shapes`, the reference's `_prefill_cache_shape`),
    each spec `dedupe`d.  A prefill's or train step's residual stream is
    cut along the sequence over the binding's sp axes that dp leaves
    (context parallelism, or Megatron-style sequence parallelism where
    sp = tp), and its MoE layers route in |moe_g| token groups; a
    prefill's logits come back whole.  Needs no process group."""
    if shape.kind != "train" and microbatch != 1:
        raise ValueError(f"a {shape.kind} cell has no microbatches")
    binding = cell_binding(cfg, shape, mesh, recipe, microbatch)
    m = binding["mesh"]
    pspecs = cell_param_specs(cfg, shape, binding)
    rows = batch_entry(shape.batch, binding)
    if shape.kind == "decode":
        vocab = pspecs["embed"][0] if cfg.tie_embeddings \
            else pspecs["lm_head"][1]
        return CellPlan(cfg=cfg, shape=shape, mesh=mesh, binding=binding,
                        param_specs=pspecs,
                        cache_specs=_cache_specs(init_cache(
                            cfg, shape.batch, shape.seq,
                            torch.device("meta")), binding),
                        batch_entry=rows, vocab_entry=vocab, recipe=recipe)
    if shape.batch % microbatch or (
            rows is not None
            and (shape.batch // microbatch) % shard_count(rows, m)):
        raise ValueError(f"{shape.batch} rows in {microbatch} microbatches "
                         f"do not split over the batch's {rows}")
    seq = _entry(tuple(a for a in binding["sp"] if a not in binding["dp"]),
                 shape.seq, m)
    cspecs = None if shape.kind == "train" else _cache_specs(
        prefill_cache_shapes(cfg, shape.batch, shape.seq), binding)
    return CellPlan(cfg=cfg, shape=shape, mesh=mesh, binding=binding,
                    param_specs=pspecs, cache_specs=cspecs,
                    batch_entry=rows, vocab_entry=None, recipe=recipe,
                    seq_entry=seq,
                    moe_groups=shard_count(tuple(binding["moe_g"]), m),
                    microbatch=microbatch)


def _cache_specs(cache, binding) -> list:
    m = binding["mesh"]
    return [{k: dedupe(spec, m) for k, spec in layer.items()}
            for layer in cache_specs(cache, m, dp_axes=binding["dp"],
                                     tp_axes=binding["tp"],
                                     seq_axes=binding["seq"])]


def _coords(plan: CellPlan, rank: int | None) -> dict:
    return mesh_coords(plan.mesh, dist.get_rank() if rank is None else rank)


def place_params(plan: CellPlan, params, rank: int | None = None,
                 device=None):
    """This rank's blocks of full `params`, in fresh storage."""
    return place(params, plan.param_specs, plan.binding["mesh"],
                 _coords(plan, rank), device)


def place_opt_state(plan: CellPlan, opt_state, rank: int | None = None,
                    device=None):
    """This rank's blocks of a train cell's full AdamW state (the moments
    like the parameters, the count whole), in fresh storage."""
    return place(opt_state, plan.opt_specs, plan.binding["mesh"],
                 _coords(plan, rank), device)


def place_cache(plan: CellPlan, cache, rank: int | None = None,
                device=None):
    """This rank's blocks of a full cache of the cell (a decode's
    `init_cache` of its batch and seq, a prefill's output), in fresh
    storage."""
    return place(cache, plan.cache_specs, plan.binding["mesh"],
                 _coords(plan, rank), device)


def init_placed_cache(plan: CellPlan, device):
    """This rank's blocks of the cell's zeroed decode cache, made at their
    own size (no full cache is built)."""
    full = init_cache(plan.cfg, plan.shape.batch, plan.shape.seq,
                      torch.device("meta"))
    mesh = plan.binding["mesh"]
    return tree_map(lambda t, spec: torch.zeros(
        local_shape(t.shape, spec, mesh), dtype=t.dtype, device=device),
        full, plan.cache_specs)


def local_rows(plan: CellPlan, x, rank: int | None = None):
    """This rank's rows of a (batch, ...) tensor under the batch's
    entry; in a train cell of M > 1 microbatches, its rows of each
    microbatch in turn (the dp block of that microbatch's rows)."""
    M = plan.microbatch
    x = x.reshape(M, x.shape[0] // M, *x.shape[1:])
    spec = P(None, plan.batch_entry, *([None] * (x.dim() - 2)))
    out = place({"x": x}, {"x": spec}, plan.binding["mesh"],
                _coords(plan, rank))["x"]
    return out.reshape(-1, *out.shape[2:])


def local_batch(plan: CellPlan, batch: dict, rank: int | None = None):
    """This rank's rows of every tensor of a batch dict (tokens, and a
    frontend stub's embeddings), whole along the rest: the reference's
    batch spec (`_batch_specs`)."""
    return {k: local_rows(plan, x, rank) for k, x in batch.items()}
