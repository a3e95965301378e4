"""Placement of parameters, moments and caches across the ranks of a
mesh, and the collectives of the placed decode, prefill and train paths
(the port's counterpart of what `jax.device_put` with a `NamedSharding`
and the SPMD partitioner do in the reference's `plan_cell`,
`repro/launch/steps.py:144-207`).

A spec is a `sharding.P`: one entry per dim, None (replicated), a mesh
axis name or a tuple of them.  A dim bound to several axes is cut
row-major over them, as `jax.sharding` lays a tuple of axes out: shard
index = i_0 * n_1 + i_1 for axes (a_0, a_1).

  * `local_shard(t, spec, mesh, coords)` is the block of `t` that the rank
    at mesh coordinates `coords` holds; `place` applies it to a tree and
    copies each block into fresh contiguous storage, so that the full
    tensor can be freed; `local_bytes` is a rank's resident bytes of a
    placed tree (every rank holds the same: a spec cuts only dims that
    its axes divide).
  * `Placement` is one rank's view of a placed cell: its coordinates,
    the process groups along ("data",), ("model",) and ("data", "model")
    (`launch/mesh.py:axis_group`), and the collectives the placed paths
    run over them: the all-gather of a weight's fsdp dim before its use
    (`take`: a weight cut to the block a computation needs), the
    all-reduce or reduce-scatter after a row-parallel product, the
    sequence all-gathers of a sequence-sharded residual, the
    vocab-parallel lookup and argmax, and the log-sum-exp merge of a
    sequence-sharded cache's partial attentions.  A dry placement
    (`dry=True`) needs no process group: it is one rank of the mesh, its
    collectives return the shapes the real ones would, and both kinds
    count the bytes each would send (`traffic`), for the planner
    (`launch/plan.py`).
  * Under autograd the collectives differentiate (`_AllGather`,
    `_AllReduce`, `_ReduceScatter`, which `take`, `gather_axis` and
    `all_gather_many` reach).  One rule covers every placed path: the
    global loss is the sum over ranks of the ranks' losses, so each
    collective's backward is its transpose under that sum (all-gather
    and reduce-scatter swap, all-reduce is its own), run on the same
    group and counted in `traffic` as the forward's; a `block` is a
    local narrow.  A parameter's gradient is then its local gradient
    summed over the ranks that hold the same block (`reduce_grads`), and
    the clip norm counts each block once (`grad_norm`).
"""
from __future__ import annotations

import collections
import dataclasses
import math

import torch
import torch.distributed as dist

from ..tree import named_leaves, tree_map
from .sharding import P, describe_mesh

AXES = ("data", "model")        # a placed cell's mesh
F32 = torch.float32


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_count(entry, mesh) -> int:
    sizes = describe_mesh(mesh).shape
    return math.prod(sizes[a] for a in axes_of(entry))


def shard_index(entry, mesh, coords: dict) -> int:
    """Which block of a dim bound to `entry` the rank at `coords` holds
    (row-major over the entry's axes)."""
    sizes = describe_mesh(mesh).shape
    i = 0
    for a in axes_of(entry):
        i = i * sizes[a] + coords[a]
    return i


def mesh_coords(mesh, rank: int) -> dict:
    """Coordinates of global `rank` on `mesh`: a DeviceMesh's own grid, or
    row-major over a description's axes."""
    m = describe_mesh(mesh)
    if hasattr(mesh, "mesh"):
        grid = mesh.mesh.cpu()
        at = (grid == rank).nonzero()[0].tolist()
        return dict(zip(m.axis_names, at))
    out = {}
    for name, n in reversed(list(zip(m.axis_names, m.sizes))):
        out[name] = rank % n
        rank //= n
    return {a: out[a] for a in m.axis_names}


def local_shape(shape, spec, mesh) -> tuple:
    """The block shape a rank holds of a `shape` tensor placed by `spec`.
    Raises where an axis appears twice or does not divide its dim."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    sizes = describe_mesh(mesh).shape
    seen: set = set()
    out = []
    for dim, entry in zip(shape, spec):
        for a in axes_of(entry):
            if a in seen and sizes[a] > 1:     # a 1-way axis cuts nothing
                raise ValueError(f"axis {a!r} bound twice in {spec}")
            seen.add(a)
        n = shard_count(entry, mesh)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{n} ways ({spec})")
        out.append(dim // n)
    return tuple(out)


def dedupe(spec, mesh):
    """`spec` with every axis of more than one device that an earlier dim
    took dropped from the later dim's entry (a pure-dp prefill's cache
    rule binds "model" to the batch and to the KV heads: a spec JAX's
    `NamedSharding` refuses, and `local_shape` too)."""
    sizes = describe_mesh(mesh).shape
    used: set = set()
    out = []
    for entry in tuple(spec):
        axes = tuple(a for a in axes_of(entry)
                     if a not in used or sizes[a] == 1)
        used.update(axes)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return P(*out)


def local_shard(t, spec, mesh, coords: dict):
    """The block of `t` held at mesh `coords` under `spec` (a view)."""
    local = local_shape(t.shape, spec, mesh)
    out = t
    for dim, (entry, size) in enumerate(zip(tuple(spec), local)):
        if size != t.shape[dim]:
            out = out.narrow(dim, shard_index(entry, mesh, coords) * size,
                             size)
    return out


def place(tree, specs, mesh, coords: dict, device=None):
    """Every leaf of `tree` cut to the block the rank at `coords` holds,
    in fresh contiguous storage on `device` (default: the leaf's), so
    that nothing keeps the full tensor alive.  `specs` has `tree`'s
    structure with a `P` at each leaf."""
    def one(t, spec):
        block = local_shard(t, spec, mesh, coords)
        out = torch.empty(block.shape, dtype=t.dtype,
                          device=t.device if device is None else device)
        return out.copy_(block)

    return tree_map(one, tree, specs)


def local_bytes(tree, specs, mesh) -> int:
    """A rank's resident bytes of `tree` (tensors, meta tensors included)
    placed by `specs`."""
    specs_at = dict(spec_leaves(specs))
    total = 0
    for name, t in named_leaves(tree):
        total += math.prod(local_shape(t.shape, specs_at[name], mesh)) \
            * t.element_size()
    return total


def spec_leaves(specs, prefix: str = ""):
    """(name, P) of a spec tree in `named_leaves`' order and names (a `P`
    is a tuple, so it is a leaf here, not a container)."""
    if specs is None:
        return []
    if isinstance(specs, dict):
        return [x for k, v in sorted(specs.items())
                for x in spec_leaves(v, f"{prefix}/{k}" if prefix
                                      else str(k))]
    if isinstance(specs, list):
        return [x for i, v in enumerate(specs)
                for x in spec_leaves(v, f"{prefix}/{i}" if prefix
                                      else str(i))]
    return [(prefix, tuple(specs))]


@dataclasses.dataclass(frozen=True)
class LayerPlace:
    """What a placed step hands one layer: the placement, the layer's
    parameter specs (a shared layer's: the shared block's) and its
    cache's specs."""
    plc: "Placement"
    spec: dict
    cache: dict | None          # None: a train step (no cache)

    @property
    def seq(self):
        """A decode KV cache's sequence entry (None for an SSM layer)."""
        return self.cache["k"][2] if "k" in self.cache else None


class Placement:
    """One rank's view of a placed cell on a ("data", "model") mesh.
    `seq` is the entry of the residual stream's sequence dim (a prefill
    under context or sequence parallelism; None for decode) and
    `moe_groups` the number of MoE token groups of the whole step (the
    reference's |moe_g|).  Every rank of the default process group must
    construct it (group creation is collective), unless `dry` (then it
    is global rank `rank` of the mesh)."""

    def __init__(self, mesh, param_specs, cache_specs, batch_entry, *,
                 seq=None, moe_groups: int = 1, dry: bool = False,
                 rank: int = 0):
        self.mesh = mesh
        self.desc = describe_mesh(mesh)
        if self.desc.axis_names != AXES:
            raise ValueError(f"a placed decode cell takes a {AXES} mesh, "
                             f"got {self.desc.axis_names}")
        self.param_specs = param_specs
        self.cache_specs = cache_specs
        self.batch_entry = batch_entry
        self.seq = seq
        self.moe_groups = moe_groups
        self.dry = dry
        self.traffic: collections.Counter = collections.Counter()
        if dry:
            self.coords = mesh_coords(self.desc, rank)
            self._groups = {}
        else:
            from ..launch.mesh import axis_group
            self.coords = mesh_coords(mesh, dist.get_rank())
            self._groups = {axes: axis_group(mesh, axes)
                            for axes in (("data",), ("model",), AXES)}

    # ---- the mesh ----
    def count(self, entry) -> int:
        return shard_count(entry, self.desc)

    def index(self, entry) -> int:
        return shard_index(entry, self.desc, self.coords)

    def layer(self, i: int) -> LayerPlace:
        spec = self.param_specs["layers"][i]
        if spec is None:                # a shared_attn occurrence
            spec = self.param_specs["shared"]
        return LayerPlace(self, spec, None if self.cache_specs is None
                          else self.cache_specs[i])

    def split(self, entry):
        """`entry` as the axes a computation splits heads (or ff, or
        experts' work) over: None where it shares an axis with the batch
        entry, whose ranks hold other rows (a pure-dp prefill under "ep"
        keeps tp for the experts; its attention gathers the heads)."""
        if set(axes_of(entry)) & set(axes_of(self.batch_entry)):
            return None
        return entry

    def block(self, x, entry, dim: int):
        """This rank's block along `dim` of `x` (whole along it) under
        `entry`."""
        n = self.count(entry)
        if n == 1:
            return x
        size = x.shape[dim] // n
        return x.narrow(dim, self.index(entry) * size, size)

    def _group(self, entry, ordered: bool):
        axes = axes_of(entry)
        key = tuple(a for a in AXES if a in axes)
        if ordered and key != axes:
            raise ValueError(f"a gather over {axes} needs the mesh's order "
                             f"{key}")
        return self._groups[key].group

    # ---- collectives (each a no-op over one rank; under autograd each
    # differentiates, its backward the transpose on the same group) ----
    def all_gather(self, x, entry, dim: int):
        """The blocks of `x` of every rank along `entry`'s axes,
        concatenated along `dim` in shard order."""
        if self.count(entry) == 1:
            return x
        if _grad(x):
            return _AllGather.apply(x, self, entry, dim)
        return self._all_gather(x, entry, dim)

    def all_reduce(self, x, entry):
        """The sum of `x` over `entry`'s axes, added in float32 and
        returned in `x`'s dtype (a new tensor)."""
        if self.count(entry) == 1:
            return x
        if _grad(x):
            return _AllReduce.apply(x, self, entry)
        return self._all_reduce(x, entry)

    def reduce_scatter(self, x, entry, dim: int):
        """The sum of `x` over `entry`'s axes, of which this rank keeps
        its block along `dim` (`block`), added in float32 and returned in
        `x`'s dtype.  NCCL reduce-scatters; gloo, which has no
        reduce-scatter, all-reduces and cuts (the bytes counted are a
        reduce-scatter's either way)."""
        if self.count(entry) == 1:
            return x
        if _grad(x):
            return _ReduceScatter.apply(x, self, entry, dim)
        return self._reduce_scatter(x, entry, dim)

    def _all_gather(self, x, entry, dim: int):
        n = self.count(entry)
        self.traffic["all_gather"] += (n - 1) * x.numel() * x.element_size()
        if self.dry:
            return torch.cat([x] * n, dim)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._group(entry, True))
        return torch.cat(parts, dim)

    def _all_reduce(self, x, entry):
        n = self.count(entry)
        y = x.to(F32).contiguous()
        self.traffic["all_reduce"] += \
            2 * (n - 1) * y.numel() * y.element_size() // n
        if self.dry:
            return x
        if y.data_ptr() == x.data_ptr():
            y = y.clone()
        dist.all_reduce(y, group=self._group(entry, False))
        return y.to(x.dtype)

    def _reduce_scatter(self, x, entry, dim: int):
        n = self.count(entry)
        y = x.to(F32).movedim(dim, 0).contiguous()
        self.traffic["reduce_scatter"] += \
            (n - 1) * y.numel() * y.element_size() // n
        if self.dry:
            return self.block(x, entry, dim)
        group = self._group(entry, True)
        if dist.get_backend(group) == "nccl":
            out = y.new_empty((y.shape[0] // n, *y.shape[1:]))
            dist.reduce_scatter_tensor(out, y, group=group)
        else:
            if y.data_ptr() == x.data_ptr():
                y = y.clone()
            dist.all_reduce(y, group=group)
            out = self.block(y, entry, 0).clone()     # frees the rest
        return out.movedim(0, dim).to(x.dtype)

    def all_gather_many(self, xs, entry, dim) -> list:
        """`all_gather` of each of `xs` (one dtype) along `dim` (an int,
        or one a tensor) in one collective."""
        n = self.count(entry)
        if n == 1:
            return list(xs)
        dims = [dim] * len(xs) if isinstance(dim, int) else list(dim)
        parts = self.all_gather(torch.cat([x.reshape(-1) for x in xs])[None],
                                entry, 0)                   # (n, total)
        out, at = [], 0
        for x, d in zip(xs, dims):
            part = parts[:, at:at + x.numel()].reshape(n, *x.shape)
            at += x.numel()
            part = part.movedim(0, d)                     # (..., n, size, ...)
            out.append(part.reshape(*x.shape[:d], n * x.shape[d],
                                    *x.shape[d + 1:]))
        return out

    def take(self, w, spec, want):
        """The block of weight `w` (this rank's block under `spec`) that
        a computation laid out by `want` (one entry per dim) needs: each
        dim whose entry differs is all-gathered whole over `spec`'s
        entry, then cut to this rank's block under `want`'s."""
        for dim, (have, need) in enumerate(zip(tuple(spec), tuple(want))):
            if have == need:
                continue
            if have is not None:
                w = self.all_gather(w, have, dim)
            if need is not None:
                w = self.block(w, need, dim)
        return w

    def gather_axis(self, w, spec, axis: str = "data"):
        """`w` with every dim bound to `axis` alone all-gathered: the fsdp
        dims of a weight before its use."""
        return self.take(w, spec, tuple(None if e == axis else e
                                        for e in tuple(spec)))

    # ---- a placed train step's gradients and leaves ----
    def replicated(self, spec):
        """The entry of the mesh axes (of more than one device) that
        `spec` leaves a tensor replicated over, in the mesh's order, or
        None."""
        used = {a for e in tuple(spec) for a in axes_of(e)}
        axes = tuple(a for a in AXES
                     if a not in used and self.desc.shape[a] > 1)
        return None if not axes else axes[0] if len(axes) == 1 else axes

    def reduce_grads(self, grads: list, specs: list) -> list:
        """Each leaf's local gradient summed over the ranks that hold the
        same block of it (the axes its spec leaves it replicated on), in
        float32: one all-reduce for all the leaves of one such entry.
        A leaf held by one rank keeps its gradient as it is."""
        out = list(grads)
        by_entry: dict = {}
        for i, spec in enumerate(specs):
            entry = self.replicated(spec)
            if entry is not None:
                by_entry.setdefault(entry, []).append(i)
        for entry, idx in by_entry.items():
            flat = self.all_reduce(torch.cat(
                [grads[i].reshape(-1).to(F32) for i in idx]), entry)
            at = 0
            for i in idx:
                n = grads[i].numel()
                out[i] = flat[at:at + n].view(grads[i].shape)
                at += n
        return out

    def grad_norm(self, grads: list, specs: list):
        """The global L2 norm of gradients placed by `specs` (each summed
        over its replicas, `reduce_grads`): each leaf's float32 sum of
        squares counted on the first rank of its replicas only, summed
        over the leaves in tree order and all-reduced over the mesh."""
        sq = sum(g.to(F32).square().sum() if self.index(self.replicated(s))
                 == 0 else torch.zeros((), dtype=F32, device=g.device)
                 for g, s in zip(grads, specs))
        return torch.sqrt(self.all_reduce(sq, AXES))

    def gather_whole(self, t, spec):
        """Leaf `t` (this rank's block under `spec`) whole on every
        rank."""
        return self.take(t, spec, (None,) * t.dim())

    # ---- the placed decode path's own collectives ----
    def embed(self, table, tokens, spec):
        """Vocab-parallel lookup: `table` is this rank's (V/v, d/e) block
        of the (V, d) embedding placed by `spec` (vocab entry, d entry);
        `tokens` this rank's rows.  A masked local lookup, an all-reduce
        over the vocab axes and an all-gather of d; where d and the batch
        share an axis, the token ids are gathered first and this rank's
        rows taken at the end.  -> (rows, d) in the table's dtype."""
        v_entry, d_entry = tuple(spec)
        shared = set(axes_of(d_entry)) & set(axes_of(self.batch_entry))
        ids = self.all_gather(tokens, self.batch_entry, 0) if shared \
            else tokens
        V = table.shape[0]
        local = ids.long() - self.index(v_entry) * V
        hit = (local >= 0) & (local < V)
        x = table[local.clamp(0, V - 1)] * hit[:, None].to(table.dtype)
        x = self.all_gather(self.all_reduce(x, v_entry), d_entry, 1)
        if shared:
            n = tokens.shape[0]
            x = x[self.index(self.batch_entry) * n:][:n]
        return x

    def argmax(self, logits, v_entry):
        """Greedy tokens of vocab-sharded `logits` (rows, V/v): the
        largest logit over every shard, a tie going to the lower token
        id, as `torch.argmax` (and `jnp.argmax`) over the whole row do.
        -> (rows,) int32."""
        V = logits.shape[-1]
        idx = torch.argmax(logits, dim=-1)
        ids = idx + self.index(v_entry) * V
        if self.count(v_entry) == 1:
            return ids.to(torch.int32)
        val = logits.gather(-1, idx[:, None])[:, 0]
        pair = torch.stack([val.double(), ids.double()])[None]   # exact
        both = self.all_gather(pair, v_entry, 0)                 # (n, 2, B)
        vals, cand = both[:, 0], both[:, 1]
        best = vals.max(dim=0).values
        cand = torch.where(vals == best, cand, torch.inf)
        return cand.min(dim=0).values.to(torch.int32)

    def logit_gap(self, logits, ids, v_entry):
        """Per row, the largest of vocab-sharded `logits` less the logit
        of token `ids` (0 where `ids` is the argmax), in float32."""
        V = logits.shape[-1]
        local = ids.long() - self.index(v_entry) * V
        hit = (local >= 0) & (local < V)
        at = logits.gather(-1, local.clamp(0, V - 1)[:, None])[:, 0].float()
        pair = torch.stack([logits.max(dim=-1).values.float(),
                            torch.where(hit, at, -torch.inf)])[None]
        both = self.all_gather(pair, v_entry, 0).amax(dim=0)    # (2, rows)
        return both[0] - both[1]

    def merge_seq(self, out, lse, seq_entry):
        """Merge the partial attentions of a cache's sequence shards:
        `out` (B, H, D) normalised over this shard's keys and its float32
        row `lse` (B, H) (-inf for an empty shard), all-gathered along
        `seq_entry` and merged with `models.common.merge_partials` (each
        shard's l is 1 at m = its lse).  -> (B, H, D) in out's dtype,
        the same on every rank of the group."""
        if self.count(seq_entry) == 1:
            return out
        from ..models.common import merge_partials
        packed = torch.cat([out.to(F32), lse[..., None]], dim=-1)[None]
        parts = self.all_gather(packed, seq_entry, 0)
        merged = merge_partials([(p[..., :-1], torch.ones_like(p[..., -1]),
                                  p[..., -1]) for p in parts])
        return merged.to(out.dtype)


def _grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _fresh(out, x):
    """`out`, or a copy where a dry collective handed back `x` or a view
    of it (a custom Function's output may not alias its input)."""
    if out is x or out._base is x or (x._base is not None
                                      and out._base is x._base):
        return out.clone()
    return out


class _AllGather(torch.autograd.Function):
    """`Placement.all_gather`; backward: the gradient reduce-scattered
    over the same axes, each rank keeping its block's sum."""

    @staticmethod
    def forward(ctx, x, plc, entry, dim):
        ctx.args = (plc, entry, dim)
        return plc._all_gather(x, entry, dim)

    @staticmethod
    def backward(ctx, g):
        plc, entry, dim = ctx.args
        return plc._reduce_scatter(g, entry, dim), None, None, None


class _AllReduce(torch.autograd.Function):
    """`Placement.all_reduce`; backward: the gradient all-reduced."""

    @staticmethod
    def forward(ctx, x, plc, entry):
        ctx.args = (plc, entry)
        return _fresh(plc._all_reduce(x, entry), x)

    @staticmethod
    def backward(ctx, g):
        plc, entry = ctx.args
        return _fresh(plc._all_reduce(g, entry), g), None, None


class _ReduceScatter(torch.autograd.Function):
    """`Placement.reduce_scatter`; backward: the gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, plc, entry, dim):
        ctx.args = (plc, entry, dim)
        return _fresh(plc._reduce_scatter(x, entry, dim), x)

    @staticmethod
    def backward(ctx, g):
        plc, entry, dim = ctx.args
        return plc._all_gather(g, entry, dim), None, None, None
