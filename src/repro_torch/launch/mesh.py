"""Meshes, logical-axis bindings and the process groups along mesh axes
(counterpart of `repro/launch/mesh.py`).

A mesh is a `torch.distributed.DeviceMesh` over the ranks of the
default process group, or a plain description (`MeshDesc`, or a
(names, sizes) pair) where only the binding is wanted.  The builders
are functions, so importing this module touches no process group.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.sharding import describe_mesh


def make_mesh(sizes: tuple, names: tuple):
    """A DeviceMesh of `sizes` named `names` over the default process
    group's ranks (row-major), on the device type its backend carries
    (NCCL: cuda, gloo: cpu)."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The job's mesh, with the reference's axis names: ("data",
    "model"), or ("pod", "data", "model") over two pods with
    `multi_pod`.

    The reference's shape is a TPU v5e pod's 16 x 16 chips (2 x 16 x 16
    for two pods), whose ICI links every chip of a pod.  A GPU job's fast
    domain is one node (NVLink between its cards) and nodes talk over
    the slower network, so the shape comes from the job instead: "model"
    is the cards of a node (tensor parallelism stays on NVLink), "data"
    the nodes (of a pod), "pod" the pods.  The world size is the default
    process group's; the cards of a node are torchrun's
    LOCAL_WORLD_SIZE, else the cards this process sees."""
    world = dist.get_world_size()
    gpus = int(os.environ.get("LOCAL_WORLD_SIZE",
                              torch.cuda.device_count() or 1))
    if world % gpus:
        raise ValueError(f"world size {world} is not a multiple of "
                         f"{gpus} cards a node")
    nodes = world // gpus
    if multi_pod:
        if nodes % 2:
            raise ValueError(f"{nodes} nodes do not split into 2 pods")
        return make_mesh((2, nodes // 2, gpus), ("pod", "data", "model"))
    return make_mesh((nodes, gpus), ("data", "model"))


def make_debug_mesh(n_devices: int | None = None, model: int = 2):
    """A (n // model, model) ("data", "model") mesh over the first
    `n_devices` ranks (default: all of them)."""
    n = n_devices or dist.get_world_size()
    model = min(model, n)
    return make_mesh((n // model, model), ("data", "model"))


def axis_binding(mesh, *, shape_kind: str = "train",
                 seq_over_all: bool = False, recipe: str = "tp",
                 batch: int | None = None, allow_sp: bool = True) -> dict:
    """Logical->physical bindings for a mesh (see distributed.sharding);
    the reference's recipes, axis for axis.

    "tp" (baseline, Megatron-style):
      dp  = ("pod","data")   batch
      tp  = ("model",)       heads/ffn/experts; also KV-seq for decode
      fsdp= ("data",)        weight sharding; pods replicate weights
      sp  = tp               residual stream S-sharded (dedupes vs tp)

    "fsdp" (no activation all-reduces):
      dp  = every mesh axis when `batch` divides mesh.size; otherwise
            dp = ("pod","data") and, for attention archs, sp =
            ("model",) (context parallelism); SSM archs keep tp
            (allow_sp=False).
      tp  = ()
      fsdp= ("data","model")

    "ep": experts over model; batch over every axis when it divides,
    else context-parallel attention; weights FSDP over data.

    vocab/embed_d are pinned to model/data.  Decode cells ignore the
    recipe; `seq_over_all` spreads the KV-seq over ("data","model")."""
    m = describe_mesh(mesh)
    names = m.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = ("model",) if "model" in names else ()
    fsdp = ("data",) if "data" in names else ()
    sp: tuple = ()
    if shape_kind in ("train", "prefill"):
        if recipe == "fsdp":
            fsdp = tuple(a for a in ("data", "model") if a in names)
            if batch is not None and batch % m.size == 0:
                dp = tuple(names)          # pure DP: fully local layers
                tp = ()
            elif allow_sp:
                sp = tp                    # context parallelism
                tp = ()
        elif recipe == "ep":
            if batch is not None and batch % m.size == 0:
                dp = tuple(names)
            elif allow_sp:
                sp = tp
        else:
            sp = tp
    seq = (("data", "model") if seq_over_all else ("model",))
    seq = tuple(a for a in seq if a in names)
    # MoE token groups follow the token sharding: dp, plus the sp axes
    # under context parallelism
    moe_g = dp + tuple(a for a in sp if a not in dp and a not in tp)
    return dict(dp=dp, tp=tp, fsdp=fsdp, sp=sp, seq=seq, moe_g=moe_g,
                vocab=("model",) if "model" in names else (),
                embed_d=("data",) if "data" in names else (),
                recipe=recipe)


@dataclasses.dataclass
class AxisGroup:
    """The ranks of a mesh that differ only along `axes`, as seen from
    this rank: its process group, its index in the group (row-major
    over `axes`) and the group's size and global ranks."""
    group: object
    index: int
    size: int
    ranks: tuple


def axis_group(mesh, axes) -> AxisGroup:
    """The process group along `axes` of `mesh` that holds this rank.
    Every rank of the default group must call it (group creation is
    collective).  A description's ranks are 0..size-1 in row-major
    order, as a DeviceMesh lays them out."""
    m = describe_mesh(mesh)
    axes = tuple(axes)
    grid = mesh.mesh.cpu().numpy() if hasattr(mesh, "mesh") \
        else np.arange(m.size).reshape(m.sizes)
    along = [m.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(m.sizes)) if i not in along]
    n = int(np.prod([m.sizes[i] for i in along]))
    rows = grid.transpose(rest + along).reshape(-1, n).tolist()
    me = dist.get_rank()
    mine = next(row for row in rows if me in row)
    group, _ = dist.new_subgroups_by_enumeration(rows)
    return AxisGroup(group=group, index=mine.index(me), size=n,
                     ranks=tuple(mine))
