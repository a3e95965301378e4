"""Logical-axis sharding (counterpart of `repro/distributed/sharding.py`).

Model code names tensor dims with *logical* axes; the launcher binds
them to physical mesh axes:

    dp    batch / token parallelism      -> ("data",) | ("pod", "data")
    tp    tensor / expert parallelism    -> ("model",)
    fsdp  weight sharding (ZeRO-3 style) -> ("data",)
    sp    sequence sharding of the residual stream / KV caches
          -> ("model",) when enabled, () to disable.

When no binding is active the specs are empty, so model code never needs
a mesh to run.  Dims whose size does not divide the bound axes fall back
to unsharded (e.g. gemma3's 8 heads on a 16-way model axis).

A mesh is a `torch.distributed.DeviceMesh` or a plain description of
one: a `MeshDesc`, or a (names, sizes) pair.  `describe_mesh` gives the
axis names, sizes and total size of either; nothing here needs a process
group.  `P` is the port's PartitionSpec: a tuple, so a spec compares
equal to the reference's as ``tuple(ref) == tuple(port)``.

Placement is explicit, not by constraint: `shard` checks its dims and
returns its input.  A placed cell (`launch/steps.py:plan_cell`) gives
each rank its blocks of the weights (a train cell's AdamW moments too),
the KV cache and the batch (`distributed/placement.py`), and the placed
decode, prefill and train paths split their activations themselves: a
rank's batch rows over dp, its q/k/v heads, the MLP's ff slice and its
experts over tp, a prefill's or train step's residual sequence over sp,
the KV sequence over `seq`, the logits' vocab over tp, with the gathers,
all-reduces and reduce-scatters between (`models/attention.py`,
`models/moe.py`, `models/mamba2.py`, `models/transformer.py`); a train
step differentiates through them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

DP = "dp"
TP = "tp"
FSDP = "fsdp"
SP = "sp"
VOCAB = "vocab"        # vocab dim of embed/lm_head (static: model axis)
EMBED_D = "embed_d"    # d_model dim of embed/lm_head (static: data axis)
MOEG = "moe_g"         # MoE token-group dim (dp [+ sp under context par.])


class P(tuple):
    """A partition spec: one entry per dim, None (replicated), an axis
    name, or a tuple of axis names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    """Axis names and sizes of a mesh, with the attributes the
    reference's binding code reads from a `jax.sharding.Mesh`."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def describe_mesh(mesh) -> MeshDesc:
    """`MeshDesc` of a DeviceMesh, a MeshDesc or a (names, sizes) pair."""
    if isinstance(mesh, MeshDesc):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # a DeviceMesh
        return MeshDesc(tuple(names), tuple(mesh.shape))
    names, sizes = mesh
    if len(names) != len(sizes):
        raise ValueError(f"mesh names {names} and sizes {sizes} differ "
                         "in length")
    return MeshDesc(tuple(names), tuple(int(s) for s in sizes))


_BINDING: dict | None = None


def set_mesh_axes(dp=("data",), tp=("model",), fsdp=("data",),
                  sp=(), vocab=("model",), embed_d=("data",),
                  moe_g=None, mesh=None) -> None:
    global _BINDING
    _BINDING = {DP: tuple(dp), TP: tuple(tp), FSDP: tuple(fsdp),
                SP: tuple(sp), VOCAB: tuple(vocab),
                EMBED_D: tuple(embed_d),
                MOEG: tuple(moe_g) if moe_g is not None else tuple(dp),
                "mesh": None if mesh is None else describe_mesh(mesh)}


def clear_mesh_axes() -> None:
    global _BINDING
    _BINDING = None


@contextlib.contextmanager
def mesh_axes(**kw):
    global _BINDING
    prev = _BINDING
    set_mesh_axes(**kw)
    try:
        yield
    finally:
        _BINDING = prev


def _size(mesh: MeshDesc | None, axes) -> int:
    return 1 if mesh is None else math.prod(mesh.shape[a] for a in axes)


def axis_size(logical: str) -> int:
    """Product of bound mesh axis sizes for a logical axis (1 if unbound)."""
    if _BINDING is None:
        return 1
    return _size(_BINDING["mesh"], _BINDING.get(logical, ()))


def sp_active() -> bool:
    """True when SP binds at least one axis not claimed by TP or DP —
    i.e. sequence dims are *actually* sharded (context parallelism)."""
    if _BINDING is None:
        return False
    extra = set(_BINDING[SP]) - set(_BINDING[TP]) - set(_BINDING[DP])
    if not extra:
        return False
    mesh = _BINDING["mesh"]
    return mesh is None or _size(mesh, extra) > 1


def logical_spec(*dims, shape=None) -> P:
    """Translate logical dims (None | dp | tp | fsdp | sp | ...) to a
    `P`.  Dims that don't divide the bound axes (when `shape` is given
    and a mesh is bound) fall back to None, and a physical axis already
    claimed by an earlier dim is dropped (first dim wins)."""
    if _BINDING is None:
        return P()
    mesh = _BINDING["mesh"]
    out = []
    used: set = set()
    for i, d in enumerate(dims):
        if d is None:
            out.append(None)
            continue
        phys = tuple(a for a in _BINDING[d] if a not in used)
        # drop trailing axes until the dim divides (e.g. a 16-group
        # tensor under fsdp=("data","model") shards over data only)
        while phys and shape is not None and _size(mesh, phys) > 1 \
                and shape[i] % _size(mesh, phys) != 0:
            phys = phys[:-1]
        if not phys or mesh is not None and _size(mesh, phys) == 1:
            out.append(None)
            continue
        used.update(phys)
        out.append(phys[0] if len(phys) == 1 else phys)
    return P(*out)


def shard(x, *dims):
    """The reference's sharding constraint: checks that `dims` names
    every dim of `x` and returns `x` unchanged.  Nothing is placed by
    constraint: the placed decode path works on each rank's blocks and
    moves them with explicit collectives (see the module docstring)."""
    if len(dims) != x.ndim:
        raise ValueError(f"{len(dims)} logical dims for a tensor of shape "
                         f"{tuple(x.shape)}")
    return x
