"""Cell planner for H100s: the port's counterpart of the reference's dry
run (`repro/launch/dryrun.py` with `launch/hlo_analysis.py`).

    PYTHONPATH=src python -m repro_torch.launch.plan
    PYTHONPATH=src python -m repro_torch.launch.plan --arch llama3-8b \
        --shape decode_32k --mesh 1x2 1x8 --out build/plan

For every (architecture, shape, mesh) cell (the ten architectures x
`SHAPES`, a long_500k cell skipped where `applicable` says so, meshes
given as DATAxMODEL, by default 1x1, 1x4 and 1x8) it says per device,
one H100 a rank:

  * bytes of parameters, gradients and AdamW moments (train) and of the
    KV cache (decode), each `placement.local_bytes` over the cell's
    specs (`steps.plan_cell`), the reference's recipe (`DEFAULT_RECIPE`)
    and moment dtype (`MOMENT_DTYPE`); the transient bytes of the step,
    counted on the meta device by following every tensor the step makes
    until it is freed (a train step's gradients among them); and the
    peak estimate, resident plus transient, against 80 GB (`fits`);
  * the step's FLOPs, counted on the meta device with
    `torch.utils.flop_counter.FlopCounterMode`, to which the kernels add
    their analytic counts (`kernels._build.META_FLOPS`: the decode kernel
    over its valid rows, causal and windowed flash over the (query, key)
    pairs its masks let through, the ssd scan's chunk products), where a
    plain causal core on meta would count all S^2 pairs; beside them the
    reference's `model_flops` (6 N D for train, 2 N D otherwise);
  * the collective bytes per device, counted from the placed step itself
    (`Placement(dry=True)`: the fsdp gathers, the tp all-reduces and
    reduce-scatters, the sequence gathers, the vocab-parallel lookup and
    argmax, the lse merge; in a train step also the remat recompute's
    collectives, the backward's transposes, the gradients' sums over
    their replicas and the clip norm's all-reduce);
  * roofline terms against the H100 SXM's published peaks (989 TFLOP/s
    bf16, 3.35 TB/s HBM, 450 GB/s NVLink each way) and the bottleneck;
    the smallest listed mesh that fits each (architecture, shape).

Every cell is counted per device from its placed step (`steps.plan_cell`
and `make_serve_step`, `make_prefill_step` or `make_train_step`'s path)
on one rank's blocks: rank 0 for decode, the last rank for prefill and
train (under context parallelism it holds the last sequence block, whose
causal attention sees the most keys); a prefill's output cache blocks
are among its transient bytes.  One JSON a cell goes to `--out`
(default `build/plan`, which .gitignore lists).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, get_config
from ..configs.shapes import SHAPES, ShapeSpec, applicable, input_specs
from ..distributed.placement import local_bytes, local_shape, place
from ..distributed.sharding import MeshDesc
from ..kernels import _build
from ..models.config import ModelConfig
from ..models.transformer import (decode_step, init_cache, layer_blocks,
                                  param_shapes, prefill_placed)
from ..optim import AdamWConfig, adamw_init
from ..tree import named_leaves, tree_map
from .steps import (TrainOptions, local_batch, make_train_step,
                    placement_of, plan_cell)

# one H100 SXM (NVIDIA data sheet, 700 W): dense bf16 tensor-core peak,
# HBM3 bandwidth, NVLink 4 bandwidth each way, device memory
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
HBM_BYTES = 80e9
META = torch.device("meta")
MESHES = ("1x1", "1x4", "1x8")

# per-cell recipes and moment dtypes of the reference's dry run
# (`repro/launch/dryrun.py:179-203`), copied: dense archs train and
# prefill in pure FSDP + context parallelism; MoE archs need the model
# axis for expert parallelism; decode cells ignore the recipe
DENSE = ("musicgen-large", "stablelm-3b", "llama3-8b", "minitron-8b",
         "gemma3-4b", "internvl2-1b", "mamba2-1.3b", "zamba2-7b",
         "mixtral-8x22b")
DEFAULT_RECIPE: dict = {}
for _a in DENSE:
    DEFAULT_RECIPE[(_a, "train_4k")] = "fsdp"
    DEFAULT_RECIPE[(_a, "prefill_32k")] = "fsdp"
DEFAULT_RECIPE[("qwen3-moe-235b-a22b", "train_4k")] = "ep"
DEFAULT_RECIPE[("qwen3-moe-235b-a22b", "prefill_32k")] = "ep"
DEFAULT_RECIPE[("mixtral-8x22b", "prefill_32k")] = "tp"
MOMENT_DTYPE = {"qwen3-moe-235b-a22b": "bfloat16",
                "mixtral-8x22b": "bfloat16"}


def recipe_for(arch: str, shape_name: str) -> str:
    return DEFAULT_RECIPE.get((arch, shape_name)) or \
        DEFAULT_RECIPE.get(arch, "tp")


def parse_mesh(name: str) -> MeshDesc:
    """"DATAxMODEL" -> a ("data", "model") mesh description."""
    data, model = (int(x) for x in name.lower().split("x"))
    return MeshDesc(("data", "model"), (data, model))


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """The reference's count: 6 N D (train), 2 N D (prefill), 2 N B
    (decode, one token a sequence); N active parameters."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n * shape.batch * shape.seq
    return 2.0 * n * shape.batch


def param_count(cfg: ModelConfig) -> int:
    """Elements of the port's parameters (vocab padded to 256)."""
    return sum(t.numel() for _, t in named_leaves(param_shapes(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """`param_count` less the experts a token does not use (top_k of
    n_experts), as the reference's `active_param_count`."""
    moe = sum(b.kind == "moe" for b in layer_blocks(cfg))
    return param_count(cfg) - moe * (cfg.n_experts - cfg.top_k) * 3 \
        * cfg.d_model * cfg.d_ff


class LiveBytes(TorchDispatchMode):
    """The peak of the bytes held by tensors made inside the mode (on any
    device, the meta device included): each output storage counts from
    the op that makes it until its last tensor is freed; an in-place
    op's output on a storage made before the mode does not count."""

    def __init__(self):
        super().__init__()
        self.refs: dict = {}
        self.live = self.peak = 0

    def _drop(self, key):
        n, c = self.refs[key]
        if c > 1:
            self.refs[key] = (n, c - 1)
        else:
            del self.refs[key]
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        before = {t.untyped_storage()._cdata
                  for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in before and key not in self.refs:
                continue            # made before the mode: resident
            n, c = self.refs.get(key, (st.nbytes(), 0))
            if c == 0:
                self.live += n
            self.refs[key] = (n, c + 1)
            weakref.finalize(t, self._drop, key)
        self.peak = max(self.peak, self.live)
        return out


def count(fn) -> dict:
    """Run `fn` (on meta tensors) under the FLOP counter and `LiveBytes`;
    -> the counted FLOPs, the kernels' analytic FLOPs and the peak of
    the bytes the run made."""
    for k in _build.META_FLOPS:
        _build.META_FLOPS[k] = 0
    live = LiveBytes()
    with FlopCounterMode(display=False) as fc, live:
        fn()
    kernels = dict(_build.META_FLOPS)
    return dict(counted=int(fc.get_total_flops()), kernels=kernels,
                flops=int(fc.get_total_flops()) + sum(kernels.values()),
                transient=live.peak)


def _meta_tokens(rows: int):
    return torch.zeros(rows, dtype=torch.int32, device=META)


def _placed(cfg, shape, plan, params, topts) -> dict:
    """The placed step of one rank of the cell's mesh (rank 0 for decode,
    the last for prefill and train), on meta blocks, with a dry
    `Placement` (its collectives' bytes counted): a decode step, a
    prefill, or a train step with its AdamW update on the rank's moments
    (made before the count: resident)."""
    mesh = plan.binding["mesh"]
    rank = 0 if shape.kind == "decode" else mesh.size - 1
    plc = placement_of(plan, dry=True, rank=rank)
    p_local = place(params, plan.param_specs, mesh, plc.coords)
    if shape.kind == "decode":
        rows = local_shape((shape.batch,), (plan.batch_entry,), mesh)[0]
        cache = init_cache(cfg, shape.batch, shape.seq, META)
        c_local = place(cache, plan.cache_specs, mesh, plc.coords)
        got = count(lambda: decode_step(p_local, cfg, c_local,
                                        _meta_tokens(rows), shape.seq - 1,
                                        place=plc))
        got["cache"] = local_bytes(cache, plan.cache_specs, mesh)
    else:
        batch = local_batch(plan, input_specs(cfg, shape), rank)
        if shape.kind == "prefill":
            got = count(lambda: prefill_placed(
                p_local, cfg, batch["tokens"], plc,
                frontend_emb=batch.get("frontend_emb")))
        else:
            opt = adamw_init(p_local, topts.opt)
            step = make_train_step(cfg, topts, plan, placement=plc)
            got = count(lambda: step(p_local, opt, 0, batch))
    got["collective"] = dict(plc.traffic)
    return got


def plan_one(cfg: ModelConfig, shape: ShapeSpec, mesh_name: str, *,
             recipe: str | None = None, microbatch: int = 1,
             arch: str | None = None) -> dict:
    """One cell's record (see the module docstring)."""
    arch = arch or cfg.name
    mesh = parse_mesh(mesh_name)
    cell = f"{arch}/{shape.name}/{mesh_name}"
    if not applicable(cfg, shape):
        return {"cell": cell, "status": "SKIP",
                "reason": "long_500k requires sub-quadratic attention"}
    t0 = time.perf_counter()
    recipe = recipe or recipe_for(arch, shape.name)
    n = mesh.size
    params = param_shapes(cfg)
    plan = plan_cell(cfg, shape, mesh, recipe,
                     microbatch=microbatch if shape.kind == "train" else 1)
    binding = plan.binding
    mem = {"params": local_bytes(params, plan.param_specs, mesh)}
    topts = TrainOptions(microbatch=microbatch, opt=AdamWConfig(
        moment_dtype=MOMENT_DTYPE.get(arch, "float32")))
    extra = {}
    if shape.kind == "train":
        mdt = getattr(torch, topts.opt.moment_dtype)
        moments = tree_map(lambda t: torch.empty(t.shape, dtype=mdt,
                                                 device=META), params)
        mem["moments"] = 2 * local_bytes(moments, plan.param_specs, mesh)
        # made and freed inside the step: among its transient bytes
        extra["grads"] = mem["params"]
    got = _placed(cfg, shape, plan, params, topts)
    if "cache" in got:
        mem["cache"] = got.pop("cache")
    flops, transient = got["flops"], got["transient"]
    collective = got.pop("collective")
    resident = sum(mem.values())
    peak = resident + transient
    coll = sum(collective.values())
    touched = resident + (extra["grads"] + mem["params"] + mem["moments"]
                          if shape.kind == "train" else 0)
    terms = {"compute": flops / PEAK_FLOPS, "memory": touched / HBM_BW,
             "collective": coll / NVLINK_BW}
    mf = model_flops(cfg, shape)
    return {
        "cell": cell, "status": "OK", "arch": arch, "shape": shape.name,
        "kind": shape.kind, "batch": shape.batch, "seq": shape.seq,
        "mesh": mesh_name, "n_devices": n, "recipe": recipe,
        "param_count": param_count(cfg),
        "active_param_count": active_param_count(cfg),
        "microbatch": microbatch,
        "binding": {k: list(v) for k, v in binding.items()
                    if k not in ("mesh", "recipe")},
        "bytes_per_device": dict(mem, **extra, resident=resident,
                                 transient=transient, peak=peak),
        "fits": peak <= HBM_BYTES, "hbm_bytes": HBM_BYTES,
        "flops_per_device": flops, "flops_split": "placed",
        "flops_counted": got["counted"], "kernel_flops": got["kernels"],
        "model_flops_global": mf,
        "useful_flops_ratio": mf / (flops * n) if flops else 0.0,
        "collective_bytes_per_device": coll,
        "collective_by_kind": collective,
        "collective_model": "counted",
        "memory_bytes_per_device": touched,
        "roofline_terms_s": terms,
        "bottleneck": max(terms, key=terms.get),
        "plan_s": time.perf_counter() - t0,
        "device": "H100 SXM 80GB (published peaks)",
    }


def _save(rec: dict, out_dir: str | None) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = rec["cell"].replace("/", "__")
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def smallest_fitting(records: list) -> dict:
    """(arch, shape) -> the first mesh (in the records' order, smallest
    first) whose cell fits, or None."""
    out: dict = {}
    for rec in records:
        if rec["status"] == "OK":
            key = (rec["arch"], rec["shape"])
            if out.get(key) is None:
                out[key] = rec["mesh"] if rec["fits"] else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", choices=ARCH_IDS)
    ap.add_argument("--shape", nargs="*", choices=list(SHAPES))
    ap.add_argument("--mesh", nargs="*", default=list(MESHES),
                    help="DATAxMODEL meshes, smallest first")
    ap.add_argument("--out", default="build/plan")
    args = ap.parse_args(argv)
    archs = args.arch or list(ARCH_IDS)
    shapes = args.shape or list(SHAPES)
    records = []
    for arch in archs:
        cfg = get_config(arch)
        for name in shapes:
            for mesh in args.mesh:
                rec = plan_one(cfg, SHAPES[name], mesh, arch=arch)
                _save(rec, args.out)
                records.append(rec)
                if rec["status"] != "OK":
                    print(f"[plan] {rec['cell']}: SKIP", flush=True)
                    continue
                b = rec["bytes_per_device"]
                t = rec["roofline_terms_s"]
                print(f"[plan] {rec['cell']}: peak {b['peak'] / 1e9:.2f} GB "
                      f"({'fits' if rec['fits'] else 'does not fit'}) "
                      f"params {b['params'] / 1e9:.2f} GB "
                      f"flops/dev {rec['flops_per_device']:.3e} "
                      f"coll/dev {rec['collective_bytes_per_device']:.3e} B "
                      f"terms(c/m/coll) {t['compute']:.4f}/"
                      f"{t['memory']:.4f}/{t['collective']:.4f} s -> "
                      f"{rec['bottleneck']}", flush=True)
    fit = smallest_fitting(records)
    for (arch, name), mesh in sorted(fit.items()):
        print(f"[plan] smallest fitting mesh {arch}/{name}: "
              f"{mesh or 'none of ' + ' '.join(args.mesh)}", flush=True)
    if args.out:
        with open(os.path.join(args.out, "fits.json"), "w") as f:
            json.dump({f"{a}/{s}": m for (a, s), m in fit.items()}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
