"""The H100 cell planner (`repro_torch.launch.plan`): its parameter
counts against the reference's configs, its model FLOPs against the
reference's formula, its per-device bytes against the blocks `place`
gives each rank, the kernels' analytic FLOPs on the meta device, the
placed steps' counted collectives (a train cell's against what gloo
ranks send) and the records it writes.

Only `repro.models.config` and the configs of the reference are imported:
`repro.launch.dryrun` sets XLA_FLAGS to 512 host devices at import."""
import json
import math

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.distributed.placement import local_bytes, place
from repro_torch.kernels import _build, ops
from repro_torch.launch import plan, steps
from repro_torch.models import transformer
from repro_torch.tree import tree_leaves

META = torch.device("meta")


def shared_block(cfg) -> int:
    """Elements of one shared attention block (zamba2's), as the
    reference's `param_count` sums a block."""
    d, hd = cfg.d_model, cfg.head_dim
    return d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
        + cfg.n_heads * hd * d + 3 * d * cfg.shared_attn_d_ff + 2 * d


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_reference(arch):
    """The planner counts the reference's `init_params` tree element for
    element.  Against its analytic `param_count` and
    `active_param_count` the planner has the vocab padding and the final
    norm more, which the formula leaves out, and for zamba2 12/13 of the
    shared block: the formula adds it once at 1/13 (`cnt / repeat` in a
    loop that runs once a stage), though the tree holds it whole."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    tree = jax.eval_shape(lambda k: jtransformer.init_params(k, jcfg),
                          jax.random.key(0))
    assert plan.param_count(cfg) == sum(
        math.prod(x.shape) for x in jax.tree.leaves(tree))
    pad = (transformer.padded_vocab(cfg) - cfg.vocab) * cfg.d_model \
        * (1 if cfg.tie_embeddings else 2)
    extra = pad + cfg.d_model
    if arch == "zamba2-7b":
        repeat = cfg.stages[0][0]
        extra += shared_block(cfg) - shared_block(cfg) / repeat
    assert abs(plan.param_count(cfg) - jcfg.param_count() - extra) < 1
    assert abs(plan.active_param_count(cfg) - jcfg.active_param_count()
               - extra) < 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_is_the_references_formula(arch):
    """6 N D for train, 2 N D for prefill, 2 N B for decode, with the
    reference's active parameter count (`launch/dryrun.py:model_flops`)."""
    jcfg = jget_config(arch)
    n = jcfg.active_param_count()
    for shape in SHAPES.values():
        want = {"train": 6.0 * n * shape.batch * shape.seq,
                "prefill": 2.0 * n * shape.batch * shape.seq,
                "decode": 2.0 * n * shape.batch}[shape.kind]
        assert plan.model_flops(get_config(arch), shape) == want


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-235b-a22b",
                                  "gemma3-4b"])
def test_bytes_per_device_are_the_placed_blocks(arch, mesh):
    """A decode cell's and a train cell's per-device bytes: parameters
    and cache are the bytes of the blocks `place` gives rank 0 of real
    (CPU) trees, and `local_bytes` of the shapes; gradients equal the
    parameters; the moments are two copies of the blocks in the reference's
    moment dtype (bf16 for qwen3)."""
    cfg = smoke_config(arch)
    decode = ShapeSpec("decode_32k", "decode", 32, 4)
    rec = plan.plan_one(cfg, decode, mesh, arch=arch)
    p = steps.plan_cell(cfg, decode, plan.parse_mesh(mesh))
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    cache = transformer.init_cache(cfg, 4, 32, "cpu")
    at = {"data": 0, "model": 0}

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    b = rec["bytes_per_device"]
    assert b["params"] == nbytes(steps.place_params(p, params, rank=0))
    assert b["params"] == local_bytes(transformer.param_shapes(cfg),
                                      p.param_specs, p.binding["mesh"])
    assert b["cache"] == nbytes(place(cache, p.cache_specs,
                                      p.binding["mesh"], at))
    assert b["peak"] == b["params"] + b["cache"] + b["transient"]
    assert rec["flops_split"] == "placed" and rec["fits"]
    train = plan.plan_one(cfg, ShapeSpec("train_4k", "train", 16, 4), mesh,
                          arch=arch)
    tb = train["bytes_per_device"]
    assert tb["grads"] == tb["params"]
    elems = tb["params"] // torch.empty(0, dtype=getattr(
        torch, cfg.dtype)).element_size()
    moment = getattr(torch, plan.MOMENT_DTYPE.get(arch, "float32"))
    assert tb["moments"] == 2 * moment.itemsize * elems
    # the gradients are made and freed inside the counted step
    assert tb["peak"] == tb["params"] + tb["moments"] + tb["transient"]
    assert tb["transient"] > tb["grads"]
    assert train["flops_split"] == "placed"


def test_placed_decode_flops_and_collectives_split_with_the_mesh():
    """On one device the placed decode step sends nothing; on (1, 2) it
    all-gathers and all-reduces, and each device counts about half the
    step's weight products."""
    cfg = smoke_config("llama3-8b")
    shape = ShapeSpec("decode_32k", "decode", 32, 4)
    one = plan.plan_one(cfg, shape, "1x1")
    two = plan.plan_one(cfg, shape, "1x2")
    assert one["collective_bytes_per_device"] == 0
    assert two["collective_by_kind"]["all_reduce"] > 0
    assert two["collective_by_kind"]["all_gather"] > 0
    assert 0.45 < two["flops_per_device"] / one["flops_per_device"] < 0.6
    assert one["kernel_flops"]["decode_attention"] == 4 * 4 * cfg.n_heads \
        * 32 * cfg.head_dim * cfg.n_layers


def test_prefill_and_ssm_decode_cells_are_counted_placed():
    """Prefill cells and the mamba2 and zamba2 decode cells are counted
    from their placed step (collectives counted, not a ring model): a
    pure-dp prefill on (1, 2) does half the one-device FLOPs and sends
    only the fsdp gathers; the context-parallel one (batch 1) also
    gathers K/V, and its last rank, counted, does more than half (its
    causal block sees the most keys); an SSM decode cell all-gathers and
    all-reduces."""
    cfg = smoke_config("llama3-8b")
    one = plan.plan_one(cfg, ShapeSpec("prefill_32k", "prefill", 64, 2),
                        "1x1", recipe="fsdp")
    dp = plan.plan_one(cfg, ShapeSpec("prefill_32k", "prefill", 64, 2),
                       "1x2", recipe="fsdp")
    cp = plan.plan_one(cfg, ShapeSpec("prefill_32k", "prefill", 64, 1),
                       "1x2", recipe="fsdp")
    for rec in (one, dp, cp):
        assert rec["flops_split"] == "placed"
        assert rec["collective_model"] == "counted"
        assert "cache" not in rec["bytes_per_device"]
    assert one["collective_bytes_per_device"] == 0
    assert set(dp["collective_by_kind"]) == {"all_gather"}
    assert abs(dp["flops_per_device"] / one["flops_per_device"] - 0.5) < 0.01
    assert cp["kernel_flops"]["flash_attention"] \
        > dp["kernel_flops"]["flash_attention"] / 2
    assert cp["binding"]["sp"] == ["model"]
    for arch in ("mamba2-1.3b", "zamba2-7b"):
        rec = plan.plan_one(smoke_config(arch),
                            ShapeSpec("decode_32k", "decode", 32, 4), "1x2")
        assert rec["flops_split"] == "placed", arch
        assert rec["collective_by_kind"]["all_gather"] > 0, arch
        assert rec["collective_by_kind"]["all_reduce"] > 0, arch
    train = plan.plan_one(cfg, ShapeSpec("train_4k", "train", 16, 4), "1x2")
    assert train["collective_model"] == "counted"


_TRAIN_TRAFFIC = """
from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.sharding import MeshDesc
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.optim import adamw_init
out = {}
for arch, recipe, batch in CELLS:
    cfg = smoke_config(arch)
    plan = steps.plan_cell(cfg, ShapeSpec("train_4k", "train", 16, batch),
                           MeshDesc(("data", "model"), (1, 2)), recipe)
    full = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   torch.device("cpu"))
    params = steps.place_params(plan, full)
    topts = steps.TrainOptions()
    step = steps.make_train_step(cfg, topts, plan)
    tok = torch.zeros((batch, 16), dtype=torch.int32)
    step(params, adamw_init(params, topts.opt), 0, steps.local_batch(
        plan, {"tokens": tok, "labels": tok}))
    out[arch + " " + recipe] = dict(step.placement.traffic)
report(out)
"""
TRAIN_CELLS = [("llama3-8b", "fsdp", 1), ("llama3-8b", "tp", 4),
               ("mamba2-1.3b", "fsdp", 1), ("qwen3-moe-235b-a22b", "ep", 4)]


def test_train_cell_collectives_are_what_ranks_send(tmp_path):
    """A train cell's counted collective bytes (the placed step of the
    last rank under a dry `Placement` on meta blocks: forward, remat
    recompute, backward, the gradients' sums over their replicas and the
    clip norm) equal, kind by kind, what each of two gloo ranks' real
    step sends: llama3 context parallel ("fsdp", batch 1) and under
    "tp", mamba2's replicated residual, qwen3-moe under "ep"."""
    from test_torch_distributed import run_ranks
    got = run_ranks(tmp_path, 2, _TRAIN_TRAFFIC.replace(
        "CELLS", repr(TRAIN_CELLS)), timeout=120)
    for arch, recipe, batch in TRAIN_CELLS:
        rec = plan.plan_one(smoke_config(arch), ShapeSpec(
            "train_4k", "train", 16, batch), "1x2", recipe=recipe, arch=arch)
        assert rec["collective_model"] == "counted"
        for r in got:
            assert r[f"{arch} {recipe}"] == rec["collective_by_kind"], (
                arch, recipe)
        assert rec["collective_by_kind"]["reduce_scatter"] > 0, arch


def test_kernel_flops_on_meta_are_analytic():
    """On the meta device the wrappers return their outputs' shapes and
    add the kernel's own FLOP count: causal flash counts the visible
    pairs (S (S + 1) / 2), a window fewer, decode its valid rows."""
    B, S, H, D = 2, 64, 4, 16
    q = torch.empty(B, S, H, D, device=META)
    k = torch.empty(B, S, 2, D, device=META)
    got = plan.count(lambda: ops.flash_attention_fwd(q, k, k))
    assert got["kernels"]["flash_attention"] == 4 * B * H * D * S * (S + 1) \
        // 2
    assert got["counted"] == 0
    got = plan.count(lambda: ops.flash_attention_fwd(q, k, k, window=8))
    assert got["kernels"]["flash_attention"] == 4 * B * H * D * (
        8 * S - 8 * 7 // 2)
    qd = torch.empty(B, H, D, device=META)
    kd = torch.empty(B, 2, 40, D, device=META)
    out, lse = ops.decode_attention_head_major(qd, kd, kd, 33,
                                               return_lse=True)
    assert out.shape == (B, H, D) and lse.shape == (B, H)
    got = plan.count(lambda: ops.decode_attention_head_major(qd, kd, kd, 33))
    assert got["kernels"]["decode_attention"] == 4 * B * H * 33 * D
    assert _build.LAUNCHES["decode_attention"] == 0


def test_live_bytes_follow_tensors_until_freed():
    """`LiveBytes` counts what the run makes while it is alive, not what
    existed before it or what an in-place op writes into."""
    w = torch.empty(256, device=META)              # made before: resident

    def run():
        a = torch.empty(1000, device=META) + 1     # 4000 B
        b = a * 2                                  # +4000 B
        del a
        c = b + 1                                  # +4000 B (a is freed)
        w.add_(1)                                  # in place: no new bytes
        return c

    got = plan.count(run)
    assert got["transient"] == 8000


def test_plan_cli_writes_every_cell(tmp_path):
    """A record per applicable (arch, shape, mesh), a SKIP record where
    long_500k needs sub-quadratic attention, and the smallest fitting
    mesh of each (arch, shape): decode_32k of llama3-8b at batch 128
    holds 550 GB of cache, so one card does not fit it; 8 do."""
    out = tmp_path / "plan"
    assert plan.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                      "long_500k", "--out", str(out)]) == 0
    names = sorted(p.name for p in out.iterdir())
    for shape in ("decode_32k", "long_500k"):
        for mesh in plan.MESHES:
            assert f"llama3-8b__{shape}__{mesh}.json" in names
    rec = json.loads((out / "llama3-8b__long_500k__1x1.json").read_text())
    assert rec["status"] == "SKIP"
    assert not applicable(get_config("llama3-8b"), SHAPES["long_500k"])
    one = json.loads((out / "llama3-8b__decode_32k__1x1.json").read_text())
    assert not one["fits"]
    assert one["bytes_per_device"]["cache"] == 32 * 2 * 128 * 8 * 32768 \
        * 128 * 2
    assert json.loads((out / "fits.json").read_text()) == {
        "llama3-8b/decode_32k": "1x8"}
