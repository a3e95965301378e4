"""The placed prefill (`launch/steps.py:plan_cell` of a prefill cell,
`make_prefill_step(cfg, plan=...)`, `transformer.prefill_placed`) on gloo
CPU ranks, and its specs against the reference's `plan_cell` prefill
branch.

All ten smoke configs prefill a 64-token prompt (musicgen and internvl2
behind an 8-row frontend stub) from seeded weights (the port's
`init_params`, handed to the reference by `params_to_reference`) on
meshes (1, 2), (2, 2) and (1, 4), under each of the three recipes of
`axis_binding` ("fsdp", "ep", "tp") at batch 4 (pure dp where the batch
divides the mesh), batch 1 (context parallelism under "fsdp"; the
residual sequence-sharded with sp = tp under "ep" and "tp") and, on
(2, 2), batch 2; a run whose binding repeats an earlier one of the same
config is skipped.  Every rank holds only its blocks of the weights and
returns its rows' last logits and its cache blocks: the logits are held
to the one-process port within 1e-5 relative and to the reference's
`forward(return_cache=True)` within 1e-4, every cache block to `place`
of the one-process cache within 1e-5 and of the reference's within 1e-4
relative (the conv window to the port only: the reference hands off the
post-conv stream, `tests/test_torch_mamba2.py`).  The smoke MoE configs
have cf >= E/K, so no token is dropped and any number of token groups
gives one process's output; at cf 1.25 qwen3-moe ("ep") and mixtral
("tp") drop, and are held to the reference run with the placed cell's
|moe_g| groups (its `axis_size` made to return it).  Each rank's
resident bytes are `local_bytes`."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.sharding as jsharding
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch.mesh import axis_binding as jaxis_binding
from repro.launch.steps import _prefill_cache_shape
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.convert import params_to_reference
from repro_torch.distributed.placement import dedupe
from repro_torch.distributed.sharding import MeshDesc
from repro_torch.launch import steps
from repro_torch.models import transformer
from test_torch_distributed import run_ranks

CPU = torch.device("cpu")
S, B, FRONT = 64, 4, 8
RECIPES = ("fsdp", "ep", "tp")
MESHES = [(1, 2), (2, 2), (1, 4)]
BATCHES = {(1, 2): (4, 1), (2, 2): (4, 2, 1), (1, 4): (4, 1)}
# capacity-dropping cases: (arch, the dry run's recipe for its prefill)
DROP = {"qwen3-cf": ("qwen3-moe-235b-a22b", "ep"),
        "mixtral-cf": ("mixtral-8x22b", "tp")}
CASES = {a: (a, {}) for a in ARCH_IDS} | {
    k: (a, {"capacity_factor": 1.25}) for k, (a, _) in DROP.items()}


def configs(case):
    arch, over = CASES[case]
    return (dataclasses.replace(smoke_config(arch), **over),
            dataclasses.replace(jsmoke_config(arch), **over))


def runs_of(sizes) -> list:
    """(case, recipe, batch) of a mesh: every recipe and batch, less the
    runs whose binding repeats one of the same case; the dropping cases
    at batch 4 under their recipe."""
    mesh = MeshDesc(("data", "model"), sizes)
    out, seen = [], set()
    for arch in ARCH_IDS:
        cfg = smoke_config(arch)
        for recipe in RECIPES:
            for batch in BATCHES[sizes]:
                b = steps.cell_binding(cfg, ShapeSpec("p", "prefill", S,
                                                      batch), mesh, recipe)
                key = (arch, batch, repr(sorted(
                    (k, v) for k, v in b.items() if k not in ("recipe",))))
                if key not in seen:
                    seen.add(key)
                    out.append((arch, recipe, batch))
    return out + [(case, recipe, B) for case, (_, recipe) in DROP.items()]


def moe_groups(case, recipe, batch, sizes) -> int:
    cfg, _ = configs(case)
    return steps.plan_cell(cfg, ShapeSpec("p", "prefill", S, batch),
                           MeshDesc(("data", "model"), sizes),
                           recipe).moe_groups


def reference_layers(caches, jcfg) -> list:
    """The reference's stacked prefill caches as the port's per-layer
    list."""
    out = []
    for (repeat, blocks), stage in zip(jcfg.stages, caches):
        for r in range(repeat):
            for bi in range(len(blocks)):
                out.append({k: torch.from_numpy(np.array(v[r]))
                            for k, v in stage[f"b{bi}"].items()})
    return out


def reference_prefill(tree, jcfg, batch, groups: int = 1):
    """The reference's last logits and per-layer cache, its MoE layers
    routing in `groups` token groups."""
    real = jsharding.axis_size
    jsharding.axis_size = lambda name: groups if name == jsharding.MOEG \
        else 1
    try:
        logits, caches = jax.jit(
            lambda t, f: jtransformer.forward(tree, jcfg, t, frontend_emb=f,
                                              return_cache=True))(
            jnp.asarray(batch["tokens"].numpy()),
            None if "frontend_emb" not in batch
            else jnp.asarray(batch["frontend_emb"].numpy()))
    finally:
        jsharding.axis_size = real
    return (torch.from_numpy(np.array(logits[:, -1])),
            reference_layers(caches, jcfg))


@pytest.fixture(scope="module")
def prefilled(tmp_path_factory):
    """The one-process port's and the reference's prefill of every case,
    saved for the ranks; then per mesh every rank's report of its
    runs."""
    root = tmp_path_factory.mktemp("prefill")
    rng = np.random.default_rng(11)
    plans = {sizes: runs_of(sizes) for sizes in MESHES}
    for case in CASES:
        cfg, jcfg = configs(case)
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                         CPU)
        torch.save(params, root / f"{case}.pt")
        tree = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                            params_to_reference(params, cfg))
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
        if cfg.frontend:
            batch["frontend_emb"] = torch.from_numpy(rng.standard_normal(
                (B, FRONT, cfg.d_model)).astype(np.float32))
        torch.save(batch, root / f"{case}_batch.pt")
        if case in DROP:            # the reference at each mesh's groups
            for G in sorted({moe_groups(case, DROP[case][1], B, sizes)
                             for sizes in MESHES}):
                torch.save(reference_prefill(tree, jcfg, batch, G),
                           root / f"{case}_ref_G{G}.pt")
            continue
        torch.save(reference_prefill(tree, jcfg, batch), root /
                   f"{case}_ref.pt")
        for n in sorted({b for bs in BATCHES.values() for b in bs}):
            one = {k: v[:n] for k, v in batch.items()}
            with torch.no_grad():
                torch.save(steps.make_prefill_step(cfg)(params, one),
                           root / f"{case}_port_{n}.pt")
    (root / "spec.json").write_text(json.dumps(
        {"cases": {k: [a, o] for k, (a, o) in CASES.items()}, "S": S,
         "drop": list(DROP)}))
    got = {}
    for sizes in MESHES:
        d = tmp_path_factory.mktemp("ranks")
        (d / "root").write_text(str(root))
        body = _RANK.replace("SIZES", repr(sizes)).replace(
            "RUNS", repr(plans[sizes]))
        got[sizes] = run_ranks(d, sizes[0] * sizes[1], body, timeout=240)
    return plans, got


_RANK = """
import dataclasses, pathlib
from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.placement import local_bytes
from repro_torch.distributed.sharding import MeshDesc
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.tree import tree_leaves
root = pathlib.Path(pathlib.Path(sys.argv[3]).parent.joinpath("root")
                    .read_text())
spec = json.loads((root / "spec.json").read_text())
mesh = MeshDesc(("data", "model"), SIZES)


def rel(got, want):
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def cache_err(plan, got, want, skip=()):
    placed = steps.place_cache(plan, want)
    err = 0.0
    for g, w in zip(got, placed):
        for k, t in g.items():
            assert t.shape == w[k].shape, (k, t.shape, w[k].shape)
            if k not in skip:
                err = max(err, rel(t, w[k]))
    return err


out = []
for case, recipe, batch in RUNS:
    arch, over = spec["cases"][case]
    cfg = dataclasses.replace(smoke_config(arch), **over)
    plan = steps.plan_cell(cfg, ShapeSpec("prefill_32k", "prefill",
                                          spec["S"], batch), mesh, recipe)
    full = torch.load(root / f"{case}.pt")
    params = steps.place_params(plan, full)
    whole = {k: v[:batch] for k, v in
             torch.load(root / f"{case}_batch.pt").items()}
    step = steps.make_prefill_step(cfg, plan)
    mine = steps.local_batch(plan, whole)
    logits, cache = step(params, mine)
    rows = steps.local_rows(plan, torch.arange(batch)).tolist()
    # the planner's dry placement of this rank counts the same bytes
    dry = steps.placement_of(plan, dry=True, rank=dist.get_rank())
    with torch.no_grad():
        transformer.prefill_placed(params, cfg, mine["tokens"], dry,
                                   frontend_emb=mine.get("frontend_emb"))
    r = dict(case=case, recipe=recipe, batch=batch, rows=rows,
             seq=plan.seq_entry, groups=plan.moe_groups,
             tp=list(plan.binding["tp"]), dp=list(plan.binding["dp"]),
             param_bytes=sum(t.numel() * t.element_size()
                             for t in tree_leaves(params)),
             param_local_bytes=local_bytes(full, plan.param_specs, mesh),
             param_full_bytes=sum(t.numel() * t.element_size()
                                  for t in tree_leaves(full)),
             traffic=dict(step.placement.traffic),
             dry_traffic=dict(dry.traffic))
    if case in spec["drop"]:
        ref_l, ref_c = torch.load(root / f"{case}_ref_G{plan.moe_groups}.pt")
    else:
        ref_l, ref_c = torch.load(root / f"{case}_ref.pt")
        port_l, port_c = torch.load(root / f"{case}_port_{batch}.pt")
        r["logits_port"] = rel(logits, port_l[rows])
        r["cache_port"] = cache_err(plan, cache, port_c)
    ref_c = [{k: v[:batch] for k, v in c.items()} for c in ref_c]
    r["logits_ref"] = float((logits - ref_l[rows]).abs().max())
    r["cache_ref"] = cache_err(plan, cache, ref_c, skip=("conv",))
    out.append(r)
report(out)
"""


def all_runs(prefilled):
    plans, got = prefilled
    for sizes in MESHES:
        for res in got[sizes]:
            for r in res:
                yield sizes, r


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_placed_prefill_matches_one_process_and_reference(prefilled, sizes):
    """Every rank, every run: last logits within 1e-5 relative of the
    one-process port and 1e-4 of the reference; every cache block within
    1e-5 relative of `place` of the one-process cache and 1e-4 of the
    reference's; and every row served."""
    plans, got = prefilled
    assert all(len(res) == len(plans[sizes]) for res in got[sizes])
    for i, (case, recipe, batch) in enumerate(plans[sizes]):
        rows = set()
        for res in got[sizes]:
            r = res[i]
            assert (r["case"], r["recipe"], r["batch"]) == (case, recipe,
                                                            batch)
            name = (case, recipe, batch)
            if case not in DROP:
                assert r["logits_port"] <= 1e-5, (name, r)
                assert r["cache_port"] <= 1e-5, (name, r)
            assert r["logits_ref"] <= 1e-4, (name, r)
            assert r["cache_ref"] <= 1e-4, (name, r)
            rows.update(r["rows"])
        assert rows == set(range(batch)), name


def test_every_config_and_recipe_ran(prefilled):
    """All ten configs under all three recipes on every mesh; context
    parallelism ("fsdp" at batch 1: the sequence over "model", tp off)
    and the "tp" recipe's sequence-sharded residual (sp = tp) among the
    runs, the SSM configs keeping their heads over "model" at batch 1;
    the dropping cases with more than one token group on some mesh."""
    plans, got = prefilled
    for sizes in MESHES:
        ran = {(c, rc) for c, rc, _ in plans[sizes]}
        assert ran >= {(a, rc) for a in ARCH_IDS for rc in RECIPES}, sizes
    runs = [(s, r) for s, r in all_runs(prefilled) if r["case"] not in DROP]
    cp = [r for _, r in runs if r["recipe"] == "fsdp" and r["seq"] == "model"
          and r["tp"] == []]
    assert {r["case"] for r in cp} == set(ARCH_IDS) - {"mamba2-1.3b",
                                                       "zamba2-7b"}
    sp = [r for _, r in runs if r["recipe"] == "tp" and r["seq"] == "model"
          and r["tp"] == ["model"]]
    assert {r["case"] for r in sp} == set(ARCH_IDS)
    ssm = [r for _, r in runs if r["case"] in ("mamba2-1.3b", "zamba2-7b")
           and r["recipe"] == "fsdp" and r["batch"] == 1]
    assert ssm and all(r["seq"] is None and r["tp"] == ["model"]
                       for r in ssm)
    assert {r["case"] for _, r in all_runs(prefilled) if r["case"] in DROP
            and r["groups"] > 1} == set(DROP)


def test_resident_bytes_equal_local_bytes(prefilled):
    """Each rank's placed weights hold exactly `local_bytes` of the full
    tree, fewer than the whole model."""
    for sizes, r in all_runs(prefilled):
        assert r["param_bytes"] == r["param_local_bytes"], (sizes, r["case"])
        assert r["param_bytes"] < r["param_full_bytes"], (sizes, r["case"])


def test_dry_placement_counts_the_collectives_a_rank_sends(prefilled):
    """The planner's count (`Placement(dry=True)` at the rank's
    coordinates, no process group) equals the bytes every rank's real
    collectives sent, kind by kind, in every run."""
    for sizes, r in all_runs(prefilled):
        assert r["dry_traffic"] == r["traffic"], (sizes, r["case"],
                                                  r["recipe"], r["batch"])
        assert sum(r["traffic"].values()) > 0, (sizes, r["case"])


# ----------------------------------------------------------------------
# specs against the reference's plan_cell prefill branch (no ranks)
# ----------------------------------------------------------------------
def plain(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [plain(v) for v in tree]
    return tuple(tree)


SPEC_MESHES = [MeshDesc(("data", "model"), s)
               for s in ((1, 4), (1, 8), (2, 4), (16, 16))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_specs_match_reference(arch):
    """prefill_32k under every recipe on (1, 4), (1, 8), (2, 4) and (16,
    16): the binding is the reference's; the parameter specs are its
    `param_specs(moe_ff_sharded=False)`; `cache_specs` over the port's
    `prefill_cache_shapes` is its `cache_specs` over
    `_prefill_cache_shape` leaf for leaf (the KV-head dim over the
    binding's seq axes), and the plan's specs that after `dedupe`, which
    drops "model" from the KV heads where a pure-dp batch took it (JAX
    refuses such a spec; the reference's lowering never met one: its
    production mesh's 256 devices do not divide the batch of 32)."""
    from repro.models.transformer import param_specs as jparam_specs
    from repro_torch.convert import (cache_specs_to_reference,
                                     specs_to_reference)
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, jshape = SHAPES["prefill_32k"], JSHAPES["prefill_32k"]
    jcache = _prefill_cache_shape(jcfg, jshape)
    jparams = jax.eval_shape(lambda k: jtransformer.init_params(k, jcfg),
                             jax.random.key(0))
    cache = transformer.prefill_cache_shapes(cfg, shape.batch, shape.seq)
    for mesh in SPEC_MESHES:
        for recipe in RECIPES:
            plan = steps.plan_cell(cfg, shape, mesh, recipe)
            b = plan.binding
            jb = jaxis_binding(mesh, shape_kind="prefill", recipe=recipe,
                               batch=shape.batch,
                               allow_sp=not any(
                                   blk.kind == "mamba2"
                                   for _, bs in jcfg.stages for blk in bs))
            assert {k: v for k, v in b.items() if k != "mesh"} == jb
            kw = dict(dp_axes=b["dp"], tp_axes=b["tp"], seq_axes=b["seq"])
            want = jtransformer.cache_specs(jcache, mesh, **kw)
            raw = transformer.cache_specs(cache, mesh, **kw)
            assert plain(cache_specs_to_reference(raw, cfg)) == plain(want)
            deduped = [{k: dedupe(v, mesh) for k, v in c.items()}
                       for c in raw]
            assert plain(plan.cache_specs) == plain(deduped)
            assert plain(specs_to_reference(plan.param_specs, cfg)) == plain(
                jparam_specs(jparams, jcfg, mesh, dp_axes=b["dp"],
                             tp_axes=b["tp"], fsdp_axes=b["fsdp"],
                             vocab_axes=b["vocab"],
                             embed_d_axes=b["embed_d"],
                             moe_ff_sharded=False))
            assert plan.vocab_entry is None
            # the residual's sequence entry: sp less dp, where it divides
            sp = tuple(a for a in b["sp"] if a not in b["dp"])
            assert plan.seq_entry == (sp[0] if sp else None)


def test_dedupe_drops_an_axis_taken_earlier():
    """A pure-dp prefill on (1, 8) binds the batch to ("data", "model")
    and the rule binds "model" to the KV heads too; `dedupe` keeps the
    batch's and drops the heads' (a one-device axis may repeat)."""
    mesh = MeshDesc(("data", "model"), (1, 8))
    plan = steps.plan_cell(get_config("llama3-8b"), SHAPES["prefill_32k"],
                           mesh, "fsdp")
    assert plan.binding["dp"] == ("data", "model")
    assert tuple(plan.cache_specs[0]["k"]) == (("data", "model"), None, None,
                                               None)
    assert tuple(dedupe(("model", ("data", "model")), MeshDesc(
        ("data", "model"), (2, 4)))) == ("model", "data")
    assert tuple(dedupe(("data", ("data", "model")), mesh)) == (
        "data", ("data", "model"))


@pytest.mark.parametrize("H,KV,h0,n_q", [(8, 2, 2, 2), (8, 2, 4, 4),
                                         (6, 3, 0, 3), (6, 3, 3, 3)])
def test_kv_heads_of_a_q_head_block(H, KV, h0, n_q):
    """The KV heads a block of q heads reads when the KV heads are whole
    (KV does not divide tp): a contiguous slice where each KV head serves
    the same number of the block's q heads (GQA on the slice), else one
    KV head per q head; either way q head h reads KV head h // G."""
    from repro_torch.models.attention import _kv_of_heads
    cfg = dataclasses.replace(smoke_config("llama3-8b"), n_heads=H,
                              n_kv_heads=KV)
    k = torch.arange(KV, dtype=torch.float32).view(1, 1, KV, 1)
    kq, vq = _kv_of_heads(k, k + 10, cfg, h0, n_q)
    G = n_q // kq.shape[2]
    got = [float(kq[0, 0, i // G, 0]) for i in range(n_q)]
    assert got == [float((h0 + i) // (H // KV)) for i in range(n_q)]
    assert torch.equal(vq, kq + 10)
