"""The placed train step (`launch/steps.py:plan_cell` of a train cell,
`make_train_step(cfg, topts, plan=...)`, `transformer.loss_placed`, the
autograd collectives of `distributed/placement.py`) on gloo CPU ranks,
and its specs against the reference's `plan_cell` train branch.

All ten smoke configs take two AdamW steps at seq 32 (musicgen and
internvl2 behind an 8-row frontend stub) from seeded weights on meshes
(1, 2), (2, 2) and (1, 4), under each of the three recipes of
`axis_binding` ("fsdp", "ep", "tp") at batch 4 (pure dp where the batch
divides the mesh) and batch 1 (context parallelism under "fsdp"; the
residual sequence-sharded with sp = tp under "ep" and "tp"; the SSM
configs on their heads over "model", the residual replicated there); a
run whose binding repeats an earlier one of the same config is skipped.
qwen3-moe at cf 1.25 drops assignments, under "ep" at one microbatch
and at two (a rank's rows of microbatch i are the dp block of that
microbatch's rows, which decides the token groups and so the drops).

Each rank holds only its blocks of the parameters and of both moments.
Each step is held from one state: step 1 from the seeded weights, step 2
from the placed step 1's state gathered whole (AdamW divides each
element's moment by its own root mean square, so an element whose
gradient is a nearly cancelling sum carries that sum's rounding into
its update nearly whole, and two trajectories drift apart by more than
a step's rounding: after two free-running steps on one process, two
orders of summation move a zero-initialised gain by 3e-4 of its norm).
Against the one-process port (computed on each rank; a dropping case's
is the placed step on a (1, 1) mesh routing in the cell's |moe_g|
groups): the global loss and gradient norm within 1e-5 relative, and
every rank's block of every parameter and moment leaf within 1e-5 of
the magnitude of its tree (and 1e-2 of its own: `block_errs` says why
a leaf's own scale is no measure of rounding).  Against the reference's
jitted `make_train_step` from the same states (its MoE layers routing in
the cell's groups), at batch 4: the same within 1e-4 (and 5e-2).  Each
rank's resident parameter and moment bytes are `local_bytes`."""
import dataclasses
import inspect
import json
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.sharding as jsharding
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import input_specs as jinput_specs
from repro.launch import steps as jsteps
from repro.launch.mesh import axis_binding as jaxis_binding
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.convert import (opt_state_from_reference,
                                 opt_state_to_reference,
                                 params_from_reference, params_to_reference,
                                 specs_to_reference)
from repro_torch.distributed.placement import place
from repro_torch.distributed.sharding import MeshDesc
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.optim import adamw_init
from repro_torch.tree import named_leaves
from test_torch_distributed import run_ranks

CPU = torch.device("cpu")
S, B, FRONT, STEPS = 32, 4, 8, 2
RECIPES = ("fsdp", "ep", "tp")
MESHES = [(1, 2), (2, 2), (1, 4)]
BATCHES = (4, 1)
TOPTS = dict(warmup_steps=1, total_steps=100)
# the dropping cases: (case, recipe, microbatch)
DROP = [("qwen3-cf", "ep", 1), ("qwen3-cf", "ep", 2)]
CASES = {a: (a, {}) for a in ARCH_IDS} | {
    "qwen3-cf": ("qwen3-moe-235b-a22b", {"capacity_factor": 1.25})}


def configs(case):
    arch, over = CASES[case]
    return (dataclasses.replace(smoke_config(arch), **over),
            dataclasses.replace(jsmoke_config(arch), **over))


def mesh_of(sizes):
    return MeshDesc(("data", "model"), sizes)


def plan_of(case, recipe, batch, micro, sizes):
    cfg, _ = configs(case)
    return steps.plan_cell(cfg, ShapeSpec("train_4k", "train", S, batch),
                           mesh_of(sizes), recipe, microbatch=micro)


def runs_of(sizes) -> list:
    """(case, recipe, batch, microbatch) of a mesh: every recipe and
    batch, less the runs whose binding repeats one of the same config;
    then the dropping cases."""
    out, seen = [], set()
    for arch in ARCH_IDS:
        for recipe in RECIPES:
            for batch in BATCHES:
                b = plan_of(arch, recipe, batch, 1, sizes).binding
                key = (arch, batch, repr(sorted(
                    (k, v) for k, v in b.items() if k != "recipe")))
                if key not in seen:
                    seen.add(key)
                    out.append((arch, recipe, batch, 1))
    return out + [(c, r, B, m) for c, r, m in DROP]


def batch_of(case, rng):
    cfg, _ = configs(case)
    tok = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok[:, :-1].copy()),
             "labels": torch.from_numpy(tok[:, 1:].copy())}
    if cfg.frontend:
        batch["frontend_emb"] = torch.from_numpy(rng.standard_normal(
            (B, FRONT, cfg.d_model)).astype(np.float32))
    return batch


def reference_fn(case, micro, groups):
    """The reference's jitted `make_train_step` of a case, its MoE layers
    routing in `groups` token groups (traced at the first call)."""
    _, jcfg = configs(case)
    fn = jax.jit(jsteps.make_train_step(
        jcfg, jsteps.TrainOptions(microbatch=micro, **TOPTS)))

    def step(params, opt, i, batch):
        real = jsharding.axis_size
        jsharding.axis_size = lambda name: groups \
            if name == jsharding.MOEG else 1
        try:
            return fn(params, opt, jnp.int32(i), batch)
        finally:
            jsharding.axis_size = real
    return step


def reference_step(fn, case, state, i, batch):
    """One reference step from a port-layout state {"params", "opt"} ->
    (loss, norm, the new state in the port's layout)."""
    cfg, _ = configs(case)
    tree = jax.tree.map(jnp.asarray, params_to_reference(state["params"],
                                                         cfg))
    opt = jax.tree.map(jnp.asarray, opt_state_to_reference(state["opt"],
                                                           cfg))
    tree, opt, m = fn(tree, opt, i, {k: jnp.asarray(v.numpy())
                                     for k, v in batch.items()})
    return float(m["loss"]), float(m["grad_norm"]), {
        "params": params_from_reference(jax.tree.map(np.asarray, tree),
                                        cfg, CPU),
        "opt": opt_state_from_reference(jax.tree.map(np.asarray, opt), cfg,
                                        CPU)}


def block_errs(p_want, m_want, v_want, params, opt):
    """[leaf, error, leaf, error]: the block of this rank with the largest
    error against the magnitude of its tree, and the one with the
    largest against its own: the L2 norm of a block's difference from
    the wanted block, over the L2 norm of the wanted tree of its kind
    (the parameters', or a moment's: this rank's blocks of them) or of
    the wanted block.  The first says every block agrees to the rounding
    of float32 numbers of its tree's size; the second, that no leaf is
    off by a factor or missing a contribution.  A leaf's own scale is no
    measure of rounding: AdamW divides each element's first moment by
    its own root mean square, so an element whose gradient is a nearly
    cancelling sum, or below the optimizer's eps, carries that sum's
    rounding into its update nearly whole (one step moves a
    zero-initialised gain of stablelm's smoke config by 3e-4 of its own
    norm between two orders of summation); the few-element gradients of
    mamba2's dt_bias, A_log and D, sums over the whole scan, round at
    1e-5 of themselves, and a second moment that nearly cancels the
    first magnifies that (4e-3 of zamba2's D against the reference)."""
    def l2(t):
        return float(t.detach().float().norm())

    tree, own = {}, {}
    for kind, got, want in (("params", params, p_want),
                            ("m", opt["m"], m_want),
                            ("v", opt["v"], v_want)):
        want = dict(named_leaves(want))
        scale = math.sqrt(sum(l2(t) ** 2 for t in want.values()))
        for name, t in named_leaves(got):
            w = want[name]
            assert t.shape == w.shape, (kind, name)
            d = l2(t.detach().float() - w.float())
            tree[kind + "/" + name] = d / max(scale, 1e-30)
            own[kind + "/" + name] = d / max(l2(w), 1e-30)
    a, b = max(tree, key=tree.get), max(own, key=own.get)
    return [a, tree[a], b, own[b]]


# Each rank: per run, step 1 from the seeded weights beside one process's
# step 1 from them; then its state gathered whole, and step 2 beside one
# process's step 2 from that state.  The blocks' errors, both metrics and
# both states go back to the test.
_RANK = """
import dataclasses, math, pathlib
from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.placement import local_bytes, spec_leaves
from repro_torch.distributed.sharding import MeshDesc
from repro_torch.launch import steps
from repro_torch.optim import adamw_init
from repro_torch.tree import named_leaves, tree_leaves, tree_map
here = pathlib.Path(sys.argv[3]).parent
root = pathlib.Path(here.joinpath("root").read_text())
spec = json.loads((root / "spec.json").read_text())
mesh = MeshDesc(("data", "model"), SIZES)


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def errs(plan, params, opt, want):
    return block_errs(steps.place_params(plan, want["params"]),
                      steps.place_params(plan, want["opt"]["m"]),
                      steps.place_params(plan, want["opt"]["v"]),
                      params, opt)


ERRS


def gathered(plc, plan, params, opt):
    # the whole state from every rank's blocks (not counted as the step's)
    keep = dict(plc.traffic)
    whole = {"params": tree_map(plc.gather_whole, params, plan.param_specs),
             "opt": tree_map(plc.gather_whole, opt, plan.opt_specs)}
    plc.traffic.clear()
    plc.traffic.update(keep)
    return tree_map(lambda t: t.detach().clone(), whole)


out = []
for i, (case, recipe, batch, micro) in enumerate(RUNS):
    arch, over = spec["cases"][case]
    cfg = dataclasses.replace(smoke_config(arch), **over)
    shape = ShapeSpec("train_4k", "train", spec["S"], batch)
    plan = steps.plan_cell(cfg, shape, mesh, recipe, microbatch=micro)
    full = torch.load(root / f"{case}.pt")
    params = steps.place_params(plan, full)
    topts = steps.TrainOptions(microbatch=micro, **spec["topts"])
    opt = adamw_init(params, topts.opt)
    whole = {k: v[:batch] for k, v in
             torch.load(root / f"{case}_batch.pt").items()}
    step = steps.make_train_step(cfg, topts, plan)
    if case in spec["drop"]:          # one process routing in the groups
        one_plan = dataclasses.replace(steps.plan_cell(
            cfg, shape, MeshDesc(("data", "model"), (1, 1)), recipe,
            microbatch=micro), moe_groups=plan.moe_groups)
        one = steps.make_train_step(cfg, topts, one_plan,
                                    steps.placement_of(one_plan, dry=True))
    else:
        one = steps.make_train_step(cfg, topts)
    mine = steps.local_batch(plan, whole)
    state = {"params": tree_map(torch.clone, full)}
    state["opt"] = adamw_init(state["params"], topts.opt)
    r = dict(case=case, recipe=recipe, batch=batch, micro=micro,
             rows=steps.local_rows(plan, torch.arange(batch)).tolist(),
             seq=plan.seq_entry, groups=plan.moe_groups,
             tp=list(plan.binding["tp"]), dp=list(plan.binding["dp"]),
             losses=[], norms=[], rank_losses=[], one_losses=[],
             one_norms=[], errs=[])
    for s in range(spec["steps"]):
        params, opt, m = step(params, opt, s, mine)
        p1, o1, m1 = one(state["params"], state["opt"], s, whole)
        r["losses"].append(float(m["loss"]))
        r["norms"].append(float(m["grad_norm"]))
        r["rank_losses"].append(float(m["rank_loss"]))
        r["one_losses"].append(float(m1["loss"]))
        r["one_norms"].append(float(m1["grad_norm"]))
        r["errs"].append(errs(plan, params, opt, {"params": p1, "opt": o1}))
        torch.save({"params": params, "opt": opt},
                   here / f"blocks_{i}_{s}_{RANK}.pt")
        state = gathered(step.placement, plan, params, opt)
        if RANK == 0:
            torch.save(state, here / f"state_{i}_{s}.pt")
    r.update(param_bytes=nbytes(params),
             param_local_bytes=local_bytes(full, plan.param_specs, mesh),
             moment_bytes=nbytes([opt["m"], opt["v"]]),
             moment_local_bytes=2 * local_bytes(full, plan.param_specs,
                                                mesh),
             param_full_bytes=nbytes(full),
             traffic=dict(step.placement.traffic))
    out.append(r)
report(out)
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Every mesh's ranks run all their cases (one launch a mesh, the
    three at once); meanwhile the reference's step is traced here for
    each case it is held to.  -> (runs per mesh, each rank's reports,
    the launches' directories, the reference's steps)."""
    root = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(12)
    for case in CASES:
        cfg, _ = configs(case)
        torch.save(transformer.init_params(
            cfg, torch.Generator().manual_seed(0), CPU), root / f"{case}.pt")
        torch.save(batch_of(case, rng), root / f"{case}_batch.pt")
    (root / "spec.json").write_text(json.dumps(
        {"cases": {k: [a, o] for k, (a, o) in CASES.items()}, "S": S,
         "steps": STEPS, "topts": TOPTS,
         "drop": sorted({c for c, _, _ in DROP})}))
    plans = {sizes: runs_of(sizes) for sizes in MESHES}
    got, dirs, errors = {}, {}, []

    def launch(sizes):
        try:
            got[sizes] = run_ranks(dirs[sizes], sizes[0] * sizes[1],
                                   _RANK.replace("SIZES", repr(sizes))
                                   .replace("ERRS", inspect.getsource(
                                       block_errs))
                                   .replace("RUNS", repr(plans[sizes])),
                                   timeout=900)
        except BaseException as e:        # re-raised below
            errors.append(e)

    threads = []
    for sizes in MESHES:
        dirs[sizes] = tmp_path_factory.mktemp("ranks")
        (dirs[sizes] / "root").write_text(str(root))
        threads.append(threading.Thread(target=launch, args=(sizes,)))
        threads[-1].start()
    refs = {}
    try:                    # trace each reference step on its first state
        for case, micro, G in ref_keys():
            fn = reference_fn(case, micro, G)
            state = {"params": torch.load(root / f"{case}.pt")}
            state["opt"] = adamw_init(state["params"],
                                      steps.TrainOptions().opt)
            reference_step(fn, case, state, 0, torch.load(
                root / f"{case}_batch.pt"))
            refs[(case, micro, G)] = fn
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return plans, got, dirs, refs, root


def ref_keys() -> list:
    """(case, microbatch, groups) of every reference step the runs at
    batch B are held to."""
    keys = [(a, 1, 1) for a in ARCH_IDS]
    for c, r, m in DROP:
        keys += [(c, m, G) for G in sorted({
            plan_of(c, r, B, m, s).moe_groups for s in MESHES})]
    return keys


def rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def all_runs(trained):
    plans, got = trained[:2]
    for sizes in MESHES:
        for i, run in enumerate(plans[sizes]):
            yield sizes, i, run, [res[i] for res in got[sizes]]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_placed_train_matches_one_process(trained, sizes):
    """Every run on every rank, both steps, each from one state (step 1
    from the seeded weights, step 2 from the placed step 1's state): the
    global loss and gradient norm within 1e-5 relative of one process's,
    and every block of every parameter and moment leaf within 1e-5 of its
    tree and 1e-2 of itself (`block_errs`); every row trained on some
    rank."""
    for sizes_, i, run, res in all_runs(trained):
        if sizes_ != sizes:
            continue
        rows = set()
        for rank, r in enumerate(res):
            assert (r["case"], r["recipe"], r["batch"], r["micro"]) == run
            for a, b in zip(r["losses"] + r["norms"],
                            r["one_losses"] + r["one_norms"]):
                assert rel(a, b) <= 1e-5, (run, rank, r)
            for s, (leaf, err, own, own_err) in enumerate(r["errs"]):
                assert err <= 1e-5, (run, rank, s, leaf, err)
                assert own_err <= 1e-2, (run, rank, s, own, own_err)
            rows.update(r["rows"])
        assert rows == set(range(run[2])), run


def test_placed_train_matches_reference(trained):
    """The runs at batch 4 (the dropping cases with the reference routing
    in their cells' groups): each rank's loss and norm of both steps
    within 1e-4 relative of the reference's `make_train_step` from the
    same state, and every block of every parameter and moment leaf
    within 1e-4 of the reference's tree and 5e-2 of itself
    (`block_errs`)."""
    plans, got, dirs, refs, root = trained
    from repro_torch.distributed.placement import mesh_coords
    for sizes, i, run, res in all_runs(trained):
        case, recipe, batch, micro = run
        if batch != B:
            continue
        fn = refs[(case, micro, res[0]["groups"] if case not in ARCH_IDS
                   else 1)]
        plan = plan_of(case, recipe, batch, micro, sizes)
        whole = torch.load(root / f"{case}_batch.pt")
        state = {"params": torch.load(root / f"{case}.pt")}
        state["opt"] = adamw_init(state["params"], steps.TrainOptions().opt)
        for s in range(STEPS):
            loss, norm, want = reference_step(fn, case, state, s, whole)
            for rank, r in enumerate(res):
                assert rel(r["losses"][s], loss) <= 1e-4, (sizes, run, s)
                assert rel(r["norms"][s], norm) <= 1e-4, (sizes, run, s)
                blocks = torch.load(dirs[sizes] / f"blocks_{i}_{s}_{rank}.pt")
                at = mesh_coords(plan.binding["mesh"], rank)
                placed = [place(t, plan.param_specs, plan.binding["mesh"], at)
                          for t in (want["params"], want["opt"]["m"],
                                    want["opt"]["v"])]
                leaf, err, own, own_err = block_errs(
                    *placed, blocks["params"], blocks["opt"])
                assert err <= 1e-4, (sizes, run, rank, s, leaf, err)
                assert own_err <= 5e-2, (sizes, run, rank, s, own, own_err)
            state = torch.load(dirs[sizes] / f"state_{i}_{s}.pt")


def test_every_config_and_recipe_ran(trained):
    """All ten configs under all three recipes on every mesh; context
    parallelism ("fsdp" at batch 1), the "tp" recipe's sequence-sharded
    residual and the SSM configs' replicated residual (heads over
    "model", batch 1) among the runs; the dropping cases with more than
    one token group, at one microbatch and at two."""
    plans = trained[0]
    for sizes in MESHES:
        ran = {(c, rc) for c, rc, _, _ in plans[sizes]}
        assert ran >= {(a, rc) for a in ARCH_IDS for rc in RECIPES}, sizes
    runs = [r[0] for _, _, _, r in all_runs(trained)]
    cp = {r["case"] for r in runs if r["recipe"] == "fsdp"
          and r["seq"] == "model" and r["tp"] == []}
    assert cp == set(ARCH_IDS) - {"mamba2-1.3b", "zamba2-7b"}
    sp = {r["case"] for r in runs if r["recipe"] == "tp"
          and r["seq"] == "model" and r["tp"] == ["model"]}
    assert sp == set(ARCH_IDS)
    ssm = [r for r in runs if r["case"] in ("mamba2-1.3b", "zamba2-7b")
           and r["recipe"] == "fsdp" and r["batch"] == 1]
    assert ssm and all(r["seq"] is None and r["tp"] == ["model"]
                       for r in ssm)
    drops = {(r["micro"], r["groups"]) for r in runs
             if r["case"] == "qwen3-cf"}
    assert {m for m, g in drops if g > 1} == {1, 2}


def test_resident_bytes_equal_local_bytes(trained):
    """Each rank's parameters and each of its moments hold exactly
    `local_bytes` of the full tree, fewer than the whole model's."""
    for sizes, _, run, res in all_runs(trained):
        for r in res:
            assert r["param_bytes"] == r["param_local_bytes"], (sizes, run)
            assert r["moment_bytes"] == r["moment_local_bytes"], (sizes, run)
            assert r["param_bytes"] < r["param_full_bytes"], (sizes, run)


def test_rank_loss_is_the_mean_over_its_tokens(trained):
    """`rank_loss`, a rank's share of the loss rescaled to its own tokens,
    averages to the global loss over the ranks (each token held by as
    many ranks as any other)."""
    for sizes, _, run, res in all_runs(trained):
        for s in range(STEPS):
            mean = np.mean([r["rank_losses"][s] for r in res])
            assert rel(mean, res[0]["losses"][s]) <= 1e-5, (sizes, run)


# ----------------------------------------------------------------------
# the rule: each collective's backward is its transpose; a token held
# by r ranks counts once
# ----------------------------------------------------------------------
_TRANSPOSE = """
from repro_torch.distributed.placement import Placement
from repro_torch.distributed.sharding import MeshDesc
torch.manual_seed(0)
mesh = MeshDesc(("data", "model"), (1, 2))
plc = Placement(mesh, None, None, None)
g = torch.Generator().manual_seed(RANK)
out = {}
cases = {
    "all_gather": (lambda x: plc.all_gather(x, "model", 1), (3, 4)),
    "reduce_scatter": (lambda x: plc.reduce_scatter(x, "model", 1), (3, 8)),
    "all_reduce": (lambda x: plc.all_reduce(x, "model"), (3, 4)),
    "take": (lambda x: plc.take(x, (None, "model"), ("model", None)),
             (4, 3)),
    "gather_many": (lambda x: torch.cat([t.reshape(-1) for t in
                    plc.all_gather_many([x, 2 * x], "model", (0, 1))]),
                    (2, 3)),
}
for name, (fn, shape) in cases.items():
    x = torch.randn(shape, generator=g, dtype=torch.float64,
                    requires_grad=True)
    y = fn(x)
    u = torch.randn(y.shape, generator=g, dtype=torch.float64)
    (gx,) = torch.autograd.grad(y, x, u)
    # <u, f(x)> summed over the ranks, by one all-reduce outside autograd
    dot = (u * y.detach()).sum().reshape(1)
    dist.all_reduce(dot)
    xs = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(xs, x.detach().contiguous())
    gs = [torch.empty_like(gx) for _ in range(2)]
    dist.all_gather(gs, gx.contiguous())
    # the sum over ranks of <x, backward(u)>: the adjoint identity
    adj = sum((a * b).sum() for a, b in zip(xs, gs))
    # gradcheck-style: a central difference of the summed <u, f(x)>
    # along a direction e every rank draws the same
    e = torch.randn(shape, generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    vals = []
    for h in (0.5, -0.5):
        with torch.no_grad():
            v = (u * fn(x + h * e)).sum().reshape(1)
        dist.all_reduce(v)
        vals.append(float(v))
    fd = vals[0] - vals[1]
    ge = (gx * e).sum().reshape(1)
    dist.all_reduce(ge)
    out[name] = dict(dot=float(dot), adj=float(adj), fd=fd, ge=float(ge),
                     traffic=dict(plc.traffic))
    plc.traffic.clear()
report(out)
"""


def test_collective_backward_is_its_transpose(tmp_path):
    """On two gloo ranks: for each autograd collective f (all-gather,
    reduce-scatter, all-reduce, and `take` and `all_gather_many` through
    them), the sum over ranks of <x, backward(u)> equals the sum of <u,
    f(x)> (f is linear, so its backward is its transpose under the
    summed loss), and a central difference of that sum along a direction
    equals the gradient's projection (gradcheck's test; f is linear, so
    the step is 0.5); within 1e-6, the rounding of the collectives'
    float32 sums of float64 inputs.  The backward collectives count in
    `traffic` beside the forward's."""
    got = run_ranks(tmp_path, 2, _TRANSPOSE, timeout=120)
    for name in got[0]:
        for r in got:
            c = r[name]
            assert c["dot"] == pytest.approx(c["adj"], rel=1e-6), name
            assert c["fd"] == pytest.approx(c["ge"], rel=1e-6), name
        kinds = set(got[0][name]["traffic"])
        want = {"all_gather": {"all_gather", "reduce_scatter"},
                "take": {"all_gather", "reduce_scatter"},
                "gather_many": {"all_gather", "reduce_scatter"},
                "reduce_scatter": {"all_gather", "reduce_scatter"},
                "all_reduce": {"all_reduce"}}[name]
        assert kinds == want, (name, kinds)


_REPLICATED = """
import dataclasses
from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.sharding import MeshDesc
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.tree import named_leaves, tree_leaves, tree_map
cfg = smoke_config("mamba2-1.3b")
plan = steps.plan_cell(cfg, ShapeSpec("t", "train", 32, 1),
                       MeshDesc(("data", "model"), (1, 2)), "fsdp")
full = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
params = steps.place_params(plan, full)
rng = np.random.default_rng(3)
tok = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 33)).astype(np.int32))
plc = steps.placement_of(plan)
share, grads = steps.value_and_grad(params, cfg, {"tokens": tok[:, :-1],
                                    "labels": tok[:, 1:]}, place=plc)
specs = [s for _, s in steps.spec_leaves(plan.param_specs)]
from repro_torch.tree import tree_leaves
reduced = plc.reduce_grads(tree_leaves(grads), specs)
names = [n for n, _ in named_leaves(grads)]
torch.save(dict(zip(names, reduced)), sys.argv[3] + f".{RANK}.pt")
report(dict(share=float(share), seq=plan.seq_entry,
            batch=plan.batch_entry, tp=list(plan.binding["tp"])))
"""


def test_replicated_residual_gradients_count_once(tmp_path):
    """mamba2 at batch 1 on (1, 2) under "fsdp": the batch cannot split
    and an SSM cell keeps sequence parallelism off, so both ranks hold
    the same tokens (the residual replicated over "model").  Each rank's
    share of the loss is half the one-process loss, and its gradient
    blocks, summed over the ranks that hold them, are the one-process
    gradient's blocks (1x, not 2x) within 1e-5."""
    got = run_ranks(tmp_path, 2, _REPLICATED, timeout=120)
    cfg = smoke_config("mamba2-1.3b")
    full = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   CPU)
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 33)).astype(
        np.int32))
    loss, grads = steps.value_and_grad(full, cfg, {"tokens": tok[:, :-1],
                                                   "labels": tok[:, 1:]})
    plan = steps.plan_cell(cfg, ShapeSpec("t", "train", 32, 1),
                           mesh_of((1, 2)), "fsdp")
    for rank, r in enumerate(got):
        # the batch over the one-device "data" axis only
        assert r["seq"] is None and r["batch"] in (None, "data")
        assert r["tp"] == ["model"]
        assert rel(2 * r["share"], float(loss)) <= 1e-6
        mine = torch.load(tmp_path / f"rendezvous.{rank}.pt")
        want = dict(named_leaves(steps.place_params(plan, grads, rank=rank)))
        for name, g in mine.items():
            err = float((g - want[name]).norm() / want[name].norm())
            assert err <= 1e-5, (rank, name, err)


# ----------------------------------------------------------------------
# specs against the reference's plan_cell train branch (no ranks)
# ----------------------------------------------------------------------
def plain(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [plain(v) for v in tree]
    return tuple(tree)


SPEC_MESHES = [mesh_of(s) for s in ((1, 4), (1, 8), (2, 4), (16, 16))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_specs_match_reference(arch):
    """train_4k under every recipe on (1, 4), (1, 8), (2, 4) and (16, 16),
    at one microbatch and at two: the binding is the reference's (at a
    microbatch's rows); the parameter specs are its `param_specs(
    moe_ff_sharded=False)`, both moments' specs its `ospecs` ("m" and
    "v" the parameters', the count replicated) and the batch's its
    `_batch_specs` over `input_specs`, leaf for leaf."""
    from repro.models.transformer import param_specs as jparam_specs
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, jshape = SHAPES["train_4k"], JSHAPES["train_4k"]
    jparams = jax.eval_shape(lambda k: jtransformer.init_params(k, jcfg),
                             jax.random.key(0))
    has_ssm = any(blk.kind == "mamba2" for _, bs in jcfg.stages
                  for blk in bs)
    for mesh in SPEC_MESHES:
        for recipe in RECIPES:
            for micro in (1, 2):
                plan = steps.plan_cell(cfg, shape, mesh, recipe,
                                       microbatch=micro)
                b = plan.binding
                jb = jaxis_binding(mesh, shape_kind="train", recipe=recipe,
                                   batch=shape.batch // micro,
                                   allow_sp=not has_ssm)
                assert {k: v for k, v in b.items() if k != "mesh"} == jb
                jb["mesh"] = mesh
                want = jparam_specs(jparams, jcfg, mesh, dp_axes=jb["dp"],
                                    tp_axes=jb["tp"], fsdp_axes=jb["fsdp"],
                                    vocab_axes=jb["vocab"],
                                    embed_d_axes=jb["embed_d"],
                                    moe_ff_sharded=False)
                ospecs = plan.opt_specs
                got = {k: specs_to_reference(ospecs[k], cfg)
                       for k in ("m", "v")}
                assert plain(specs_to_reference(plan.param_specs, cfg)) \
                    == plain(want)
                assert plain(got) == plain({"m": want, "v": want})
                assert tuple(ospecs["count"]) == ()
                jbatch = jsteps._batch_specs(jinput_specs(jcfg, jshape), jb)
                for k, v in jbatch.items():
                    assert tuple(v) == (plan.batch_entry,) + (None,) * (
                        len(v) - 1), (k, v)
                assert plan.cache_specs is None
                assert plan.microbatch == micro
