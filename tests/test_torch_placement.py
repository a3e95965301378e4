"""The placed decode path (`launch/steps.py:plan_cell`, `make_serve_step(
plan=...)`, `distributed/placement.py`) on gloo CPU ranks.

Each smoke config is served for 20 steps (past mixtral's and gemma3's
16-slot rings) from seeded weights (the port's `init_params`, handed to
the reference by `params_to_reference`) on meshes (1, 2), (2, 2) and (1, 4), every rank holding only its blocks
of the weights and the cache; at every step the vocab-sharded logits,
gathered, are held to the one-process port within 1e-5 relative and to
the reference's `decode_step` within 1e-4, and the greedy tokens to the
one-process port's.  mamba2 and zamba2 (SSM heads over "model", the
conv window's contiguous blocks, zamba2's shared block at two
occurrences with a KV cache each) also hold every rank's cache blocks to
`place` of the one-process cache at every step.  Each rank's resident
bytes are held to `local_bytes`.  long_500k-style cells (batch 1) of
gemma3 and zamba2 bind the KV sequence over ("data", "model").  The decode kernel's new row lse and empty shard
are held to the plain versions here (their CUDA side is in
`tests/test_torch_gpu.py`)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.convert import params_to_reference
from repro_torch.distributed import placement
from repro_torch.distributed.sharding import MeshDesc, P
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.models.common import decode_attention_partial
from repro_torch.tree import tree_leaves
from test_torch_distributed import run_ranks

CPU = torch.device("cpu")
B, S_MAX, STEPS = 4, 24, 20
CASES = {"llama3": ("llama3-8b", {}),
         "qwen3": ("qwen3-moe-235b-a22b", {}),
         "mixtral": ("mixtral-8x22b", {}),
         "gemma3": ("gemma3-4b", {}),
         "llama3-int8": ("llama3-8b", {"kv_quant": True}),
         "mamba2": ("mamba2-1.3b", {}),
         "zamba2": ("zamba2-7b", {})}
SSM = ("mamba2", "zamba2")      # their caches are checked at every step
MESHES = [(1, 2), (2, 2), (1, 4)]
# long_500k-style cells: batch 1, the KV sequence over ("data", "model")
LONG = {"gemma3": (2, 2), "zamba2": (2, 2)}


def configs(case):
    arch, over = CASES[case]
    return (dataclasses.replace(smoke_config(arch), **over),
            dataclasses.replace(jsmoke_config(arch), **over))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per case: the one-process port's and the reference's logits at
    every step, at batch B (and batch 1 for the long case); then per
    mesh, every rank's report of its placed run of every case."""
    root = tmp_path_factory.mktemp("placed")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 512, (STEPS, B)).astype(np.int32)
    np.save(root / "tokens.npy", tokens)
    want = {}
    for case in CASES:
        cfg, jcfg = configs(case)
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                         CPU)
        tree = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                            params_to_reference(params, cfg))
        torch.save(params, root / f"{case}.pt")
        jstep = jax.jit(lambda c, t, p, tree=tree, jcfg=jcfg:
                        jtransformer.decode_step(tree, jcfg, c, t, p))
        for batch in ((B, 1) if case in LONG else (B,)):
            cache = transformer.init_cache(cfg, batch, S_MAX, CPU)
            jcache = jtransformer.init_cache(jcfg, batch, S_MAX)
            port, refs, states = [], [], []
            for pos in range(STEPS):
                toks = tokens[pos, :batch] % cfg.vocab
                port.append(transformer.decode_step(
                    params, cfg, cache, torch.from_numpy(toks), pos).numpy())
                jl, jcache = jstep(jcache, jnp.asarray(toks), jnp.int32(pos))
                refs.append(np.asarray(jl))
                if case in SSM:
                    states.append([{k: t.clone() for k, t in c.items()}
                                   for c in cache])
            if states:
                torch.save(states, root / f"{case}_{batch}_states.pt")
            want[case, batch] = (np.stack(port), np.stack(refs))
    (root / "cases.json").write_text(json.dumps(
        {"cases": {k: [a, o] for k, (a, o) in CASES.items()},
         "B": B, "S": S_MAX, "steps": STEPS, "ssm": SSM}))
    got = {}
    for sizes in MESHES:
        d = tmp_path_factory.mktemp("ranks")
        (d / "root").write_text(str(root))
        body = _RANK.replace("SIZES", repr(sizes)).replace(
            "LONG_CASES", repr([c for c, m in LONG.items() if m == sizes]))
        got[sizes] = run_ranks(d, sizes[0] * sizes[1], body, timeout=240)
    return want, got


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
spec = json.loads((root / "cases.json").read_text())
tokens = torch.from_numpy(np.load(root / "tokens.npy"))
mesh = MeshDesc(("data", "model"), SIZES)
runs = [(case, spec["B"], "decode_32k") for case in spec["cases"]]
runs += [(case, 1, "long_500k") for case in LONG_CASES]
out = {}
for case, batch, name in runs:
    arch, over = spec["cases"][case]
    cfg = dataclasses.replace(smoke_config(arch), **over)
    plan = steps.plan_cell(cfg, ShapeSpec(name, "decode", spec["S"], batch),
                           mesh)
    full = torch.load(root / f"{case}.pt")
    params = steps.place_params(plan, full)
    cache0 = transformer.init_cache(cfg, batch, spec["S"], "cpu")
    cache = steps.place_cache(plan, cache0)
    step = steps.make_serve_step(cfg, plan)
    plc = step.placement
    rows = steps.local_rows(plan, torch.arange(batch)).tolist()
    logits, toks = [], []
    states = torch.load(root / f"{case}_{batch}_states.pt") \
        if case in spec["ssm"] else None
    state_err = {}
    for pos in range(spec["steps"]):
        mine = steps.local_rows(plan, tokens[pos, :batch] % cfg.vocab)
        if pos == spec["steps"] - 1:        # for the serve step below
            before = [{k: t.clone() for k, t in c.items()} for c in cache]
        lg = transformer.decode_step(params, cfg, cache, mine, pos, place=plc)
        toks.append(plc.argmax(lg, plan.vocab_entry).tolist())
        logits.append(plc.all_gather(lg, plan.vocab_entry, 1).tolist())
        if states is not None:      # every leaf against place(one process)
            for c, w in zip(cache, steps.place_cache(plan, states[pos])):
                for k, t in c.items():
                    assert t.shape == w[k].shape, (k, t.shape, w[k].shape)
                    e = float((t - w[k]).abs().max()
                              / w[k].abs().max().clamp(min=1e-30))
                    state_err[k] = max(state_err.get(k, 0.0), e)
    # the serve step itself: the last step again, on a copy of the cache
    # as it was before that step
    nxt, _ = step(params, before, mine, spec["steps"] - 1)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    out[f"{case}/{name}"] = dict(
        rows=rows, logits=logits, tokens=toks, step_tokens=nxt.tolist(),
        param_bytes=nbytes(params), cache_bytes=nbytes(cache),
        param_local_bytes=local_bytes(full, plan.param_specs, mesh),
        cache_local_bytes=local_bytes(cache0, plan.cache_specs, mesh),
        param_full_bytes=nbytes(full), traffic=dict(plc.traffic),
        seq=next((c["k"][2] for c in reversed(plan.cache_specs)
                  if "k" in c), None),
        state_err=state_err)
# the serve CLI's placed path: the engine's schedule over two waves
from repro_torch.launch.serve import serve_placed
rng = np.random.default_rng(0)
cfg = smoke_config("llama3-8b")
prompts = np.stack([rng.integers(0, cfg.vocab, 6) for _ in range(8)])
res = serve_placed(cfg, mesh, prompts, 5, batch=4, device=torch.device("cpu"))
out["serve"] = {str(k): v for k, v in res["tokens"].items()}
# every rank needs every request's teacher tokens: take them from the
# one-process engine (the test holds both to it)
from repro_torch.serving.engine import Request, ServeEngine
eng = ServeEngine(cfg, batch=4, max_len=19, seed=0, device="cpu")
for rid in range(8):
    eng.submit(Request(rid=rid, prompt=list(prompts[rid]), max_new=5))
teacher = np.array([r.out for r in sorted(eng.run(), key=lambda r: r.rid)])
forced = serve_placed(cfg, mesh, prompts, 5, batch=4,
                      device=torch.device("cpu"), teacher=teacher)
out["forced"] = {str(k): [v, forced["gaps"][k]]
                 for k, v in forced["tokens"].items()}
# zamba2 (mamba2 layers and the shared block) through the same path
zcfg = smoke_config("zamba2-7b")
zres = serve_placed(zcfg, mesh, prompts % zcfg.vocab, 5, batch=4,
                    device=torch.device("cpu"))
out["serve_zamba2"] = {str(k): v for k, v in zres["tokens"].items()}
report(out)
"""


def engine_tokens(arch) -> dict:
    """`ServeEngine`'s new tokens of the serve runs' eight requests."""
    from repro_torch.serving.engine import Request, ServeEngine
    cfg = smoke_config(arch)
    eng = ServeEngine(cfg, batch=4, max_len=6 + 5 + 8, seed=0, device=CPU)
    rng = np.random.default_rng(0)
    prompts = np.stack([rng.integers(0, smoke_config("llama3-8b").vocab, 6)
                        for _ in range(8)]) % cfg.vocab
    for rid in range(8):
        eng.submit(Request(rid=rid, prompt=list(prompts[rid]), max_new=5))
    return {str(r.rid): r.out for r in eng.run()}


def test_serve_placed_gives_the_engines_tokens(served):
    """`launch.serve.serve_placed` (the `--mesh` path) over two waves of
    four requests: every request's new tokens are `ServeEngine`'s on the
    same seeded weights and prompts, each from the rank that holds its
    row; and forced on the engine's tokens (`teacher`), every step's
    argmax is the forced token (logit gap 0).  zamba2 (mamba2 layers and
    the shared block) serves the engine's tokens through the same
    path."""
    want = engine_tokens("llama3-8b")
    zwant = engine_tokens("zamba2-7b")
    _, got = served
    for sizes in MESHES:
        seen = {}
        for res in got[sizes]:
            for rid, toks in res["serve"].items():
                assert seen.setdefault(rid, toks) == toks
        assert seen == want, sizes
        zseen = {}
        for res in got[sizes]:
            zseen.update(res["serve_zamba2"])
        assert zseen == zwant, sizes
        # forced on the engine's tokens: the argmax is the teacher's at
        # every step, a gap of 0
        for res in got[sizes]:
            for rid, (toks, gaps) in res["forced"].items():
                assert toks == want[rid] and gaps == [0.0] * 5


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", list(CASES))
def test_placed_decode_matches_one_process_and_reference(served, case,
                                                         sizes):
    """Every rank's gathered logits at every step against the one-process
    port (1e-5 relative) and the reference (1e-4), its greedy tokens the
    one-process argmax's, and one `serve_step` call's tokens the argmax
    of the last step's rows."""
    want, got = served
    port, reference = want[case, B]
    for res in got[sizes]:
        r = res[f"{case}/decode_32k"]
        rows = r["rows"]
        logits = np.asarray(r["logits"], np.float32)          # (T, rows, V)
        assert logits.shape == (STEPS, len(rows), port.shape[-1])
        assert rel_err(logits, port[:, rows]) <= 1e-5
        assert np.abs(logits - reference[:, rows]).max() <= 1e-4
        assert r["tokens"] == port[:, rows].argmax(-1).tolist()
        # the last step again on a copy of the cache from before it: the
        # argmax of that step's rows
        assert r["step_tokens"] == r["tokens"][-1]
    # the batch splits over "data" and every row is served once
    served_rows = sorted({i for res in got[sizes]
                          for i in res[f"{case}/decode_32k"]["rows"]})
    assert served_rows == list(range(B))
    assert all(len(res[f"{case}/decode_32k"]["rows"]) == B // sizes[0]
               for res in got[sizes])


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_resident_bytes_equal_local_bytes(served, sizes):
    """Each rank's placed weights and cache hold exactly `local_bytes` of
    the full trees, and fewer bytes than the whole model."""
    _, got = served
    for res in got[sizes]:
        for name, r in res.items():
            if "/" not in name:         # the serve runs' tokens
                continue
            assert r["param_bytes"] == r["param_local_bytes"], name
            assert r["cache_bytes"] == r["cache_local_bytes"], name
            assert r["param_bytes"] < r["param_full_bytes"], name


def test_llama3_weights_split_four_ways_at_1x4(served):
    """llama3 at (1, 4): every weight is a quarter on each rank but the
    replicated norms and wk/wv (2 KV heads do not split 4 ways, so
    `param_specs` leaves them whole); the KV cache a quarter."""
    _, got = served
    cfg = smoke_config("llama3-8b")
    params = transformer.param_shapes(cfg)
    whole = ("norm1", "norm2", "wk", "wv", "final_norm")

    def nbytes(t):
        return t.numel() * t.element_size()
    kept = nbytes(params["final_norm"]) + sum(
        nbytes(p[w]) for p in params["layers"] for w in whole if w in p)
    total = sum(nbytes(t) for t in tree_leaves(params))
    cache = transformer.init_cache(cfg, B, S_MAX, "meta")
    cache_total = sum(nbytes(t) for c in cache for t in c.values())
    for res in got[(1, 4)]:
        r = res["llama3/decode_32k"]
        assert r["param_bytes"] == (total - kept) // 4 + kept
        assert r["cache_bytes"] == cache_total // 4


@pytest.mark.parametrize("case", list(LONG))
def test_long_cell_binds_the_sequence_over_data_and_model(served, case):
    """A long_500k-style cell (batch 1) on (2, 2): the KV sequence is cut
    4 ways over ("data", "model"), the batch replicated, and the logits
    are the one-process port's and the reference's (zamba2: each shared
    occurrence's cache on sequence shards, its mamba2 layers' state on
    the heads)."""
    want, got = served
    port, reference = want[case, 1]
    for res in got[LONG[case]]:
        r = res[f"{case}/long_500k"]
        assert r["seq"] == ["data", "model"]
        assert r["rows"] == [0]
        logits = np.asarray(r["logits"], np.float32)
        assert rel_err(logits, port) <= 1e-5
        assert np.abs(logits - reference).max() <= 1e-4
        assert r["tokens"] == port.argmax(-1).tolist()
        if case == "gemma3":        # a quarter of every layer's cache
            assert r["cache_bytes"] * 4 == sum(
                t.numel() * t.element_size() for c in transformer.init_cache(
                    smoke_config("gemma3-4b"), 1, S_MAX, "meta")
                for t in c.values())


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", SSM)
def test_placed_ssm_cache_blocks_are_the_one_process_cache(served, case,
                                                           sizes):
    """mamba2 and zamba2: at every one of the 20 steps, each rank's ssm
    state (its heads), conv window (its contiguous block of conv_dim,
    which does not line up with the heads) and, for zamba2's shared
    occurrences, K/V blocks equal `place` of the one-process cache
    within 1e-5 relative (at batch 1 too, the long cell)."""
    _, got = served
    names = [f"{case}/decode_32k"] + (
        [f"{case}/long_500k"] if LONG.get(case) == sizes else [])
    for res in got[sizes]:
        for name in names:
            err = res[name]["state_err"]
            assert {"ssm", "conv"} <= set(err), name
            if case == "zamba2":
                assert {"k", "v"} <= set(err), name
            assert max(err.values()) <= 1e-5, (name, err)


# ----------------------------------------------------------------------
# without ranks
# ----------------------------------------------------------------------
def test_local_shard_is_row_major_over_a_tuple_of_axes():
    """A dim over ("data", "model") is cut row-major, as `jax.sharding`
    lays a tuple of axes out: rank (d, m) of a (2, 3) mesh holds block
    d * 3 + m; over ("model", "data") block m * 2 + d."""
    mesh = MeshDesc(("data", "model"), (2, 3))
    t = torch.arange(12 * 5).reshape(12, 5)
    for d in range(2):
        for m in range(3):
            at = {"data": d, "model": m}
            got = placement.local_shard(t, P(("data", "model")), mesh, at)
            assert torch.equal(got, t[2 * (d * 3 + m):][:2])
            got = placement.local_shard(t, P(("model", "data"), None), mesh,
                                        at)
            assert torch.equal(got, t[2 * (m * 2 + d):][:2])
            t2 = torch.arange(6 * 4).reshape(6, 4)
            got = placement.local_shard(t2, P("model", "data"), mesh, at)
            assert torch.equal(got, t2[2 * m:2 * m + 2, 2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="split"):
        placement.local_shape((5,), P("data"), mesh)
    with pytest.raises(ValueError, match="twice"):
        placement.local_shape((6, 6), P("model", "model"), mesh)
    # a 1-way axis cuts nothing, so naming it twice is harmless
    assert placement.local_shape((4, 6), P("data", ("data", "model")),
                                 MeshDesc(("data", "model"), (1, 3))) \
        == (4, 2)


def test_place_copies_each_block_into_its_own_storage():
    mesh = MeshDesc(("data", "model"), (2, 2))
    full = {"w": torch.arange(16.0).reshape(4, 4), "n": torch.ones(3)}
    specs = {"w": P("data", "model"), "n": P(None)}
    got = placement.place(full, specs, mesh, {"data": 1, "model": 0})
    assert torch.equal(got["w"], full["w"][2:, :2])
    assert got["w"].is_contiguous()
    assert got["w"].untyped_storage().nbytes() == 16
    assert got["n"].data_ptr() != full["n"].data_ptr()
    assert placement.local_bytes(full, specs, mesh) == 4 * 4 + 3 * 4


def test_plan_cell_raises_only_for_train_cells():
    """Every cell kind is placed now: a train cell with its moments'
    specs and no cache; plan_cell raises only for a train cell whose
    microbatches the dp ranks do not split (and microbatches of another
    kind of cell).  Prefill cells and the mamba2 and zamba2 decode cells
    are placed; a decode cell follows the reference's decode branch."""
    mesh = MeshDesc(("data", "model"), (2, 4))
    cfg = get_config("llama3-8b")
    train = steps.plan_cell(cfg, SHAPES["train_4k"], mesh)
    assert train.cache_specs is None and train.batch_entry == "data"
    assert train.opt_specs["m"] is train.param_specs
    with pytest.raises(ValueError, match="microbatches"):
        steps.plan_cell(cfg, ShapeSpec("t", "train", 64, 4), mesh,
                        microbatch=4)
    with pytest.raises(ValueError, match="microbatches"):
        steps.plan_cell(cfg, SHAPES["prefill_32k"], mesh, microbatch=2)
    assert steps.plan_cell(cfg, SHAPES["prefill_32k"], mesh,
                           "fsdp").cache_specs
    for arch in ("mamba2-1.3b", "zamba2-7b"):
        for name in ("decode_32k", "long_500k", "prefill_32k"):
            p = steps.plan_cell(get_config(arch), SHAPES[name], mesh)
            assert p.shape.name == name
    plan = steps.plan_cell(cfg, SHAPES["decode_32k"], mesh)
    assert plan.binding["seq"] == ("model",)
    assert plan.batch_entry == "data" and plan.vocab_entry == "model"
    assert tuple(plan.cache_specs[0]["k"]) == ("data", None, "model", None)
    qwen = steps.plan_cell(get_config("qwen3-moe-235b-a22b"),
                           SHAPES["decode_32k"], mesh)
    # weight-stationary experts: E over model, ff over data
    assert tuple(qwen.param_specs["layers"][0]["moe"]["w_gate"]) == (
        "model", None, "data")
    long = steps.plan_cell(get_config("gemma3-4b"), SHAPES["long_500k"],
                           mesh)
    assert long.binding["seq"] == ("data", "model")
    assert long.batch_entry is None
    zamba = steps.plan_cell(get_config("zamba2-7b"), SHAPES["long_500k"],
                            mesh)
    assert {tuple(c["k"][2]) for c in zamba.cache_specs if "k" in c} == {
        ("data", "model")}
    assert {tuple(c["ssm"]) for c in zamba.cache_specs if "ssm" in c} == {
        (None, "model", None, None)}


def test_zamba2_shared_block_is_placed_once():
    """zamba2's one shared block is one subtree of the specs
    (`param_specs["shared"]`), counted once by `local_bytes`; every
    shared occurrence's `Placement.layer` hands it the shared specs and
    its own cache's."""
    cfg = smoke_config("zamba2-7b")
    mesh = MeshDesc(("data", "model"), (1, 2))
    plan = steps.plan_cell(cfg, ShapeSpec("d", "decode", 24, 4), mesh)
    params = transformer.param_shapes(cfg)
    blocks = transformer.layer_blocks(cfg)
    shared = [i for i, b in enumerate(blocks) if b.kind == "shared_attn"]
    assert len(shared) == 2
    assert all(plan.param_specs["layers"][i] is None for i in shared)
    one = placement.local_bytes(params["shared"], plan.param_specs["shared"],
                                mesh)
    rest = {k: v for k, v in params.items() if k != "shared"}
    rest_specs = {k: v for k, v in plan.param_specs.items() if k != "shared"}
    assert placement.local_bytes(params, plan.param_specs, mesh) == \
        placement.local_bytes(rest, rest_specs, mesh) + one
    plc = steps.placement_of(plan, dry=True)
    for i in shared:
        lp = plc.layer(i)
        assert lp.spec is plan.param_specs["shared"]
        assert lp.cache is plan.cache_specs[i] and lp.seq == "model"


# ----------------------------------------------------------------------
# the decode kernels' row lse and empty shard, plain versions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("valid", [1, 7, 23])
def test_decode_lse_is_the_partials_m_plus_log_l(valid):
    """The head-major entry point's lse (and the int8 cache's) against
    `decode_attention_partial`'s m + log l, the output against its
    o / l, within 1e-5."""
    g = torch.Generator().manual_seed(valid)
    q = torch.randn(3, 8, 16, generator=g)
    k, v = (torch.randn(3, 2, 24, 16, generator=g) for _ in range(2))
    out, lse = ops.decode_attention_head_major(q, k, v, valid,
                                               return_lse=True)
    o, l, m = decode_attention_partial(q, k.transpose(1, 2),
                                       v.transpose(1, 2), valid)
    assert float((lse - (m + l.log()).reshape(3, 8)).abs().max()) <= 1e-5
    assert float((out - (o / l[..., None]).reshape(3, 8, 16)).abs().max()) \
        <= 1e-5
    k8, ks = ref.quantize_kv(k)
    v8, vs = ref.quantize_kv(v)
    _, lse8 = ops.decode_attention_head_major(q, k8, v8, valid, ks, vs,
                                              return_lse=True)
    s = torch.einsum("bhgd,bhsd->bhgs", q.reshape(3, 2, 4, 16),
                     k8.float()) * 16 ** -0.5 * ks[:, :, None]
    want = torch.logsumexp(s[..., :valid], dim=-1).reshape(3, 8)
    assert float((lse8 - want).abs().max()) <= 1e-5


def test_empty_shard_gives_zero_and_minus_inf():
    """valid_len 0 (a shard holding no filled row): output 0 and lse
    -inf, for both cache kinds; the int8 append with slot None writes
    nothing.  The reference's entry point still takes [1, S]."""
    q = torch.randn(2, 4, 16)
    k, v = torch.randn(2, 2, 8, 16), torch.randn(2, 2, 8, 16)
    out, lse = ops.decode_attention_head_major(q, k, v, 0, return_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert bool(torch.isneginf(lse).all())
    k8, ks = ref.quantize_kv(k)
    v8, vs = ref.quantize_kv(v)
    before = [t.clone() for t in (k8, v8, ks, vs)]
    k_new, v_new = torch.randn(2, 2, 16), torch.randn(2, 2, 16)
    out, lse = ops.decode_attention_int8_append(q, k_new, v_new, k8, v8, ks,
                                                vs, None, 0, return_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert bool(torch.isneginf(lse).all())
    assert all(torch.equal(a, b) for a, b in zip(before, (k8, v8, ks, vs)))
    with pytest.raises(ValueError, match="valid_len"):
        ops.decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), 0)


def test_lse_merge_of_shards_is_the_whole_cache():
    """Sequence shards' (out, lse), an empty one among them, merged by
    `merge_partials` as `Placement.merge_seq` does, give the attention
    over the whole cache."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 6, 16, generator=g)
    k, v = (torch.randn(2, 3, 32, 16, generator=g) for _ in range(2))
    valid = 13                      # shards of 8: 8, 5, 0, 0 filled rows
    want = ops.decode_attention_head_major(q, k, v, valid)
    from repro_torch.models.common import merge_partials
    parts = []
    for i in range(4):
        o, lse = ops.decode_attention_head_major(
            q, k[:, :, 8 * i:8 * i + 8].contiguous(),
            v[:, :, 8 * i:8 * i + 8].contiguous(),
            min(max(valid - 8 * i, 0), 8), return_lse=True)
        parts.append((o, torch.ones_like(lse), lse))
    got = merge_partials(parts)
    assert float((got - want).abs().max()) <= 1e-6


def test_serve_cli_mesh_under_torchrun():
    """`launch.serve --mesh 1x2 --device cpu` under torchrun: two gloo
    ranks each print their resident weight bytes, which are
    `local_bytes` of the smoke model at (1, 2), and serve every
    request."""
    import os
    import pathlib
    import subprocess
    import sys
    from repro_torch.configs.shapes import ShapeSpec
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), OMP_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--smoke", "--device", "cpu", "--mesh", "1x2", "--requests", "4",
         "--prompt-len", "6", "--max-new", "4", "--batch", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=150)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, 9)
            p.wait()
    assert p.returncode == 0, out[-3000:]
    cfg = smoke_config("llama3-8b")
    plan = steps.plan_cell(cfg, ShapeSpec("serve", "decode", 18, 2),
                           MeshDesc(("data", "model"), (1, 2)))
    want = placement.local_bytes(transformer.param_shapes(cfg),
                                 plan.param_specs, plan.binding["mesh"])
    for rank in range(2):
        assert f"[serve] rank {rank} llama3-smoke mesh 1x2" in out
    assert out.count(f"weights {want} B") == 2, out
    assert out.count("4 requests, 16 tokens") == 2, out
