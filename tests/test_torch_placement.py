"""The placed decode path (`launch/steps.py:plan_cell`, `make_serve_step(
plan=...)`, `distributed/placement.py`) on gloo CPU ranks.

Each smoke config is served for 20 steps (past mixtral's and gemma3's
16-slot rings) from the reference's weights (`params_from_reference`)
on meshes (1, 2), (2, 2) and (1, 4), every rank holding only its blocks
of the weights and the KV cache; at every step the vocab-sharded logits,
gathered, are held to the one-process port within 1e-5 relative and to
the reference's `decode_step` within 1e-4, and the greedy tokens to the
one-process port's.  Each rank's resident bytes are held to
`local_bytes`.  A long_500k-style cell (batch 1) binds the KV sequence
over ("data", "model").  The decode kernel's new row lse and empty shard
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
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import params_from_reference
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
         "llama3-int8": ("llama3-8b", {"kv_quant": True})}
MESHES = [(1, 2), (2, 2), (1, 4)]
# a long_500k-style cell: batch 1, the KV sequence over ("data", "model")
LONG = ("gemma3", (2, 2))


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
        tree = jax.tree.map(np.asarray,
                            jtransformer.init_params(jax.random.key(0), jcfg))
        params = params_from_reference(tree, cfg, CPU)
        torch.save(params, root / f"{case}.pt")
        for batch in ((B, 1) if case == LONG[0] else (B,)):
            cache = transformer.init_cache(cfg, batch, S_MAX, CPU)
            jcache = jtransformer.init_cache(jcfg, batch, S_MAX)
            jstep = jax.jit(lambda c, t, p, tree=tree, jcfg=jcfg:
                            jtransformer.decode_step(tree, jcfg, c, t, p))
            port, refs = [], []
            for pos in range(STEPS):
                toks = tokens[pos, :batch]
                port.append(transformer.decode_step(
                    params, cfg, cache, torch.from_numpy(toks), pos).numpy())
                jl, jcache = jstep(jcache, jnp.asarray(toks), jnp.int32(pos))
                refs.append(np.asarray(jl))
            want[case, batch] = (np.stack(port), np.stack(refs))
    (root / "cases.json").write_text(json.dumps(
        {"cases": {k: [a, o] for k, (a, o) in CASES.items()},
         "B": B, "S": S_MAX, "steps": STEPS, "long": LONG[0]}))
    got = {}
    for sizes in MESHES:
        d = tmp_path_factory.mktemp("ranks")
        (d / "root").write_text(str(root))
        body = _RANK.replace("SIZES", repr(sizes)).replace(
            "LONG_MESH", repr(sizes == LONG[1]))
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
if LONG_MESH:
    runs.append((spec["long"], 1, "long_500k"))
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
    for pos in range(spec["steps"]):
        mine = steps.local_rows(plan, tokens[pos, :batch])
        lg = transformer.decode_step(params, cfg, cache, mine, pos, place=plc)
        toks.append(plc.argmax(lg, plan.vocab_entry).tolist())
        logits.append(plc.all_gather(lg, plan.vocab_entry, 1).tolist())
    # the serve step itself, one more step, on a copy of the cache
    nxt, _ = step(params, [{k: t.clone() for k, t in c.items()}
                           for c in cache], mine, spec["steps"] - 1)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    out[f"{case}/{name}"] = dict(
        rows=rows, logits=logits, tokens=toks, step_tokens=nxt.tolist(),
        param_bytes=nbytes(params), cache_bytes=nbytes(cache),
        param_local_bytes=local_bytes(full, plan.param_specs, mesh),
        cache_local_bytes=local_bytes(cache0, plan.cache_specs, mesh),
        param_full_bytes=nbytes(full), seq=plan.cache_specs[-1]["k"][2],
        traffic=dict(plc.traffic))
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
report(out)
"""


def test_serve_placed_gives_the_engines_tokens(served):
    """`launch.serve.serve_placed` (the `--mesh` path) over two waves of
    four requests: every request's new tokens are `ServeEngine`'s on the
    same seeded weights and prompts, each from the rank that holds its
    row; and forced on the engine's tokens (`teacher`), every step's
    argmax is the forced token (logit gap 0)."""
    from repro_torch.serving.engine import Request, ServeEngine
    cfg = smoke_config("llama3-8b")
    eng = ServeEngine(cfg, batch=4, max_len=6 + 5 + 8, seed=0, device=CPU)
    rng = np.random.default_rng(0)
    for rid in range(8):
        eng.submit(Request(rid=rid, prompt=list(rng.integers(0, cfg.vocab,
                                                             6)), max_new=5))
    want = {str(r.rid): r.out for r in eng.run()}
    _, got = served
    for sizes in MESHES:
        seen = {}
        for res in got[sizes]:
            for rid, toks in res["serve"].items():
                assert seen.setdefault(rid, toks) == toks
        assert seen == want, sizes
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
        # the same step again on a copy of the cache (the slot rewritten
        # with the same token): the argmax of that step's rows
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


def test_long_cell_binds_the_sequence_over_data_and_model(served):
    """A long_500k-style cell (batch 1) on (2, 2): the KV sequence is cut
    4 ways over ("data", "model"), the batch replicated, and the logits
    are the one-process port's and the reference's."""
    want, got = served
    port, reference = want[LONG[0], 1]
    for res in got[LONG[1]]:
        r = res[f"{LONG[0]}/long_500k"]
        assert r["seq"] == ["data", "model"]
        assert r["rows"] == [0]
        logits = np.asarray(r["logits"], np.float32)
        assert rel_err(logits, port) <= 1e-5
        assert np.abs(logits - reference).max() <= 1e-4
        assert r["tokens"] == port.argmax(-1).tolist()
        # each rank holds a quarter of every layer's cache
        assert r["cache_bytes"] * 4 == sum(
            t.numel() * t.element_size() for c in transformer.init_cache(
                smoke_config("gemma3-4b"), 1, S_MAX, "meta")
            for t in c.values())


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


def test_plan_cell_places_decode_only():
    """Train and prefill cells, and the mamba2 and shared-attention
    layers, are not placed yet: plan_cell says which ROADMAP item ports
    them.  A decode cell follows the reference's decode branch."""
    mesh = MeshDesc(("data", "model"), (2, 4))
    cfg = get_config("llama3-8b")
    for name in ("train_4k", "prefill_32k"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            steps.plan_cell(cfg, SHAPES[name], mesh)
    for arch in ("mamba2-1.3b", "zamba2-7b"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            steps.plan_cell(get_config(arch), SHAPES["decode_32k"], mesh)
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
