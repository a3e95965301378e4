"""zamba2 parity of the PyTorch port against the JAX reference: the
shared attention block (one set of weights, applied at every occurrence,
each occurrence with its own KV cache) beside mamba2 blocks, at the
smoke config and at a narrow config of zamba2's head_dim 112.  Both
float32; the reference's parameters are drawn with `jax.random`, turned
into numpy and loaded into the port.

Checked against the live reference: forward logits and the loss,
gradients (the shared block's is one tensor, the sum over its
occurrences), the prefill-to-decode hand-off (every occurrence's k/v and
every mamba2 state), 16 decode steps, the serving engine over two waves,
parameter conversion both ways, checkpoints both ways, one AdamW step
(the shared leaves updated once) and the leaf count of the tree."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.configs import smoke_config as jsmoke_config
from repro.models import config as jconfig
from repro.models import transformer as jtransformer
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.checkpoint import restore, save
from repro_torch.configs import smoke_config
from repro_torch.convert import (_layer_index, opt_state_from_reference,
                                 opt_state_to_reference,
                                 params_from_reference, params_to_reference)
from repro_torch.launch import steps
from repro_torch.models import attention, config, transformer
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.tree import named_leaves, tree_leaves

ARCH = "zamba2-7b"
CPU = torch.device("cpu")
# a narrow zamba2: its head_dim 112 and SSM head_dim 64 (d_inner =
# 2 d_model), one stage of (mamba2, shared_attn) x 2
NARROW = dict(name="zamba2-narrow", d_model=224, n_heads=2, n_kv_heads=2,
              head_dim=112, d_ff=448, vocab=256, ssm_state=16, ssm_heads=7,
              ssm_head_dim=64, ssm_chunk=32, shared_attn_d_ff=448,
              rope_theta=10_000.0, dtype="float32", subquadratic=True)
CONFIGS = ("smoke", "narrow")


def pair(which: str, **over):
    """The port's and the reference's config, with the same overrides (a
    32-wide flash chunk, so that the tiles are exercised)."""
    over = {"flash_chunk": 32, **over}
    if which == "smoke":
        return (dataclasses.replace(smoke_config(ARCH), **over),
                dataclasses.replace(jsmoke_config(ARCH), **over))
    out = []
    for mod in (config, jconfig):
        blocks = (mod.Block("mamba2"), mod.Block("shared_attn"))
        out.append(mod.ModelConfig(stages=((2, blocks),),
                                   **{**NARROW, **over}))
    return tuple(out)


def reference_params(cfg, seed):
    return jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(seed), cfg))


def t(x):
    return torch.from_numpy(np.array(x))


def tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)).astype(np.int32)


def shared_layers(cfg) -> list[int]:
    return [i for i, b in enumerate(transformer.layer_blocks(cfg))
            if b.kind == "shared_attn"]


def assert_close_scaled(got, want, rtol, err_msg=""):
    """allclose at `rtol`, with an atol of rtol times want's largest
    magnitude (a sum over a few hundred terms in another order)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=err_msg)


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
@pytest.mark.parametrize("which", CONFIGS)
def test_shared_block_is_held_once(which):
    """`params["shared"]` holds the block once, a shared layer's entry is
    None, and the port's own `init_params` gives the layout (and shapes)
    that conversion from the reference gives."""
    cfg, jcfg = pair(which)
    converted = params_from_reference(reference_params(jcfg, 0), cfg, CPU)
    drawn = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    CPU)
    for params in (converted, drawn):
        assert sorted(params["shared"]) == sorted(attention.WEIGHTS)
        for i in shared_layers(cfg):
            assert params["layers"][i] is None
        ids = [id(x) for x in tree_leaves(params)]
        assert len(ids) == len(set(ids))
    assert [(n, tuple(x.shape)) for n, x in named_leaves(drawn)] == \
        [(n, tuple(x.shape)) for n, x in named_leaves(converted)]


@pytest.mark.parametrize("which", CONFIGS)
def test_leaf_count_matches_reference(which):
    """The port's leaves are the reference's with each stacked leaf
    counted once per layer of its stage: the shared block's nine leaves
    appear once; the element counts agree with `param_count()`'s
    padded-vocab tree."""
    cfg, jcfg = pair(which)
    tree = reference_params(jcfg, 0)
    params = params_from_reference(tree, cfg, CPU)
    per_layer = sum(leaf.shape[0] if path[0].key == "stages" else 1
                    for path, leaf in
                    jax.tree_util.tree_leaves_with_path(tree))
    assert len(tree_leaves(params)) == per_layer
    assert sum(x.numel() for x in tree_leaves(params)) == \
        sum(x.size for x in jax.tree.leaves(tree))
    assert len(tree_leaves(params_to_reference(params, cfg))) == \
        len(jax.tree.leaves(tree))
    assert sum(1 for n, _ in named_leaves(params)
               if n.startswith("shared/")) == len(attention.WEIGHTS)


@pytest.mark.parametrize("which", CONFIGS)
def test_params_round_trip_with_shared(which):
    """`params_to_reference(params_from_reference(t)) == t`, ``shared``
    included; a leftover shared leaf is refused."""
    cfg, jcfg = pair(which)
    tree = reference_params(jcfg, 3)
    back = params_to_reference(params_from_reference(tree, cfg, CPU), cfg)
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: x.numpy(), back))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any(p[0].key == "shared" for p, _ in got)
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    tree["shared"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        params_from_reference(tree, cfg, CPU)


# ----------------------------------------------------------------------
# forward, loss, gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("which", CONFIGS)
def test_forward_and_loss_match_reference(which):
    cfg, jcfg = pair(which)
    tree = reference_params(jcfg, 1)
    params = params_from_reference(tree, cfg, CPU)
    tok = tokens(cfg, 2, 65, seed=2)
    jlogits = jtransformer.forward(tree, jcfg, tok[:, :-1])
    with torch.no_grad():
        logits = transformer.forward(params, cfg, t(tok[:, :-1]))
    assert_close_scaled(logits.numpy(), jlogits, 1e-5)
    jl = jtransformer.loss_fn(tree, jcfg, tok[:, :-1], tok[:, 1:],
                              ce_chunk=32)
    with torch.no_grad():
        loss = transformer.loss_fn(params, cfg, t(tok[:, :-1]),
                                   t(tok[:, 1:]), ce_chunk=32)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)


@pytest.mark.parametrize("which", CONFIGS)
def test_gradients_match_jax_grad(which):
    """Every gradient against `jax.value_and_grad` (remat on): the shared
    block's is one tensor per weight, the sum over its occurrences."""
    cfg, jcfg = pair(which)
    tree = reference_params(jcfg, 4)
    tok = tokens(cfg, 2, 65, seed=5)
    jl, jg = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(p, jcfg, tok[:, :-1], tok[:, 1:],
                                       ce_chunk=32))(tree)
    params = params_from_reference(tree, cfg, CPU)
    loss, grads = steps.value_and_grad(
        params, cfg, {"tokens": t(tok[:, :-1]), "labels": t(tok[:, 1:])})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = params_from_reference(jax.tree.map(np.asarray, jg), cfg, CPU)
    got, exp = named_leaves(grads), named_leaves(want)
    assert [n for n, _ in got] == [n for n, _ in exp]
    for (name, g), (_, e) in zip(got, exp):
        assert_close_scaled(g.numpy(), e.numpy(), 1e-4, err_msg=name)
    assert all(grads["layers"][i] is None for i in shared_layers(cfg))
    assert len(tree_leaves(grads)) == len(tree_leaves(params))


# ----------------------------------------------------------------------
# prefill, decode, engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("which", CONFIGS)
def test_prefill_hands_decode_its_cache(which):
    """The port's prefill cache against the reference's teacher-forced
    decode cache over the same 64 tokens: every shared occurrence's k/v
    (each its own) and every mamba2 layer's ssm and conv state; then one
    more token decoded from the port's prefill cache against the
    reference's next decode step."""
    cfg, jcfg = pair(which)
    tree = reference_params(jcfg, 6)
    B, T = 2, 64
    tok = tokens(cfg, B, T + 1, seed=7)
    params = params_from_reference(tree, cfg, CPU)
    last, cache = steps.make_prefill_step(cfg)(params,
                                               {"tokens": t(tok[:, :T])})
    assert len(cache) == cfg.n_layers
    jcache = jtransformer.init_cache(jcfg, B, T + 1)
    jstep = jax.jit(lambda c, x, p: jtransformer.decode_step(tree, jcfg, c,
                                                             x, p))
    for i in range(T):
        jlogits, jcache = jstep(jcache, tok[:, i], jnp.int32(i))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)
    blocks = transformer.layer_blocks(cfg)
    occurrences = []
    dcache = transformer.init_cache(cfg, B, T + 1, CPU)
    for i, (si, bi, r, _) in enumerate(_layer_index(cfg)):
        want = {n: np.asarray(a[r]) for n, a in
                jcache[si][f"b{bi}"].items()}
        if blocks[i].kind == "shared_attn":
            occurrences.append(cache[i]["k"])
            got = {n: cache[i][n].transpose(1, 2) for n in ("k", "v")}
            want = {n: w[:, :, :T] for n, w in want.items()}
            for n in ("k", "v"):
                dcache[i][n][:, :, :T] = got[n]
        else:
            got = cache[i]
            for n in ("ssm", "conv"):
                dcache[i][n].copy_(got[n])
        assert got.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{i} {name}")
    # each occurrence its own k (the shared weights see other inputs)
    assert len(occurrences) == len(shared_layers(cfg)) >= 2
    assert not torch.allclose(occurrences[0], occurrences[1])
    jnext, _ = jstep(jcache, tok[:, T], jnp.int32(T))
    nxt = transformer.decode_step(params, cfg, dcache, t(tok[:, T]), T)
    np.testing.assert_allclose(nxt.numpy(), np.asarray(jnext), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("which", CONFIGS)
def test_decode_step_matches_reference_over_16_steps(which):
    """Logits of 16 decode steps and, after them, every layer's cache:
    each shared occurrence's k/v and each mamba2 state."""
    cfg, jcfg = pair(which)
    tree = reference_params(jcfg, 8)
    params = params_from_reference(tree, cfg, CPU)
    B, s_max = 3, 20
    jcache = jtransformer.init_cache(jcfg, B, s_max)
    cache = transformer.init_cache(cfg, B, s_max, CPU)
    jstep = jax.jit(lambda c, x, p: jtransformer.decode_step(tree, jcfg, c,
                                                             x, p))
    rng = np.random.default_rng(9)
    for pos in range(16):
        toks = rng.integers(0, cfg.vocab, B).astype(np.int32)
        jlogits, jcache = jstep(jcache, jnp.asarray(toks), jnp.int32(pos))
        logits = transformer.decode_step(params, cfg, cache,
                                         torch.from_numpy(toks), pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
    for layer, (si, bi, r, _) in zip(cache, _layer_index(cfg)):
        for name, got in layer.items():
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jcache[si][f"b{bi}"][name][r]),
                rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("which", CONFIGS)
def test_engine_matches_reference_over_two_waves(which):
    """Greedy tokens of 3 requests at batch 2 (two waves: the second
    starts from a zeroed cache, every shared occurrence's included)."""
    cfg, jcfg = pair(which)
    jeng = JServeEngine(jcfg, batch=2, max_len=24, seed=1)
    params = params_from_reference(jax.tree.map(np.asarray, jeng.params),
                                   cfg, CPU)
    eng = ServeEngine(cfg, params, batch=2, max_len=24, device="cpu")
    rng = np.random.default_rng(10)
    for rid in range(3):
        prompt = [int(x) for x in rng.integers(0, cfg.vocab, 6)]
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_new=5))
        eng.submit(Request(rid=rid, prompt=prompt, max_new=5))
    jdone, done = jeng.run(), eng.run()
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in jdone]
    assert len(done) == 3 and all(len(r.out) == 5 for r in done)
    assert eng.steps_used == jeng.steps_used
    assert len(eng.cache) == cfg.n_layers
    eng._reset_cache()
    assert not any(bool(x.any()) for c in eng.cache for x in c.values())


# ----------------------------------------------------------------------
# checkpoints, optimizer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("which", CONFIGS)
def test_checkpoint_roundtrips_both_ways(which, tmp_path):
    """A bfloat16 zamba2 written by the reference restores in the port,
    and the port's write restores in the reference, ``shared`` held once
    in both (optimizer moments included)."""
    cfg, jcfg = pair(which, dtype="bfloat16")
    jparams = jtransformer.init_params(jax.random.key(11), jcfg)
    jstate = {"params": jparams,
              "opt": jadamw_init(jparams, JAdamWConfig())}
    jsave(str(tmp_path / "ref"), 3, jstate)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   CPU)
    opt = adamw_init(params, AdamWConfig())
    like = {"params": params_to_reference(params, cfg),
            "opt": opt_state_to_reference(opt, cfg)}
    got, _ = restore(str(tmp_path / "ref"), 3, like)
    back = params_from_reference(got["params"], cfg, CPU)
    opt_state_from_reference(got["opt"], cfg, CPU)
    for (name, a), (_, b) in zip(named_leaves(back), named_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    save(str(tmp_path / "port"), 4, like)
    names = [n for n, _ in named_leaves(like)]
    assert sum(n.startswith("params/shared/") for n in names) == \
        len(attention.WEIGHTS)
    jback, _ = jrestore(str(tmp_path / "port"), 4, jstate)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(jback),
            jax.tree_util.tree_leaves_with_path(jstate)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("which", CONFIGS)
def test_adamw_step_matches_reference(which):
    """One AdamW update of the whole model on identical numpy gradients
    (large enough to clip): every parameter and moment as the reference's
    update leaves them.  A shared tensor updated once per occurrence, or
    its gradient counted once per occurrence in the clip norm, would
    differ."""
    cfg, jcfg = pair(which)
    tree = reference_params(jcfg, 12)
    rng = np.random.default_rng(13)
    jg = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), tree)
    ocfg = dict(lr=1e-2, clip_norm=0.5)
    jstate = jadamw_init(tree, JAdamWConfig(**ocfg))
    jp, jstate, jm = jax.jit(jadamw_update, static_argnums=3)(
        tree, jg, jstate, JAdamWConfig(**ocfg))
    params = params_from_reference(tree, cfg, CPU)
    grads = params_from_reference(jax.tree.map(np.asarray, jg), cfg, CPU)
    state = adamw_init(params, AdamWConfig(**ocfg))
    params, state, m = adamw_update(params, grads, state,
                                    AdamWConfig(**ocfg))
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    for got, want in ((params, jp), (state["m"], jstate["m"]),
                      (state["v"], jstate["v"])):
        want = params_from_reference(jax.tree.map(np.asarray, want), cfg,
                                     CPU, "float32")
        for (name, a), (_, b) in zip(named_leaves(got), named_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


# ----------------------------------------------------------------------
# launchers
# ----------------------------------------------------------------------
def test_serve_and_train_clis_run_zamba2_on_cpu(tmp_path, capsys):
    """Both launchers with ``--arch zamba2-7b --smoke --device cpu``; the
    train run checkpoints (``shared`` held once) and resumes."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import serve, train
    done = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "4",
                       "--max-new", "3", "--batch", "2"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--global-batch",
            "2", "--seq-len", "32", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "5"]
    hist = train.main(args + ["--steps", "2"])
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
    assert latest_step(str(tmp_path)) == 1
    hist = train.main(args + ["--steps", "3", "--resume"])
    assert len(hist["loss"]) == 1
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out and "resumed from step 1" in out
