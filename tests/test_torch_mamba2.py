"""Mamba2 parity of the PyTorch port against the JAX reference at the
smoke config (float32): the mixer's output, final state and gradients,
the cache a prefill hands to decode, the serving engine over two waves,
parameter conversion and checkpoints in the reference's format.  Loss and
every gradient, the prefill step and decode logits are held to the
reference for every ported architecture, mamba2 included, in
`tests/test_torch_training.py` and `tests/test_torch_serving.py`.

The reference's mixer hands decode the post-conv stream as its conv
state, while its decode step keeps the raw projections; the port hands
off the raw window.  `test_reference_conv_tail_is_not_its_decode_window`
keeps the reference's defect on record."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.configs import smoke_config as jsmoke_config
from repro.models import mamba2 as jmamba2
from repro.models import transformer as jtransformer
from repro.models.common import rms_norm as jrms_norm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.checkpoint import restore, save
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_reference, params_to_reference
from repro_torch.models import mamba2, transformer
from repro_torch.models.config import Block, ModelConfig
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.tree import named_leaves

ARCH = "mamba2-1.3b"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)


def reference_params(cfg, seed):
    return jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(seed), cfg))


def layer0(tree):
    """The first layer's weights of the reference's stacked stage."""
    return {k: v[0] for k, v in tree["stages"][0]["b0"].items()}


def t(x):
    return torch.from_numpy(np.array(x))


def tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)).astype(np.int32)


# ----------------------------------------------------------------------
# mixer
# ----------------------------------------------------------------------
def test_mixer_matches_reference():
    """Output and final SSM state over 2 chunks (L 64, chunk 32); the conv
    state is the raw window of the last K-1 projections, which the
    reference's decode step keeps."""
    cfg, jcfg = smoke_config(ARCH), jsmoke_config(ARCH)
    p = layer0(reference_params(jcfg, 0))
    xin = np.random.default_rng(1).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    jout, (jssm, _) = jmamba2.mamba2_mixer(p, jnp.asarray(xin), jcfg)
    tp = {k: t(v) for k, v in p.items()}
    out, (ssm, conv) = mamba2.mamba2_mixer(tp, t(xin), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(ssm.numpy(), np.asarray(jssm), **TOL)
    x, _, Bm, Cm, _ = jmamba2._proj(p, jrms_norm(jnp.asarray(xin), p["norm"]),
                                    jcfg)
    raw = jnp.concatenate([x, Bm, Cm], axis=-1)[:, -(cfg.ssm_conv - 1):]
    np.testing.assert_allclose(conv.numpy(), np.asarray(raw), **TOL)


def test_mixer_gradients_match_jax_grad():
    """Every weight's and the input's gradient of <out, ct> + <ssm, ct2>
    against `jax.grad` of the reference's mixer: the backward of the scan
    (autograd through the plain chunk scan) for both outputs."""
    cfg, jcfg = smoke_config(ARCH), jsmoke_config(ARCH)
    p = layer0(reference_params(jcfg, 2))
    rng = np.random.default_rng(3)
    xin = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    ct2 = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_state,
                               cfg.ssm_head_dim)).astype(np.float32)

    def jloss(p, xin):
        out, (ssm, _) = jmamba2.mamba2_mixer(p, xin, jcfg)
        return jnp.sum(out * ct) + jnp.sum(ssm * ct2)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(xin))
    tp = {k: t(v).requires_grad_() for k, v in p.items()}
    tx = t(xin).requires_grad_()
    out, (ssm, _) = mamba2.mamba2_mixer(tp, tx, cfg)
    ((out * t(ct)).sum() + (ssm * t(ct2)).sum()).backward()
    for name, want in [("xin", jgx)] + sorted(jgp.items()):
        got = tx.grad if name == "xin" else tp[name].grad
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)


def test_mixer_rejects_length_off_the_chunk():
    cfg = smoke_config(ARCH)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     CPU)
    with pytest.raises(ValueError, match="multiple of the chunk 32"):
        mamba2.mamba2_mixer(params["layers"][0],
                            torch.zeros(1, 48, cfg.d_model), cfg)


# ----------------------------------------------------------------------
# the cache a prefill hands to decode
# ----------------------------------------------------------------------
def test_prefill_then_decode_matches_teacher_forced_decode():
    """T 64: the prefill's cache, then decoding token 65 from it, equal
    65 teacher-forced decode steps: the logits of token 65 and every
    layer's ssm and conv state after the prompt."""
    cfg, jcfg = smoke_config(ARCH), jsmoke_config(ARCH)
    params = params_from_reference(reference_params(jcfg, 4), cfg, CPU)
    B, T = 2, 64
    tok = torch.from_numpy(tokens(cfg, B, T + 1, seed=5)).long()
    with torch.no_grad():
        _, cache = transformer.forward(params, cfg, tok[:, :T],
                                       return_cache=True)
        dcache = transformer.init_cache(cfg, B, T + 1, CPU)
        for i in range(T):
            transformer.decode_step(params, cfg, dcache, tok[:, i], i)
        for layer, dc in zip(cache, dcache):
            for name in ("ssm", "conv"):
                assert layer[name].dtype == dc[name].dtype
                assert layer[name].shape == dc[name].shape
                np.testing.assert_allclose(layer[name].numpy(),
                                           dc[name].numpy(), **TOL,
                                           err_msg=name)
        want = transformer.decode_step(params, cfg, dcache, tok[:, T], T)
        got = transformer.decode_step(params, cfg, cache, tok[:, T], T)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_reference_conv_tail_is_not_its_decode_window():
    """The reference's defect, on record: its mixer hands off the
    post-conv, post-SiLU stream (`mamba2.py:144-146`), while its decode
    step keeps the raw projections (`:158-159`).  The SSM states agree;
    the conv states do not, so the reference's prefilled cache decodes
    other logits than its teacher-forced one."""
    jcfg = jsmoke_config(ARCH)
    tree = jax.tree.map(jnp.asarray, reference_params(jcfg, 4))
    B, T = 2, 64
    tok = jnp.asarray(tokens(jcfg, B, T + 1, seed=5))
    _, pcache = jtransformer.forward(tree, jcfg, tok[:, :T],
                                     return_cache=True)
    step = jax.jit(lambda c, x, p: jtransformer.decode_step(tree, jcfg, c,
                                                            x, p))
    dcache = jtransformer.init_cache(jcfg, B, T + 1)
    for i in range(T):
        _, dcache = step(dcache, tok[:, i], jnp.int32(i))
    prefilled, decoded = pcache[0]["b0"], dcache[0]["b0"]
    np.testing.assert_allclose(np.asarray(prefilled["ssm"]),
                               np.asarray(decoded["ssm"]), **TOL)
    gap = float(jnp.abs(prefilled["conv"] - decoded["conv"]).max())
    assert gap > 0.1, gap
    want, _ = step(dcache, tok[:, T], jnp.int32(T))
    got, _ = step(pcache, tok[:, T], jnp.int32(T))
    assert float(jnp.abs(got - want).max()) > 0.1


# ----------------------------------------------------------------------
# serving engine
# ----------------------------------------------------------------------
def test_engine_two_waves_match_reference():
    """Batch 2 and 4 requests of unequal prompts: two waves, so the
    second starts from the zeroed ssm and conv state; greedy tokens equal
    the reference engine's, token for token."""
    jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
    jeng = JServeEngine(jcfg, batch=2, max_len=32, seed=0)
    params = params_from_reference(jax.tree.map(np.asarray, jeng.params),
                                   cfg, CPU)
    eng = ServeEngine(cfg, params, batch=2, max_len=32, device="cpu")
    rng = np.random.default_rng(6)
    for rid, n in enumerate((5, 9, 3, 7)):
        prompt = [int(x) for x in rng.integers(0, cfg.vocab, n)]
        jeng.submit(JRequest(rid=rid, prompt=list(prompt), max_new=6))
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new=6))
    jdone, done = jeng.run(), eng.run()
    assert len(done) == 4 and all(len(r.out) == 6 for r in done)
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in jdone]
    assert eng.steps_used == jeng.steps_used


def test_engine_resets_the_state_between_waves():
    """A request served in the second wave gets the tokens it gets alone:
    nothing of the first wave's state carries over."""
    cfg = smoke_config(ARCH)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(1),
                                     CPU)
    first = Request(rid=0, prompt=[3, 1, 4, 1, 5], max_new=5)
    second = Request(rid=1, prompt=[9, 2, 6], max_new=5)
    alone = Request(rid=1, prompt=[9, 2, 6], max_new=5)
    eng = ServeEngine(cfg, params, batch=1, max_len=16, device="cpu")
    eng.submit(first)
    eng.submit(second)
    eng.run()
    eng = ServeEngine(cfg, params, batch=1, max_len=16, device="cpu")
    eng.submit(alone)
    eng.run()
    assert second.out == alone.out


# ----------------------------------------------------------------------
# parameters and checkpoints
# ----------------------------------------------------------------------
def bf16_pair():
    cfg = dataclasses.replace(smoke_config(ARCH), dtype="bfloat16")
    jcfg = dataclasses.replace(jsmoke_config(ARCH), dtype="bfloat16")
    return cfg, jcfg, jtransformer.init_params(jax.random.key(7), jcfg)


def test_params_keep_the_reference_dtypes():
    """In a bfloat16 model A_log, D and dt_bias stay float32, in the
    port's own parameters and in those converted from the reference."""
    cfg, _, jparams = bf16_pair()
    made = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   CPU)
    converted = params_from_reference(jax.tree.map(np.asarray, jparams),
                                      cfg, CPU)
    for params in (made, converted):
        for name, w in params["layers"][0].items():
            want = torch.float32 if name in mamba2.F32_WEIGHTS \
                else torch.bfloat16
            assert w.dtype == want, name
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(jparams),
            jax.tree_util.tree_leaves_with_path(
                params_to_reference(converted, cfg))):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
        assert a.shape == tuple(b.shape), path


def test_checkpoint_roundtrips_both_ways(tmp_path):
    """The reference writes a bfloat16 mamba2 model and the port restores
    it; the port writes it back and the reference reads the same values,
    dtypes included."""
    cfg, _, jparams = bf16_pair()
    jsave(str(tmp_path / "ref"), 3, {"params": jparams})
    want = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                 CPU)
    like = {"params": params_to_reference(want, cfg)}
    got, _ = restore(str(tmp_path / "ref"), 3, like)
    params = params_from_reference(got["params"], cfg, CPU)
    for (name, a), (_, b) in zip(named_leaves(params), named_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    save(str(tmp_path / "port"), 4,
         {"params": params_to_reference(params, cfg)})
    back, _ = jrestore(str(tmp_path / "port"), 4, {"params": jparams})
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path({"params": jparams})):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("kind", ["moe", "shared_attn"])
def test_unported_block_kinds_raise(kind):
    cfg = ModelConfig(name="x", d_model=16, n_heads=2, n_kv_heads=2,
                      head_dim=8, d_ff=32, vocab=64,
                      stages=((1, (Block("mamba2"), Block(kind))),),
                      ssm_state=8, ssm_heads=2, ssm_head_dim=8)
    with pytest.raises(NotImplementedError, match=kind):
        transformer.init_params(cfg, torch.Generator(), CPU)
