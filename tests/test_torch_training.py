"""Training/prefill-slice parity of the PyTorch port against the JAX
reference: the flash-attention forward (plain version vs the Pallas
kernel in interpret mode and the naive oracle) and its gradients (vs
`jax.grad` of the reference's chunked flash), the loss and every
parameter gradient of the smoke models (vs `jax.value_and_grad`), AdamW
and the schedule, the data pipeline and the prefill step.
Inputs come from numpy seeds; reference parameters reach the port through
`convert.params_from_reference`.  The train step and loop, checkpoints
and the restart property are in `tests/test_torch_train_loop.py`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.data.lm_pipeline import DataConfig as JDataConfig
from repro.data.lm_pipeline import LMPipeline as JLMPipeline
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine_schedule
from repro_torch.configs import PORTED, smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.data.lm_pipeline import DataConfig, LMPipeline
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.models import common, transformer
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)

CPU = torch.device("cpu")
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),       # tests/test_kernels.py
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# tests/test_kernels.py:24-30
FLASH_SHAPES = [(1, 128, 4, 4, 64, None), (2, 256, 8, 2, 64, None),
                (1, 256, 8, 1, 128, None), (2, 256, 4, 4, 128, 96),
                (1, 512, 2, 2, 256, None), (1, 128, 4, 2, 80, None)]


def reference_params(cfg, seed):
    return jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(seed), cfg))


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def assert_close_scaled(got, want, rtol):
    """|got - want| <= rtol * (|want| + max|want|): relative, with the
    leaf's scale as the floor for elements near zero."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# ----------------------------------------------------------------------
# flash attention: forward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KVH,D,window", FLASH_SHAPES)
def test_flash_forward_matches_pallas_and_oracle(B, S, H, KVH, D, window,
                                                 dtype):
    rng = np.random.default_rng(0)
    xs = [f32(rng, B, S, H, D), f32(rng, B, S, KVH, D), f32(rng, B, S, KVH, D)]
    jq, jk, jv = (jnp.asarray(x).astype(getattr(jnp, dtype)) for x in xs)
    tq, tk, tv = (t(x).to(getattr(torch, dtype)) for x in xs)
    want = np.asarray(jops.flash_attention(
        jq, jk, jv, causal=True, window=window, block_q=64, block_k=64,
        interpret=True), np.float32)
    out, lse = ops.flash_attention_fwd(tq, tk, tv, window=window,
                                       q_chunk=64, kv_chunk=64)
    assert out.dtype == tq.dtype and out.shape == (B, S, H, D)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(out.float().numpy(), want, **TOL[dtype])
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv, window=window),
                        np.float32)
    np.testing.assert_allclose(out.float().numpy(), oracle, **TOL[dtype])
    np.testing.assert_allclose(
        ref.flash_attention_ref(tq, tk, tv, window=window).float().numpy(),
        oracle, **TOL[dtype])
    # `ops.flash_attention` is the same forward without the lse (its
    # plain version tiles by 1024: the sums run in another order)
    np.testing.assert_allclose(
        ops.flash_attention(tq, tk, tv, window=window).float().numpy(),
        out.float().numpy(), **TOL[dtype])


@pytest.mark.parametrize("G,window,kv_len,q_offset", [
    (1, None, None, 0), (4, None, None, 0), (4, 24, None, 0),
    (2, None, 70, 0), (1, 16, 90, 8)])
def test_flash_lse_matches_reference_scan(G, window, kv_len, q_offset):
    """Output and row log-sum-exp against the reference's
    `_flash_fwd_scan` on the expanded heads, including kv_len and
    q_offset (float32)."""
    rng = np.random.default_rng(1)
    B, S, KVH, D = 2, 96, 2, 16
    q, k, v = f32(rng, B, S, KVH * G, D), f32(rng, B, S, KVH, D), \
        f32(rng, B, S, KVH, D)
    kvl = S if kv_len is None else kv_len
    opts = (True, window, q_offset, 32, 32, kvl, D ** -0.5)
    head_major = [jnp.moveaxis(jnp.repeat(x, G, axis=2) if x is not q else x,
                               1, 2) for x in (q, k, v)]
    jout, jlse = jcommon._flash_fwd_scan(*head_major, opts)
    out, lse = ops.flash_attention_fwd(t(q), t(k), t(v), window=window,
                                       kv_len=kv_len, q_offset=q_offset,
                                       q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(out.numpy(),
                               np.moveaxis(np.asarray(jout), 1, 2),
                               **TOL["float32"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                               **TOL["float32"])


def test_flash_ragged_and_fully_masked_rows():
    """Any Sq and Skv; a row that sees no key gives 0 and a finite lse,
    not NaN; the chunking does not change the result."""
    rng = np.random.default_rng(2)
    q, k, v = (t(f32(rng, 1, n, 4, 16)) for n in (70, 45, 45))
    one, _ = ops.flash_attention_fwd(q, k, v, q_chunk=1024, kv_chunk=1024)
    tiled, lse = ops.flash_attention_fwd(q, k, v, q_chunk=32, kv_chunk=16)
    np.testing.assert_allclose(tiled.numpy(), one.numpy(), **TOL["float32"])
    # rows past Skv + window - 1 see no key through the window
    out, lse = ops.flash_attention_fwd(q, k, v, window=8, q_chunk=32,
                                       kv_chunk=16)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert float(out[:, 45 + 8 - 1:].abs().max()) == 0.0
    assert float(out[:, :45 + 7].abs().sum(-1).min()) > 0.0
    out0, _ = ops.flash_attention_fwd(q, k, v, kv_len=0)
    assert float(out0.abs().max()) == 0.0


# ----------------------------------------------------------------------
# flash attention: gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [None, 40])
def test_flash_gradients_match_jax_grad(G, window):
    """dq, dk, dv of <flash(q, k, v), cotangent> against `jax.grad` of the
    reference's chunked flash (whose VJP expands KV with `jnp.repeat`)."""
    rng = np.random.default_rng(3)
    B, S, KVH, D = 2, 96, 2, 16
    q, k, v = f32(rng, B, S, KVH * G, D), f32(rng, B, S, KVH, D), \
        f32(rng, B, S, KVH, D)
    ct = f32(rng, B, S, KVH * G, D)

    def jloss(q, k, v):
        o = jcommon.flash_attention(q, k, v, causal=True, window=window,
                                    q_chunk=32, kv_chunk=32)
        return jnp.sum(o * ct)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    o = common.flash_attention(tq, tk, tv, causal=True, window=window,
                               q_chunk=32, kv_chunk=32)
    (o * t(ct)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_flash_gradients_ragged_match_autograd_of_oracle():
    """Ragged Sq/Skv, kv_len and q_offset, which the reference's chunked
    flash does not take: the tiled backward against autograd through a
    dense masked softmax (float64)."""
    rng = np.random.default_rng(4)
    B, Sq, Skv, KVH, G, D = 1, 70, 77, 2, 2, 16
    q, k, v = f32(rng, B, Sq, KVH * G, D), f32(rng, B, Skv, KVH, D), \
        f32(rng, B, Skv, KVH, D)
    ct = f32(rng, B, Sq, KVH * G, D)
    kv_len, q_offset, window = 71, 5, 30
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    o = common.flash_attention(tq, tk, tv, window=window, q_offset=q_offset,
                               q_chunk=32, kv_chunk=16, kv_len=kv_len)
    (o * t(ct)).sum().backward()
    dq, dk, dv = (t(x).double().requires_grad_() for x in (q, k, v))
    ke, ve = (x.repeat_interleave(G, dim=2) for x in (dk, dv))
    s = torch.einsum("bqhd,bkhd->bhqk", dq, ke) * D ** -0.5
    pq = q_offset + torch.arange(Sq)[:, None]
    pk = torch.arange(Skv)[None, :]
    mask = (pk < kv_len) & (pk <= pq) & (pq - pk < window)
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", w, ve)
    np.testing.assert_allclose(o.detach().numpy(),
                               want.detach().float().numpy(),
                               rtol=1e-5, atol=1e-5)
    (want * t(ct).double()).sum().backward()
    for got, exp in ((tq.grad, dq.grad), (tk.grad, dk.grad),
                     (tv.grad, dv.grad)):
        np.testing.assert_allclose(got.numpy(), exp.float().numpy(),
                                   rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# model: loss and gradients, prefill
# ----------------------------------------------------------------------
def smoke_pair(arch, **over):
    """The port's and the reference's smoke configs, with the same
    overrides (a 32-wide flash chunk, so that the tiles are exercised)."""
    over = {"flash_chunk": 32, **over}
    return (dataclasses.replace(smoke_config(arch), **over),
            dataclasses.replace(jsmoke_config(arch), **over))


def lm_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.frontend:
        batch["frontend_emb"] = rng.standard_normal(
            (B, 8, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", PORTED)
def test_loss_and_every_gradient_match_jax(arch):
    """`loss_fn` and the gradient of every parameter (float32 smoke
    configs, remat on, chunked CE) against `jax.value_and_grad`."""
    cfg, jcfg = smoke_pair(arch)
    tree = reference_params(jcfg, 0)
    batch = lm_batch(cfg, 2, 64, seed=1)
    fe = batch.get("frontend_emb")

    def jloss(p):
        return jtransformer.loss_fn(p, jcfg, batch["tokens"], batch["labels"],
                                    fe, ce_chunk=32)

    jl, jg = jax.value_and_grad(jloss)(tree)
    params = params_from_reference(tree, cfg, CPU)
    loss, grads = steps.value_and_grad(
        params, cfg, {k: t(v) for k, v in batch.items()})
    # the loss itself through the public entry point, chunk as above
    direct = transformer.loss_fn(params, cfg, t(batch["tokens"]),
                                 t(batch["labels"]),
                                 None if fe is None else t(fe), ce_chunk=32)
    np.testing.assert_allclose(float(direct.detach()), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    want = params_from_reference(jax.tree.map(np.asarray, jg), cfg, CPU)
    assert_close_scaled(grads["embed"].numpy(), want["embed"].numpy(), 1e-4)
    assert_close_scaled(grads["final_norm"].numpy(),
                        want["final_norm"].numpy(), 1e-4)
    if "lm_head" in want:
        assert_close_scaled(grads["lm_head"].numpy(),
                            want["lm_head"].numpy(), 1e-4)
    for got, exp in zip(grads["layers"], want["layers"]):
        assert got.keys() == exp.keys()
        for name in got:
            assert_close_scaled(got[name].numpy(), exp[name].numpy(), 1e-4)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(5)
    logits = f32(rng, 3, 7, 40) * 4
    labels = rng.integers(0, 40, (3, 7)).astype(np.int32)
    np.testing.assert_allclose(
        float(common.cross_entropy(t(logits), t(labels))),
        float(jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
    x, head = f32(rng, 2, 48, 16), f32(rng, 16, 40)
    lab = rng.integers(0, 40, (2, 48)).astype(np.int32)
    for chunk in (16, 48, 1024, 20):          # 20: odd size, one chunk
        np.testing.assert_allclose(
            float(common.chunked_cross_entropy(t(x), t(head), t(lab),
                                               chunk=chunk)),
            float(jcommon.chunked_cross_entropy(x, head, lab, chunk=chunk)),
            rtol=1e-6)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_step_matches_reference(arch):
    """Last logits and every layer's cache of the prefill step: k/v, and
    the mamba2 ssm state, against the reference's prefill; the mamba2
    conv state against the reference's teacher-forced decode, whose raw
    window the port hands off (its prefill hands off the post-conv
    stream, `tests/test_torch_mamba2.py`)."""
    cfg, jcfg = smoke_pair(arch)
    tree = reference_params(jcfg, 2)
    batch = lm_batch(cfg, 2, 64, seed=3)
    del batch["labels"]
    jlast, jcache = jax.jit(jsteps.make_prefill_step(jcfg))(tree, batch)
    last, cache = steps.make_prefill_step(cfg)(
        params_from_reference(tree, cfg, CPU),
        {k: t(v) for k, v in batch.items()})
    assert not last.requires_grad
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    assert len(cache) == cfg.n_layers
    mamba = cfg.stages[0][1][0].kind == "mamba2"
    if mamba:
        dcache = jtransformer.init_cache(jcfg, 2, 64)
        step = jax.jit(lambda c, x, p: jtransformer.decode_step(tree, jcfg,
                                                                c, x, p))
        for i in range(64):
            _, dcache = step(dcache, batch["tokens"][:, i], jnp.int32(i))
    for i, layer in enumerate(cache):
        want = {"ssm": jcache[0]["b0"]["ssm"][i],
                "conv": dcache[0]["b0"]["conv"][i]} if mamba \
            else {n: jcache[0]["b0"][n][i] for n in ("k", "v")}
        assert layer.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(layer[name].numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_matches_teacher_forced_decode(arch):
    """`tests/test_arch_smoke.py::test_decode_matches_prefill` on the
    port: the prefill step's logits and cache (k/v, or the mamba2 ssm and
    conv state) equal what the decode step leaves after teacher-forcing
    the same tokens."""
    cfg = smoke_config(arch)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     CPU)
    T, B = 12, 2
    tokens = torch.from_numpy(lm_batch(cfg, B, T, seed=4)["tokens"])
    logits, cache = transformer.forward(params, cfg, tokens,
                                        return_cache=True)
    dcache = transformer.init_cache(cfg, B, 32, CPU)
    got = torch.stack([transformer.decode_step(params, cfg, dcache,
                                               tokens[:, i], i)
                       for i in range(T)], dim=1)
    np.testing.assert_allclose(got.detach().numpy(), logits.detach().numpy(),
                               rtol=2e-2, atol=2e-2)
    for layer, dc in zip(cache, dcache):
        if "ssm" in layer:
            pairs = [(dc[n], layer[n]) for n in ("ssm", "conv")]
        else:
            pairs = [(dc["k"][:, :, :T].transpose(1, 2), layer["k"])]
        for d, p in pairs:
            np.testing.assert_allclose(d.detach().numpy(), p.detach().numpy(),
                                       rtol=2e-2, atol=2e-2)


# ----------------------------------------------------------------------
# optimizer, schedule, data
# ----------------------------------------------------------------------
def test_adamw_update_matches_reference():
    """Three updates of a toy tree (float32 and bfloat16 leaves, one with
    gradients large enough to clip) on identical numpy gradients."""
    rng = np.random.default_rng(6)
    init = {"a": f32(rng, 4, 5), "b": [f32(rng, 7), f32(rng, 3, 2)]}
    dts = {"a": "float32", "b": "bfloat16"}
    jp = {"a": jnp.asarray(init["a"]),
          "b": [jnp.asarray(x).astype(jnp.bfloat16) for x in init["b"]]}
    tp = {"a": t(init["a"]).clone(),
          "b": [t(x).to(torch.bfloat16) for x in init["b"]]}
    jcfg, cfg = JAdamWConfig(weight_decay=0.05), AdamWConfig(weight_decay=0.05)
    jstate, state = jadamw_init(jp, jcfg), adamw_init(tp, cfg)
    for i, mag in enumerate((0.1, 5.0, 0.3)):
        g = {"a": f32(rng, 4, 5) * mag, "b": [f32(rng, 7) * mag,
                                              f32(rng, 3, 2) * mag]}
        lr = jcosine_schedule(jnp.int32(i), 1, 10)
        jp, jstate, jm = jadamw_update(jp, jax.tree.map(jnp.asarray, g),
                                       jstate, jcfg, lr)
        tp, state, m = adamw_update(
            tp, {"a": t(g["a"]), "b": [t(x) for x in g["b"]]}, state, cfg,
            cosine_schedule(i, 1, 10))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(state["count"]) == int(jstate["count"]) == i + 1
    for name in ("a", "b"):
        got = [tp[name]] if name == "a" else tp[name]
        want = [jp[name]] if name == "a" else jp[name]
        for x, y in zip(got, want):
            assert str(x.dtype).endswith(dts[name])
            np.testing.assert_allclose(x.float().numpy(),
                                       np.asarray(y, np.float32),
                                       rtol=1e-6, atol=1e-6)
    for x, y in zip(state["m"]["b"] + state["v"]["b"],
                    jstate["m"]["b"] + jstate["v"]["b"]):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("warmup,total", [(1, 100), (10, 50), (0, 1),
                                          (100, 10_000)])
def test_cosine_schedule_exact(warmup, total):
    for step in list(range(0, 60)) + [total - 1, total, total + 5, 9999]:
        got = cosine_schedule(step, warmup, total)
        assert got.dtype == torch.float32
        want = np.asarray(jcosine_schedule(jnp.int32(step), warmup, total))
        assert got.numpy().tobytes() == want.tobytes(), (step, float(got),
                                                         float(want))


@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2)])
def test_lm_pipeline_tokens_identical(shard, num_shards):
    kw = dict(vocab=512, seq_len=48, global_batch=4, seed=7)
    port, jpipe = LMPipeline(DataConfig(**kw)), JLMPipeline(JDataConfig(**kw))
    for step in (0, 3, 11):
        a = port.batch_at(step, shard, num_shards)
        b = jpipe.batch_at(step, shard, num_shards)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="num_shards"):
        port.batch_at(0, 0, 3)
