"""Windowed (ring-buffer) and int8-cache decode of the PyTorch port
against the JAX reference.

A windowed layer's decode cache is a ring of min(window, s_max) slots
(`repro/models/transformer.py:246-249,343-362`); these tests run past the
ring's wrap, which the reference's own `test_decode_matches_prefill` (12
steps) never reaches.  The int8 cache (`kv_quant`) is held payload for
payload against the reference's quantizer and einsum
(`repro/models/attention.py:123-166`), and to the bounds of
`tests/test_kv_quant.py`.  Inputs come from numpy seeds; reference
parameters reach the port through `convert.params_from_reference`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import attention as jattention
from repro.models import transformer as jtransformer
from repro_torch.configs import smoke_config
from repro_torch.convert import _layer_index, params_from_reference
from repro_torch.models import attention, transformer
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")
WINDOWED = ("gemma3-4b", "mixtral-8x22b")
STEPS, S_MAX = 40, 64          # past the smoke configs' 16-slot rings


def configs(arch, **over):
    return (dataclasses.replace(smoke_config(arch), **over),
            dataclasses.replace(jsmoke_config(arch), **over))


def reference_params(jcfg, seed):
    return jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(seed), jcfg))


def reference_layer(jcache, cfg, i):
    """Layer i (execution order) of the reference's stacked cache."""
    si, bi, r, _ = _layer_index(cfg)[i]
    return {name: np.asarray(a[r]) for name, a in jcache[si][f"b{bi}"].items()}


def decode_both(arch, steps, s_max, seed, **over):
    """`steps` decode steps of the smoke config on both packages from the
    same tokens; -> (port cache, reference cache, [(logits, jlogits)])."""
    cfg, jcfg = configs(arch, **over)
    tree = reference_params(jcfg, seed)
    params = params_from_reference(tree, cfg, CPU)
    B = 3
    jcache = jtransformer.init_cache(jcfg, B, s_max)
    cache = transformer.init_cache(cfg, B, s_max, CPU)
    jstep = jax.jit(lambda c, t, p: jtransformer.decode_step(tree, jcfg, c,
                                                             t, p))
    rng = np.random.default_rng(seed)
    out = []
    for pos in range(steps):
        toks = rng.integers(0, cfg.vocab, B).astype(np.int32)
        jlogits, jcache = jstep(jcache, jnp.asarray(toks), jnp.int32(pos))
        logits = transformer.decode_step(params, cfg, cache,
                                         torch.from_numpy(toks), pos)
        out.append((logits.numpy(), np.asarray(jlogits)))
    return cache, jcache, out


# ----------------------------------------------------------------------
# (a) ring decode against the reference, past the wrap
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", WINDOWED)
def test_ring_decode_matches_reference_past_the_wrap(arch):
    """40 decode steps into 64-slot caches: logits at every step and
    every layer's cache (16-slot rings for the windowed layers, 64 slots
    for gemma3's global ones) against the reference's `decode_step`."""
    cache, jcache, out = decode_both(arch, STEPS, S_MAX, seed=1)
    for logits, jlogits in out:
        np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)
    cfg = smoke_config(arch)
    blocks = transformer.layer_blocks(cfg)
    for i, (b, layer) in enumerate(zip(blocks, cache)):
        want = reference_layer(jcache, cfg, i)
        assert layer["k"].shape[2] == (b.window or S_MAX)
        assert layer.keys() == want.keys()
        for name, got in layer.items():
            np.testing.assert_allclose(got.numpy(), want[name], rtol=1e-4,
                                       atol=1e-4, err_msg=f"{i} {name}")


# ----------------------------------------------------------------------
# (b) prefill against teacher-forced ring decode, past the wrap
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", WINDOWED)
def test_prefill_matches_ring_decode_past_the_wrap(arch):
    """`tests/test_arch_smoke.py:62-78` past the wrap: the windowed
    forward's logits at every position against teacher-forced decode
    steps, and its k/v against the caches: a windowed layer's position p
    in ring slot p % W for the last W positions, a global layer's every
    position."""
    cfg = smoke_config(arch)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     CPU)
    B, T = 2, STEPS
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (B, T)))
    with torch.no_grad():
        logits, cache = transformer.forward(params, cfg, tokens,
                                            return_cache=True)
        dcache = transformer.init_cache(cfg, B, S_MAX, CPU)
        got = torch.stack([transformer.decode_step(params, cfg, dcache,
                                                   tokens[:, i], i)
                           for i in range(T)], dim=1)
    np.testing.assert_allclose(got.numpy(), logits.numpy(), rtol=2e-2,
                               atol=2e-2)
    for b, layer, dc in zip(transformer.layer_blocks(cfg), cache, dcache):
        W = dc["k"].shape[2]
        positions = range(T - W, T) if b.window else range(T)
        assert (W < T) == bool(b.window)
        for name in ("k", "v"):
            for p in positions:
                np.testing.assert_allclose(
                    dc[name][:, :, p % W].numpy(), layer[name][:, p].numpy(),
                    rtol=2e-2, atol=2e-2, err_msg=f"{name} position {p}")


# ----------------------------------------------------------------------
# (c) the quantizer, bit for bit
# ----------------------------------------------------------------------
def reference_quantize(x):
    """The reference's int8 quantizer, as written inline in
    `repro/models/attention.py:123-130`."""
    s = jnp.maximum(jnp.abs(x).max(-1), 1e-8).astype(jnp.float32) / 127
    w = jnp.round(x.astype(jnp.float32) / s[..., None])
    return jnp.clip(w, -127, 127).astype(jnp.int8), s


def quantizer_inputs(rng):
    """(B, KV, hd) = (3, 4, 16) rows: random ones at random scales, rows
    whose every element sits on an exact half-step (amax 127/16, so the
    scale is exactly 1/16 and x / scale = n + 0.5 for x = (2n + 1) / 32),
    a zero row (the 1e-8 floor) and a row of equal elements."""
    x = rng.standard_normal((3, 4, 16)).astype(np.float32)
    x *= rng.uniform(1e-3, 30.0, (3, 4, 1)).astype(np.float32)
    halves = (2 * rng.integers(-127, 127, (4, 16)) + 1) / 32
    halves[:, 0] = 127 / 16                   # the row's amax
    halves[1, 1] = -127 / 16
    x[1] = halves
    x[2, 0] = 0.0
    x[2, 1] = 0.75
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizer_is_the_references_bit_for_bit(dtype):
    x = quantizer_inputs(np.random.default_rng(0))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert np.array_equal(np.asarray(jx.astype(jnp.float32)),
                          tx.float().numpy())        # identical inputs
    want_q, want_s = reference_quantize(jx)
    got_q, got_s = attention.quantize_kv(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  np.asarray(want_s).view(np.uint32))
    # the half-steps were ties, and both rounded them to even
    tie = (np.abs(x[1]) * 32) % 2 == 1           # the (2n + 1) / 32
    assert tie.sum() > 40
    assert (got_q[1].numpy()[tie].astype(np.int64) % 2 == 0).all()
    assert abs(got_q[1]).max() == 127


# ----------------------------------------------------------------------
# (d) int8 decode against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3-8b", *WINDOWED])
def test_int8_block_decode_matches_reference_past_the_wrap(arch):
    """The first attention block of each smoke config on both packages,
    fed the same hidden state at each of 40 steps, its int8 cache a
    16-slot ring where the block is windowed: the block output within
    1e-5, the payloads equal and the scales within 1e-6 relative at
    every step."""
    cfg, jcfg = configs(arch, kv_quant=True)
    tree = reference_params(jcfg, 3)
    block = transformer.layer_blocks(cfg)[0]
    p = params_from_reference(tree, cfg, CPU)["layers"][0]
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stages"][0]["b0"])
    B, W = 3, transformer._cache_len(block, S_MAX)
    jc = jtransformer.init_cache(jcfg, B, S_MAX)[0]["b0"]
    jc = {n: a[0] for n, a in jc.items()}
    c = transformer.init_cache(cfg, B, S_MAX, CPU)[0]
    assert jc["k"].shape[2] == W
    mlp = None
    if block.kind == "moe":
        from repro.models.moe import moe_ffn as jmoe_ffn
        from repro_torch.models import moe
        mlp = (lambda h: jmoe_ffn(jp["moe"], h, jcfg, dropless=True),
               lambda h: moe.moe_ffn(p["moe"], h, cfg, dropless=True))
    jdecode = jax.jit(lambda x, k, v, ks, vs, pos, slot, valid:
                      jattention.attn_decode(
                          jp, x, k, v, pos, jcfg, None,
                          mlp_fn=mlp and mlp[0], valid_len=valid, slot=slot,
                          k_scale=ks, v_scale=vs))
    rng = np.random.default_rng(8)
    for pos in range(STEPS):
        x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
        slot = pos % W if block.window else pos
        valid = min(pos + 1, W)
        jy, jc["k"], jc["v"], jc["k_scale"], jc["v_scale"] = jdecode(
            x, jc["k"], jc["v"], jc["k_scale"], jc["v_scale"],
            jnp.int32(pos), jnp.int32(slot), jnp.int32(valid))
        y = attention.attn_decode(p, torch.from_numpy(x), c["k"], c["v"], pos,
                                  cfg, mlp_fn=mlp and mlp[1], slot=slot,
                                  valid_len=valid, k_scale=c["k_scale"],
                                  v_scale=c["v_scale"])
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {pos}")
        for name in ("k", "v"):
            np.testing.assert_array_equal(c[name].numpy(),
                                          np.asarray(jc[name]),
                                          err_msg=f"step {pos} {name}")
            np.testing.assert_allclose(c[f"{name}_scale"].numpy(),
                                       np.asarray(jc[f"{name}_scale"]),
                                       rtol=1e-6, err_msg=f"step {pos}")


NEAR_TIE = 1e-3     # a quotient x / scale this close to n + 1/2


def int8_model_run(arch, seed):
    """40 int8-cache decode steps of the whole smoke model on both
    packages, the port's quotients x / scale recorded as it quantizes.
    -> per step: (max |logits - reference's|, [(layer, name, payload
    difference, the port's quotient) at every payload that differs])."""
    cfg, jcfg = configs(arch, kv_quant=True)
    tree = reference_params(jcfg, seed)
    params = params_from_reference(tree, cfg, CPU)
    B = 3
    jcache = jtransformer.init_cache(jcfg, B, S_MAX)
    cache = transformer.init_cache(cfg, B, S_MAX, CPU)
    jstep = jax.jit(lambda c, t, p: jtransformer.decode_step(tree, jcfg, c,
                                                             t, p))
    quotients = []
    real = attention.quantize_kv

    def recording(x):
        q, scale = real(x)
        quotients.append(x.float() / scale[..., None])
        return q, scale

    rng = np.random.default_rng(seed)
    steps = []
    attention.quantize_kv = recording
    try:
        for pos in range(STEPS):
            toks = rng.integers(0, cfg.vocab, B).astype(np.int32)
            jlogits, jcache = jstep(jcache, jnp.asarray(toks), jnp.int32(pos))
            quotients.clear()
            logits = transformer.decode_step(params, cfg, cache,
                                             torch.from_numpy(toks), pos)
            flips = []
            for i, layer in enumerate(cache):
                want = reference_layer(jcache, cfg, i)
                slot = pos % layer["k"].shape[2]      # this step's token
                for j, name in enumerate(("k", "v")):
                    diff = (layer[name][:, :, slot].numpy().astype(np.int64)
                            - want[name][:, :, slot].astype(np.int64))
                    for b, h, d in np.argwhere(diff):
                        flips.append((i, name, int(diff[b, h, d]),
                                      float(quotients[2 * i + j][b, h, d])))
                    np.testing.assert_allclose(
                        layer[f"{name}_scale"].numpy(),
                        want[f"{name}_scale"], rtol=1e-5,
                        err_msg=f"step {pos} layer {i}")
            steps.append((float(np.abs(logits.numpy()
                                       - np.asarray(jlogits)).max()), flips))
    finally:
        attention.quantize_kv = real
    return steps


@pytest.mark.parametrize("arch", ["llama3-8b", *WINDOWED])
def test_int8_decode_matches_reference(arch):
    """40 int8-cache decode steps of the whole model, past the rings'
    wrap: the logits within 1e-4 at every step until a payload rounds to
    the other step, every payload equal but where the port's quotient
    lies within NEAR_TIE of a half-step, and there one step apart; the
    scales within 1e-5 relative (they are row maxima of k and v, which the
    two packages' float paths already compute up to 3e-6 apart; ROADMAP
    Queue 3).  Identical inputs hold them to 1e-6 above."""
    steps = int8_model_run(arch, seed=2)
    flipped = False
    for pos, (err, flips) in enumerate(steps):
        for layer, name, diff, quotient in flips:
            assert abs(diff) == 1, (pos, layer, name, diff)
            assert abs(abs(quotient) % 1 - 0.5) < NEAR_TIE, quotient
        flipped = flipped or bool(flips)
        if not flipped:
            assert err <= 1e-4, (pos, err)
    assert sum(len(f) for _, f in steps) <= 2


def test_int8_near_tie_rounds_to_the_other_step():
    """On record (ROADMAP Queue 3): in the gemma3 smoke run above, one v
    element of the last layer at step 10 lies so near a half-step that
    the few-ulp difference between the two packages' float k/v rounds it
    to the neighbouring int8, and the logits then differ by more than
    1e-4 (by up to 6.1e-4) while that token stays in the window."""
    steps = int8_model_run("gemma3-4b", seed=2)
    flips = [(pos, f) for pos, (_, fs) in enumerate(steps) for f in fs]
    assert len(flips) == 1
    pos, (layer, name, diff, quotient) = flips[0]
    assert (pos, layer, name, abs(diff)) == (10, 6, "v", 1)
    assert abs(abs(quotient) % 1 - 0.5) < NEAR_TIE
    assert max(err for err, _ in steps[:pos]) <= 1e-4
    assert 1e-4 < steps[pos][0] < 1e-3


# ----------------------------------------------------------------------
# (e) the bounds of tests/test_kv_quant.py, on the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3-8b", *WINDOWED])
def test_int8_decode_tracks_the_float_forward(arch):
    """`tests/test_kv_quant.py::test_quantized_decode_tracks_prefill` on
    the port: int8-cache decode logits within 0.08 of the float forward's
    (relative to its largest) and greedy tokens agreeing above 0.9."""
    cfg, jcfg = configs(arch, kv_quant=True)
    base = dataclasses.replace(cfg, kv_quant=False)
    params = params_from_reference(
        reference_params(dataclasses.replace(jcfg, kv_quant=False), 0),
        base, CPU)
    B, T = 2, 12
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, T)))
    with torch.no_grad():
        ref = transformer.forward(params, base, tokens).numpy()
        cache = transformer.init_cache(cfg, B, 32, CPU)
        got = torch.stack([transformer.decode_step(params, cfg, cache,
                                                   tokens[:, t], t)
                           for t in range(T)], dim=1).numpy()
    assert cache[0]["k"].dtype == torch.int8 and "k_scale" in cache[0]
    err = np.abs(got - ref) / (np.abs(ref).max() + 1e-6)
    assert err.max() < 0.08, err.max()
    agree = (got.argmax(-1) == ref.argmax(-1)).mean()
    assert agree > 0.9, agree


def test_int8_cache_halves_bytes():
    """`tests/test_kv_quant.py::test_quantized_cache_halves_bytes`."""
    cfg = dataclasses.replace(smoke_config("llama3-8b"), kv_quant=True)
    base = dataclasses.replace(cfg, kv_quant=False)
    qb, fb = (sum(t.numel() * t.element_size() for t in tree_leaves(
        transformer.init_cache(c, 4, 64, CPU))) for c in (cfg, base))
    assert qb < 0.65 * fb, (qb, fb)


# ----------------------------------------------------------------------
# (f) the plain int8 decode against the reference's einsum path
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_attn_decode_matches_reference_at_ragged_valid_len(dtype):
    """One attention block's int8 decode from a filled cache on both
    packages, the new token written at slot 36 with 37 of the 64 entries
    valid: the block output, and the cache and scales written."""
    cfg, jcfg = configs("llama3-8b", kv_quant=True, dtype=dtype)
    tree = reference_params(jcfg, 3)
    p = params_from_reference(tree, cfg, CPU)["layers"][0]
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stages"][0]["b0"])
    rng = np.random.default_rng(7)
    B, S, KV, hd = 2, S_MAX, cfg.n_kv_heads, cfg.head_dim
    k8, v8 = (rng.integers(-127, 128, (B, KV, S, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 2e-2, (B, KV, S)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    pos, slot, valid = 50, 36, 37
    jy, jk, jv, jks, jvs = jattention.attn_decode(
        jp, jnp.asarray(x).astype(dtype), jnp.asarray(k8), jnp.asarray(v8),
        jnp.int32(pos), jcfg, None, valid_len=jnp.int32(valid),
        slot=jnp.int32(slot), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    tk, tv, tks, tvs = (torch.from_numpy(a.copy()) for a in (k8, v8, ks, vs))
    y = attention.attn_decode(p, torch.from_numpy(x).to(getattr(torch, dtype)),
                              tk, tv, pos, cfg, slot=slot, valid_len=valid,
                              k_scale=tks, v_scale=tvs)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), **tol)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in ((tks, jks), (tvs, jvs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
