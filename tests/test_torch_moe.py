"""MoE parity of the PyTorch port (`repro_torch.models.moe`) against the
reference (`repro.models.moe`): the expert MLP's output with and without
capacity drops and on the decode path, the routing's tie rule, the
auxiliary loss and the gradients, at the qwen3-moe and mixtral smoke
widths.  The reference's weights (`init_moe`, drawn with `jax.random`)
and numpy inputs go to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import moe as jmoe
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig

ARCHS = ("qwen3-moe-235b-a22b", "mixtral-8x22b")
TOL = dict(rtol=1e-5, atol=1e-5)


def configs(arch, **over):
    """The reference's smoke config of `arch` with `over` applied, and
    the same as the port's `ModelConfig`."""
    jcfg = dataclasses.replace(jsmoke_config(arch), **over)
    # mixtral is not in the port's registry (windowed blocks); the MoE
    # MLP reads only its widths, which the port's config copies
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})
    return cfg, jcfg


def weights(jcfg, seed=0, dtype=np.float32):
    tree = jmoe.init_moe(jax.random.key(seed), jcfg, None)
    return {k: np.asarray(v, np.float32).astype(dtype) for k, v in
            tree.items()}


def to_port(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype)
            for k, v in tree.items()}


def inputs(jcfg, shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (*shape, jcfg.d_model)).astype(np.float32)


def reference_kept(tree, x, jcfg, C):
    """The (token, expert) pairs the reference's dispatch keeps, from its
    own top-k, stable argsort and searchsorted (`moe.py:96-117`)."""
    E, K = jcfg.n_experts, jcfg.top_k
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, tree["router"])
                           .astype(jnp.float32), axis=-1)
    _, eidx = jax.lax.top_k(probs, K)
    e_flat = eidx.reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    starts = jnp.searchsorted(e_sorted, jnp.arange(E))
    pos = (starts[:, None] + jnp.arange(C)[None]).reshape(-1)
    pos_c = jnp.clip(pos, 0, e_flat.size - 1)
    valid = (pos < e_flat.size) & (e_sorted[pos_c]
                                   == jnp.repeat(jnp.arange(E), C))
    a = np.asarray(order[pos_c])[np.asarray(valid)]
    eidx = np.asarray(eidx).reshape(-1)
    return {(int(i) // K, int(eidx[i])) for i in a}


def port_kept(p, x, cfg, C):
    xf = x.reshape(-1, x.shape[-1])
    _, eidx = moe.route(p["router"], xf, cfg)
    keep = moe.kept(eidx, cfg.n_experts, C)
    return {(int(t), int(eidx[t, k])) for t, k in keep.nonzero().tolist()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["dropless", "drops", "decode"])
def test_moe_ffn_matches_reference(arch, case):
    """float32, 1e-5.  `dropless`: the smoke configs' cf >= E/K (no slot
    overflows) and `dropless=True`; `drops`: cf 1.0, where experts
    overflow, with the dropped pairs equal; `decode`: (B, d) tokens,
    `dropless=True`, as the decode step calls it."""
    cfg, jcfg = configs(arch, **({"capacity_factor": 1.0}
                                 if case == "drops" else {}))
    tree = weights(jcfg)
    x = inputs(jcfg, (5,) if case == "decode" else (2, 16))
    dropless = case != "drops"
    want = jmoe.moe_ffn(tree, jnp.asarray(x), jcfg, dropless=dropless)
    p = to_port(tree)
    got = moe.moe_ffn(p, torch.from_numpy(x), cfg, dropless=dropless)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    T = x.size // x.shape[-1]
    C = moe.capacity(T, cfg, dropless)
    kept = port_kept(p, torch.from_numpy(x), cfg, C)
    assert kept == reference_kept(tree, x, jcfg, C)
    assigned = T * cfg.top_k
    if case == "drops":
        assert 0 < assigned - len(kept), "the case must drop assignments"
    else:
        assert len(kept) == assigned
    if case == "dropless":        # the smoke cf keeps every assignment
        np.testing.assert_allclose(
            moe.moe_ffn(p, torch.from_numpy(x), cfg).numpy(),
            np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routing_ties_go_to_the_lower_expert(dtype):
    """Router columns repeated in threes, so probabilities tie exactly and
    the K-th choice often has a twin just past K: the port's top-k picks
    what `jax.lax.top_k` picks (the lower id), and the MLP's output
    matches the reference's (float32 at 1e-5, bf16 at 2e-2)."""
    cfg, jcfg = configs("qwen3-moe-235b-a22b", dtype=dtype,
                        n_experts=9, top_k=2, capacity_factor=4.5)
    tree = weights(jcfg, seed=3)
    tree["router"] = np.repeat(tree["router"][:, :3], 3, axis=1)
    x = inputs(jcfg, (2, 24), seed=4)
    tdt = getattr(torch, dtype)
    p = to_port(tree, tdt)
    xt = torch.from_numpy(x).to(tdt)
    probs = torch.softmax((xt.reshape(-1, cfg.d_model) @ p["router"])
                          .float(), dim=-1)
    s = torch.sort(probs, dim=-1, descending=True).values
    assert (s[:, 1] == s[:, 2]).sum() >= 10, "ties at the K boundary"
    _, eidx = moe.route(p["router"], xt.reshape(-1, cfg.d_model), cfg)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.top_k)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jidx))
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    jtree = {k: jnp.asarray(v).astype(jnp.dtype(dtype))
             for k, v in tree.items()}
    want = np.asarray(jmoe.moe_ffn(jtree, jx, jcfg), np.float32)
    got = moe.moe_ffn(p, xt, cfg).float().numpy()
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_load_balance_loss_matches_reference(arch):
    cfg, jcfg = configs(arch)
    tree = weights(jcfg, seed=5)
    x = inputs(jcfg, (3, 20), seed=6)
    want = float(jmoe.aux_load_balance_loss(tree, jnp.asarray(x), jcfg))
    got = float(moe.aux_load_balance_loss(to_port(tree), torch.from_numpy(x),
                                          cfg))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dropless", [True, False])
def test_moe_gradients_match_jax_grad(arch, dropless):
    """Gradients of sum(moe_ffn(p, x) * ct) with respect to the router,
    every expert weight and x, against `jax.grad` (float32, 2e-5); cf 1.0
    when not dropless, so dropped assignments carry no gradient."""
    cfg, jcfg = configs(arch, capacity_factor=1.0)
    tree = weights(jcfg, seed=7)
    x = inputs(jcfg, (2, 16), seed=8)
    ct = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(tr, xx):
        return jnp.sum(jmoe.moe_ffn(tr, xx, jcfg, dropless=dropless) * ct)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(tree, jnp.asarray(x))
    p = {k: v.requires_grad_(True) for k, v in to_port(tree).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (moe.moe_ffn(p, xt, cfg, dropless=dropless)
            * torch.from_numpy(ct)).sum()
    grads = torch.autograd.grad(loss, [*p.values(), xt])
    for name, g in zip([*p, "x"], grads):
        want = jgx if name == "x" else jg[name]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_is_deterministic(dtype):
    """Two runs on the same inputs are bit-equal (the combine gathers and
    adds in a fixed order; no scatter-add)."""
    cfg, jcfg = configs("qwen3-moe-235b-a22b", capacity_factor=1.0)
    tdt = getattr(torch, dtype)
    p = to_port(weights(jcfg, seed=10), tdt)
    x = torch.from_numpy(inputs(jcfg, (4, 32), seed=11)).to(tdt)
    a, b = (moe.moe_ffn(p, x, cfg) for _ in range(2))
    assert torch.equal(a.view(torch.int16 if dtype == "bfloat16"
                              else torch.int32),
                       b.view(torch.int16 if dtype == "bfloat16"
                              else torch.int32))
