"""Input cells and the serve step of the port against the reference:
`configs/shapes.py` (`SHAPES`, `applicable`, `input_specs` on the meta
device) and `launch/steps.py:make_serve_step` (greedy next tokens and
the in-place cache, at every architecture's smoke config)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.configs import smoke_config as jsmoke_config
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.models import transformer as jtransformer
from repro_torch.configs import PORTED, get_config, shapes, smoke_config
from repro_torch.convert import _layer_index, params_from_reference
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer
from repro_torch.serving.engine import Request, ServeEngine

CPU = torch.device("cpu")


def test_shapes_match_reference():
    assert shapes.FRONTEND_LEN == jshapes.FRONTEND_LEN
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(shapes.ShapeSpec)] == \
        [f.name for f in dataclasses.fields(jshapes.ShapeSpec)]


@pytest.mark.parametrize("arch", PORTED)
def test_input_specs_match_reference(arch):
    """Every (architecture, shape) cell that `applicable` allows: the same
    inputs, shapes and dtypes, on the meta device (no memory)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    cells = 0
    for name, shape in shapes.SHAPES.items():
        jshape = jshapes.SHAPES[name]
        assert shapes.applicable(cfg, shape) == \
            jshapes.applicable(jcfg, jshape)
        if not shapes.applicable(cfg, shape):
            continue
        got = shapes.input_specs(cfg, shape)
        want = jshapes.input_specs(jcfg, jshape)
        assert list(got) == list(want), (arch, name)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape),
                    str(t.dtype).removeprefix("torch.")) == \
                (want[k].shape, np.dtype(want[k].dtype).name), (arch, name, k)
        cells += 1
    assert cells == 3 + cfg.subquadratic


def test_input_specs_frontend_and_unknown_kind():
    cfg = get_config("musicgen-large")
    spec = shapes.input_specs(cfg, shapes.SHAPES["prefill_32k"])
    assert spec["frontend_emb"].shape == (32, 64, cfg.d_model)
    spec = shapes.input_specs(cfg, shapes.SHAPES["decode_32k"])
    assert set(spec) == {"tokens", "pos"} and spec["pos"].shape == ()
    with pytest.raises(ValueError):
        shapes.input_specs(cfg, shapes.ShapeSpec("x", "score", 8, 1))


@pytest.mark.parametrize("arch", PORTED)
def test_serve_step_matches_reference(arch):
    """Eight serve steps on both packages from the same weights: a
    4-token prompt teacher-forced, then each package's own greedy tokens;
    the next tokens equal at every step, the cache (every layer, held in
    place by the port) within 1e-4."""
    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    tree = jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(2), jcfg))
    params = params_from_reference(tree, cfg, CPU)
    B, s_max = 2, 12
    jstep = jax.jit(jmake_serve_step(jcfg))
    step = make_serve_step(cfg)
    jcache = jtransformer.init_cache(jcfg, B, s_max)
    cache = transformer.init_cache(cfg, B, s_max, CPU)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (4, B))
    jtok, tok = jnp.asarray(prompt[0], jnp.int32), \
        torch.from_numpy(prompt[0]).to(torch.int32)
    for pos in range(8):
        jnext, jcache = jstep(tree, jcache, jtok, jnp.int32(pos))
        nxt, out = step(params, cache, tok, pos)
        assert out is cache
        assert nxt.dtype == torch.int32 and nxt.shape == (B,)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
        if pos + 1 < len(prompt):
            jtok = jnp.asarray(prompt[pos + 1], jnp.int32)
            tok = torch.from_numpy(prompt[pos + 1]).to(torch.int32)
        else:
            jtok, tok = jnext, nxt
    for si, bi, r, n in _layer_index(cfg):
        for name, t in cache[n].items():
            np.testing.assert_allclose(
                t.numpy(), np.asarray(jcache[si][f"b{bi}"][name][r]),
                rtol=1e-4, atol=1e-4, err_msg=f"{arch} layer {n} {name}")


def test_serve_step_tokens_are_the_engines():
    """Requests decoded through `make_serve_step` (prompt teacher-forced
    into a batch-4 cache, then greedy) give `ServeEngine`'s tokens."""
    cfg = smoke_config("llama3-8b")
    eng = ServeEngine(cfg, batch=4, max_len=24, seed=0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 6))
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=[int(t) for t in p], max_new=8))
    want = {r.rid: r.out for r in eng.run()}
    step = make_serve_step(cfg)
    cache = transformer.init_cache(cfg, 4, 24, CPU)
    tok, out = torch.from_numpy(prompts[:, 0]).to(torch.int32), []
    for pos in range(6 + 8 - 1):
        nxt, cache = step(eng.params, cache, tok, pos)
        if pos >= 5:
            out.append(nxt)
        tok = torch.from_numpy(prompts[:, pos + 1]).to(torch.int32) \
            if pos + 1 < 6 else nxt
    got = torch.stack(out, 1).tolist()
    assert {rid: got[rid] for rid in range(4)} == want
