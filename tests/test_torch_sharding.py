"""Logical-axis sharding of the port against the reference:
`distributed/sharding.py`, `launch/mesh.py:axis_binding` and the spec
trees of every architecture (`logical_param_specs`, `param_specs`,
`cache_specs`), leaf for leaf.  The binding code reads only a mesh's
axis names and sizes, so a `MeshDesc` stands in for a mesh of any size
in both packages (the production 16 x 16 and 2 x 16 x 16, and 4 x 2)
without any device."""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.distributed import sharding as jsh
from repro.launch.mesh import axis_binding as jaxis_binding
from repro.models import transformer as jtransformer
from repro_torch.configs import PORTED, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import cache_specs_to_reference, specs_to_reference
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import MeshDesc, P
from repro_torch.launch.mesh import axis_binding
from repro_torch.models import transformer

PKGS = {"reference": (jsh, jaxis_binding, JP), "port": (sh, axis_binding, P)}


def teardown_function(_):
    jsh.clear_mesh_axes()
    sh.clear_mesh_axes()


def mesh11(pkg):
    """A real (1, 1) mesh for the reference, its description for the
    port."""
    if pkg == "reference":
        return jax.make_mesh((1, 1), ("data", "model"))
    return MeshDesc(("data", "model"), (1, 1))


# ----------------------------------------------------------------------
# every case of tests/test_sharding_logic.py, against both packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pkg", PKGS)
def test_dedupe_first_dim_wins(pkg):
    m, _, Spec = PKGS[pkg]
    m.set_mesh_axes(dp=("data", "model"), tp=("model",))
    assert m.logical_spec(m.DP, m.TP, None) == \
        Spec(("data", "model"), None, None)


@pytest.mark.parametrize("pkg", PKGS)
def test_dedupe_tp_then_sp(pkg):
    m, _, Spec = PKGS[pkg]
    m.set_mesh_axes(dp=("data",), tp=("model",), sp=("model",))
    assert m.logical_spec(m.DP, m.TP, m.SP, None) == \
        Spec("data", "model", None, None)


@pytest.mark.parametrize("pkg", PKGS)
def test_size1_mesh_drops_constraints(pkg):
    m, _, Spec = PKGS[pkg]
    m.set_mesh_axes(dp=("data",), tp=("model",), mesh=mesh11(pkg))
    assert m.logical_spec(m.DP, m.TP, shape=(4, 4)) == Spec(None, None)


@pytest.mark.parametrize("pkg", PKGS)
def test_divisibility_fallback_without_mesh(pkg):
    m, _, Spec = PKGS[pkg]
    m.set_mesh_axes(tp=("model",))
    assert m.logical_spec(m.TP, shape=(7,)) == Spec("model")


@pytest.mark.parametrize("pkg", PKGS)
def test_sp_active_logic(pkg):
    m, _, _ = PKGS[pkg]
    m.set_mesh_axes(dp=("data",), tp=("model",), sp=("model",))
    assert not m.sp_active()
    m.set_mesh_axes(dp=("data",), tp=(), sp=("model",))
    assert m.sp_active()
    m.set_mesh_axes(dp=("data",), tp=(), sp=("model",), mesh=mesh11(pkg))
    assert not m.sp_active()


@pytest.mark.parametrize("pkg", PKGS)
def test_axis_binding_recipes(pkg):
    _, axis_binding_, _ = PKGS[pkg]
    mesh = mesh11(pkg)
    b = axis_binding_(mesh, shape_kind="train", recipe="tp")
    assert b["tp"] == ("model",) and b["dp"] == ("data",)
    assert b["sp"] == ("model",)
    b = axis_binding_(mesh, shape_kind="train", recipe="fsdp", batch=1)
    assert b["tp"] == () and set(b["fsdp"]) == {"data", "model"}
    assert b["dp"] == ("data", "model")
    b = axis_binding_(mesh, shape_kind="train", recipe="fsdp",
                      batch=None, allow_sp=False)
    assert b["tp"] == ("model",)
    b = axis_binding_(mesh, shape_kind="train", recipe="fsdp",
                      batch=None, allow_sp=True)
    assert b["tp"] == () and b["sp"] == ("model",)
    b = axis_binding_(mesh, shape_kind="train", recipe="ep", batch=1)
    assert b["tp"] == ("model",) and b["dp"] == ("data", "model")
    b = axis_binding_(mesh, shape_kind="decode")
    assert b["seq"] == ("model",)
    b = axis_binding_(mesh, shape_kind="decode", seq_over_all=True)
    assert b["seq"] == ("data", "model")


@pytest.mark.parametrize("pkg", PKGS)
def test_moe_g_includes_context_parallel_axes(pkg):
    _, axis_binding_, _ = PKGS[pkg]
    mesh = mesh11(pkg)
    b = axis_binding_(mesh, shape_kind="train", recipe="fsdp",
                      batch=None, allow_sp=True)
    assert b["sp"] == ("model",)
    assert b["moe_g"] == ("data", "model")
    b = axis_binding_(mesh, shape_kind="train", recipe="tp")
    assert b["moe_g"] == ("data",)


@pytest.mark.parametrize("pkg", PKGS)
def test_param_specs_moe_ff_sharded(pkg):
    if pkg == "reference":
        cfg = jsmoke_config("mixtral-8x22b")
        params = jax.eval_shape(lambda k: jtransformer.init_params(k, cfg),
                                jax.random.key(0))
        specs = jtransformer.param_specs(params, cfg, mesh11(pkg),
                                         moe_ff_sharded=True)
        wg = specs["stages"][0]["b0"]["moe"]["w_gate"]
        assert isinstance(wg, JP) and len(wg) == 4
    else:
        cfg = smoke_config("mixtral-8x22b")
        specs = transformer.param_specs(transformer.param_shapes(cfg), cfg,
                                        mesh11(pkg), moe_ff_sharded=True)
        wg = specs["layers"][0]["moe"]["w_gate"]
        assert isinstance(wg, P) and len(wg) == 3      # no stack dim


# ----------------------------------------------------------------------
# the port's own rules
# ----------------------------------------------------------------------
def test_partition_spec_is_a_tuple():
    assert P() == () and P("data", None) == ("data", None)
    assert tuple(JP(("data", "model"), None)) == \
        tuple(P(("data", "model"), None))
    assert repr(P("data")) == "P('data',)"


def test_describe_mesh():
    d = sh.describe_mesh((("pod", "data", "model"), (2, 16, 16)))
    assert d == MeshDesc(("pod", "data", "model"), (2, 16, 16))
    assert d.size == 512 and d.shape == {"pod": 2, "data": 16, "model": 16}
    assert sh.describe_mesh(d) is d
    with pytest.raises(ValueError):
        sh.describe_mesh((("data",), (2, 2)))


def test_bound_axis_sizes_and_mesh_axes_context():
    mesh = MeshDesc(("data", "model"), (4, 2))
    assert sh.axis_size(sh.DP) == 1                 # nothing bound
    with sh.mesh_axes(dp=("data",), tp=("model",), mesh=mesh):
        assert sh.axis_size(sh.DP) == 4 and sh.axis_size(sh.TP) == 2
        assert sh.axis_size(sh.MOEG) == 4           # defaults to dp
        # 6 heads do not divide 2 x 4 over (data, model): data is dropped
        sh.set_mesh_axes(fsdp=("model", "data"), mesh=mesh)
        assert sh.logical_spec(sh.FSDP, shape=(6,)) == P("model")
    assert sh._BINDING is None


def test_shard_checks_dims_and_returns_input():
    x = torch.zeros(2, 3)
    assert sh.shard(x, sh.DP, None) is x
    sh.set_mesh_axes(mesh=MeshDesc(("data", "model"), (2, 1)))
    assert sh.shard(x, sh.DP, sh.TP) is x
    with pytest.raises(ValueError):
        sh.shard(x, sh.DP)


# ----------------------------------------------------------------------
# spec trees, leaf for leaf, at the production and debug meshes
# ----------------------------------------------------------------------
MESHES = [MeshDesc(("data", "model"), (16, 16)),
          MeshDesc(("pod", "data", "model"), (2, 16, 16)),
          MeshDesc(("data", "model"), (4, 2))]


def plain(tree):
    """Specs as plain tuples (None kept), for either package's tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [plain(v) for v in tree]
    return tuple(tree)


_REF_SHAPES = {}


def ref_param_shapes(arch):
    if arch not in _REF_SHAPES:
        cfg = jget_config(arch)
        _REF_SHAPES[arch] = jax.eval_shape(
            lambda k: jtransformer.init_params(k, cfg), jax.random.key(0))
    return _REF_SHAPES[arch]


@pytest.mark.parametrize("arch", PORTED)
def test_logical_param_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for ff in (False, True):
        got = specs_to_reference(
            transformer.logical_param_specs(cfg, moe_ff_sharded=ff), cfg)
        want = jtransformer.logical_param_specs(jcfg, moe_ff_sharded=ff)
        assert plain(got) == plain(want), (arch, ff)


@pytest.mark.parametrize("arch", PORTED)
def test_param_specs_match_reference(arch):
    """Concrete specs under the binding of every recipe and shape kind
    (`plan_cell`'s arguments: decode takes the weight-stationary expert
    layout) and under both expert layouts with the default axes."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    port_shapes, ref_shapes = transformer.param_shapes(cfg), \
        ref_param_shapes(arch)
    for mesh in MESHES:
        cases = [dict(moe_ff_sharded=ff) for ff in (False, True)]
        for kind, recipe in (("train", "tp"), ("train", "fsdp"),
                             ("train", "ep"), ("decode", "tp")):
            b = axis_binding(mesh, shape_kind=kind, recipe=recipe, batch=256)
            assert b == jaxis_binding(mesh, shape_kind=kind, recipe=recipe,
                                      batch=256)
            cases.append(dict(dp_axes=b["dp"], tp_axes=b["tp"],
                              fsdp_axes=b["fsdp"], vocab_axes=b["vocab"],
                              embed_d_axes=b["embed_d"],
                              moe_ff_sharded=kind == "decode"))
        for kw in cases:
            got = specs_to_reference(
                transformer.param_specs(port_shapes, cfg, mesh, **kw), cfg)
            want = jtransformer.param_specs(ref_shapes, jcfg, mesh, **kw)
            assert plain(got) == plain(want), (arch, mesh, kw)


@pytest.mark.parametrize("arch", PORTED)
def test_cache_specs_match_reference(arch):
    """decode_32k's cache (every applicable architecture) and long_500k's
    (sub-quadratic ones), with the KV sequence over tp and over every
    axis (`seq_over_all`); int8 caches at llama3."""
    import dataclasses
    cfgs = [(get_config(arch), jget_config(arch))]
    if arch == "llama3-8b":
        cfgs.append(tuple(dataclasses.replace(c, kv_quant=True)
                          for c in cfgs[0]))
    for cfg, jcfg in cfgs:
        for name in ("decode_32k", "long_500k"):
            shape = SHAPES[name]
            if name == "long_500k" and not cfg.subquadratic:
                continue
            cache = transformer.init_cache(cfg, shape.batch, shape.seq,
                                           "meta")
            jcache = jax.eval_shape(lambda: jtransformer.init_cache(
                jcfg, JSHAPES[name].batch, JSHAPES[name].seq))
            for mesh in MESHES:
                for seq_over_all in (False, True):
                    b = axis_binding(mesh, shape_kind="decode",
                                     seq_over_all=seq_over_all)
                    kw = dict(dp_axes=b["dp"], tp_axes=b["tp"],
                              seq_axes=b["seq"])
                    got = cache_specs_to_reference(
                        transformer.cache_specs(cache, mesh, **kw), cfg)
                    want = jtransformer.cache_specs(jcache, mesh, **kw)
                    assert plain(got) == plain(want), (arch, name, mesh)


def test_divisibility_fallbacks_gemma3_and_mixtral():
    """gemma3's 8 heads (4 KV) skip a 16-way model axis while d_model
    still shards over data; mixtral's 8 experts cannot take the model
    axis, so its ff dim does (and, weight-stationary, spans model and
    data)."""
    mesh = MESHES[0]
    cfg = get_config("gemma3-4b")
    layer = transformer.param_specs(transformer.param_shapes(cfg), cfg,
                                    mesh)["layers"][0]
    assert layer["wq"] == P("data", None, None)
    assert layer["wk"] == P("data", None, None)
    assert layer["w_gate"] == P("data", "model")
    cfg = get_config("mixtral-8x22b")
    shapes_ = transformer.param_shapes(cfg)
    moe = transformer.param_specs(shapes_, cfg, mesh)["layers"][0]["moe"]
    assert moe["w_gate"] == P(None, "data", "model")
    moe = transformer.param_specs(shapes_, cfg, mesh,
                                  moe_ff_sharded=True)["layers"][0]["moe"]
    assert moe["w_gate"] == P(None, None, ("model", "data"))
    cfg = get_config("qwen3-moe-235b-a22b")
    moe = transformer.param_specs(transformer.param_shapes(cfg), cfg,
                                  mesh)["layers"][0]["moe"]
    assert moe["w_gate"] == P("model", "data", None)     # EP


def test_specs_to_reference_rejects_disagreeing_layers():
    cfg = smoke_config("llama3-8b")
    specs = transformer.logical_param_specs(cfg)
    specs["layers"][1]["wq"] = (None, None, None)
    with pytest.raises(ValueError):
        specs_to_reference(specs, cfg)
