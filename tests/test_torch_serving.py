"""Serving-slice parity of the PyTorch port against the reference:
configurations, parameter conversion, decode-step logits and the serving
engine's greedy tokens, plus the port's import and device rules.  The
reference's parameters are drawn with `jax.random`, turned into numpy and
loaded into the port (torch cannot reproduce `jax.random`)."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.data.lm_pipeline import DataConfig as JDataConfig
from repro.kernels import ref as jref
from repro.launch.steps import TrainOptions as JTrainOptions
from repro.models import common as jcommon
from repro.models import config as jconfig
from repro.models import transformer as jtransformer
from repro.optim import AdamWConfig as JAdamWConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.tiering.hotness import TrackerConfig as JTrackerConfig
from repro.tiering.kvcache import KVTierConfig as JKVTierConfig
from repro_torch.configs import PORTED, get_config, smoke_config
from repro_torch.convert import (_layer_index, params_from_reference,
                                 params_to_reference)
from repro_torch.data.lm_pipeline import DataConfig
from repro_torch.launch.steps import TrainOptions
from repro_torch.models import attention, common, config, transformer
from repro_torch.optim import AdamWConfig
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.tiering.hotness import HotTracker, TrackerConfig
from repro_torch.tiering.kvcache import KVTierConfig, TieredKVCache
from repro_torch.tree import tree_leaves

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def reference_params(cfg, seed):
    """The reference's random parameters as a numpy tree."""
    tree = jtransformer.init_params(jax.random.key(seed), cfg)
    return jax.tree.map(np.asarray, tree)


def field_spec(cls):
    """(name, default, default_factory) per field; a dataclass default
    (TrainOptions.opt) compares by its fields, as the two packages'
    classes differ."""
    def default(f):
        if dataclasses.is_dataclass(f.default):
            return type(f.default).__name__, dataclasses.asdict(f.default)
        return f.default
    return [(f.name, default(f), f.default_factory) for f in
            dataclasses.fields(cls)]


# ----------------------------------------------------------------------
# configurations
# ----------------------------------------------------------------------
@pytest.mark.parametrize("port,reference", [
    (config.Block, jconfig.Block), (config.ModelConfig, jconfig.ModelConfig),
    (TrackerConfig, JTrackerConfig), (KVTierConfig, JKVTierConfig),
    (AdamWConfig, JAdamWConfig), (TrainOptions, JTrainOptions),
    (DataConfig, JDataConfig)])
def test_dataclasses_match_reference_field_for_field(port, reference):
    assert field_spec(port) == field_spec(reference)


@pytest.mark.parametrize("arch", PORTED)
def test_ported_configs_match_reference(arch):
    for port, reference in ((get_config(arch), jget_config(arch)),
                            (smoke_config(arch), jsmoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(reference)
        assert port.n_layers == reference.n_layers
        assert port.param_count() == reference.param_count()


@pytest.mark.parametrize("arch", ["zamba2-70b", "llama3"])
def test_unported_configs_raise(arch):
    """Every architecture of the reference is ported; an id it does not
    know raises."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_config(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        smoke_config(arch)


def test_page_bytes_match_reference():
    kw = dict(n_pages=64, fast_slots=8, n_layers=2, dtype="float32")
    assert KVTierConfig(**kw).page_bytes == JKVTierConfig(**kw).page_bytes
    assert KVTierConfig(64, 8).page_bytes == JKVTierConfig(64, 8).page_bytes


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", PORTED)
def test_params_from_reference_consumes_every_leaf(arch):
    cfg = smoke_config(arch)
    tree = reference_params(jsmoke_config(arch), 0)
    params = params_from_reference(tree, cfg, CPU)
    assert len(params["layers"]) == cfg.n_layers
    n_ref = sum(x.size for x in jax.tree.leaves(tree))
    n_port = sum(t.numel() for t in tree_leaves(params))
    assert n_port == n_ref
    tree["stages"][0]["b0"]["extra"] = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        params_from_reference(tree, cfg, CPU)


@pytest.mark.parametrize("arch", PORTED)
def test_params_to_reference_round_trip(arch):
    """`params_to_reference` gives the reference's tree back, leaf for
    leaf (nested `moe` leaves included), in the reference's layout."""
    cfg = smoke_config(arch)
    tree = reference_params(jsmoke_config(arch), 0)
    back = params_to_reference(params_from_reference(tree, cfg, CPU), cfg)
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), back))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32),
                                      err_msg=str(path))


def test_init_params_shapes_match_reference():
    cfg = smoke_config("llama3-8b")
    g = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, g, CPU)
    converted = params_from_reference(
        reference_params(jsmoke_config("llama3-8b"), 0), cfg, CPU)
    assert params.keys() == converted.keys()
    for layer, want in zip(params["layers"], converted["layers"]):
        assert {k: v.shape for k, v in layer.items()} == \
            {k: v.shape for k, v in want.items()}
    assert params["embed"].shape == (transformer.padded_vocab(cfg),
                                     cfg.d_model)


# ----------------------------------------------------------------------
# model primitives, decode step and engine
# ----------------------------------------------------------------------
def test_common_primitives_match_reference():
    """rms_norm, rope, swiglu and the decode partials with their
    log-sum-exp merge (float32; the reductions may sum in another
    order)."""
    rng = np.random.default_rng(3)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)
    x, scale = f(2, 5, 4, 16), f(16)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    t = torch.from_numpy
    np.testing.assert_allclose(common.rms_norm(t(x), t(scale)).numpy(),
                               np.asarray(jcommon.rms_norm(x, scale)), **tol)
    np.testing.assert_allclose(
        common.rope(t(x), t(pos), 1e4).numpy(),
        np.asarray(jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        **tol)
    h, wg, wu, wd = f(2, 16), f(16, 24), f(16, 24), f(24, 16)
    np.testing.assert_allclose(
        common.swiglu(t(h), t(wg), t(wu), t(wd)).numpy(),
        np.asarray(jcommon.swiglu(h, wg, wu, wd)), **tol)
    q, k, v = f(2, 8, 16), f(2, 12, 2, 16), f(2, 12, 2, 16)
    valid = 10
    parts, jparts = [], []
    for lo, hi in ((0, 7), (7, 12)):
        parts.append(common.decode_attention_partial(
            t(q), t(k[:, lo:hi]), t(v[:, lo:hi]), valid, pos_offset=lo))
        jparts.append(jcommon.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k[:, lo:hi]), jnp.asarray(v[:, lo:hi]),
            valid, pos_offset=lo))
        for a, b in zip(parts[-1], jparts[-1]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    merged = common.merge_partials(parts).reshape(2, 8, 16)
    np.testing.assert_allclose(
        merged.numpy(),
        np.asarray(jcommon.merge_partials(jparts)).reshape(2, 8, 16), **tol)
    np.testing.assert_allclose(
        merged.numpy(), np.asarray(jref.decode_attention_ref(q, k, v, valid)),
        **tol)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_step_logits_match_reference(arch):
    """12 decode steps on both packages (float32 smoke configs); the
    einsums sum in another order than torch's matmuls, hence 1e-4."""
    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    tree = reference_params(jcfg, 1)
    params = params_from_reference(tree, cfg, CPU)
    B, s_max = 3, 16
    jcache = jtransformer.init_cache(jcfg, B, s_max)
    cache = transformer.init_cache(cfg, B, s_max, CPU)
    jstep = jax.jit(lambda c, t, p: jtransformer.decode_step(tree, jcfg, c,
                                                             t, p))
    rng = np.random.default_rng(5)
    for pos in range(12):
        toks = rng.integers(0, cfg.vocab, B).astype(np.int32)
        jlogits, jcache = jstep(jcache, jnp.asarray(toks), jnp.int32(pos))
        logits = transformer.decode_step(params, cfg, cache,
                                         torch.from_numpy(toks), pos)
        assert logits.shape == (B, transformer.padded_vocab(cfg))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
    # the in-place cache holds what the reference's functional one does
    # (k/v, or the mamba2 ssm and conv state)
    for name, got in cache[-1].items():
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jcache[-1]["b0"][name][-1]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def run_both(arch, *, batch, max_len, seed, prompts, max_new):
    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    jeng = JServeEngine(jcfg, batch=batch, max_len=max_len, seed=seed)
    params = params_from_reference(jax.tree.map(np.asarray, jeng.params),
                                   cfg, CPU)
    eng = ServeEngine(cfg, params, batch=batch, max_len=max_len,
                      device="cpu")
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=list(prompt), max_new=max_new))
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new=max_new))
    jdone, done = jeng.run(), eng.run()
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in jdone]
    assert (eng.steps_used, eng.starved) == (jeng.steps_used, jeng.starved)
    return eng, done


def test_engine_greedy_matches_reference_internvl2():
    """`tests/test_serving.py::test_engine_completes_requests` on both."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, 8) for _ in range(4)]
    _, done = run_both("internvl2-1b", batch=2, max_len=48, seed=0,
                       prompts=prompts, max_new=6)
    assert len(done) == 4 and all(len(r.out) == 6 for r in done)


def test_engine_greedy_matches_reference_stablelm():
    """`tests/test_serving.py::test_engine_greedy_is_deterministic`."""
    _, done = run_both("stablelm-3b", batch=1, max_len=32, seed=3,
                       prompts=[[5, 9, 2, 7]], max_new=8)
    assert len(done[0].out) == 8


def test_engine_greedy_matches_reference_qwen3_moe():
    """The MoE engine over two waves (dropless decode, as the reference
    decodes)."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, 6) for _ in range(3)]
    _, done = run_both("qwen3-moe-235b-a22b", batch=2, max_len=24, seed=1,
                       prompts=prompts, max_new=5)
    assert len(done) == 3 and all(len(r.out) == 5 for r in done)


def test_engine_starves_like_reference():
    """A step budget that runs out leaves the same state on both."""
    jcfg, cfg = jsmoke_config("llama3-8b"), smoke_config("llama3-8b")
    jeng = JServeEngine(jcfg, batch=1, max_len=32, seed=0)
    eng = ServeEngine(cfg, params_from_reference(
        jax.tree.map(np.asarray, jeng.params), cfg, CPU), batch=1,
        max_len=32, device="cpu")
    for e, req in ((jeng, JRequest), (eng, Request)):
        for rid in range(2):
            e.submit(req(rid=rid, prompt=[1, 2, 3], max_new=4))
        e.run(max_steps=9)
    assert eng.starved and jeng.starved
    assert eng.steps_used == jeng.steps_used == 9
    assert [r.out for r in eng.completed] == [r.out for r in jeng.completed]


# ----------------------------------------------------------------------
# windowed and int8 decode caches
# ----------------------------------------------------------------------
def test_window_and_int8_decode_raise():
    """Windowed and int8 caches, which the port refused before it ran
    them, have the reference's shapes and dtypes
    (`repro/models/transformer.py:252-283`): a windowed layer a ring of
    min(window, s_max) slots, an int8 cache int8 k/v with float32 scales
    of shape (B, KV, S), for every layer of gemma3's and mixtral's smoke
    configs."""
    for arch in ("gemma3-4b", "mixtral-8x22b", "llama3-8b"):
        for quant, s_max in ((False, 8), (False, 40), (True, 40)):
            cfg = dataclasses.replace(smoke_config(arch), kv_quant=quant)
            jcfg = dataclasses.replace(jsmoke_config(arch), kv_quant=quant)
            jcache = jtransformer.init_cache(jcfg, 2, s_max)
            cache = transformer.init_cache(cfg, 2, s_max, CPU)
            want = [{n: (a.shape[1:], np.dtype(a.dtype).name)
                     for n, a in jcache[si][f"b{bi}"].items()}
                    for si, bi, _, _ in _layer_index(cfg)]
            got = [{n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                    for n, t in layer.items()} for layer in cache]
            assert got == want, (arch, quant, s_max)


# ----------------------------------------------------------------------
# import and device rules
# ----------------------------------------------------------------------
_IMPORT_SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
for name in ("repro_torch.launch.train", "repro_torch.launch.steps",
             "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
             "repro_torch.optim", "repro_torch.optim.adamw",
             "repro_torch.data", "repro_torch.data.lm_pipeline",
             "repro_torch.kernels.flash_attention",
             "repro_torch.kernels.ssd_scan", "repro_torch.models.mamba2",
             "repro_torch.configs.mamba2_1_3b", "repro_torch.models.moe",
             "repro_torch.configs.qwen3_moe_235b_a22b",
             "repro_torch.tiering.embedding",
             "repro_torch.tiering.expert_cache",
             "repro_torch.configs.gemma3_4b",
             "repro_torch.configs.mixtral_8x22b",
             "repro_torch.configs.minitron_8b",
             "repro_torch.configs.musicgen_large",
             "repro_torch.configs.shapes", "repro_torch.launch.mesh",
             "repro_torch.distributed", "repro_torch.distributed.sharding",
             "repro_torch.distributed.compression",
             "repro_torch.distributed.pipeline",
             "repro_torch.distributed.placement", "repro_torch.launch.plan",
             "repro_torch.launch.profile_placed",
             "repro_torch.core.lsm", "repro_torch.core.ralt",
             "repro_torch.core.runner", "repro_torch.core.baselines",
             "repro_torch.data.workloads", "repro_torch.obs.metrics",
             "repro_torch.core.wal", "repro_torch.core.crashpoints",
             "repro_torch.core.shards", "repro_torch.configs.hotrap_kv",
             "repro_torch.core.sanitize", "repro_torch.obs.trace",
             "repro_torch.obs.attribution", "repro_torch.obs.serving"):
    assert name in sys.modules, name
print(len(names), "modules")
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 20


@pytest.mark.parametrize("make", [
    lambda: ServeEngine(smoke_config("llama3-8b"), batch=1, max_len=8),
    lambda: HotTracker(TrackerConfig(n_units=8, unit_bytes=1,
                                     fast_bytes=4)),
    lambda: TieredKVCache(KVTierConfig(n_pages=8, fast_slots=2),
                          hbm_bw=1.0, pcie_bw=1.0),
    lambda: __import__("repro_torch.launch.serve", fromlist=["main"]).main(
        ["--smoke", "--requests", "1"]),
    lambda: __import__("repro_torch.launch.train", fromlist=["train"]).train(
        smoke_config("llama3-8b"), steps=1, global_batch=2, seq_len=8),
    lambda: __import__("repro_torch.launch.train", fromlist=["main"]).main(
        ["--smoke", "--steps", "1"]),
    lambda: __import__("repro_torch.launch.train", fromlist=["train"]).train(
        smoke_config("llama3-8b"), steps=1, global_batch=2, seq_len=8,
        mesh=(("data", "model"), (1, 1))),
    lambda: __import__("repro_torch.launch.train", fromlist=["main"]).main(
        ["--smoke", "--steps", "1", "--mesh", "data=1,model=1"]),
    lambda: __import__("repro_torch.launch.serve", fromlist=["main"]).main(
        ["--smoke", "--mesh", "1x1"]),
])
def test_entry_points_need_cuda_unless_cpu_is_asked(make):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    done = main(["--smoke", "--device", "cpu", "--requests", "3",
                 "--prompt-len", "4", "--max-new", "3", "--batch", "2"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    assert "3 requests, 9 tokens" in capsys.readouterr().out
