"""The port's train step and training loop against the JAX reference:
four train steps (with and without gradient accumulation), checkpoints
in the reference's on-disk format read by both packages, the
restart-from-checkpoint property, the straggler monitor and the train
CLI on the CPU.  Inputs come from numpy seeds; reference parameters
reach the port through `convert.params_from_reference`."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.configs import smoke_config as jsmoke_config
from repro.launch import steps as jsteps
from repro.models import transformer as jtransformer
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.configs import smoke_config
from repro_torch.convert import (opt_state_from_reference,
                                 opt_state_to_reference,
                                 params_from_reference, params_to_reference)
from repro_torch.launch import steps
from repro_torch.launch.train import StragglerMonitor, main, train
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import named_leaves, tree_leaves

CPU = torch.device("cpu")


def reference_params(cfg, seed):
    return jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(seed), cfg))


def smoke_pair(arch, **over):
    over = {"flash_chunk": 16, **over}
    return (dataclasses.replace(smoke_config(arch), **over),
            dataclasses.replace(jsmoke_config(arch), **over))


# ----------------------------------------------------------------------
# train step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_steps_match_reference(microbatch):
    """Four train steps of the llama3 smoke model on one batch: the losses
    and gradient norms match the reference's (jitted) step, and the loss
    falls."""
    cfg, jcfg = smoke_pair("llama3-8b")
    tree = reference_params(jcfg, 3)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab, (4, 33)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    kw = dict(warmup_steps=1, total_steps=100, microbatch=microbatch)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jsteps.TrainOptions(**kw)))
    jopt = jadamw_init(tree, JAdamWConfig())
    step_fn = steps.make_train_step(cfg, steps.TrainOptions(**kw))
    params = params_from_reference(tree, cfg, CPU)
    opt = adamw_init(params, AdamWConfig())
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jp, losses, jlosses = tree, [], []
    for i in range(4):
        jp, jopt, jm = jstep(jp, jopt, jnp.int32(i), batch)
        params, opt, m = step_fn(params, opt, i, tbatch)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3, atol=1e-3)
    assert losses[-1] < losses[0]


def test_microbatches_average_the_full_batch():
    """M = 2 accumulates float32 gradients of two half batches: equal to
    the whole batch's gradient up to summation order."""
    cfg = smoke_config("internvl2-1b")
    params = params_from_reference(reference_params(jsmoke_config(
        "internvl2-1b"), 0), cfg, CPU)
    rng = np.random.default_rng(6)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 17)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "frontend_emb": torch.from_numpy(
                 rng.standard_normal((4, 8, cfg.d_model), np.float32))}
    l1, g1 = steps.value_and_grad(params, cfg, batch, 1)
    l2, g2 = steps.value_and_grad(params, cfg, batch, 2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    for (name, a), (_, b) in zip(named_leaves(g1), named_leaves(g2)):
        assert b.dtype == torch.float32, name
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        steps.value_and_grad(params, cfg, batch, 3)


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------
def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "n": torch.tensor(3, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    t = tree()
    save(str(tmp_path), 3, t, extra={"step": 3})
    assert latest_step(str(tmp_path)) == 3
    got, extra = restore(str(tmp_path), 3, t)
    assert extra["step"] == 3
    for (name, a), (_, b) in zip(named_leaves(t), named_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_crash_debris_is_ignored_and_cleaned(tmp_path):
    save(str(tmp_path), 1, tree())
    os.makedirs(tmp_path / "step_00000002.tmp")   # simulated crash
    assert latest_step(str(tmp_path)) == 1
    assert not (tmp_path / "step_00000002.tmp").exists()


@pytest.mark.parametrize("async_write", [False, True])
def test_manager_keeps_last_k(tmp_path, async_write):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=async_write)
    t = tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t, extra={"step": s})
        t["a"] += 1          # the snapshot was taken at save time
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    got, _ = mgr.restore(tree())
    assert mgr.latest() == 4 and float(got["a"][0, 0]) == 3.0


def bf16_pair():
    """The llama3 smoke model in bfloat16 (reference tree and the port's
    params) with one step's worth of AdamW state."""
    cfg, jcfg = smoke_pair("llama3-8b", dtype="bfloat16")
    jparams = jtransformer.init_params(jax.random.key(4), jcfg)
    jopt = jadamw_init(jparams, JAdamWConfig())
    jopt = {"m": jax.tree.map(lambda x: x + 0.25, jopt["m"]),
            "v": jax.tree.map(lambda x: x + 0.5, jopt["v"]),
            "count": jnp.int32(7)}
    return cfg, jcfg, jparams, jopt


def test_checkpoint_reference_to_port(tmp_path):
    """The reference writes params (bfloat16 leaves) and AdamW state; the
    port restores them into its layout."""
    cfg, _, jparams, jopt = bf16_pair()
    jsave(str(tmp_path), 5, {"params": jparams, "opt": jopt},
          extra={"step": 5})
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   CPU)
    opt = adamw_init(params, AdamWConfig())
    like = {"params": params_to_reference(params, cfg),
            "opt": opt_state_to_reference(opt, cfg)}
    got, extra = restore(str(tmp_path), 5, like)
    assert extra == {"step": 5}
    p = params_from_reference(got["params"], cfg, CPU)
    o = opt_state_from_reference(got["opt"], cfg, CPU)
    want = params_from_reference(jax.tree.map(np.asarray, jparams), cfg, CPU)
    for (name, a), (_, b) in zip(named_leaves(p), named_leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), name
    assert int(o["count"]) == 7 and o["count"].dtype == torch.int32
    assert all(float(x.min()) == float(x.max()) == 0.5
               for x in tree_leaves(o["v"]))
    assert all(x.dtype == torch.float32 for x in tree_leaves(o["m"]))


def test_checkpoint_port_to_reference(tmp_path):
    """The port writes; the reference restores into its own tree, bfloat16
    bytes included, and reads the same values."""
    cfg, _, jparams, jopt = bf16_pair()
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   CPU)
    opt = opt_state_from_reference(jax.tree.map(np.asarray, jopt), cfg, CPU)
    save(str(tmp_path), 9, {"params": params_to_reference(params, cfg),
                            "opt": opt_state_to_reference(opt, cfg)},
         extra={"step": 9})
    like = {"params": jparams, "opt": jopt}
    got, extra = jrestore(str(tmp_path), 9, like)
    assert extra == {"step": 9}
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(like)
    assert len(flat_got) == len(flat_want)
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# ----------------------------------------------------------------------
# training loop
# ----------------------------------------------------------------------
def test_restart_matches_uninterrupted(tmp_path):
    """`tests/test_fault_tolerance.py::test_restart_matches_uninterrupted`
    as it states the property: a run that fails at step 7 and resumes
    from its last checkpoint gives the loss history and the parameters of
    the uninterrupted run (bit for bit: the data stream and every step
    are deterministic)."""
    cfg = smoke_config("llama3-8b")
    kw = dict(global_batch=4, seq_len=32, ckpt_every=5, log_every=100,
              device="cpu")
    p_ref, o_ref, h_ref = train(cfg, steps=12, ckpt_dir=str(tmp_path / "a"),
                                async_ckpt=False, **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        train(cfg, steps=12, ckpt_dir=str(tmp_path / "b"),
              inject_failure_at=7, **kw)
    assert latest_step(str(tmp_path / "b")) == 4
    p2, o2, h2 = train(cfg, steps=12, ckpt_dir=str(tmp_path / "b"),
                       resume=True, **kw)
    assert h2["loss"] == h_ref["loss"][5:]
    assert h_ref["loss"][-1] < h_ref["loss"][0]
    for (name, a), (_, b) in zip(named_leaves((p_ref, o_ref)),
                                 named_leaves((p2, o2))):
        assert torch.equal(a, b), name
    assert latest_step(str(tmp_path / "b")) == 11


def test_checkpoint_every_step_ends_cleanly(tmp_path):
    """With the step count a multiple of `ckpt_every` the loop has just
    written the last step's checkpoint, so the final save does not write
    it again (it renamed onto the existing directory and raised); a
    resume with no step left to run writes nothing."""
    cfg = smoke_config("llama3-8b")
    kw = dict(steps=2, global_batch=2, seq_len=8, ckpt_dir=str(tmp_path),
              ckpt_every=1, log_every=100, async_ckpt=False, device="cpu")
    train(cfg, **kw)
    assert sorted(os.listdir(tmp_path)) == ["step_00000000",
                                            "step_00000001"]
    _, _, hist = train(cfg, resume=True, **kw)
    assert hist["loss"] == [] and latest_step(str(tmp_path)) == 1


def test_straggler_monitor_flags_slow_steps():
    m = StragglerMonitor(deadline_factor=2.0, warmup=1)
    flags = [m.observe(i, dt) for i, dt in
             enumerate([1.0, 1.0, 1.0, 5.0, 1.0])]
    assert flags[3] is True and sum(flags) == 1 and m.strikes == 1


def test_train_cli_runs_on_cpu(tmp_path, capsys):
    hist = main(["--arch", "internvl2-1b", "--smoke", "--device", "cpu",
                 "--steps", "3", "--global-batch", "2", "--seq-len", "16",
                 "--microbatch", "2", "--ckpt-dir", str(tmp_path)])
    assert len(hist["loss"]) == 3 and all(np.isfinite(hist["loss"]))
    assert latest_step(str(tmp_path)) == 2
    assert "[train] done on cpu" in capsys.readouterr().out
