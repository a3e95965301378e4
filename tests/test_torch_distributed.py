"""The port's multi-rank code on gloo CPU processes: `compressed_allreduce`
against the reference's on a one-device mesh and, at 2 and 4 ranks,
against a numpy `_compress_one` (the int8 payload exact); `gpipe_apply`
against the reference's (one stage in-process, four stages on four
forced host devices in a subprocess) and the sequential stack; the
meshes and process groups of `launch/mesh.py`; and placed `train` on 8
ranks at mesh (4, 2) against the one-process run, and resumed from a
checkpoint on another mesh.

Every multi-rank case starts its ranks as subprocesses under one
deadline (all are killed when it passes), each rank with one thread,
meeting through a file in the test's tmp_path (no fixed port) with a
60 s collective timeout, so a rank that dies cannot hang the suite."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import smoke_config
from repro_torch.distributed import compression
from repro_torch.distributed.pipeline import bubble_fraction, gpipe_apply
from repro_torch.launch.train import train

REPO = pathlib.Path(__file__).resolve().parent.parent

_PRELUDE = """
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                        rank=RANK, world_size=WORLD,
                        timeout=datetime.timedelta(seconds=60))
def report(obj):
    print("RESULT " + json.dumps(obj), flush=True)
"""


def run_ranks(tmp_path, world: int, body: str, timeout: float = 120):
    """Run `body` on `world` gloo ranks; -> each rank's `report`ed object."""
    script = tmp_path / "rank.py"
    script.write_text(_PRELUDE + textwrap.dedent(body)
                      + "\ndist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    init = tmp_path / "rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(init)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-3000:]}"
    return [json.loads(next(line[7:] for line in out.splitlines()
                            if line.startswith("RESULT ")))
            for _, out, _ in outs]


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo process group in this process."""
    from datetime import timedelta
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# compression
# ----------------------------------------------------------------------
def np_compress(gs, es):
    """The reference's `_compress_one` in numpy over every rank's leaf:
    -> (int8 payload per rank, mean, error per rank)."""
    xs = [g.astype(np.float32) + e for g, e in zip(gs, es)]
    amax = np.float32(max(np.abs(x).max() for x in xs))
    scale = np.maximum(amax / np.float32(127.0), np.float32(1e-12))
    qs = [np.clip(np.round(x / scale), -127, 127).astype(np.int8)
          for x in xs]
    qsum = sum(q.astype(np.float32) for q in qs)
    mean = qsum * scale / np.float32(len(xs))
    return qs, mean, [x - q.astype(np.float32) * scale
                      for x, q in zip(xs, qs)]


def test_compressed_allreduce_bounded_error_and_convergence(one_rank):
    """`tests/test_fault_tolerance.py:141-164` on the port (one rank)."""
    g = {"w": torch.from_numpy(np.random.default_rng(0)
                               .standard_normal((64, 64)).astype(np.float32))}
    e = compression.init_error_state(g)
    out, e2 = compression.compressed_allreduce(g, e)
    scale = float(g["w"].abs().max()) / 127.0
    assert float((out["w"] - g["w"]).abs().max()) <= scale * 0.5 + 1e-6
    np.testing.assert_allclose((out["w"] + e2["w"]).numpy(), g["w"].numpy(),
                               atol=1e-5)
    x = torch.full((16,), 5.0)
    err = {"x": torch.zeros(16)}
    for _ in range(60):
        cg, err = compression.compressed_allreduce({"x": 2 * x}, err)
        x = x - 0.05 * cg["x"]
    assert float(x.abs().max()) < 0.2


def test_compressed_allreduce_one_rank_is_the_numpy_rule(one_rank):
    """Two rounds (the second with the first's error state) over a float32
    and a bf16 leaf: payload, mean and error as numpy computes them."""
    rng = np.random.default_rng(1)
    g = {"a": torch.from_numpy(rng.standard_normal((8, 33)).astype(
        np.float32)), "b": torch.randn(50).to(torch.bfloat16)}
    e = compression.init_error_state(g)
    for _ in range(2):
        out, e_new = compression.compressed_allreduce(g, e)
        for k in g:
            gk = g[k].float().numpy()
            qs, mean, errs = np_compress([gk], [e[k].numpy()])
            x = g[k].float() + e[k]
            q8, _ = compression.quantize(x, x.abs().max())
            np.testing.assert_array_equal(q8.numpy(), qs[0])
            assert out[k].dtype == g[k].dtype
            np.testing.assert_allclose(
                out[k].float().numpy(),
                torch.from_numpy(mean).to(g[k].dtype).float().numpy(),
                rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(e_new[k].numpy(), errs[0],
                                       rtol=1e-6, atol=1e-7)
        e = e_new


def test_compressed_allreduce_one_rank_matches_reference(one_rank):
    """The same float32 and bf16 leaves through two rounds of error
    feedback, each package carrying its own error state: the reference's
    `compressed_allreduce` on a one-device mesh and the port's on a
    one-rank group.  The int8 payload equal (the reference's recovered
    from its error, q = round((x - e') / scale)), the mean and the error
    within 1e-6."""
    import jax
    import jax.numpy as jnp
    from repro.distributed import compression as ref

    mesh = jax.make_mesh((1,), ("data",))
    rng = np.random.default_rng(2)
    a = rng.standard_normal((8, 33)).astype(np.float32) * 3
    b = rng.standard_normal(50).astype(np.float32)
    g_ref = {"a": jnp.asarray(a), "b": jnp.asarray(b, jnp.bfloat16)}
    g = {"a": torch.from_numpy(a), "b": torch.from_numpy(b).to(
        torch.bfloat16)}
    e_ref, e = ref.init_error_state(g_ref), compression.init_error_state(g)
    for rnd in range(2):
        out_ref, e_ref_new = ref.compressed_allreduce(g_ref, e_ref, mesh,
                                                      dp_axes=("data",))
        out, e_new = compression.compressed_allreduce(g, e)
        for k in g:
            x = g[k].float() + e[k]
            q8, scale = compression.quantize(x, x.abs().max())
            x_ref = (np.asarray(g_ref[k].astype(jnp.float32))
                     + np.asarray(e_ref[k]))
            q_ref = np.round((x_ref - np.asarray(e_ref_new[k]))
                             / np.float32(scale.item()))
            np.testing.assert_array_equal(q8.numpy(), q_ref.astype(np.int8),
                                          err_msg=f"{k} round {rnd}")
            assert out[k].dtype == g[k].dtype
            np.testing.assert_allclose(
                out[k].float().numpy(),
                np.asarray(out_ref[k].astype(jnp.float32)),
                rtol=1e-6, atol=1e-7, err_msg=f"{k} round {rnd}")
            np.testing.assert_allclose(e_new[k].numpy(),
                                       np.asarray(e_ref_new[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} round {rnd}")
        e, e_ref = e_new, e_ref_new


_COMPRESS = """
from repro_torch.distributed import compression
def grads(r, rnd):
    rng = np.random.default_rng(100 * rnd + r)
    return {"a": torch.from_numpy(rng.standard_normal((16, 9)).astype(
                np.float32) * (r + 1)),
            "b": {"c": torch.from_numpy(rng.standard_normal(40).astype(
                np.float32))}}
e = compression.init_error_state(grads(RANK, 0))
rounds = []
for rnd in range(2):
    g = grads(RANK, rnd)
    x = g["a"] + e["a"]
    amax = x.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    q8, _ = compression.quantize(x, amax)
    out, e = compression.compressed_allreduce(g, e)
    rounds.append({"q_a": q8.tolist(), "mean_a": out["a"].tolist(),
                   "mean_c": out["b"]["c"].tolist(),
                   "err_a": e["a"].tolist(), "err_c": e["b"]["c"].tolist()})
report(rounds)
"""


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_allreduce_on_gloo_ranks(tmp_path, world):
    """Each rank's int8 payload exactly numpy's; the mean (equal on every
    rank) and each rank's error state within 1e-6, over two rounds of
    error feedback."""
    got = run_ranks(tmp_path, world, _COMPRESS)

    def grads(r, rnd):
        rng = np.random.default_rng(100 * rnd + r)
        return (rng.standard_normal((16, 9)).astype(np.float32) * (r + 1),
                rng.standard_normal(40).astype(np.float32))

    errs = [(np.zeros((16, 9), np.float32), np.zeros(40, np.float32))] \
        * world
    for rnd in range(2):
        gs = [grads(r, rnd) for r in range(world)]
        qa, mean_a, err_a = np_compress([g[0] for g in gs],
                                        [e[0] for e in errs])
        _, mean_c, err_c = np_compress([g[1] for g in gs],
                                       [e[1] for e in errs])
        for r in range(world):
            res = got[r][rnd]
            np.testing.assert_array_equal(np.array(res["q_a"], np.int8),
                                          qa[r])
            for k, want in (("mean_a", mean_a), ("mean_c", mean_c),
                            ("err_a", err_a[r]), ("err_c", err_c[r])):
                np.testing.assert_allclose(np.array(res[k], np.float32),
                                           want, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{k} rank {r}")
        errs = list(zip(err_a, err_c))


# ----------------------------------------------------------------------
# pipeline
# ----------------------------------------------------------------------
def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def make_stages(S, d, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((S, d, d)).astype(
        np.float32) * 0.3),
        "b": torch.from_numpy(rng.standard_normal((S, d)).astype(
            np.float32) * 0.1)}


def sequential(params, xs):
    x = xs
    for s in range(params["w"].shape[0]):
        x = stage_fn({k: v[s] for k, v in params.items()}, x)
    return x


def test_single_stage_degenerate(one_rank):
    """One stage on a one-rank group: the sequential stack's output and
    the reference's `gpipe_apply` on a one-device mesh, within 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.distributed.pipeline import gpipe_apply as ref_gpipe

    params = make_stages(1, 8)
    xs = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 2, 8)).astype(np.float32))
    got = gpipe_apply(stage_fn, {k: v[0] for k, v in params.items()}, xs)
    np.testing.assert_allclose(got.numpy(), sequential(params, xs).numpy(),
                               rtol=1e-5, atol=1e-5)
    want = ref_gpipe(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                     {k: jnp.asarray(v.numpy()) for k, v in params.items()},
                     jnp.asarray(xs.numpy()),
                     mesh=jax.make_mesh((1,), ("stage",)), axis="stage")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_bubble_fraction():
    assert bubble_fraction(4, 12) == pytest.approx(3 / 15)
    assert bubble_fraction(1, 8) == 0.0


_PIPE = """
from repro_torch.distributed.pipeline import gpipe_apply
S, d, M = 4, 8, 6
rng = np.random.default_rng(0)
w = rng.standard_normal((S, d, d)).astype(np.float32) * 0.3
b = rng.standard_normal((S, d)).astype(np.float32) * 0.1
xs = torch.from_numpy(np.random.default_rng(1).standard_normal(
    (M, 2, d)).astype(np.float32))
def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])
mine = {"w": torch.from_numpy(w[RANK]), "b": torch.from_numpy(b[RANK])}
report(gpipe_apply(stage_fn, mine, xs).tolist())
"""


_REF_PIPE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import gpipe_apply
S, d, M = 4, 8, 6
rng = np.random.default_rng(0)
w = rng.standard_normal((S, d, d)).astype(np.float32) * 0.3
b = rng.standard_normal((S, d)).astype(np.float32) * 0.1
xs = np.random.default_rng(1).standard_normal((M, 2, d)).astype(np.float32)
got = gpipe_apply(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                  {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                  jnp.asarray(xs), mesh=jax.make_mesh((4,), ("stage",)),
                  axis="stage")
np.save(sys.argv[1], np.asarray(got))
"""


def test_four_stage_pipeline_on_gloo_ranks(tmp_path):
    """Four gloo ranks, a stage each, against the reference's
    `gpipe_apply` over four forced host devices (a subprocess run beside
    the ranks) on the same stacked params and microbatches, and against
    the sequential stack: every rank's outputs within 1e-5."""
    ref_out = tmp_path / "ref.npy"
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_PIPE, str(ref_out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 JAX_PLATFORMS="cpu"))
    try:
        got = run_ranks(tmp_path, 4, _PIPE)
        _, err = ref.communicate(timeout=120)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    params = make_stages(4, 8)
    xs = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, 2, 8)).astype(np.float32))
    want = sequential(params, xs).numpy()
    want_ref = np.load(ref_out)
    for r in range(4):                     # every rank holds the outputs
        np.testing.assert_allclose(np.array(got[r], np.float32), want_ref,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.array(got[r], np.float32), want,
                                   rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# meshes and groups
# ----------------------------------------------------------------------
_MESH = """
from repro_torch.distributed.sharding import describe_mesh
from repro_torch.launch import mesh as M
mesh = M.make_debug_mesh()
desc = describe_mesh(mesh)
groups = {}
for axes in (("data",), ("model",), ("data", "model"), ()):
    g = M.axis_group(mesh, axes)
    t = torch.tensor([float(RANK)])
    dist.all_reduce(t, group=g.group)
    groups["/".join(axes)] = [g.index, g.size, list(g.ranks), t.item()]
os.environ["LOCAL_WORLD_SIZE"] = "2"
prod = [describe_mesh(M.make_production_mesh(multi_pod=m))
        for m in (False, True)]
report({"names": desc.axis_names, "sizes": desc.sizes, "groups": groups,
        "production": [[d.axis_names, d.sizes] for d in prod]})
"""


def test_debug_mesh_and_axis_groups(tmp_path):
    """make_debug_mesh over 4 ranks is (2, 2) ("data", "model"); the group
    along each axis set holds the ranks differing only there, indexed
    row-major, and its all_reduce sums just those ranks;
    make_production_mesh takes its shape from the job."""
    got = run_ranks(tmp_path, 4, _MESH)
    for r, res in enumerate(got):
        assert res["names"] == ["data", "model"] and res["sizes"] == [2, 2]
        d, m = divmod(r, 2)
        g = res["groups"]
        assert g["data"] == [d, 2, [m, m + 2], 2.0 * m + 2]
        assert g["model"] == [m, 2, [2 * d, 2 * d + 1], 4.0 * d + 1]
        assert g["data/model"] == [r, 4, [0, 1, 2, 3], 6.0]
        assert g[""] == [0, 1, [r], float(r)]
        # 2 nodes of 2 cards; two pods of one node each
        assert res["production"] == [[["data", "model"], [2, 2]],
                                     [["pod", "data", "model"], [2, 1, 2]]]


# ----------------------------------------------------------------------
# placed train on 8 ranks, and across meshes
# ----------------------------------------------------------------------
_TRAIN = """
import dataclasses
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import train
mesh = make_mesh((4, 2), ("data", "model"))
out = {}
llama = smoke_config("llama3-8b")
for recipe in ("tp", "fsdp"):
    _, _, h = train(llama, steps=3, global_batch=8, seq_len=64, mesh=mesh,
                    recipe=recipe, log_every=100, device="cpu")
    out["llama3 " + recipe] = h["loss"]
qwen = smoke_config("qwen3-moe-235b-a22b")
for cf in (qwen.n_experts / qwen.top_k, 1.25):
    cfg = dataclasses.replace(qwen, capacity_factor=cf)
    _, _, h = train(cfg, steps=2, global_batch=8, seq_len=32, mesh=mesh,
                    recipe="tp", log_every=100, device="cpu")
    out[f"qwen3 cf {cf}"] = h["loss"]
report(out)
"""


def test_train_on_eight_ranks_matches_one_process(tmp_path):
    """`tests/test_serving.py::test_multidevice_execution_subprocess`'s
    property on the port: llama3's smoke config 3 steps at global batch
    8 under tp (dp over "data": 2 rows a rank, the weights' heads and ff
    over "model", d_model over "data") and fsdp (dp over both axes: 1
    row a rank, the weights over both), qwen3-moe's 2 steps under tp;
    every rank holds its blocks only, and every loss is finite and the
    same on every rank.  With no dropped assignment (llama3, and qwen3
    at cf = E/K) each loss is the one-process run's within 1e-5
    relative; at cf 1.25 the placed step routes in the cell's |moe_g|
    token groups, as the reference's does, so drops differ from one
    process's and only finiteness is held."""
    got = run_ranks(tmp_path, 8, _TRAIN, timeout=240)
    for r in range(1, 8):
        assert got[r] == got[0]
    res = got[0]
    assert all(np.isfinite(v).all() for v in res.values())
    llama = smoke_config("llama3-8b")
    _, _, h = train(llama, steps=3, global_batch=8, seq_len=64,
                    log_every=100, device="cpu")
    for recipe in ("tp", "fsdp"):
        np.testing.assert_allclose(res["llama3 " + recipe], h["loss"],
                                   rtol=1e-5)
    import dataclasses
    qwen = smoke_config("qwen3-moe-235b-a22b")
    cf = qwen.n_experts / qwen.top_k
    _, _, h = train(dataclasses.replace(qwen, capacity_factor=cf), steps=2,
                    global_batch=8, seq_len=32, log_every=100, device="cpu")
    np.testing.assert_allclose(res[f"qwen3 cf {cf}"], h["loss"], rtol=1e-5)
    assert len(res["qwen3 cf 1.25"]) == 2


_RESUME = """
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import train
mesh = make_mesh(SIZES, ("data", "model"))
_, _, h = train(smoke_config("llama3-8b"), steps=STEPS, global_batch=4,
                seq_len=16, mesh=mesh, recipe="tp", ckpt_dir=CKPT,
                ckpt_every=1, resume=RESUME, log_every=100,
                async_ckpt=False, device="cpu")
report(h["loss"])
"""


def test_train_resumes_on_another_mesh(tmp_path):
    """llama3's smoke config under "tp": 2 steps on a (1, 2) mesh with a
    checkpoint each step, then resumed on (2, 2) to 3 steps.  The
    checkpoint is the reference's whole tree, so the second mesh takes
    its own blocks of it: its step-2 loss and the step-2 checkpoint are
    one uninterrupted process's (1e-5)."""
    ckpt = tmp_path / "ckpt"
    for sizes, steps, resume in (((1, 2), 2, False), ((2, 2), 3, True)):
        d = tmp_path / f"mesh_{sizes[0]}x{sizes[1]}"
        d.mkdir()
        got = run_ranks(d, sizes[0] * sizes[1], _RESUME.replace(
            "SIZES", repr(sizes)).replace("STEPS", str(steps)).replace(
            "CKPT", repr(str(ckpt))).replace("RESUME", str(resume)),
            timeout=120)
        assert all(r == got[0] for r in got)
    assert len(got[0]) == 1                   # step 2 only
    one = tmp_path / "one"
    _, _, h = train(smoke_config("llama3-8b"), steps=3, global_batch=4,
                    seq_len=16, ckpt_dir=str(one), log_every=100,
                    async_ckpt=False, device="cpu")
    np.testing.assert_allclose(got[0], h["loss"][2:], rtol=1e-5)
    name = "step_00000002/arrays.npz"
    with np.load(one / name) as want, np.load(ckpt / name) as have:
        assert sorted(have.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_allclose(have[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_train_over_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torch.distributed"):
        train(smoke_config("llama3-8b"), steps=1, global_batch=2, seq_len=8,
              mesh=(("data", "model"), (1, 1)), device="cpu")


def _torchrun(args, timeout=150):
    """`torchrun --standalone` (a free rendezvous port) of the train CLI;
    the whole process group is killed if it outlives `timeout`."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, 9)
            p.wait()
    assert p.returncode == 0, out[-3000:]
    return out


def test_train_cli_under_torchrun_resumes(tmp_path):
    """The CLI over a (2, 1) mesh under torchrun, 2 steps with a
    checkpoint each step, then resumed to 3: rank 0 wrote the reference's
    layout, both ranks restored it, and the step-2 checkpoint holds what
    one process's uninterrupted run holds (1e-5)."""
    from repro_torch.checkpoint.ckpt import latest_step
    ckpt = tmp_path / "ckpt"
    args = ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
            "--mesh", "data=2,model=1", "--recipe", "fsdp",
            "--global-batch", "4", "--seq-len", "16", "--ckpt-dir",
            str(ckpt), "--ckpt-every", "1"]
    _torchrun(args + ["--steps", "2"])
    out = _torchrun(args + ["--steps", "3", "--resume"])
    assert out.count("[train] resumed from step 1") == 2, out
    assert latest_step(str(ckpt)) == 2
    one = tmp_path / "one"
    train(smoke_config("llama3-8b"), steps=3, global_batch=4, seq_len=16,
          ckpt_dir=str(one), log_every=100, async_ckpt=False, device="cpu")
    name = "step_00000002/arrays.npz"
    with np.load(one / name) as want, np.load(ckpt / name) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
