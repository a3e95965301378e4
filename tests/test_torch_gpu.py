"""The PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version (which `tests/test_torch_kernels.py`,
`tests/test_torch_training.py` and `tests/test_torch_ssd.py` hold to the
JAX reference), and the decode step, tiered KV cache, training step and
mamba2 mixer, prefill and decode on CUDA against the same code on the
CPU.  Imports neither jax nor `repro`, so it runs on a GPU machine
without them:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test is marked `gpu` and skips where there is no CUDA device."""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import transformer
from repro_torch.tiering import KVTierConfig, TieredKVCache

pytestmark = pytest.mark.gpu

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),       # tests/test_kernels.py
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run "
                    "only on the card")
    return torch.device("cuda")


def ralt_inputs(N):
    rng = np.random.default_rng(N)
    return (torch.from_numpy(rng.integers(0, 50, N).astype(np.int32)),
            torch.from_numpy((rng.random(N) * 5).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 2, N).astype(np.int8)))


@pytest.mark.parametrize("N", [1, 100, 128, 1000, 4096, 5000, 1 << 20])
@pytest.mark.parametrize("offset", [0, 1])
def test_ralt_kernel_matches_plain(cuda, N, offset):
    """Bit for bit, with 16-byte-aligned inputs and with inputs one
    element off alignment (the scalar path)."""
    ticks, scores, hits = (x[offset:] for x in ralt_inputs(N + offset))
    want = ops.ralt_update(ticks, scores, hits, 57, 1.0)
    before = ops.LAUNCHES["ralt_update"]
    got = ops.ralt_update(ticks.to(cuda), scores.to(cuda), hits.to(cuda),
                          torch.tensor(57, dtype=torch.int32, device=cuda),
                          torch.tensor(1.0, device=cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ralt_update"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KVH,D,valid", [
    (2, 256, 8, 2, 64, 256), (2, 256, 8, 2, 64, 130), (1, 512, 4, 1, 128, 17),
    (4, 128, 4, 4, 128, 128), (1, 1024, 8, 4, 256, 700),
    (4, 168, 32, 8, 128, 1), (4, 168, 32, 8, 128, 129),
    (2, 4096, 32, 32, 80, 3001), (1, 300, 16, 1, 256, 300)])
def test_decode_kernel_matches_plain(cuda, B, S, H, KVH, D, valid, dtype):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=cuda, dtype=getattr(torch, dtype))
        for shape in ((B, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    want = ref.decode_attention_ref(q, k, v, valid).float().cpu().numpy()
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, valid)
    hm = ops.decode_attention_head_major(
        q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
        valid)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 2
    for out in (got, hm):
        assert out.dtype == q.dtype
        np.testing.assert_allclose(out.float().cpu().numpy(), want,
                                   **TOL[dtype])


def test_decode_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 4, 64, device=cuda)
    k = torch.zeros(1, 32, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention(q, k.transpose(1, 2).contiguous().transpose(
            1, 2), k, 8)
    with pytest.raises(ValueError, match="float32"):
        ops.decode_attention(q, k.half(), k.half(), 8)
    with pytest.raises(ValueError, match="D <= 256"):
        big = torch.zeros(1, 32, 2, 320, device=cuda)
        ops.decode_attention(torch.zeros(1, 4, 320, device=cuda), big, big, 8)


def test_decode_step_on_card_matches_cpu(cuda):
    """12 decode steps of the float32 smoke config through the CUDA
    kernel and through the plain path (TF32 off: full float32 matmuls)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("llama3-8b")
    cpu = torch.device("cpu")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     cpu)
    on_card = {k: ([{n: w.to(cuda) for n, w in layer.items()} for layer in v]
                   if k == "layers" else v.to(cuda))
               for k, v in params.items()}
    caches = (transformer.init_cache(cfg, 3, 16, cpu),
              transformer.init_cache(cfg, 3, 16, cuda))
    rng = np.random.default_rng(5)
    for pos in range(12):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3))
        want = transformer.decode_step(params, cfg, caches[0], toks, pos)
        got = transformer.decode_step(on_card, cfg, caches[1], toks.to(cuda),
                                      pos)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_tiered_kv_on_card_matches_cpu(cuda):
    """The same hotspot replay on both devices, with the same threshold
    draws: identical counters, one RALT launch per read on the card."""
    def sampler(now, n, n_units):
        return np.random.default_rng(now).integers(0, n_units, n)

    cfg = KVTierConfig(n_pages=256, fast_slots=32, page_tokens=16,
                       kv_heads=4, head_dim=32, staging_slots=16,
                       sweep_every=64)
    kvs = [TieredKVCache(cfg, hbm_bw=1e12, pcie_bw=1e10, device=d,
                         sampler=sampler) for d in ("cpu", cuda)]
    shape = (1, 16, 4, 32)
    for p in range(256):
        page = torch.full(shape, float(p % 7))
        for kv in kvs:
            kv.write_page(p, page, -page)
    rng = np.random.default_rng(0)
    stream = [int(rng.integers(0, 12)) if rng.random() < 0.95
              else int(rng.integers(0, 256)) for _ in range(1500)]
    before = ops.LAUNCHES["ralt_update"]
    for p in stream:
        got = [kv.read_pages([p])[0].cpu() for kv in kvs]
        assert torch.equal(got[0], got[1])
        assert float(got[1][0].flatten()[0]) == p % 7
    assert ops.LAUNCHES["ralt_update"] == before + len(stream)
    for name in ("fast_hits", "slow_hits", "promoted", "demoted",
                 "retained", "aborted", "sweeps", "flushes"):
        assert getattr(kvs[1].clock, name) == getattr(kvs[0].clock, name)
    assert kvs[1].clock.promoted > 0


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------
def flash_inputs(cuda, B, Sq, Skv, H, KVH, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=cuda, dtype=getattr(torch, dtype))
        for shape in ((B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,window,kv_len", [
    (1, 128, 128, 4, 4, 64, None, None), (2, 256, 256, 8, 2, 64, None, None),
    (1, 256, 256, 8, 1, 128, None, None), (2, 256, 256, 4, 4, 128, 96, None),
    (1, 512, 512, 2, 2, 256, None, None), (1, 128, 128, 4, 2, 80, None, None),
    (1, 200, 200, 32, 32, 80, None, None),        # stablelm, ragged S
    (1, 333, 333, 32, 8, 128, None, None),        # llama3, ragged S
    (2, 130, 190, 8, 1, 16, None, 150),           # Sq != Skv, kv_len < Skv
    (1, 100, 100, 16, 2, 32, 7, None),            # G = 8, narrow window
    (1, 70, 45, 4, 4, 256, 8, None),              # rows that see no key
])
def test_flash_kernel_matches_plain(cuda, B, Sq, Skv, H, KVH, D, window,
                                    kv_len, dtype):
    q, k, v = flash_inputs(cuda, B, Sq, Skv, H, KVH, D, dtype)
    want, want_lse = ops.flash_attention_fwd(
        q.cpu(), k.cpu(), v.cpu(), window=window, kv_len=kv_len)
    before = ops.LAUNCHES["flash_attention"]
    out, lse = ops.flash_attention_fwd(q, k, v, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().numpy(), **TOL[dtype])
    # the kernel keeps p in float32 where the plain version rounds it to
    # the input type before P.V; lse sees only the float32 scores
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_offset", [0, 37])
def test_flash_kernel_q_offset(cuda, q_offset):
    """A query block that continues a prefill: q row 0 sits at absolute
    position `q_offset`."""
    q, k, v = flash_inputs(cuda, 1, 64, 101, 8, 2, 64, "float32", seed=1)
    want, want_lse = ops.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu(),
                                             q_offset=q_offset)
    out, lse = ops.flash_attention_fwd(q, k, v, q_offset=q_offset)
    np.testing.assert_allclose(out.cpu().numpy(), want.numpy(),
                               **TOL["float32"])
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = flash_inputs(cuda, 1, 32, 32, 4, 2, 64, "float32")
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v)
    with pytest.raises(ValueError, match="float32"):
        ops.flash_attention(q, k.half(), v.half())
    with pytest.raises(ValueError, match="not supported"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        qq, kk, vv = flash_inputs(cuda, 1, 32, 32, 4, 2, 48, "float32")
        ops.flash_attention(qq, kk, vv)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, v, kv_len=33)
    with pytest.raises(ValueError, match="head grouping"):
        ops.flash_attention(q[:, :, :3].contiguous(), k, v)


def test_flash_autograd_on_card_matches_cpu(cuda):
    """One forward and backward of `common.flash_attention` (kernel
    forward, tiled backward) on the card against the CPU path."""
    from repro_torch.models import common
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (x.cpu() for x in flash_inputs(cuda, 2, 150, 150, 8, 2, 80,
                                               "float32", seed=2))
    ct = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    grads = []
    for dev in ("cpu", cuda):
        xs = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        o = common.flash_attention(*xs, window=64, q_chunk=64, kv_chunk=64)
        (o * ct.to(dev)).sum().backward()
        grads.append([o.detach().cpu()] + [x.grad.cpu() for x in xs])
    for got, want in zip(grads[1], grads[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_train_step_on_card_matches_cpu(cuda):
    """Loss and every gradient of the float32 llama3 smoke model through
    the CUDA flash kernel against the CPU path; then one AdamW step on
    each device from the same gradients (the first step is sign-like, so
    a gradient that rounds to another sign would flip a parameter)."""
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import named_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("llama3-8b")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     torch.device("cpu"))
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 65)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def on(dev, tree):          # a copy per device: AdamW works in place
        return tree_map(lambda x: x.detach().to(dev, copy=True), tree)

    runs = []
    for dev in ("cpu", cuda):
        before = ops.LAUNCHES["flash_attention"]
        loss, grads = steps.value_and_grad(
            on(dev, params), cfg, {k: x.to(dev) for k, x in batch.items()},
            2)
        runs.append((loss, grads, ops.LAUNCHES["flash_attention"] - before))
    # CUDA: 2 layers x (forward + remat recompute) x 2 microbatches
    assert (runs[0][2], runs[1][2]) == (0, 8)
    np.testing.assert_allclose(float(runs[1][0]), float(runs[0][0]),
                               rtol=1e-5)
    updated = []
    for dev in ("cpu", cuda):
        p = on(dev, params)
        adamw_update(p, on(dev, runs[0][1]), adamw_init(p, AdamWConfig()),
                     AdamWConfig(), 1.0)
        updated.append(p)
    for a_tree, b_tree in ((runs[0][1], runs[1][1]), tuple(updated)):
        for (name, a), (_, b) in zip(named_leaves(a_tree),
                                     named_leaves(b_tree)):
            np.testing.assert_allclose(b.detach().cpu().numpy(),
                                       a.detach().numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


# ----------------------------------------------------------------------
# ssd scan
# ----------------------------------------------------------------------
def ssd_inputs(cuda, B, nC, Q, nh, hp, ns, dtype, seed=0):
    """x, B, C in `dtype`, dt and A in float32, as tests/test_kernels.py
    draws them (A = -exp(N(0, 0.2)), dt = softplus(N(0, 1)))."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    x, Bm, Cm = (normal(*s) * 0.5 for s in ((B, nC, Q, nh, hp),
                                            (B, nC, Q, ns), (B, nC, Q, ns)))
    dt = torch.nn.functional.softplus(normal(B, nC, Q, nh))
    A = -torch.exp(normal(nh) * 0.2)
    dt_ = getattr(torch, dtype)
    return ([t.to(device=cuda, dtype=dt_) for t in (x, Bm, Cm)]
            + [dt.to(cuda), A.to(cuda)])


SSD_TOL = {"float32": dict(rtol=5e-4, atol=5e-4),   # tests/test_kernels.py
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nC,Q,nh,hp,ns", [
    (1, 4, 32, 2, 64, 16), (2, 2, 64, 4, 64, 128), (1, 8, 16, 1, 128, 64),
    (1, 3, 100, 2, 32, 48),                 # 3 chunks, ragged 64-row tile
    (2, 5, 256, 4, 64, 128),                # 5 chunks at the full chunk
    (1, 16, 256, 64, 64, 128),              # mamba2-1.3b's prefill shape
])
def test_ssd_kernel_matches_plain(cuda, B, nC, Q, nh, hp, ns, dtype):
    """Both forms of the op against the plain chunk scan on the same
    inputs; h_final within 5e-3 as in tests/test_kernels.py."""
    x, Bm, Cm, dt, A = ssd_inputs(cuda, B, nC, Q, nh, hp, ns, dtype)
    want_y, want_h = ssd.ssd_scan_plain(x, Bm, Cm, dt, A)
    before = ops.LAUNCHES["ssd_scan"]
    y32, h32 = ops.ssd_scan_fwd(x, Bm, Cm, dt, A)
    y, h = ops.ssd_scan(x, Bm, Cm, dt, A)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == before + 2
    assert y32.dtype == h.dtype == h32.dtype == torch.float32
    assert y.dtype == x.dtype and y.shape == x.shape
    assert h.shape == (B, nh, ns, hp)
    for got in (y32, y):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want_y.cpu().numpy(), **SSD_TOL[dtype])
    for got in (h32, h):
        np.testing.assert_allclose(got.cpu().numpy(), want_h.cpu().numpy(),
                                   rtol=5e-3, atol=5e-3)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, Bm, Cm, dt, A = ssd_inputs(cuda, 1, 2, 32, 2, 64, 16, "float32")
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.transpose(3, 4).contiguous().transpose(3, 4), Bm, Cm,
                     dt, A)
    with pytest.raises(ValueError, match="B is torch.bfloat16"):
        ops.ssd_scan(x, Bm.bfloat16(), Cm, dt, A)
    with pytest.raises(ValueError, match="dt is torch.bfloat16"):
        ops.ssd_scan(x, Bm, Cm, dt.bfloat16(), A)
    with pytest.raises(ValueError, match="not supported"):
        ops.ssd_scan(x.half(), Bm.half(), Cm.half(), dt, A)
    with pytest.raises(ValueError, match="A is torch.float32 on cpu"):
        ops.ssd_scan(x, Bm, Cm, dt, A.cpu())
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.ssd_scan(x[..., :48].contiguous(), Bm, Cm, dt, A)
    with pytest.raises(ValueError, match="disagree"):
        ops.ssd_scan(x, Bm, Cm, dt[..., :1].contiguous(), A)


def test_mamba2_mixer_on_card_matches_cpu(cuda):
    """The mamba2 smoke mixer (float32, 2 chunks) forward and backward on
    the card (scan kernel forward, plain-scan backward) against the CPU
    path: output, both states and every gradient."""
    from repro_torch.models import mamba2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("mamba2-1.3b")
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                torch.device("cpu"))["layers"][0]
    rng = np.random.default_rng(1)
    xin = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model),
                                               np.float32))
    ct = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model),
                                              np.float32))
    runs = []
    for dev in ("cpu", cuda):
        before = ops.LAUNCHES["ssd_scan"]
        pp = {k: w.detach().to(dev).requires_grad_() for k, w in p.items()}
        x = xin.detach().to(dev).requires_grad_()
        out, (ssm, conv) = mamba2.mamba2_mixer(pp, x, cfg)
        ((out * ct.to(dev)).sum() + ssm.sum()).backward()
        runs.append(([out, ssm, conv, x.grad] + [pp[k].grad for k in
                                                 sorted(pp)],
                     ops.LAUNCHES["ssd_scan"] - before))
    assert (runs[0][1], runs[1][1]) == (0, 1)
    for got, want in zip(runs[1][0], runs[0][0]):
        np.testing.assert_allclose(got.detach().cpu().numpy(),
                                   want.detach().numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_mamba2_prefill_and_decode_on_card_match_cpu(cuda):
    """The mamba2 smoke model: a 64-token prefill, then 12 decode steps
    from its cache, on both devices."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("mamba2-1.3b")
    cpu = torch.device("cpu")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     cpu)
    on_card = {k: ([{n: w.to(cuda) for n, w in layer.items()} for layer in v]
                   if k == "layers" else v.to(cuda))
               for k, v in params.items()}
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 64)))
    with torch.no_grad():
        want, cache = transformer.forward(params, cfg, prompt,
                                          return_cache=True)
        got, ccache = transformer.forward(on_card, cfg, prompt.to(cuda),
                                          return_cache=True)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
        for pos in range(64, 76):
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3))
            want = transformer.decode_step(params, cfg, cache, toks, pos)
            got = transformer.decode_step(on_card, cfg, ccache,
                                          toks.to(cuda), pos)
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-4)
