"""The PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version (which `tests/test_torch_kernels.py`,
`tests/test_torch_training.py` and `tests/test_torch_ssd.py` hold to the
JAX reference), and the decode step, tiered KV cache, training step,
mamba2 mixer, prefill and decode, the MoE MLP and model, windowed (ring
buffer) and int8-cache decode (the append included), zamba2's decode
step (the shared block at each occurrence, each with its own cache) and
the tiered embedding and expert cache on CUDA against the same code on
the CPU.
Imports neither jax nor `repro`, so it runs on a GPU machine without
them:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test is marked `gpu` and skips where there is no CUDA device."""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ralt_score
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import moe, transformer
from repro_torch.tiering import ExpertCache, KVTierConfig, TieredEmbedding
from repro_torch.tiering import TieredKVCache
from repro_torch.tree import tree_map
from repro_torch.tiering import hotness

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


STATE_FIELDS = ("tick", "score", "c", "t", "seen", "now", "accessed_bytes",
                "accessed_bytes_r", "hot_limit", "threshold")


def assert_states_equal(got, want):
    """Every field of two tracker states, bit for bit."""
    for name in STATE_FIELDS:
        a, b = got[name].cpu(), want[name].cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), name


def random_state(cfg, cuda, seed):
    """A tracker state with every field drawn (counters, tags and clock
    remainders near their edges), on the card."""
    rng = np.random.default_rng(seed)
    n = cfg.n_units
    st = hotness.init_state(cfg, cuda)
    every = np.float32(cfg.gamma * cfg.fast_bytes)
    R = np.float32(cfg.hot_hi_frac * cfg.fast_bytes)
    vals = dict(
        tick=rng.integers(0, 60, n).astype(np.int32),
        score=(rng.random(n) * 5).astype(np.float32),
        c=np.where(rng.random(n) < 0.3, 0,
                   rng.random(n) * cfg.c_max).astype(np.float32),
        t=rng.random(n) < 0.3, seen=rng.random(n) < 0.6,
        now=np.int32(60), accessed_bytes=np.float32(every * 0.97),
        accessed_bytes_r=np.float32(R * 0.99))
    return {**st, **{k: torch.from_numpy(np.asarray(v)).to(cuda)
                     for k, v in vals.items()}}


def clone_state(st):
    return {k: v.clone() for k, v in st.items()}


def record_both(kst, pst, ids, cfg):
    """One record through the fused kernel (host ids) and through the
    plain `record_accesses` on the card (a dense mask of the same ids)."""
    n = cfg.n_units
    mask = torch.zeros(n, dtype=torch.bool, device=pst["tick"].device)
    if len(ids):
        mask[torch.as_tensor(np.asarray(ids) % n,
                             device=mask.device)] = True
    before = ops.LAUNCHES["ralt_record"]
    kst = ops.ralt_record_(kst, ids, cfg)
    assert ops.LAUNCHES["ralt_record"] == before + 1
    return kst, hotness.record_accesses(pst, mask, cfg)


TIERED_TRACKER = dict(n_units=65_536, unit_bytes=65_536,
                      fast_bytes=8_192 * 65_536)


def test_ralt_record_hotspot_stream_matches_plain(cuda):
    """2,000 single-page reads of a hotspot stream at the tiered KV
    cache's 65,536 pages, then records of many ids (by value and through
    device memory): the fused kernel against `record_accesses` on the
    card, every field bit for bit after every record."""
    cfg = hotness.TrackerConfig(**TIERED_TRACKER)
    kst = hotness.init_state(cfg, cuda)
    pst = hotness.init_state(cfg, cuda)
    rng = np.random.default_rng(0)
    for i in range(2000):
        p = int(rng.integers(0, 3276)) if rng.random() < 0.95 \
            else int(rng.integers(0, 65_536))
        kst, pst = record_both(kst, pst, [p], cfg)
        assert_states_equal(kst, pst)
    assert int(kst["now"]) > 0
    k = ralt_score.param_ids()
    for n_ids in (k, k + 1, 5000, 0):
        ids = rng.integers(0, 65_536, n_ids)
        kst, pst = record_both(kst, pst, ids, cfg)
        assert_states_equal(kst, pst)


@pytest.mark.parametrize("case", ["duplicates", "slices", "r_bytes",
                                  "tail", "unaligned", "device_ids"])
def test_ralt_record_edge_records_match_plain(cuda, case):
    """Repeated ids; records that advance many slices (large unit_bytes,
    small gamma); records that cross R (dec >= 1); N not a multiple of 4
    (the scalar tail); arrays off 16-byte alignment (the scalar path);
    ids as a CUDA tensor: every field bit for bit."""
    kw = dict(n_units=4096, unit_bytes=4096, fast_bytes=64 * 4096)
    if case == "slices":
        kw.update(unit_bytes=1 << 20, gamma=0.0037)
    if case == "r_bytes":
        kw.update(hot_hi_frac=0.03, delta_c=7.5, c_max=40.0)
    if case == "tail":
        kw.update(n_units=4099)
    cfg = hotness.TrackerConfig(**kw)
    n = cfg.n_units
    pst = random_state(cfg, cuda, seed=len(case))
    if case == "unaligned":
        pst = {k: (torch.cat([v[:1], v])[1:] if v.dim() else v)
               for k, v in pst.items()}
        assert pst["tick"].data_ptr() % 16 != 0
    kst = clone_state(pst) if case != "unaligned" else {
        k: (torch.cat([v[:1], v])[1:] if v.dim() else v.clone())
        for k, v in pst.items()}
    rng = np.random.default_rng(7)
    for i in range(40):
        ids = rng.integers(0, n, 1 + i % 13)
        if case == "duplicates":
            ids = np.concatenate([ids, ids[: 1 + i % 3], [n - 1, n - 1]])
        if case == "device_ids":
            mask = torch.zeros(n, dtype=torch.bool, device=cuda)
            mask[torch.from_numpy(ids).to(cuda)] = True
            kst = ops.ralt_record_(kst, mask.nonzero(), cfg)
            pst = hotness.record_accesses(pst, mask, cfg)
        else:
            kst, pst = record_both(kst, pst, ids, cfg)
        assert_states_equal(kst, pst)
    if case == "slices":
        assert int(kst["now"]) > 60 + 40 * 100
    if case == "r_bytes":
        assert float(kst["c"].max()) < 40.0


def test_tracker_on_card_matches_cpu_twin(cuda):
    """`HotTracker` on the card (the fused kernel; `record` and
    `record_ids`) and on the CPU (the plain path), one numpy sampler:
    every field bit for bit at every refresh."""
    def sampler(now, n, n_units):
        return np.random.default_rng(now).integers(0, n_units, n)

    cfg = hotness.TrackerConfig(n_units=4096, unit_bytes=4096,
                                fast_bytes=512 * 4096)
    cpu = hotness.HotTracker(cfg, device="cpu", sampler=sampler)
    card = hotness.HotTracker(cfg, device=cuda, sampler=sampler)
    rng = np.random.default_rng(3)
    before = ops.LAUNCHES["ralt_record"]
    for i in range(600):
        ids = rng.integers(0, 200 if rng.random() < 0.9 else 4096,
                           1 + i % 5)
        if i % 3 == 0:
            mask = torch.zeros(4096, dtype=torch.bool)
            mask[torch.from_numpy(ids)] = True
            cpu.record(mask)
            card.record(mask.to(cuda))
        else:
            cpu.record_ids(ids)
            card.record_ids(ids)
        if i % 64 == 63:
            cpu.refresh_limits()
            card.refresh_limits()
            assert_states_equal(card.state, cpu.state)
            assert torch.equal(card.hot().cpu(), cpu.hot())
    assert ops.LAUNCHES["ralt_record"] == before + 600


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KVH,D,valid", [
    (2, 256, 8, 2, 64, 256), (2, 256, 8, 2, 64, 130), (1, 512, 4, 1, 128, 17),
    (4, 128, 4, 4, 128, 128), (1, 1024, 8, 4, 256, 700),
    (4, 168, 32, 8, 128, 1), (4, 168, 32, 8, 128, 129),
    (2, 4096, 32, 32, 80, 3001), (1, 300, 16, 1, 256, 300),
    (4, 168, 64, 4, 128, 129),                   # qwen3-moe: G = 16
    (4, 168, 32, 32, 112, 129),                  # zamba2: G 1, D 112
    (1, 9000, 32, 32, 112, 8193)])               # zamba2, many splits
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KVH,D,valid,one_split", [
    (4, 64, 32, 8, 128, 8, True),         # one split: the block writes out
    (1, 8192, 8, 1, 128, 8000, False),    # the fused merge of many splits
    (1, 500, 32, 32, 80, 457, False),     # D = 80: 10 of 16 lanes
    (2, 1000, 14, 2, 64, 999, False),     # internvl2's G = 7
    (4, 100, 32, 8, 128, 1, True),        # valid_len 1
    (2, 2100, 4, 2, 20, 2000, False),     # D = 20: element loads
])
def test_decode_kernel_paths(cuda, B, S, H, KVH, D, valid, one_split,
                             dtype):
    """The kernel's paths against the plain version, through both
    layouts, each in one launch."""
    from repro_torch.kernels import decode_attention as tdecode
    dt = getattr(torch, dtype)
    G = H // KVH
    slots = tdecode._slots(cuda.index or 0, dt, dt, tdecode.head_slice(G))
    _, n_splits = tdecode.plan_splits(B, KVH, valid,
                                      tdecode.tile(G, D, dt), slots)
    assert (n_splits == 1) == one_split
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=cuda, dtype=dt)
        for shape in ((B, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    want = ref.decode_attention_ref(q, k, v, valid).float().cpu().numpy()
    before = ops.LAUNCHES["decode_attention"]
    for _ in range(2):    # the second call finds the counters reset
        outs = (ops.decode_attention(q, k, v, valid),
                ops.decode_attention_head_major(
                    q, k.transpose(1, 2).contiguous(),
                    v.transpose(1, 2).contiguous(), valid))
        torch.cuda.synchronize()
        for out in outs:
            np.testing.assert_allclose(out.float().cpu().numpy(), want,
                                       **TOL[dtype])
    assert ops.LAUNCHES["decode_attention"] == before + 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_on_two_streams_at_once(cuda, dtype):
    """Launches on two streams may overlap on the card: each stream's
    fused merge keeps its own arrival counters, so no block takes the
    other launch's arrivals and partials for its own."""
    from repro_torch.kernels import decode_attention as tdecode
    dt = getattr(torch, dtype)
    B, S, H, KVH, D, valid = 2, 16384, 8, 1, 128, 16000
    rng = np.random.default_rng(2)
    qs = [torch.from_numpy(rng.standard_normal((B, H, D), np.float32)).to(
        device=cuda, dtype=dt) for _ in range(2)]
    k, v = (torch.from_numpy(rng.standard_normal((B, KVH, S, D),
                                                 np.float32)).to(
        device=cuda, dtype=dt) for _ in range(2))
    wants = [ref.decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                      valid).float().cpu().numpy()
             for q in qs]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(ops.decode_attention_head_major(qs[i], k, v,
                                                               valid))
    torch.cuda.synchronize()
    assert all((qs[0].device, st.cuda_stream) in tdecode._COUNTERS
               for st in streams)
    for want, got in zip(wants, outs):
        for out in got:
            np.testing.assert_allclose(out.float().cpu().numpy(), want,
                                       **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KVH,D,valid", [
    (4, 168, 32, 8, 128, 129),                   # llama3's serve shape
    (4, 64, 32, 8, 128, 8),                      # one split
    (8, 32768, 32, 8, 128, 30001),               # the long cache
    (4, 168, 64, 4, 128, 129),                   # qwen3: G 16
    (2, 2100, 4, 2, 20, 2000)])                  # element loads
def test_decode_kernel_lse_matches_partials(cuda, B, S, H, KVH, D, valid,
                                            dtype):
    """The row lse a sequence shard's merge takes: the kernel's against
    `decode_attention_partial`'s m + log l within 1e-5, its output the
    same as without the lse, in one launch."""
    from repro_torch.models.common import decode_attention_partial
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=cuda, dtype=dt)
        for shape in ((B, H, D), (B, KVH, S, D), (B, KVH, S, D)))
    before = ops.LAUNCHES["decode_attention"]
    out, lse = ops.decode_attention_head_major(q, k, v, valid,
                                               return_lse=True)
    plain = ops.decode_attention_head_major(q, k, v, valid)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 2
    assert torch.equal(out, plain)
    _, l, m = decode_attention_partial(q, k.transpose(1, 2),
                                       v.transpose(1, 2), valid)
    want = (m + torch.log(l)).reshape(B, H)
    assert float((lse - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("valid,slot", [(129, 128), (30001, None),
                                        (129, None)])
def test_decode_int8_kernel_lse_matches_plain(cuda, valid, slot):
    """The int8 kernel's row lse (with and without the append) against
    the plain version's within 1e-5."""
    B, S = (8, 32768) if valid > 168 else (4, 168)
    H, KVH, D = 32, 8, 128
    k, ks, v, vs = int8_cache(cuda, B, S, KVH, D, torch.bfloat16, 4)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32)).to(
        device=cuda, dtype=torch.bfloat16)
    if slot is None:
        out, lse = ops.decode_attention_head_major(q, k, v, valid, ks, vs,
                                                   return_lse=True)
    else:
        new = torch.from_numpy(rng.standard_normal((2, B, KVH, D),
                                                   np.float32)).to(
            device=cuda, dtype=torch.bfloat16)
        out, lse = ops.decode_attention_int8_append(
            q, new[0], new[1], k, v, ks, vs, slot, valid, return_lse=True)
    want, want_lse = ref.decode_attention_ref(
        q, k.transpose(1, 2), v.transpose(1, 2), valid, ks, vs,
        return_lse=True)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL["bfloat16"])
    assert float((lse - want_lse).abs().max()) <= 1e-5


@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernels_take_an_empty_shard(cuda, int8):
    """Local valid length 0: output 0 and lse -inf in one launch; the int8
    kernel with no slot writes nothing."""
    B, S, H, KVH, D = 4, 84, 32, 8, 128
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32)).to(
        device=cuda, dtype=torch.bfloat16)
    if int8:
        k, ks, v, vs = int8_cache(cuda, B, S, KVH, D, torch.bfloat16, 7)
        before = [t.clone() for t in (k, v, ks, vs)]
        new = q[:, :KVH].contiguous()
        name = "decode_attention_int8"
        n = ops.LAUNCHES[name]
        out, lse = ops.decode_attention_int8_append(
            q, new, new, k, v, ks, vs, None, 0, return_lse=True)
    else:
        k, v = (q.new_ones(B, KVH, S, D) for _ in range(2))
        name = "decode_attention"
        n = ops.LAUNCHES[name]
        out, lse = ops.decode_attention_head_major(q, k, v, 0,
                                                   return_lse=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == n + 1
    assert torch.equal(out, torch.zeros_like(out))
    assert bool(torch.isneginf(lse).all())
    if int8:
        assert all(torch.equal(a, b) for a, b in zip(before, (k, v, ks, vs)))


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


def int8_cache(cuda, B, S, KVH, D, dtype, seed):
    """A (B, KVH, S, D) int8 cache and its (B, KVH, S) float32 scales, as
    the model's decode step quantizes them (`attention.quantize_kv`)."""
    from repro_torch.models.attention import quantize_kv
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((B, S, KVH, D), np.float32))
        x = x * torch.from_numpy(rng.uniform(0.1, 3.0, (B, S, KVH, 1)).astype(
            np.float32))
        payload, scale = quantize_kv(x.to(device=cuda, dtype=dtype))
        out += [payload.transpose(1, 2).contiguous(),
                scale.transpose(1, 2).contiguous()]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KVH,D,valid", [
    (2, 300, 4, 4, 64, 257),            # G = 1 (musicgen), 16 dims a lane
    (4, 1024, 8, 4, 256, 1000),         # G = 2, D = 256 (gemma3)
    (4, 168, 32, 8, 128, 129),          # G = 4 (llama3's serving shape)
    (2, 700, 48, 8, 128, 613),          # G = 6: 8 dims a lane (mixtral)
    (2, 400, 64, 4, 128, 129),          # G = 16: two slices of 8 (qwen3)
    (1, 8192, 8, 1, 128, 8000),         # many splits, the fused merge
    (2, 500, 32, 32, 80, 457),          # D = 80: 5 of 8 lanes
    (2, 500, 32, 32, 112, 457),         # D = 112 (zamba2), G 1
    (1, 100, 2, 2, 20, 77),             # D = 20: element loads
    (3, 64, 8, 2, 16, 1)])              # valid_len 1, one lane a row
def test_decode_int8_kernel_matches_plain(cuda, B, S, H, KVH, D, valid,
                                          dtype):
    """The int8-cache kernels against the plain version at ragged
    valid_len, two calls each (the second finds the merge's counters
    reset): bf16 q takes `decode_attention_int8.cu`, float32 q the float
    kernel's int8 instantiation (`decode_attention_int8_f32`)."""
    dt = getattr(torch, dtype)
    k, ks, v, vs = int8_cache(cuda, B, S, KVH, D, dt, seed=S + H)
    rng = np.random.default_rng(H)
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32)).to(
        device=cuda, dtype=dt)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    want = ref.decode_attention_ref(q, kt, vt, valid, ks,
                                    vs).float().cpu().numpy()
    before = dict(ops.LAUNCHES)
    for _ in range(2):
        out = ops.decode_attention_head_major(q, k, v, valid, k_scale=ks,
                                              v_scale=vs)
        torch.cuda.synchronize()
        assert out.dtype == dt
        np.testing.assert_allclose(out.float().cpu().numpy(), want,
                                   **TOL[dtype])
    name = {"bfloat16": "decode_attention_int8",
            "float32": "decode_attention_int8_f32"}[dtype]
    for op in ("decode_attention", "decode_attention_int8",
               "decode_attention_int8_f32"):
        assert ops.LAUNCHES[op] == before[op] + (2 if op == name else 0), op


def tie_rows(rng, B, KVH, D):
    """(B, KVH, D) float32 rows, every second (batch, kv head) row on exact
    half-steps of its scale (amax 127/16, elements (2n + 1) / 32, so x /
    scale = n + 0.5: ties that round to even), the rest random at random
    scales, one row zero (the 1e-8 floor)."""
    x = rng.standard_normal((B, KVH, D)).astype(np.float32)
    x *= rng.uniform(1e-3, 30.0, (B, KVH, 1)).astype(np.float32)
    halves = (2 * rng.integers(-127, 127, (B, KVH, D)) + 1) / 32
    halves[..., 0] = 127 / 16
    tie = (np.arange(B * KVH) % 2 == 0).reshape(B, KVH)
    x[tie] = halves[tie]
    x[-1, -1] = 0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("B,S,H,KVH,D,valid,slot", [
    (4, 168, 32, 8, 128, 129, 128),     # llama3's serving shape
    (2, 400, 64, 4, 128, 129, 128),     # qwen3's G 16
    (4, 1024, 8, 4, 256, 1024, 37),     # gemma3's ring, wrapped (pos 1061)
    (1, 8192, 8, 1, 128, 8000, "edge"),  # the first row of a split
    (1, 8192, 8, 1, 128, 8000, "end"),  # the last row of a split
    (1, 8192, 8, 1, 128, 8000, 4321),   # mid-split
    (2, 100, 2, 2, 20, 77, 50),         # D 20: 4-byte copies
    (4, 168, 32, 32, 112, 129, 128),    # D 112 (zamba2), G 1
    (3, 64, 8, 2, 16, 1, 0)])           # valid_len 1
def test_decode_int8_append_matches_plain(cuda, B, S, H, KVH, D, valid,
                                          slot):
    """One launch quantizes the new k and v, writes payload and scales at
    `slot` and attends: the caches bit for bit and the output at the bf16
    tolerance against `quantize_kv`, the writes and the plain version on
    the card."""
    from repro_torch.kernels import decode_attention as tdecode
    from repro_torch.models.attention import quantize_kv
    bf16 = torch.bfloat16
    G = H // KVH
    split_len, n_splits = tdecode.plan_splits(
        B, KVH, valid, tdecode.INT8_TILE,
        tdecode._int8_slots(cuda.index or 0, D, tdecode.int8_smem_bytes(
            D, G, tdecode.int8_stages(D, G))))
    if slot in ("edge", "end"):
        assert n_splits > 1
        slot = split_len - (slot == "end")
    k, ks, v, vs = int8_cache(cuda, B, S, KVH, D, bf16, seed=S + slot)
    rng = np.random.default_rng(slot)
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32)).to(
        device=cuda, dtype=bf16)
    k_new, v_new = (tie_rows(rng, B, KVH, D).to(device=cuda, dtype=bf16)
                    for _ in range(2))
    want = [t.clone() for t in (k, v, ks, vs)]
    (k8, s8), (v8, sv) = quantize_kv(k_new), quantize_kv(v_new)
    for t, row in zip(want, (k8, v8, s8, sv)):
        t[:, :, slot] = row
    want_out = ref.decode_attention_ref(
        q, want[0].transpose(1, 2), want[1].transpose(1, 2), valid, want[2],
        want[3]).float().cpu().numpy()
    before = dict(ops.LAUNCHES)
    for _ in range(2):     # the second call rewrites the same row
        got = [t.clone() for t in (k, v, ks, vs)]
        out = ops.decode_attention_int8_append(q, k_new, v_new, *got, slot,
                                               valid)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.uint8) if g.dtype == torch.int8
                               else g.view(torch.int32),
                               w.view(torch.uint8) if w.dtype == torch.int8
                               else w.view(torch.int32))
        np.testing.assert_allclose(out.float().cpu().numpy(), want_out,
                                   **TOL["bfloat16"])
    assert ops.LAUNCHES["decode_attention_int8"] == \
        before["decode_attention_int8"] + 2


def test_fused_quantizer_is_quantize_kv_on_card(cuda):
    """The append's quantizer against `quantize_kv` on the card, on
    identical bf16 rows that are half of them exact ties: payload and
    scales bit for bit, ties rounded to even."""
    from repro_torch.models.attention import quantize_kv
    bf16 = torch.bfloat16
    B, KVH, D, S = 32, 8, 128, 64
    rng = np.random.default_rng(7)
    k, ks, v, vs = int8_cache(cuda, B, S, KVH, D, bf16, seed=3)
    q = torch.zeros(B, 4 * KVH, D, device=cuda, dtype=bf16)
    k_new, v_new = (tie_rows(rng, B, KVH, D).to(device=cuda, dtype=bf16)
                    for _ in range(2))
    ops.decode_attention_int8_append(q, k_new, v_new, k, v, ks, vs, 9, 10)
    for new, cache, scale in ((k_new, k, ks), (v_new, v, vs)):
        want_q, want_s = quantize_kv(new)
        assert torch.equal(cache[:, :, 9], want_q)
        assert torch.equal(scale[:, :, 9].view(torch.int32),
                           want_s.view(torch.int32))
        tie = torch.zeros(B, KVH, dtype=torch.bool)
        tie.view(-1)[::2] = True
        odd = want_q[tie.to(cuda)][:, 1:].to(torch.int64) % 2
        assert not odd.any()


def test_decode_int8_kernel_rejects_what_it_does_not_take(cuda):
    k, ks, v, vs = int8_cache(cuda, 1, 32, 2, 64, torch.float32, seed=0)
    q = torch.zeros(1, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        ops.decode_attention_head_major(q, k, v, 8, k_scale=ks)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        ops.decode_attention_head_major(q, k.float(), v.float(), 8,
                                        k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="float32 of shape"):
        ops.decode_attention_head_major(q, k, v, 8, k_scale=ks.double(),
                                        v_scale=vs)
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention_head_major(q, k, v, 8, k_scale=ks,
                                        v_scale=vs.transpose(1, 2)
                                        .contiguous().transpose(1, 2))
    # the reference layout's entry point takes no int8 cache
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        ops.decode_attention(q, k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(), 8)


def test_int8_decode_step_on_card_matches_cpu(cuda):
    """12 decode steps of the llama3 smoke model with `kv_quant`: logits
    and the int8 caches on both devices, and one launch of the int8
    variant per layer and step (none of the float kernel)."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(smoke_config("llama3-8b"), kv_quant=True)
    cpu = torch.device("cpu")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     cpu)
    on_card = tree_map(lambda t: t.to(cuda), params)
    caches = (transformer.init_cache(cfg, 3, 16, cpu),
              transformer.init_cache(cfg, 3, 16, cuda))
    rng = np.random.default_rng(5)
    before = dict(ops.LAUNCHES)
    for pos in range(12):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3))
        want = transformer.decode_step(params, cfg, caches[0], toks, pos)
        got = transformer.decode_step(on_card, cfg, caches[1], toks.to(cuda),
                                      pos)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert ops.LAUNCHES["decode_attention_int8_f32"] == \
        before["decode_attention_int8_f32"] + 12 * cfg.n_layers
    for op in ("decode_attention", "decode_attention_int8"):
        assert ops.LAUNCHES[op] == before[op], op
    for c_cpu, c_card in zip(*caches):
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(c_card[name].cpu().numpy(),
                                       c_cpu[name].numpy(), rtol=1e-5)


def test_int8_bf16_decode_step_on_card_matches_cpu(cuda):
    """12 decode steps of the llama3 smoke model in bf16 with `kv_quant`:
    one launch of `decode_attention_int8` per layer and step (the append
    and the attention; no other decode launch), against the CPU twin.
    The first layer's k and v do not depend on attention, so its caches
    match bit for bit.  Later layers' inputs carry the two devices' bf16
    roundings, and a k or v element within them of a half-step quantizes
    to the neighbouring int8 (ROADMAP Queue 3): their payloads are held
    to one step and 95 % equal (96.7 % on an H100), their scales to 1e-2,
    and the logits at the bf16 tolerance with an atol of 5e-2 (about 5 %
    of their RMS of 1)."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(smoke_config("llama3-8b"), kv_quant=True,
                              dtype="bfloat16")
    cpu = torch.device("cpu")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     cpu)
    on_card = tree_map(lambda t: t.to(cuda), params)
    caches = (transformer.init_cache(cfg, 3, 16, cpu),
              transformer.init_cache(cfg, 3, 16, cuda))
    rng = np.random.default_rng(5)
    before = dict(ops.LAUNCHES)
    for pos in range(12):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3))
        want = transformer.decode_step(params, cfg, caches[0], toks, pos)
        got = transformer.decode_step(on_card, cfg, caches[1], toks.to(cuda),
                                      pos)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().numpy(), rtol=2e-2,
                                   atol=5e-2)
    assert ops.LAUNCHES["decode_attention_int8"] == \
        before["decode_attention_int8"] + 12 * cfg.n_layers
    for op in ("decode_attention", "decode_attention_int8_f32"):
        assert ops.LAUNCHES[op] == before[op], op
    for layer, (c_cpu, c_card) in enumerate(zip(*caches)):
        for name in ("k", "v"):
            diff = (c_card[name].cpu().to(torch.int32)
                    - c_cpu[name].to(torch.int32))[:, :, :12]
            assert diff.abs().max() <= (0 if layer == 0 else 1), name
            assert (diff == 0).float().mean() >= 0.95, name
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(c_card[name].cpu().numpy(),
                                       c_cpu[name].numpy(),
                                       rtol=0 if layer == 0 else 1e-2)


def test_ring_decode_on_card_matches_cpu(cuda):
    """The gemma3 smoke model (windows of 16 before every global layer)
    over 40 decode steps into a 64-token cache, past the rings' wrap:
    logits and every layer's cache on both devices."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("gemma3-4b")
    cpu = torch.device("cpu")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     cpu)
    on_card = tree_map(lambda t: t.to(cuda), params)
    caches = (transformer.init_cache(cfg, 3, 64, cpu),
              transformer.init_cache(cfg, 3, 64, cuda))
    assert {c["k"].shape[2] for c in caches[0]} == {16, 64}
    rng = np.random.default_rng(6)
    for pos in range(40):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3))
        want = transformer.decode_step(params, cfg, caches[0], toks, pos)
        got = transformer.decode_step(on_card, cfg, caches[1], toks.to(cuda),
                                      pos)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
    for c_cpu, c_card in zip(*caches):
        for name in ("k", "v"):
            np.testing.assert_allclose(c_card[name].cpu().numpy(),
                                       c_cpu[name].numpy(), rtol=1e-4,
                                       atol=1e-4)


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


def test_zamba2_decode_step_on_card_matches_cpu(cuda):
    """12 decode steps of zamba2's float32 smoke model (the shared block
    at both occurrences, each with its own cache) through the CUDA
    kernels and through the plain path: logits and every cache."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("zamba2-7b")
    cpu = torch.device("cpu")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     cpu)
    on_card = tree_map(lambda t: t.to(cuda), params)
    caches = (transformer.init_cache(cfg, 3, 16, cpu),
              transformer.init_cache(cfg, 3, 16, cuda))
    rng = np.random.default_rng(5)
    before = ops.LAUNCHES["decode_attention"]
    for pos in range(12):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3))
        want = transformer.decode_step(params, cfg, caches[0], toks, pos)
        got = transformer.decode_step(on_card, cfg, caches[1], toks.to(cuda),
                                      pos)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
    shared = sum(b.kind == "shared_attn"
                 for b in transformer.layer_blocks(cfg))
    assert ops.LAUNCHES["decode_attention"] == before + 12 * shared
    for c_cpu, c_card in zip(*caches):
        for name, t in c_cpu.items():
            np.testing.assert_allclose(c_card[name].cpu().numpy(), t.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=name)


def test_tiered_kv_on_card_matches_cpu(cuda):
    """The same hotspot replay on both devices, with the same threshold
    draws: identical counters, one fused tracker launch per read on the
    card and no other RALT launch."""
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
    before = dict(ops.LAUNCHES)
    for p in stream:
        got = [kv.read_pages([p])[0].cpu() for kv in kvs]
        assert torch.equal(got[0], got[1])
        assert float(got[1][0].flatten()[0]) == p % 7
    assert ops.LAUNCHES["ralt_record"] == before["ralt_record"] + len(stream)
    assert ops.LAUNCHES["ralt_update"] == before["ralt_update"]
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
    (1, 333, 333, 64, 4, 128, None, None),        # qwen3-moe: G = 16
    (1, 333, 333, 32, 32, 112, None, None),       # zamba2: D 112, G 1
    (1, 300, 300, 16, 4, 112, 100, None),         # D 112, G 4, window
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
    # both round p to the input type before P.V (the bf16 kernel in
    # registers, as the wgmma A operand); lse sees only the float32 scores
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


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,window,kv_len,q_offset", [
    (1, 300, 300, 8, 8, 80, None, None, 0),     # D = 80, S % 128 != 0
    (2, 190, 250, 8, 8, 80, None, 201, 0),      # D = 80, kv_len mid-tile
    (1, 256, 256, 8, 2, 128, None, 70, 0),      # kv_len in the first tile
    (1, 384, 384, 8, 2, 64, 100, None, 0),      # G = 4, window mid-tile
    (1, 256, 256, 16, 2, 128, None, None, 0),   # G = 8
    (1, 200, 237, 16, 4, 80, None, None, 37),   # q_offset 37, ragged S
    (1, 130, 300, 8, 8, 256, 50, 280, 37),      # D = 256, every mask
    (1, 77, 140, 4, 1, 16, 30, None, 37),       # D = 16: one 16-col chunk
    (1, 150, 150, 4, 2, 32, None, None, 0),     # D = 32: one 32-col chunk
    (1, 300, 300, 8, 8, 112, None, None, 0),    # D = 112: 64 + 32 + 16
    (2, 190, 250, 8, 2, 112, 64, 201, 37),      # D = 112, G 4, every mask
])
def test_flash_kernel_bf16_edges(cuda, B, Sq, Skv, H, KVH, D, window,
                                 kv_len, q_offset):
    """The wgmma kernel where masks, ragged tiles and the D chunks meet:
    every row sees a different number of keys."""
    q, k, v = flash_inputs(cuda, B, Sq, Skv, H, KVH, D, "bfloat16", seed=3)
    kw = dict(window=window, kv_len=kv_len, q_offset=q_offset)
    want, want_lse = ops.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu(), **kw)
    before = ops.LAUNCHES["flash_attention"]
    out, lse = ops.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().numpy(), **TOL["bfloat16"])
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
def ssd_inputs(cuda, B, nC, Q, nh, hp, ns, dtype, seed=0, dt_scale=1.0):
    """x, B, C in `dtype`, dt and A in float32, as tests/test_kernels.py
    draws them (A = -exp(N(0, 0.2)), dt = softplus(N(0, 1)) times
    `dt_scale`)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    x, Bm, Cm = (normal(*s) * 0.5 for s in ((B, nC, Q, nh, hp),
                                            (B, nC, Q, ns), (B, nC, Q, ns)))
    dt = torch.nn.functional.softplus(normal(B, nC, Q, nh)) * dt_scale
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
    (1, 1, 256, 8, 64, 128),                # one chunk: no state passing
    (2, 2, 100, 3, 128, 256),               # ragged Q, hp 128, ns 256
    (2, 3, 64, 4, 32, 16),                  # ns 16: one k step
    (1, 2, 192, 2, 128, 48),                # 3 query tiles, ns 48
])
def test_ssd_kernel_matches_plain(cuda, B, nC, Q, nh, hp, ns, dtype):
    """Both forms of the op against the plain chunk scan on the same
    inputs; h_final within 5e-3 as in tests/test_kernels.py.  bfloat16
    runs the four tensor-core passes, float32 the CUDA-core kernel."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_large_decay_stays_finite(cuda, dtype):
    """dt 40 times its draw: La falls by about 8,000 over a 256-row chunk,
    so exp(La_i - La_j) above the diagonal would overflow; the kernels
    mask before the exp and stay finite.  At La near -8,000 float32 keeps
    La_i - La_j only to about 5e-4, so two float32 scans differ by about
    that much relative after the exp, and more where y cancels: y is held
    at the bf16 5e-2 in both dtypes here, h_final at 5e-3."""
    x, Bm, Cm, dt, A = ssd_inputs(cuda, 1, 3, 256, 8, 64, 128, dtype,
                                  seed=3, dt_scale=40.0)
    want_y, want_h = ssd.ssd_scan_plain(x, Bm, Cm, dt, A)
    y, h = ops.ssd_scan_fwd(x, Bm, Cm, dt, A)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    np.testing.assert_allclose(y.cpu().numpy(), want_y.cpu().numpy(),
                               **SSD_TOL["bfloat16"])
    np.testing.assert_allclose(h.cpu().numpy(), want_h.cpu().numpy(),
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_counts_one_per_op_call(cuda, dtype):
    """LAUNCHES counts op calls: one per call of either form, whether the
    call launches one kernel (float32) or four passes (bfloat16)."""
    args = ssd_inputs(cuda, 1, 2, 64, 2, 64, 16, dtype)
    for fn in (ops.ssd_scan_fwd, ops.ssd_scan):
        before = ops.LAUNCHES["ssd_scan"]
        fn(*args)
        assert ops.LAUNCHES["ssd_scan"] == before + 1
    torch.cuda.synchronize()


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
    # the bfloat16 passes: head_dim 32, 64 or 128, ssm_state a multiple
    # of 16 up to 256, x, B and C on 16 bytes
    xb, Bb, Cb, dtb, Ab = ssd_inputs(cuda, 1, 2, 32, 2, 96, 32, "bfloat16")
    with pytest.raises(ValueError, match="head_dim in"):
        ops.ssd_scan(xb, Bb, Cb, dtb, Ab)
    xb = xb[..., :64].contiguous()
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.ssd_scan(xb, Bb[..., :24].contiguous(), Cb[..., :24].contiguous(),
                     dtb, Ab)
    big = ssd_inputs(cuda, 1, 2, 32, 2, 64, 512, "bfloat16")
    with pytest.raises(ValueError, match="up to 256"):
        ops.ssd_scan(xb, big[1], big[2], dtb, Ab)
    off = torch.empty(xb.numel() + 1, dtype=xb.dtype, device=cuda)[1:]
    off = off.view(xb.shape).copy_(xb)
    assert off.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.ssd_scan(off, Bb, Cb, dtb, Ab)
    ops.ssd_scan(xb, Bb, Cb, dtb, Ab)       # the same inputs, aligned
    torch.cuda.synchronize()


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


# ----------------------------------------------------------------------
# MoE and the tiered embedding and expert caches
# ----------------------------------------------------------------------
def test_moe_on_card_matches_cpu(cuda):
    """The qwen3-moe smoke model (float32, TF32 off): the MoE MLP with
    drops (cf 1.0) and dropless, then a 16-token prefill and 8 decode
    steps, on both devices."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("qwen3-moe-235b-a22b")
    cpu = torch.device("cpu")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     cpu)
    on_card = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model),
                                             np.float32))
    drops = dataclasses.replace(cfg, capacity_factor=1.0)
    for c, dropless in ((drops, False), (cfg, True)):
        want = moe.moe_ffn(params["layers"][0]["moe"], x, c, dropless)
        got = moe.moe_ffn(on_card["layers"][0]["moe"], x.to(cuda), c,
                          dropless)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 16)))
    with torch.no_grad():
        want, cache = transformer.forward(params, cfg, prompt,
                                          return_cache=True)
        got, _ = transformer.forward(on_card, cfg, prompt.to(cuda),
                                     return_cache=True)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
        caches = (transformer.init_cache(cfg, 3, 16, cpu),
                  transformer.init_cache(cfg, 3, 16, cuda))
        for pos in range(8):
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3))
            want = transformer.decode_step(params, cfg, caches[0], toks, pos)
            got = transformer.decode_step(on_card, cfg, caches[1],
                                          toks.to(cuda), pos)
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-4)


def numpy_sampler(now, n, n_units):
    return np.random.default_rng(now).integers(0, n_units, n)


def test_tiered_embedding_on_card_matches_cpu(cuda):
    """A zipf replay on both devices with the same threshold draws: every
    lookup the exact gather, the same clocks and slot tables, one fused
    tracker launch per lookup."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((4096, 64), np.float32)
                             ).to(torch.bfloat16)
    embs = [TieredEmbedding(table, 512, 64, hbm_bw=1e12, pcie_bw=1e10,
                            device=d, sampler=numpy_sampler)
            for d in ("cpu", cuda)]
    before = ops.LAUNCHES["ralt_record"]
    for _ in range(300):
        ids = np.minimum(rng.zipf(1.3, 64) - 1, 4095)
        want = table[torch.from_numpy(ids)]
        for emb in embs:
            assert torch.equal(emb.lookup(ids).cpu(), want)
    assert ops.LAUNCHES["ralt_record"] == before + 300
    for name in ("fast_hits", "slow_hits", "promoted", "demoted",
                 "retained", "flushes"):
        assert getattr(embs[1].clock, name) == getattr(embs[0].clock, name)
    np.testing.assert_array_equal(embs[1].slot_of_row, embs[0].slot_of_row)
    assert embs[1].free == embs[0].free
    assert embs[1].clock.promoted > 0
    assert torch.equal(embs[1].cache.cpu(), embs[0].cache)


def test_expert_cache_on_card_matches_cpu(cuda):
    """A zipf routing replay on both devices: the same clocks, slot
    tables and resident fraction, every resident blob its host blob, one
    fused tracker launch per step."""
    rng = np.random.default_rng(1)
    blobs = torch.from_numpy(rng.standard_normal((64, 3, 32, 32),
                                                 np.float32))
    ecs = [ExpertCache(blobs, 16, 8, hbm_bw=1e12, pcie_bw=1e10, device=d,
                       sampler=numpy_sampler) for d in ("cpu", cuda)]
    before = ops.LAUNCHES["ralt_record"]
    for _ in range(200):
        counts = np.bincount(np.minimum(rng.zipf(1.4, 128) - 1, 63),
                             minlength=64)
        for ec in ecs:
            ec.route(counts)
        assert ecs[1].resident_fraction(counts) == \
            ecs[0].resident_fraction(counts)
    assert ops.LAUNCHES["ralt_record"] == before + 200
    for name in ("fast_hits", "slow_hits", "promoted", "demoted",
                 "retained", "sweeps"):
        assert getattr(ecs[1].clock, name) == getattr(ecs[0].clock, name)
    np.testing.assert_array_equal(ecs[1].expert_of_slot,
                                  ecs[0].expert_of_slot)
    for s, e in enumerate(ecs[1].expert_of_slot):
        if e >= 0:
            assert torch.equal(ecs[1].cache[s].cpu(), blobs[e])
    assert ecs[1].clock.promoted > 0


@pytest.mark.parametrize("system,mix", [
    ("hotrap", "RO"), ("hotrap", "UH"), ("hotrap", "SR"),
    ("rocksdb_tiered", "RW"), ("rocksdb_fd", "WH"),
    ("hotrap_noretain", "UH"), ("hotrap_nohotcheck", "RO")])
def test_lsm_engine_on_card_matches_cpu(cuda, system, mix):
    """The HotRAP engine (`repro_torch.core`) loaded and driven on the
    card and on the CPU: the same RunResult (floats bit for bit), every
    op's outcome, each level's runs, then the same answers to scalar
    gets, deletes and scans; every engine tensor on the card."""
    import dataclasses
    import pickle

    from repro_torch.core import runner
    from repro_torch.data import workloads
    cfg = dataclasses.replace(runner.default_config("tiny"),
                              sd_size=8 << 20)
    n_keys = runner.db_key_count(cfg, 1000)
    wl = workloads.ycsb(mix, workloads.KeyDist("hotspot", n_keys),
                        600 if mix == "SR" else 4000, 1000, seed=1)
    got = []
    for device in ("cpu", cuda):
        db = runner.make_system(system, cfg, device=device)
        runner.load_db(db, n_keys, 1000)
        db = pickle.loads(pickle.dumps(db))
        outs: list = []
        res = runner.run_workload(db, wl, name=system, results_out=outs)
        rng = np.random.default_rng(2)
        scalar = [db.scan(k, 20) if k % 5 == 0 else
                  db.delete(k) if k % 7 == 0 else db.get(k)
                  for k in rng.integers(0, n_keys, 200).tolist()]
        got.append((res.to_json(), outs, scalar, [
            [(s.tier, s.keys.tolist(), s.seqs.tolist(), s.vlens.tolist())
             for s in level] for level in db.levels],
            dataclasses.asdict(db.stats), db.storage.snapshot()))
    assert got[1] == got[0]
    assert all(t.is_cuda for t in db.tensors())
