#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `src/repro_torch/csrc` and runs
seven phases, each printing one JSON line:

  device   the card's name and power limit, and the kernels' build time;
  kernels  each kernel against its plain PyTorch version on the card, at
           the shapes the serving and training paths give it and at
           others, with its time, the plain version's time, one PyTorch
           call's time where one computes the same function, and its bound;
  serve    llama3-8b at full width (32 layers, random bf16 weights from a
           seed) answering 8 requests through `ServeEngine`, after a check
           of the CUDA decode path's logits against the CPU path's;
  tiered   `TieredKVCache` at llama3-8b's KV widths replaying a hotspot
           stream of single-page reads through the RALT tracker;
  prefill  llama3-8b at full width: a 128-token prefill step against
           teacher-forced decode steps (last logits and every layer's
           k/v; the seeded bf16 weights computed in float32, and in bf16
           for the record), then one timed 4096-token prefill;
  train    stablelm-3b at full width (bf16 weights, f32 AdamW moments):
           one step's loss and gradient norm with the flash kernel against
           the same step with the plain attention core, then 4 train
           steps of 2 x 4096 tokens (2 microbatches) from `LMPipeline`,
           with the reference's default options (100 warmup steps);
  mamba2   mamba2-1.3b at full width and depth (48 layers, random bf16
           weights from a seed): a 2 x 512-token prefill against 512
           teacher-forced decode steps (last logits, every layer's ssm and
           conv state, and one more token decoded from each cache; float32
           compute), one timed 4096-token prefill, 32 greedy decode steps
           from its state, and 4 train steps as in `train`, after one
           step's loss and gradient norm with the scan kernel against the
           plain chunk scan.

Kernel launches are counted from zero in each of the serve, tiered,
prefill and train runs and in each part of the mamba2 run.  Then come
the kernel summary line, the `nvidia-smi` line and the result line.
Exits nonzero without CUDA, outside a checkout of the repository, and
on any failure.  Imports neither jax nor `repro`.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
# Published H100 SXM peaks (NVIDIA data sheet), at a 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
REPS = 25
# serving run: 8 requests of 128 prompt and 32 new tokens, batch 4
PROMPT, NEW, BATCH, REQUESTS = 128, 32, 4, 8
MAX_LEN = PROMPT + NEW + 8
# tiered run: llama3-8b's KV widths, one layer per page
N_PAGES, FAST_SLOTS, READS = 65_536, 8_192, 20_000
# prefill run: a 128-token check against decode, one 4096-token prefill
PREFILL_CHECK, PREFILL_LEN = 128, 4096
# train run: stablelm-3b, 2 sequences of 4096 tokens in 2 microbatches
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4096, 2, 2, 4
# mamba2 run: a 2 x 512-token hand-off check (2 chunks of 256), a
# 4096-token prefill, 32 decode steps, then training as above
HANDOFF_BATCH, HANDOFF_LEN, DECODE_STEPS = 2, 512, 32
# tests/test_kernels.py's ssd_scan tolerances: y by dtype, h_final
SSD_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}
SSD_H_TOL = 5e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms(fn, flush: torch.Tensor, reps: int = REPS) -> float:
    """Median device time of `fn` in ms over `reps` calls, each after a
    write of `flush` (larger than the 50 MB L2, so every call starts
    cold).  The calls queue behind a spin kernel, so the host's launch
    time does not show between the events."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------
def ralt_case(ops, ralt_score, dev, g, flush, N: int) -> dict:
    ticks = torch.randint(0, 50, (N,), generator=g, device=dev,
                          dtype=torch.int32)
    scores = torch.rand(N, generator=g, device=dev) * 5
    hits = torch.randint(0, 2, (N,), generator=g, device=dev,
                         dtype=torch.int8)
    now = torch.tensor(57, dtype=torch.int32, device=dev)
    thr = torch.tensor(1.0, device=dev)
    log_alpha = float(np.float32(np.log(0.999)))
    nt, ns, hot = ops.ralt_update(ticks, scores, hits, now, thr)
    pt, ps, phot = ralt_score._plain(ticks, scores, hits, now, thr,
                                     log_alpha)
    # a unit whose plain score lies within one ulp of the threshold may
    # round to the other side; such units are counted, not failed
    ulp = torch.nextafter(thr, torch.tensor(float("inf"), device=dev)) - thr
    near = (ps - thr).abs() <= ulp
    flips = int(((hot != phot) & ~near).sum())
    rel = float(((ns - ps).abs() / ps.abs().clamp_min(1e-30)).max())
    ok = (torch.equal(nt, pt) and flips == 0 and rel <= 1e-6)
    ms = device_ms(lambda: ops.ralt_update(ticks, scores, hits, now, thr),
                   flush)
    plain_ms = device_ms(lambda: ralt_score._plain(
        ticks, scores, hits, now, thr, log_alpha), flush)
    b_ms, b_by = bound(18 * N, 20 * N, torch.float32)
    return dict(N=N, ok=ok, max_abs_err=float((ns - ps).abs().max()),
                max_rel_err=rel, rtol=1e-6, hot_flips=flips,
                near_threshold=int(near.sum()), kernel_ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


def decode_case(ops, ref, dev, g, flush, B, H, KVH, D, S, valid,
                dtype) -> dict:
    q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, KVH, S, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, KVH, S, D, generator=g, device=dev).to(dtype)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    got = ops.decode_attention_head_major(q, k, v, valid)
    want = ref.decode_attention_ref(q, kt, vt, valid)
    err = float((got.float() - want.float()).abs().max())
    if S <= 4096:      # the reference layout's entry point, same kernel
        other = ops.decode_attention(q, kt.contiguous(), vt.contiguous(),
                                     valid)
        err = max(err, float((other.float() - want.float()).abs().max()))
    q4, kv, vv = q[:, :, None], k[:, :, :valid], v[:, :, :valid]
    lib = F.scaled_dot_product_attention(q4, kv, vv, enable_gqa=True)
    lib_err = float((lib[:, :, 0].float() - want.float()).abs().max())
    ms = device_ms(lambda: ops.decode_attention_head_major(q, k, v, valid),
                   flush)
    plain_ms = device_ms(lambda: ref.decode_attention_ref(q, kt, vt, valid),
                         flush)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q4, kv, vv, enable_gqa=True), flush)
    item = q.element_size()
    n_bytes = 2 * B * KVH * valid * D * item + 2 * B * H * D * item
    b_ms, b_by = bound(n_bytes, 4 * B * H * valid * D + 5 * B * H * valid,
                       dtype)
    return dict(shape=dict(B=B, H=H, KVH=KVH, D=D, S=S, valid_len=valid),
                dtype=str(dtype).removeprefix("torch."),
                ok=err <= TOL[dtype], max_abs_err=err, tol=TOL[dtype],
                library_max_abs_err=lib_err, kernel_ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by)


def visible_pairs(Sq: int, Skv: int, window) -> int:
    """(query, key) pairs that pass the causal and window masks."""
    rows = np.arange(Sq)
    lo = 0 if window is None else np.maximum(rows - window + 1, 0)
    return int((np.minimum(rows + 1, Skv) - lo).clip(min=0).sum())


def excess(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 inside the
    allclose tolerance of tests/test_kernels.py."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def flash_case(ops, fa, dev, g, flush, B, S, H, KVH, D, window,
               dtype) -> dict:
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, KVH, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, KVH, D, generator=g, device=dev).to(dtype)
    got, lse = ops.flash_attention_fwd(q, k, v, window=window)
    want, want_lse = fa.flash_attention_plain(q, k, v, window=window)
    tol = TOL[dtype]
    over = excess(got, want, tol, tol)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    else:
        pos = torch.arange(S, device=dev)
        keep = (pos[None, :] <= pos[:, None]) \
            & (pos[:, None] - pos[None, :] < window)

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                                  enable_gqa=True)
    lib_err = float((lib().transpose(1, 2).float() - want.float()).abs().max())
    ms = device_ms(lambda: ops.flash_attention_fwd(q, k, v, window=window),
                   flush)
    plain_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                          window=window),
                         flush)
    library_ms = device_ms(lib, flush)
    pairs = visible_pairs(S, S, window)
    item = q.element_size()
    n_bytes = item * (2 * B * S * H * D + 2 * B * S * KVH * D) + 4 * B * H * S
    b_ms, b_by = bound(n_bytes, B * H * pairs * (4 * D + 5), dtype)
    return dict(shape=dict(B=B, S=S, H=H, KVH=KVH, D=D, window=window),
                dtype=str(dtype).removeprefix("torch."), ok=over <= 1.0,
                max_abs_err=float((got.float() - want.float()).abs().max()),
                err_over_tol=over, tol=tol,
                lse_max_abs_err=float((lse - want_lse).abs().max()),
                library_max_abs_err=lib_err, kernel_ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                visible_pairs=pairs)


def ssd_case(ops, ssd, dev, g, flush, B, nC, Q, nh, hp, ns, dtype) -> dict:
    """The mixer's form (`ssd_scan_fwd`, y in float32) against the plain
    chunk scan; inputs drawn as tests/test_kernels.py draws them."""
    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x, Bm, Cm = ((normal(*s) * 0.5).to(dtype) for s in (
        (B, nC, Q, nh, hp), (B, nC, Q, ns), (B, nC, Q, ns)))
    dt = F.softplus(normal(B, nC, Q, nh))
    A = -torch.exp(normal(nh) * 0.2)
    y, h = ops.ssd_scan_fwd(x, Bm, Cm, dt, A)
    want_y, want_h = ssd.ssd_scan_plain(x, Bm, Cm, dt, A)
    tol = SSD_TOL[dtype]
    over = max(excess(y, want_y, tol, tol),
               excess(h, want_h, SSD_H_TOL, SSD_H_TOL))
    ms = device_ms(lambda: ops.ssd_scan_fwd(x, Bm, Cm, dt, A), flush)
    plain_ms = device_ms(lambda: ssd.ssd_scan_plain(x, Bm, Cm, dt, A), flush)
    L, item = nC * Q, x.element_size()
    n_bytes = (item * B * L * (nh * hp + 2 * ns) + 4 * B * L * nh + 4 * nh
               + 4 * B * L * nh * hp + 4 * B * nh * ns * hp)
    # C B^T once per chunk; per head and chunk W x, C h and the update
    n_ops = 2 * B * nC * (Q * Q * ns + nh * (Q * Q * hp + 2 * Q * ns * hp))
    b_ms, b_by = bound(n_bytes, n_ops, dtype)
    return dict(shape=dict(B=B, nC=nC, Q=Q, nh=nh, hp=hp, ns=ns),
                dtype=str(dtype).removeprefix("torch."), ok=over <= 1.0,
                max_abs_err=float((y - want_y).abs().max()),
                h_max_abs_err=float((h - want_h).abs().max()),
                err_over_tol=over, tol=tol, h_tol=SSD_H_TOL, kernel_ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


def kernels_phase(dev, flush, power: str) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ralt_score, ref
    from repro_torch.kernels import ssd_scan as ssd

    g = torch.Generator(device=dev).manual_seed(0)
    ralt = [ralt_case(ops, ralt_score, dev, g, flush, n)
            for n in (N_PAGES, 16_777_216)]
    bf16, f32 = torch.bfloat16, torch.float32
    decode = [decode_case(ops, ref, dev, g, flush, *shape)
              for shape in (
                  # llama3-8b's serving shape: the first step, the first
                  # generated token (129 is no multiple of any tile) and
                  # the last step
                  (BATCH, 32, 8, 128, MAX_LEN, 1, bf16),
                  (BATCH, 32, 8, 128, MAX_LEN, PROMPT + 1, bf16),
                  (BATCH, 32, 8, 128, MAX_LEN, PROMPT + NEW, bf16),
                  (BATCH, 32, 8, 128, MAX_LEN, PROMPT + 1, f32),
                  # a long cache, then stablelm's D = 80 and internvl2's 64
                  (8, 32, 8, 128, 32_768, 30_001, bf16),
                  (4, 32, 32, 80, 4096, 3001, bf16),
                  (4, 14, 2, 64, 4096, 3001, bf16))]
    flash = [flash_case(ops, fa, dev, g, flush, *shape)
             for shape in (
                 # the training path's shapes: stablelm-3b (D = 80, MHA)
                 # and llama3-8b's prefill (D = 128, G = 4); a ragged S;
                 # a window with D = 256; float32 at internvl2's widths
                 (1, TRAIN_SEQ, 32, 32, 80, None, bf16),
                 (1, PREFILL_LEN, 32, 8, 128, None, bf16),
                 (1, 4001, 32, 8, 128, None, bf16),
                 (1, 4096, 8, 4, 256, 96, bf16),
                 (1, 2048, 14, 2, 64, None, f32))]
    ssd_cases = [ssd_case(ops, ssd, dev, g, flush, *shape)
                 for shape in (
                     # mamba2-1.3b's prefill and training shape (4096
                     # tokens, bf16); the same in float32; the hand-off
                     # check's 2 x 512 tokens in float32
                     (1, 16, 256, 64, 64, 128, bf16),
                     (1, 16, 256, 64, 64, 128, f32),
                     (HANDOFF_BATCH, 2, 256, 64, 64, 128, f32))]
    torch.cuda.synchronize()
    emit("kernels", ralt_update=dict(
        tpu_counterpart="src/repro/kernels/ralt_score.py:78", cases=ralt),
        decode_attention=dict(
            tpu_counterpart="src/repro/kernels/decode_attention.py:106",
            cases=decode),
        flash_attention=dict(
            tpu_counterpart="src/repro/kernels/flash_attention.py:111",
            cases=flash),
        ssd_scan=dict(tpu_counterpart="src/repro/kernels/ssd_scan.py:89",
                      cases=ssd_cases),
        peak_bytes_per_s=PEAK_BYTES, power_limit=power)
    bad = [c for c in ralt + decode + flash + ssd_cases if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    # the main path's shapes: the tracker's page table, the first
    # generated token's decode step, stablelm-3b's training attention,
    # mamba2-1.3b's prefill and training scan
    return {"ralt_update": ralt[0], "decode_attention": decode[1],
            "flash_attention": flash[0], "ssd_scan": ssd_cases[0]}


# ----------------------------------------------------------------------
# serve
# ----------------------------------------------------------------------
def reference_check(dev) -> float:
    """Logits of 12 decode steps of llama3-8b's smoke config (float32),
    CUDA path against the CPU path that the tests hold to the reference."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer

    cfg = smoke_config("llama3-8b")
    cpu = torch.device("cpu")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     cpu)
    on_dev = {k: ([{n: w.to(dev) for n, w in layer.items()} for layer in v]
                  if k == "layers" else v.to(dev))
              for k, v in params.items()}
    caches = (transformer.init_cache(cfg, 3, 16, cpu),
              transformer.init_cache(cfg, 3, 16, dev))
    rng = np.random.default_rng(5)
    err = 0.0
    for pos in range(12):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3))
        want = transformer.decode_step(params, cfg, caches[0], toks, pos)
        got = transformer.decode_step(on_dev, cfg, caches[1], toks.to(dev),
                                      pos)
        err = max(err, float((got.cpu() - want).abs().max()))
    return err


def serve_phase(dev, power: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.serving import engine

    ref_err = reference_check(dev)
    if not ref_err <= 1e-4:
        raise SystemExit(f"CUDA decode logits differ from the CPU path's "
                         f"by {ref_err}")
    cfg = get_config("llama3-8b")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = engine.ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, seed=0,
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    for rid in range(REQUESTS):
        eng.submit(engine.Request(
            rid=rid, prompt=[int(t) for t in rng.integers(0, cfg.vocab,
                                                          PROMPT)],
            max_new=NEW))
    nan_seen = torch.zeros((), dtype=torch.bool, device=dev)
    decode_step = engine.decode_step

    def checked_step(*args):
        logits = decode_step(*args)
        nan_seen.logical_or_(torch.isnan(logits).any())
        return logits

    engine.decode_step = checked_step
    try:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        engine.decode_step = decode_step
    tokens = sum(len(r.out) for r in done)
    out = dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               dtype=cfg.dtype, params=cfg.param_count(), batch=BATCH,
               requests_completed=len(done), tokens=tokens,
               steps_used=eng.steps_used, init_s=init_s, wall_s=wall,
               tokens_per_s=tokens / wall, ms_per_step=wall * 1e3
               / eng.steps_used,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               decode_launches=launches["decode_attention"],
               ralt_launches=launches["ralt_update"],
               cuda_vs_cpu_logits_max_abs_err=ref_err, power_limit=power)
    emit("serve", **out)
    V = padded_vocab(cfg)
    checks = {
        "every request completed": len(done) == REQUESTS and all(
            len(r.out) == NEW for r in done) and not eng.starved,
        "tokens < padded vocab": all(0 <= t < V for r in done
                                     for t in r.out),
        "no NaN logits": not bool(nan_seen),
        "decode kernel once per layer and step":
            launches["decode_attention"] == cfg.n_layers * eng.steps_used,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"serve phase failed: {failed}")
    return launches


# ----------------------------------------------------------------------
# tiered
# ----------------------------------------------------------------------
def hotspot_stream(n_pages, n_ops, seed=0):
    """The hotspot generator of `benchmarks/tiered_serving.py:49-64`."""
    rng = np.random.default_rng(seed)
    for _ in range(n_ops):
        n_hot = max(n_pages // 20, 1)
        p = int(rng.integers(0, n_hot)) if rng.random() < 0.95 \
            else int(rng.integers(0, n_pages))
        yield p % n_pages


def measured_bandwidths(dev) -> tuple[float, float]:
    """Bytes/s of a device-to-device copy and of a pinned host-to-device
    copy of 256 MiB on this card (medians of 10)."""
    n = 256 << 20
    src = torch.empty(n, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    rates = []
    for copy in (lambda: dst.copy_(src),
                 lambda: dst.copy_(host, non_blocking=True)):
        copy()
        times = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            copy()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        rates.append(n / statistics.median(times))
    return rates[0], rates[1]


def tiered_phase(dev, power: str) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.tiering import KVTierConfig, TieredKVCache

    hbm_bw, pcie_bw = measured_bandwidths(dev)
    cfg = KVTierConfig(n_pages=N_PAGES, fast_slots=FAST_SLOTS,
                       page_tokens=16, kv_heads=8, head_dim=128,
                       n_layers=1, dtype="bfloat16")
    t0 = time.perf_counter()
    kv = TieredKVCache(cfg, hbm_bw=hbm_bw, pcie_bw=pcie_bw, device=dev)
    shape = (cfg.n_layers, cfg.page_tokens, cfg.kv_heads, cfg.head_dim)

    def fill(p):      # exact in bfloat16: multiples of 1/8 up to 12
        return (p % 97) / 8

    for p in range(N_PAGES):
        val = torch.full(shape, fill(p), dtype=torch.bfloat16)
        kv.write_page(p, val, -val)
    kv.clock.pcie_s = kv.clock.hbm_s = 0.0
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    wrong = torch.zeros((), dtype=torch.int64, device=dev)
    fills = torch.tensor([fill(p) for p in range(97)],
                         dtype=torch.bfloat16).to(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    for p in hotspot_stream(N_PAGES, READS):
        (page,) = kv.read_pages([p])
        w = fills[p % 97]
        wrong += (page[0] != w).sum() + (page[1] != -w).sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    c = kv.clock
    out = dict(n_pages=N_PAGES, fast_slots=FAST_SLOTS,
               page_bytes=cfg.page_bytes, reads=READS,
               fast_hit_rate=kv.fast_hit_rate(), promoted=c.promoted,
               demoted=c.demoted, retained=c.retained, aborted=c.aborted,
               sweeps=c.sweeps, flushes=c.flushes, sim_s=c.total_s,
               hbm_bw_measured=hbm_bw, pcie_bw_measured=pcie_bw,
               load_s=load_s, wall_s=wall, reads_per_s=READS / wall,
               wrong_elements=int(wrong),
               ralt_launches=launches["ralt_update"],
               decode_launches=launches["decode_attention"],
               power_limit=power)
    emit("tiered", **out)
    checks = {
        "hit rate beats fast_slots / n_pages":
            out["fast_hit_rate"] > FAST_SLOTS / N_PAGES,
        "RALT kernel once per read": launches["ralt_update"] == READS,
        "every read returns its page": out["wrong_elements"] == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"tiered phase failed: {failed}")
    return launches


# ----------------------------------------------------------------------
# prefill
# ----------------------------------------------------------------------
def prefill_vs_decode(cfg, params, prompt, dev) -> dict:
    """The prefill step's last logits and k/v against what teacher-forced
    decode steps leave (`tests/test_arch_smoke.py:62-78`), as err/tol
    (at most 1 inside the allclose tolerance 2e-2) per layer and
    overall."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer

    last, cache = make_prefill_step(cfg)(params, {"tokens": prompt})
    decode_cache = transformer.init_cache(cfg, 1, prompt.shape[1], dev)
    with torch.no_grad():
        for pos in range(prompt.shape[1]):
            logits = transformer.decode_step(params, cfg, decode_cache,
                                             prompt[:, pos], pos)
    tol = TOL[torch.bfloat16]
    by_layer = [max(excess(c[name], d[name].transpose(1, 2), tol, tol)
                    for name in ("k", "v"))
                for c, d in zip(cache, decode_cache)]
    logits_over = excess(last, logits, tol, tol)
    return dict(err_over_tol=max(by_layer + [logits_over]),
                logits_err_over_tol=logits_over,
                logits_max_abs_err=float((last.float()
                                          - logits.float()).abs().max()),
                kv_err_over_tol_by_layer=by_layer,
                finite=bool(torch.isfinite(last).all()))


def prefill_phase(dev, power: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    cfg = get_config("llama3-8b")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = transformer.init_params(cfg, g, dev)
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (1, PREFILL_CHECK))).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    # The property is checked with the seeded bf16 weights computed in
    # float32 (exact copies): in bf16 the two paths round at different
    # places and drift apart with depth, which the bf16 run shows per
    # layer beside it.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    check32 = prefill_vs_decode(cfg32, params32, prompt, dev)
    del params32
    torch.cuda.empty_cache()
    check16 = prefill_vs_decode(cfg, params, prompt, dev)
    prefill = make_prefill_step(cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (1, PREFILL_LEN))).to(dev)
    prefill(params, {"tokens": tokens})             # warm-up, same shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = check32["finite"] and check16["finite"] \
        and bool(torch.isfinite(out).all())
    launches = dict(ops.LAUNCHES)
    res = dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               dtype=cfg.dtype, params=cfg.param_count(),
               check_tokens=PREFILL_CHECK, tol=TOL[torch.bfloat16],
               prefill_vs_decode_f32=check32, prefill_vs_decode_bf16=check16,
               prefill_tokens=PREFILL_LEN, prefill_s=wall,
               tokens_per_s=PREFILL_LEN / wall,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               flash_launches=launches["flash_attention"],
               decode_launches=launches["decode_attention"],
               power_limit=power)
    emit("prefill", **res)
    checks = {
        "prefill matches teacher-forced decode (float32)":
            check32["err_over_tol"] <= 1.0,
        "finite logits": finite,
        # two checks, the warm-up and the timed prefill
        "flash kernel once per layer and prefill":
            launches["flash_attention"] == 4 * cfg.n_layers,
        "decode kernel once per layer and step":
            launches["decode_attention"] == 2 * cfg.n_layers * PREFILL_CHECK,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"prefill phase failed: {failed}")
    return launches


# ----------------------------------------------------------------------
# train
# ----------------------------------------------------------------------
def train_run(cfg, dev, op: str, plain) -> tuple[dict, dict]:
    """Full-width training of `cfg` (bf16 weights, f32 AdamW moments, the
    reference's default options: at full width, Adam's first sign-like
    step at the peak lr moves every output of a wide layer by about
    width * 3e-4, and the loss diverges).  One step's loss and gradient
    norm with the kernel behind `ops.<op>` against the same step with
    `plain` in its place; then TRAIN_STEPS train steps of TRAIN_BATCH x
    TRAIN_SEQ tokens in TRAIN_MICRO microbatches from `LMPipeline`, with
    the launches counted from zero.  -> (results, launches)."""
    from repro_torch.data.lm_pipeline import DataConfig, LMPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init, global_norm

    topts = steps.TrainOptions(microbatch=TRAIN_MICRO)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    torch.cuda.reset_peak_memory_stats(dev)
    params = transformer.init_params(cfg, g, dev)
    opt = adamw_init(params, topts.opt)
    data = LMPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, seed=0))

    def batch_at(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_at(step).items()}

    def loss_and_norm():
        loss, grads = steps.value_and_grad(params, cfg, batch_at(0),
                                           TRAIN_MICRO)
        return float(loss), float(global_norm(grads))

    kernel = loss_and_norm()
    fwd = getattr(ops, op)
    setattr(ops, op, plain)
    try:
        plain_run = loss_and_norm()
    finally:
        setattr(ops, op, fwd)
    rel = [abs(a - b) / abs(b) for a, b in zip(kernel, plain_run)]

    step_fn = steps.make_train_step(cfg, topts)
    losses, norms, step_s = [], [], []
    ops.reset_launches()
    for step in range(TRAIN_STEPS):
        batch = batch_at(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, step, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                dtype=cfg.dtype, moment_dtype=topts.opt.moment_dtype,
                params=cfg.param_count(), seq=TRAIN_SEQ,
                global_batch=TRAIN_BATCH, microbatch=TRAIN_MICRO,
                check_loss_kernel=kernel[0], check_loss_plain=plain_run[0],
                check_grad_norm_kernel=kernel[1],
                check_grad_norm_plain=plain_run[1],
                check_rel_err=dict(loss=rel[0], grad_norm=rel[1]),
                losses=losses, grad_norms=norms, step_s=step_s,
                tokens_per_s=[tokens / s for s in step_s],
                max_memory_allocated=torch.cuda.max_memory_allocated(dev)
                ), launches


def train_phase(dev, power: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    cfg = get_config("stablelm-3b")
    res, launches = train_run(cfg, dev, "flash_attention_fwd",
                              fa.flash_attention_plain)
    emit("train", **res, flash_launches=launches["flash_attention"],
         power_limit=power)
    losses, rel = res["losses"], res["check_rel_err"].values()
    # forward and remat recompute, per layer, microbatch and step
    want = cfg.n_layers * 2 * TRAIN_MICRO * TRAIN_STEPS
    checks = {
        "kernel step matches the plain attention core (2e-2 relative)":
            max(rel) <= 2e-2,
        "finite losses": all(np.isfinite(losses)),
        "loss falls from step 1 to step 4": losses[-1] < losses[0],
        "flash kernel once per layer, pass, microbatch and step":
            launches["flash_attention"] == want,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"train phase failed: {failed}")
    return launches


# ----------------------------------------------------------------------
# mamba2
# ----------------------------------------------------------------------
def mamba2_handoff(cfg, params, prompt, dev) -> dict:
    """The prefill step over prompt[:, :-1] against teacher-forced decode
    steps over the same tokens: last logits and every layer's ssm and
    conv state, then the logits of the last token decoded from each
    cache; as err/tol (at most 1 inside allclose 2e-2)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer

    B, T = prompt.shape[0], prompt.shape[1] - 1
    ops.reset_launches()
    last, cache = make_prefill_step(cfg)(params, {"tokens": prompt[:, :T]})
    launches = ops.LAUNCHES["ssd_scan"]
    dcache = transformer.init_cache(cfg, B, T + 1, dev)
    tol = TOL[torch.bfloat16]
    with torch.no_grad():
        for pos in range(T):
            logits = transformer.decode_step(params, cfg, dcache,
                                             prompt[:, pos], pos)
        by_layer = [max(excess(c[n], d[n], tol, tol) for n in ("ssm", "conv"))
                    for c, d in zip(cache, dcache)]
        logits_over = excess(last, logits, tol, tol)
        nxt = [transformer.decode_step(params, cfg, c, prompt[:, T], T)
               for c in (cache, dcache)]
    next_over = excess(nxt[0], nxt[1], tol, tol)
    return dict(err_over_tol=max(by_layer + [logits_over, next_over]),
                logits_err_over_tol=logits_over,
                next_logits_err_over_tol=next_over,
                next_logits_max_abs_err=float((nxt[0] - nxt[1]).abs().max()),
                state_err_over_tol_by_layer=by_layer, ssd_launches=launches,
                finite=bool(torch.isfinite(last).all()
                            and torch.isfinite(nxt[0]).all()))


def mamba2_phase(dev, power: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    cfg = get_config("mamba2-1.3b")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    torch.cuda.reset_peak_memory_stats(dev)
    params = transformer.init_params(cfg, g, dev)
    rng = np.random.default_rng(2)
    # (a) the cache hand-off, with the seeded bf16 weights computed in
    # float32 (exact copies), as the prefill phase checks attention
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (HANDOFF_BATCH, HANDOFF_LEN + 1))).to(dev)
    params32 = tree_map(lambda t: t.float(), params)
    handoff = mamba2_handoff(dataclasses.replace(cfg, dtype="float32"),
                             params32, prompt, dev)
    del params32
    torch.cuda.empty_cache()
    # (b) one timed 4096-token prefill after a warm-up of the same shape
    prefill = make_prefill_step(cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (1, PREFILL_LEN))).to(dev)
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    last, cache = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = ops.LAUNCHES["ssd_scan"]
    prefill_mem = torch.cuda.max_memory_allocated(dev)
    # (c) greedy decode from the prefilled state
    tok = last.argmax(dim=-1)
    finite = bool(torch.isfinite(last).all())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(DECODE_STEPS):
            logits = transformer.decode_step(params, cfg, cache, tok,
                                             PREFILL_LEN + i)
            tok = logits.argmax(dim=-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    finite = finite and bool(torch.isfinite(logits).all())
    del params, cache, last, logits
    torch.cuda.empty_cache()
    # (d) training, the scan kernel against the plain chunk scan
    train, launches = train_run(cfg, dev, "ssd_scan_fwd", ssd.ssd_scan_plain)
    res = dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               dtype=cfg.dtype, params=cfg.param_count(),
               handoff=dict(batch=HANDOFF_BATCH, tokens=HANDOFF_LEN,
                            compute="float32", tol=TOL[torch.bfloat16],
                            **handoff),
               prefill=dict(tokens=PREFILL_LEN, prefill_s=prefill_s,
                            tokens_per_s=PREFILL_LEN / prefill_s,
                            max_memory_allocated=prefill_mem,
                            ssd_launches=prefill_launches),
               decode=dict(batch=1, steps=DECODE_STEPS,
                           ms_per_step=decode_ms),
               train=dict(**train, ssd_launches=launches["ssd_scan"]),
               power_limit=power)
    emit("mamba2", **res)
    L = cfg.n_layers
    losses = train["losses"]
    checks = {
        "prefill hands decode its cache (float32, 2e-2)":
            handoff["err_over_tol"] <= 1.0,
        "finite logits": finite and handoff["finite"],
        "scan kernel once per layer and prefill":
            handoff["ssd_launches"] == prefill_launches == L,
        "kernel step matches the plain chunk scan (2e-2 relative)":
            max(train["check_rel_err"].values()) <= 2e-2,
        "finite losses": all(np.isfinite(losses)),
        "scan kernel once per layer, pass, microbatch and step":
            launches["ssd_scan"] == L * 2 * TRAIN_MICRO * TRAIN_STEPS,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"mamba2 phase failed: {failed}")
    return launches


# ----------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    power = smi()
    t0 = time.perf_counter()
    _build.build()
    emit("device", name=torch.cuda.get_device_name(dev), nvidia_smi=power,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    main_shapes = kernels_phase(dev, flush, power)
    del flush
    # each phase's model is freed when its function returns; each
    # kernel's launches are those of the phase that is its main path
    launches = {"decode_attention": serve_phase(dev, power)[
        "decode_attention"], "ralt_update": tiered_phase(dev, power)[
        "ralt_update"]}
    torch.cuda.empty_cache()
    prefill_phase(dev, power)
    torch.cuda.empty_cache()
    launches["flash_attention"] = train_phase(dev, power)["flash_attention"]
    torch.cuda.empty_cache()
    launches["ssd_scan"] = mamba2_phase(dev, power)["ssd_scan"]
    sources = {
        "ralt_update": ("src/repro_torch/csrc/ralt_score.cu",
                        "src/repro/kernels/ralt_score.py:78"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:106"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:111"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:89")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name],
         "max_abs_err": main_shapes[name]["max_abs_err"],
         "ms": main_shapes[name]["kernel_ms"],
         "plain_ms": main_shapes[name]["plain_ms"],
         "bound_ms": main_shapes[name]["bound_ms"],
         "bound_by": main_shapes[name]["bound_by"],
         "library_ms": main_shapes[name]["library_ms"]}
        for name, (src, tpu) in sources.items()]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
