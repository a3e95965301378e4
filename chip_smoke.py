#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `src/repro_torch/csrc` and runs
four phases, each printing one JSON line:

  device   the card's name and power limit, and the kernels' build time;
  kernels  each kernel against its plain PyTorch version on the card, at
           the shapes the serving path gives it and at larger ones, with
           its time, the plain version's time, one PyTorch call's time
           where one computes the same function, and its bound;
  serve    llama3-8b at full width (32 layers, random bf16 weights from a
           seed) answering 8 requests through `ServeEngine`, after a check
           of the CUDA decode path's logits against the CPU path's;
  tiered   `TieredKVCache` at llama3-8b's KV widths replaying a hotspot
           stream of single-page reads through the RALT tracker.

Kernel launches are counted from zero over each of the serve and tiered
runs.  Then come the kernel summary line, the `nvidia-smi` line and the
result line.  Exits nonzero without CUDA, outside a checkout of the
repository, and on any failure.  Imports neither jax nor `repro`.
"""
from __future__ import annotations

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


def kernels_phase(dev, flush, power: str) -> dict:
    from repro_torch.kernels import ops, ralt_score, ref

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
    torch.cuda.synchronize()
    emit("kernels", ralt_update=dict(
        tpu_counterpart="src/repro/kernels/ralt_score.py:78", cases=ralt),
        decode_attention=dict(
            tpu_counterpart="src/repro/kernels/decode_attention.py:106",
            cases=decode),
        peak_bytes_per_s=PEAK_BYTES, power_limit=power)
    bad = [c for c in ralt + decode if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    # the main path's shapes: the tracker's page table, the first
    # generated token's decode step
    return {"ralt_update": ralt[0], "decode_attention": decode[1]}


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
    launches = {"decode_attention": serve_phase(dev, power)[
        "decode_attention"], "ralt_update": tiered_phase(dev, power)[
        "ralt_update"]}
    sources = {
        "ralt_update": ("src/repro_torch/csrc/ralt_score.cu",
                        "src/repro/kernels/ralt_score.py:78"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:106")}
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
