#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `src/repro_torch/csrc` and runs
twenty phases, each printing one JSON line:

  device   the card's name and power limit, and the kernels' build time;
  ptxas    registers and spill bytes of the flash, decode (float and
           int8-cache) and ssd kernels (every pass of the ssd scan);
  kernels  each kernel against its plain PyTorch version on the card, at
           the shapes the serving and training paths give it and at
           others (the int8-cache decode kernel with the appended token
           held bit for bit; both decode kernels' row lse against the
           plain versions, timed with and without it, and an empty
           sequence shard), with its time, the plain version's time,
           one PyTorch call's time where one computes the same function,
           its bound, the share of the bound it reaches and its time over
           the PyTorch call's;
  serve    llama3-8b at full width (32 layers, random bf16 weights from a
           seed) answering 8 requests through `ServeEngine`, after a check
           of the CUDA decode path's logits against the CPU path's; then
           the same requests with `ServingObservability` attached (the
           same tokens and decode launches, the wave spans, a valid
           trace);
  tiered   `TieredKVCache` at llama3-8b's KV widths replaying a hotspot
           stream of single-page reads, the tracker recording each read
           with one fused `ralt_record` launch; then the same reads on a
           fresh cache with `ServingObservability` attached (clock, hit
           rate and slot tables bit for bit, the same launches, the page
           pathways' instants, µs a read against the unattached pass);
  tracker  the tracker at the tiered run's 65,536 pages over a hotspot id
           stream, three ways with one numpy threshold sampler: the
           `HotTracker` on the card (`ralt_record`), the functional
           `record_accesses` on the card (`ralt_update` and the plain ops
           around it) and the `HotTracker` on the CPU (the plain path);
           every state field bit for bit at every refresh;
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
           plain chunk scan;
  moe      qwen3-moe-235b-a22b at full width (d_model 4096, 64 q / 4 kv
           heads, 128 experts top-8, random bf16 weights from a seed),
           depth cut to 8 of 94 layers (all 94 would hold 470 GB): the
           CUDA decode path's logits against the CPU path's at the smoke
           config; a 128-token prefill against teacher-forced decode at 2
           layers in float32 with cf = E/K (no drops); 8 requests served
           through `ServeEngine` (dropless decode) beside the step's byte
           bound; one timed 4096-token prefill at the published cf 1.25
           with the share of assignments dropped;
  caches   `TieredEmbedding` over the seeded qwen3 embedding table
           (151,936 x 4096 bf16, 1/8 of the rows on the card) replaying
           400 lookups of 64 zipf(1.3) ids, and `ExpertCache` over one
           qwen3 layer's 128 expert blobs (36 MiB each, 16 on the card)
           replaying 300 steps of zipf(1.4) routing, each against a CPU
           twin fed the same stream and threshold draws: clocks, slot
           tables and tracker state bit for bit, every lookup the exact
           gather, every resident blob its host blob, one `ralt_record`
           per lookup or route;
  window   gemma3-4b at full width and depth (34 layers, 5 windowed of
           1024 to 1 global, random bf16 weights from a seed): the CUDA
           decode path's smoke logits against the CPU path's past the
           rings' wrap; a 1,088-token prefill against teacher-forced
           decode at the first 6 layers in float32 (a windowed layer's
           position p in ring slot p % 1024); 4 requests of 1,024 + 32
           tokens through `ServeEngine`, every ring wrapping; one timed
           4096-token prefill;
  mixtral  mixtral-8x22b as `moe` runs qwen3 (every block windowed at
           4096), depth cut to 8 of 56 layers (all 56 would hold 281 GB),
           its prefill 8192 tokens so that the window masks keys;
  dense    minitron-8b and musicgen-large at full width and depth: the
           smoke logits check and 8 requests served each; one timed
           4096-token musicgen prefill whose first 64 positions are a
           seeded audio `frontend_emb`;
  int8     llama3-8b with the int8 KV cache (`kv_quant`): the CUDA int8
           decode path's smoke logits against the CPU path's, then the
           `serve` phase's 8 requests on the same weights through the
           int8 decode kernel (one launch a layer and step appends the
           token and attends; no other decode kernel launched), with the
           cache's bytes against the bf16 cache's, the greedy tokens'
           agreement with the `serve` run's and the ms a step over the
           `serve` run's;
  zamba2   zamba2-7b at full width (32 heads of 112, the flash kernel's
           64 + 32 + 16-column cut; SSM 112 heads of 64, state 64): the
           CUDA decode path's smoke logits against the CPU path's; a
           2 x 512-token prefill against 512 teacher-forced decode steps
           at 15 of 81 layers (the shared block twice) in float32, every
           mamba2 state and every shared occurrence's k/v; at full depth
           (81 layers, the shared block's one set of weights at 13, each
           occurrence with its own KV cache) 8 requests through
           `ServeEngine`, one timed 4096-token prefill, one 32,768-token
           prefill and 32 greedy decode steps from its cache; 4 train
           steps at the 15 layers, the flash kernel against the plain
           attention core on step 0, AdamW's leaves counted against the
           reference's per-layer count;
  multidevice  the serve phase's requests and weights driven through
           `make_serve_step` (its tokens the engine's, bit for bit); the
           reference's decode_32k cell (llama3-8b, batch cut from 128 to
           8: 34.4 GB of cache) prefilled row by row, then 32 serve
           steps beside their byte bound; stablelm-3b through
           `train(mesh=...)` on a (1, 1) mesh over a one-rank NCCL group,
           2 steps a recipe, its losses the train phase's;
           `compressed_allreduce` on that group, the int8 payload against
           the numpy rule; two gloo ranks sharing the card (stablelm-3b
           at 8 of 32 layers, one 4096-token row a rank, the placed
           train cell of the "tp" recipe) against one process, and
           compression at world 2;
  placed   two gloo ranks sharing the card on a (1, 2) mesh, each holding
           its blocks of the weights and caches (`plan_cell`,
           `serve.serve_placed`, `make_prefill_step(plan=)`): llama3-8b
           at full width and depth in bf16 serving the `serve` phase's
           first 4 requests forced on the engine's tokens; mamba2-1.3b
           (full) and zamba2-7b (full width, 15 layers: the shared block
           twice) serving 4 requests; bf16 prefills of 4096 tokens at
           batch 1: llama3-8b at full depth under "fsdp" (context
           parallel), mamba2-1.3b under "fsdp" (its heads over "model"),
           qwen3-moe at 2 layers under "ep"; float32 checks against one
           process: decode (12 steps, logits and every cache block) of
           llama3-8b and mamba2-1.3b at 4 layers, zamba2 at 3 mamba2
           layers and the shared block, qwen3-moe at 2; prefill (last
           logits and every cache block) of llama3-8b and mamba2-1.3b at
           4 layers and qwen3-moe at 2; each rank's weights against
           `local_bytes` and the memory its cells allocate, the flash,
           ssd and decode launches of every placed run; placed training
           (`make_train_step(plan=)`): float32 checks of 2 steps at
           batch 1 of 512 tokens against one process (both steps' loss
           and gradient norm, every parameter and moment block through
           16 float64 Gaussian projections of it): stablelm-3b at 4
           layers under "fsdp" (context parallel) and "tp" (sp = tp),
           mamba2-1.3b at 4 layers under "fsdp" (its residual replicated
           over "model"), qwen3-moe at 1 layer under "ep"; a bf16 timing
           of stablelm-3b at 8 layers, 2 steps of 2 x 4096 tokens under
           "fsdp" (a row a rank, every weight gathered for its use): s a
           step, tokens/s a rank, each step's collective bytes against
           the planner's dry count, each rank's bytes against
           `local_bytes` and its peak against the planner's;
  plan     the planner (`launch/plan.py`) under 1x1: each model above, its
           parameter bytes against memory_allocated after init_params,
           and its peak estimates beside peaks measured by earlier runs;
  lsm      the HotRAP engine (`repro_torch.core`) with its sorted runs,
           blooms, merged views and RALT records on the card: at
           `default_config("tiny")` (22,528 keys of 1,000 B) `hotrap`
           and `rocksdb_tiered` under the RO, RW, WH, UH and SR mixes on
           hotspot-5% and `hotrap` RO on zipfian and uniform, 20,000 ops
           each, every cell's RunResult (floats bit for bit), every op's
           outcome and every level's runs against a CPU twin (a
           subprocess that works while the card runs the phase's cells);
           at `default_config("medium")` (64 MiB
           FD : 640 MiB SD, 720,896 keys) `hotrap` and `rocksdb_tiered`
           under hotspot-5% RO and RW, 200,000 ops each: load and run
           walls, µs an op, host syncs an op (over a clone's first 20,000
           ops), the engine's device bytes and the peak, StorageSim's
           simulated ops/s and FD hit rate; HotRAP's RO run against its
           CPU twin, and HotRAP above `rocksdb_tiered` in both.  Then
           durability and clusters, each against the twin (RunResult,
           every op's outcome, every shard's levels, memtables, seq,
           fences, WAL state, topology records, `recovery_info`): tiny
           `hotrap` with the WAL crashed mid-flush, mid-compaction and
           mid-promotion-install during 20,000 RW ops, recovered, then
           2,000 more ops; 4 hash shards with HotBudget under RO, RW and
           SR; 2 range shards with the WAL forced through a split and a
           merge, and crashed mid-migration-stream and mid-cutover; at
           `medium` the `configs/hotrap_kv.py` cluster shape with the
           WAL: HotRAP RW against the twin, HotRAP and `rocksdb_tiered`
           RO timed, with the WAL counters and the bytes the manifests'
           registries keep on the card.  The compared systems (`mutant`,
           `sas_cache`, `prismdb`) at tiny under RO, RW (5,000 ops) and
           SR (1,000), `hotrap` RW and the range cluster's split and
           merge under the runtime sanitizer (the close report against
           the twin's), the hash4 RW cell with `Observability()` attached
           (its trace events, metrics and attribution against the twin's,
           its digest the unattached cell's), the medium cluster's RW
           with the plane attached (its digest the unattached run's; its
           events, µs and syncs an op, the exported trace's size), and
           `sas_cache` RO at `medium` against a second CPU twin.

Kernel launches are counted from zero in each of the serve, tiered,
tracker, prefill, train and int8 runs, in each part of the mamba2, moe,
window, mixtral, zamba2 and multidevice runs, in each placed rank's run, in each dense model's
serve run and in each cache's replay.  The summary line's launches of
the flash, decode and ssd kernels add zamba2's main-path runs to those
of the train, serve and mamba2 runs, and their rows carry the numbers of
zamba2's shape beside their first shape's.
Then come the kernel summary line, the `nvidia-smi` line and the result
line.
Exits nonzero without CUDA, outside a checkout of the repository, and
on any failure.  Imports neither jax nor `repro`.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
LSE_TOL = 1e-5      # the flash forward's f32 row lse against the plain one
REPS = 25
# serving run: 8 requests of 128 prompt and 32 new tokens, batch 4
PROMPT, NEW, BATCH, REQUESTS = 128, 32, 4, 8
MAX_LEN = PROMPT + NEW + 8
# tiered run: llama3-8b's KV widths, one layer per page
N_PAGES, FAST_SLOTS, READS = 65_536, 8_192, 20_000
TRACKER_READS = 2_000
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
# moe run: qwen3-moe-235b-a22b cut to 8 layers; its float32 check at 2
MOE_ARCH, MOE_LAYERS, MOE_CHECK_LAYERS = "qwen3-moe-235b-a22b", 8, 2
# caches run: qwen3's vocab rows and one layer's experts, 1/8 on the card
EMB_FAST, EMB_STAGING, EMB_LOOKUPS, EMB_IDS = 18_992, 64, 400, 64
EXPERT_FAST, EXPERT_SWAP, EXPERT_STEPS, EXPERT_DRAWS = 16, 8, 300, 128
# window run: gemma3-4b at full depth; 4 requests of 1024 + 32 tokens (the
# 1024-slot rings wrap); its float32 check past the wrap at the first 6
# layers (5 windowed, 1 global)
WINDOW_ARCH, WINDOW_PROMPT, WINDOW_CHECK_LEN = "gemma3-4b", 1024, 1088
# mixtral run: 8 of 56 layers, its float32 check at 2; an 8192-token
# prefill, so that the 4096-token window masks keys
MIXTRAL_ARCH, MIXTRAL_LAYERS, MIXTRAL_PREFILL = "mixtral-8x22b", 8, 8192
# dense run: musicgen's audio stub, the reference's FRONTEND_LEN["audio"]
DENSE_ARCHS, AUDIO_FRAMES = ("minitron-8b", "musicgen-large"), 64
# zamba2 run: full width and depth (81 layers, the shared attention block
# at 13 of them); a 32,768-token prefill (the reference's decode_32k
# length at batch 1, not 128) and DECODE_STEPS decode steps from it; the
# hand-off check and the train steps at 15 layers: stages
# ((2, 5 x mamba2 + shared_attn), (1, 3 x mamba2)), the shared block twice
ZAMBA_ARCH, ZAMBA_LONG, ZAMBA_REPEATS = "zamba2-7b", 32_768, (2, 1)
# multidevice run: the decode_32k cell at batch 8 of its 128 (at 131,072
# bytes of llama3-8b cache a token, 128 rows would hold 550 GB); train
# steps a recipe over the one-rank NCCL mesh; two gloo ranks at 8 of
# stablelm-3b's 32 layers
MD_BATCH, MD_STEPS, MD_TRAIN_STEPS, MD_RANK_LAYERS = 8, 32, 2, 8
# placed run: two gloo ranks sharing the card, a (1, 2) mesh, serving the
# first 4 of the serve run's requests (about 0.3 s a step: each of a
# step's 131 collectives is staged through the host); float32 checks of
# 12 steps at 4 of llama3-8b's layers and at 2 of qwen3-moe's; one
# deadline for both ranks; a bf16 logit's size for the near-tie bound
PLACED_WORLD, PLACED_REQUESTS, PLACED_CHECK_LAYERS = 2, 4, 4
PLACED_CHECK_STEPS, PLACED_MOE_LAYERS = 12, 2
PLACED_DEADLINE, PLACED_LOGIT_SCALE = 900, 8.0
# placed prefills: a 4096-token prompt at batch 1; mamba2 and zamba2
# served 8 new tokens from the first 16 of the serve run's prompts
PLACED_PREFILL, PLACED_SSM_PROMPT, PLACED_SSM_NEW = 4096, 16, 8
# placed training: float32 checks of 2 steps at batch 1 of 512 tokens (two
# mamba2 chunks; qwen3's 1-layer state fills 60 GB whatever the length)
# against one process, each rank's blocks compared through 16 float64
# Gaussian projections each (their difference's mean square estimates
# the squared L2 norm of the blocks' difference, spread sqrt(2 / 16));
# one bf16 timing: stablelm-3b at 8 of 32 layers, 2 steps of 2 x 4096
PLACED_TRAIN_STEPS, PLACED_TRAIN_SEQ, PLACED_SKETCH = 2, 512, 16
PLACED_TIMING_LAYERS, PLACED_TIMING_BATCH = 8, 2
SKETCH_CHUNK = 1 << 21
# lsm run: the engine at default_config("tiny") (22,528 keys of 1,000 B),
# every cell 20,000 ops against its CPU twin; at default_config("medium")
# (720,896 keys) 200,000 ops a cell (the reference's `full` profile),
# host syncs counted over a clone's first 20,000 ops; the twin (a
# subprocess started with the phase) given LSM_TWIN_DEADLINE s more once
# the card's cells are done
LSM_VALUE, LSM_TINY_OPS, LSM_SCALE_OPS, LSM_SYNC_OPS = 1000, 20_000, \
    200_000, 20_000
LSM_TINY_CELLS = ([(s, m, "hotspot") for s in ("hotrap", "rocksdb_tiered")
                   for m in ("RO", "RW", "WH", "UH", "SR")]
                  + [("hotrap", "RO", "zipfian"), ("hotrap", "RO", "uniform")])
LSM_TWIN_SCALE_CELL, LSM_TWIN_DEADLINE = ("hotrap", "RO"), 600
LSM_SCALE = "medium"
# lsm durability and clusters: `hotrap` with the WAL at tiny, 20,000
# hotspot-5% RW ops with one site armed to crash at its visit in
# LSM_WAL_HITS (about half of the run's visits), recovery, then
# LSM_AFTER_OPS more ops; 4 hash shards with HotBudget at tiny under the
# mixes of LSM_CLUSTER_OPS; a 2-shard range cluster with the WAL, through
# a forced split and merge in LSM_SEGMENT_OPS-op segments, and crashed
# at each migration site; at medium the cluster shape of
# `configs.hotrap_kv.shard_config()` with the WAL
LSM_WAL_HITS = {"mid-flush": 20, "mid-compaction": 88,
                "mid-promotion-install": 9}
LSM_MIGRATION_SITES = ("mid-migration-stream", "mid-cutover")
LSM_AFTER_OPS, LSM_SEGMENT_OPS = 2_000, 5_000
LSM_CLUSTER_OPS = {"RO": 20_000, "RW": 20_000, "SR": 1_000}
# lsm, the compared systems, the sanitizer and the observability plane:
# `mutant`, `sas_cache` and `prismdb` at tiny under the mixes of
# LSM_COMPARED_OPS (their reads take the per-key path, about 330 µs a
# get on the card: 5,000 and 1,000 ops keep the nine cells near 12 s);
# `hotrap` RW and
# the range cluster's split and merge under the sanitizer, sweeping every
# LSM_SANITIZE_EVERY of its ops (the runner's batched calls: about 22 in
# 20,000 ops); hash4 RW and the medium cluster's RW with
# `Observability()` attached; `sas_cache` RO at medium, LSM_SCALE_OPS ops
# or as many as LSM_SAS_BUDGET_S s take at the tiny RO cell's µs an op
# (host syncs over LSM_SAS_SYNC_OPS), against a second CPU twin
LSM_COMPARED = ("mutant", "sas_cache", "prismdb")
LSM_COMPARED_OPS = {"RO": 5_000, "RW": 5_000, "SR": 1_000}
LSM_SANITIZE_EVERY, LSM_SAS_BUDGET_S, LSM_SAS_SYNC_OPS = 4, 60.0, 2_000


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail_on(phase: str, checks: dict) -> None:
    """Exit naming the checks of `phase` that failed, if any did."""
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"{phase} phase failed: {failed}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms(fn, flush: torch.Tensor | None, reps: int = REPS) -> float:
    """Median device time of `fn` in ms over `reps` calls, each after a
    write of `flush` (larger than the 50 MB L2, so every call starts
    cold; None: warm caches).  The calls queue behind a spin kernel, so
    the host's launch time does not show between the events."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        if flush is not None:
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


def shares(ms: float, bound_ms: float, library_ms) -> dict:
    """share_of_bound = bound / kernel time; vs_library = kernel time /
    the one PyTorch call's (None where there is none)."""
    return dict(share_of_bound=bound_ms / ms,
                vs_library=None if library_ms is None else ms / library_ms)


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


def tracker_config(n_units: int):
    """The tiered run's tracker: llama3-8b KV pages of one layer (64 KiB),
    a fast tier of one page in 8."""
    from repro_torch.tiering import TrackerConfig
    return TrackerConfig(n_units=n_units, unit_bytes=65_536,
                         fast_bytes=(n_units // 8) * 65_536)


STATE_FIELDS = ("tick", "score", "c", "t", "seen", "now", "accessed_bytes",
                "accessed_bytes_r", "hot_limit", "threshold")


def state_mismatch(got, want) -> list[str]:
    """The tracker state fields whose bits differ."""
    return [k for k in STATE_FIELDS
            if got[k].dtype != want[k].dtype
            or not torch.equal(got[k].reshape(-1).view(torch.uint8),
                               want[k].reshape(-1).view(torch.uint8))]


def ralt_record_case(ops, hotness, dev, g, flush, N: int,
                     n_ids: int) -> dict:
    """One fused tracker record against `record_accesses` on the card, from
    a drawn state whose clock remainders sit just below a slice and an
    R-byte boundary (so the record advances `now` and decrements c);
    every field bit for bit.  Times: L2 flushed and warm."""
    cfg = tracker_config(N)
    every = float(np.float32(cfg.gamma * cfg.fast_bytes))
    R = float(np.float32(cfg.hot_hi_frac * cfg.fast_bytes))
    st = hotness.init_state(cfg, dev)
    st.update(
        tick=torch.randint(0, 60, (N,), generator=g, device=dev,
                           dtype=torch.int32),
        score=torch.rand(N, generator=g, device=dev) * 5,
        c=torch.rand(N, generator=g, device=dev) * cfg.c_max,
        t=torch.rand(N, generator=g, device=dev) < 0.3,
        seen=torch.rand(N, generator=g, device=dev) < 0.6,
        now=torch.tensor(60, dtype=torch.int32, device=dev),
        accessed_bytes=torch.tensor(every - 1000.0, device=dev),
        accessed_bytes_r=torch.tensor(R - 100.0, device=dev))
    ids = np.random.default_rng(N + n_ids).choice(N, n_ids, replace=False)
    mask = torch.zeros(N, dtype=torch.bool, device=dev)
    mask[torch.from_numpy(ids).to(dev)] = True
    want = hotness.record_accesses(st, mask, cfg)
    got = ops.ralt_record_({k: v.clone() for k, v in st.items()}, ids, cfg)
    bad = state_mismatch(got, want)
    err = max(float((got[k].float() - want[k].float()).abs().max())
              for k in ("score", "c", "accessed_bytes", "accessed_bytes_r"))
    advanced = int(got["now"]) > 60 and int(want["now"]) > 60
    run = {k: v.clone() for k, v in st.items()}

    def kernel():
        nonlocal run
        run = ops.ralt_record_(run, ids, cfg)

    ms = device_ms(kernel, flush)
    warm_ms = device_ms(kernel, None)
    plain_ms = device_ms(lambda: hotness.record_accesses(st, mask, cfg), flush)
    # tick, score, c read and written (4 B each), t and seen (1 B each);
    # the ids and both clock rows; ~30 float32 operations a unit
    b_ms, b_by = bound(28 * N + 4 * n_ids + 32, 30 * N, torch.float32)
    return dict(N=N, ids=n_ids, ok=not bad and advanced,
                mismatched_fields=bad, slice_advanced=advanced,
                max_abs_err=err, tol="bit for bit", kernel_ms=ms,
                kernel_warm_l2_ms=warm_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                **shares(ms, b_ms, None))


def decode_case(ops, ref, dev, g, flush, B, H, KVH, D, S, valid,
                dtype) -> dict:
    """The float decode kernel against the plain version, and its row lse
    (the placed path's merge input) against `decode_attention_partial`'s
    m + log l within LSE_TOL; its time with the lse store beside the
    time without."""
    from repro_torch.models.common import decode_attention_partial
    q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, KVH, S, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, KVH, S, D, generator=g, device=dev).to(dtype)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    out, lse = ops.decode_attention_head_major(q, k, v, valid,
                                               return_lse=True)
    outs = [ops.decode_attention_head_major(q, k, v, valid), out]
    want = ref.decode_attention_ref(q, kt, vt, valid)
    if S <= 4096:      # the reference layout's entry point, same kernel
        outs.append(ops.decode_attention(q, kt.contiguous(), vt.contiguous(),
                                         valid))
    agree = decode_agrees(outs, want, TOL[dtype])
    _, l_p, m_p = decode_attention_partial(q, kt, vt, valid)
    lse_err = float((lse - (m_p + torch.log(l_p)).reshape(B, H)).abs().max())
    agree["ok"] = agree["ok"] and lse_err <= LSE_TOL
    q4, kv, vv = q[:, :, None], k[:, :, :valid], v[:, :, :valid]
    lib = F.scaled_dot_product_attention(q4, kv, vv, enable_gqa=True)
    lib_err = float((lib[:, :, 0].float() - want.float()).abs().max())
    ms = device_ms(lambda: ops.decode_attention_head_major(q, k, v, valid),
                   flush)
    lse_ms = device_ms(lambda: ops.decode_attention_head_major(
        q, k, v, valid, return_lse=True), flush)
    plain_ms = device_ms(lambda: ref.decode_attention_ref(q, kt, vt, valid),
                         flush)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q4, kv, vv, enable_gqa=True), flush)
    item = q.element_size()
    n_bytes = 2 * B * KVH * valid * D * item + 2 * B * H * D * item
    b_ms, b_by = bound(n_bytes, 4 * B * H * valid * D + 5 * B * H * valid,
                       dtype)
    return dict(shape=dict(B=B, H=H, KVH=KVH, D=D, S=S, valid_len=valid),
                dtype=str(dtype).removeprefix("torch."), **agree,
                tol=TOL[dtype], lse_max_abs_err=lse_err, lse_tol=LSE_TOL,
                library_max_abs_err=lib_err, kernel_ms=ms,
                kernel_ms_with_lse=lse_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                **shares(ms, b_ms, library_ms))


def decode_int8_case(ops, ref, quantize_kv, dev, g, flush, B, H, KVH, D, S,
                     valid, slot=None) -> dict:
    """The int8-cache decode kernel against the plain version: bf16 q, the
    cache quantized from bf16 rows as the model's decode step does
    (`attention.quantize_kv`).  With `slot`, the model's call: one launch
    quantizes a new token's k and v, writes them at `slot` and attends;
    the written payload and scales are held bit for bit against
    `quantize_kv`, the output against the plain version over the cache
    that `quantize_kv` and the writes leave.  No single PyTorch call
    attends over an int8 cache with per-token scales."""
    bf16 = torch.bfloat16
    q = torch.randn(B, H, D, generator=g, device=dev).to(bf16)
    k, ks = quantize_kv(torch.randn(B, KVH, S, D, generator=g,
                                    device=dev).to(bf16))
    v, vs = quantize_kv(torch.randn(B, KVH, S, D, generator=g,
                                    device=dev).to(bf16))
    scales = dict(k_scale=ks, v_scale=vs)
    appended = {}
    if slot is None:
        def kernel(return_lse=False):
            return ops.decode_attention_head_major(q, k, v, valid, **scales,
                                                   return_lse=return_lse)
    else:
        k_new, v_new = (torch.randn(B, KVH, D, generator=g, device=dev).to(
            bf16) for _ in range(2))
        (k8, s8), (v8, sv) = quantize_kv(k_new), quantize_kv(v_new)
        want_rows = (k8, v8, s8, sv)
        caches = [t.clone() for t in (k, v, ks, vs)]

        def kernel(return_lse=False):
            return ops.decode_attention_int8_append(
                q, k_new, v_new, *caches, slot, valid, return_lse=return_lse)
    outs = [kernel()]
    out_l, lse = kernel(True)
    outs.append(out_l)
    if slot is not None:
        torch.cuda.synchronize()
        appended = dict(slot=slot, appended_bit_for_bit=all(
            torch.equal(c[:, :, slot].contiguous().view(torch.uint8),
                        w.contiguous().view(torch.uint8))
            for c, w in zip(caches, want_rows)))
        for t, w in zip((k, v, ks, vs), want_rows):
            t[:, :, slot] = w
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    want, want_lse = ref.decode_attention_ref(q, kt, vt, valid, ks, vs,
                                              return_lse=True)
    agree = decode_agrees(outs, want, TOL[bf16])
    lse_err = float((lse - want_lse).abs().max())
    agree["ok"] = agree["ok"] and lse_err <= LSE_TOL
    if slot is not None:
        agree["ok"] = agree["ok"] and appended["appended_bit_for_bit"]
    ms = device_ms(kernel, flush)
    lse_ms = device_ms(lambda: kernel(True), flush)
    plain_ms = device_ms(lambda: ref.decode_attention_ref(q, kt, vt, valid,
                                                          ks, vs), flush)
    # int8 K and V rows and their two float32 scales, q and out in bf16;
    # with the append its k and v read, one row and two scales written
    n_bytes = 2 * B * KVH * valid * (D + 4) + 2 * B * H * D * 2
    if slot is not None:
        n_bytes += 2 * B * KVH * (2 * D + D + 4)
    b_ms, b_by = bound(n_bytes, 4 * B * H * valid * D + 7 * B * H * valid,
                       bf16)
    return dict(shape=dict(B=B, H=H, KVH=KVH, D=D, S=S, valid_len=valid),
                dtype="bfloat16", cache="int8", **appended, **agree,
                tol=TOL[bf16], lse_max_abs_err=lse_err, lse_tol=LSE_TOL,
                kernel_ms=ms, kernel_ms_with_lse=lse_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                **shares(ms, b_ms, None))


def empty_shard_case(ops, ref, quantize_kv, dev, g, B, H, KVH, D, S,
                     int8: bool) -> dict:
    """A sequence shard that holds no filled row (local valid length 0):
    the kernel's output 0 and lse -inf, as the plain version gives, in
    one launch; the int8 kernel with no slot to append to."""
    bf16 = torch.bfloat16
    q = torch.randn(B, H, D, generator=g, device=dev).to(bf16)
    k, v = (torch.randn(B, KVH, S, D, generator=g, device=dev).to(bf16)
            for _ in range(2))
    scales = {}
    name = "decode_attention"
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
        name = "decode_attention_int8"
    before = ops.LAUNCHES[name]
    if int8:
        new = torch.randn(B, KVH, D, generator=g, device=dev).to(bf16)
        out, lse = ops.decode_attention_int8_append(
            q, new, new, k, v, ks, vs, None, 0, return_lse=True)
    else:
        out, lse = ops.decode_attention_head_major(q, k, v, 0,
                                                   return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = ref.decode_attention_ref(
        q, k.transpose(1, 2), v.transpose(1, 2), 0, return_lse=True,
        **scales)
    return dict(shape=dict(B=B, H=H, KVH=KVH, D=D, S=S, valid_len=0),
                cache="int8" if int8 else "bfloat16",
                ok=bool(torch.equal(out, want) and torch.equal(lse, want_lse)
                        and torch.isneginf(lse).all()
                        and ops.LAUNCHES[name] == before + 1),
                max_abs_err=float(out.float().abs().max()),
                lse_all_minus_inf=bool(torch.isneginf(lse).all()))


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


def scaled_excess(got, want, tol) -> float:
    """excess() at rtol `tol` and an atol of `tol` or a tenth of the RMS
    of `want`, whichever is less.  A bf16 attention output over a few
    thousand keys is a few hundredths in size, so an atol of 2e-2 alone
    would pass a kernel that drops a key tile or a split of the cache."""
    rms = float(want.float().pow(2).mean().sqrt())
    return excess(got, want, tol, min(tol, 0.1 * rms))


def flash_agrees(got, lse, want, want_lse, tol) -> dict:
    """The flash kernel's output and row lse against the plain version's:
    the output within scaled_excess, the lse within LSE_TOL."""
    over = scaled_excess(got, want, tol)
    lse_err = float((lse - want_lse).abs().max())
    return dict(ok=over <= 1.0 and lse_err <= LSE_TOL,
                max_abs_err=float((got.float() - want.float()).abs().max()),
                err_over_tol=over, lse_max_abs_err=lse_err)


def decode_agrees(outs, want, tol) -> dict:
    """Each of the decode kernel's outputs against the plain version's:
    within `tol` absolute and within scaled_excess."""
    err = max(float((o.float() - want.float()).abs().max()) for o in outs)
    over = max(scaled_excess(o, want, tol) for o in outs)
    return dict(ok=err <= tol and over <= 1.0, max_abs_err=err,
                err_over_tol=over)


def flash_case(ops, fa, dev, g, flush, B, S, H, KVH, D, window,
               dtype) -> dict:
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, KVH, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, KVH, D, generator=g, device=dev).to(dtype)
    got, lse = ops.flash_attention_fwd(q, k, v, window=window)
    want, want_lse = fa.flash_attention_plain(q, k, v, window=window)
    tol = TOL[dtype]
    agree = flash_agrees(got, lse, want, want_lse, tol)
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
                dtype=str(dtype).removeprefix("torch."), **agree, tol=tol,
                lse_tol=LSE_TOL, library_max_abs_err=lib_err, kernel_ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                **shares(ms, b_ms, library_ms), visible_pairs=pairs)


def ssd_case(ops, ssd, dev, g, flush, B, nC, Q, nh, hp, ns, dtype,
             dt_scale=1.0) -> dict:
    """The mixer's form (`ssd_scan_fwd`, y in float32) against the plain
    chunk scan; inputs drawn as tests/test_kernels.py draws them, dt times
    `dt_scale` (40: La falls by about 8,000 over a chunk, so exp(La_i -
    La_j) above the diagonal would overflow)."""
    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x, Bm, Cm = ((normal(*s) * 0.5).to(dtype) for s in (
        (B, nC, Q, nh, hp), (B, nC, Q, ns), (B, nC, Q, ns)))
    dt = F.softplus(normal(B, nC, Q, nh)) * dt_scale
    A = -torch.exp(normal(nh) * 0.2)
    y, h = ops.ssd_scan_fwd(x, Bm, Cm, dt, A)
    want_y, want_h = ssd.ssd_scan_plain(x, Bm, Cm, dt, A)
    tol = SSD_TOL[dtype]
    finite = bool(torch.isfinite(y).all() and torch.isfinite(h).all())
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
                dtype=str(dtype).removeprefix("torch."), dt_scale=dt_scale,
                ok=finite and over <= 1.0, finite=finite,
                max_abs_err=float((y - want_y).abs().max()),
                h_max_abs_err=float((h - want_h).abs().max()),
                err_over_tol=over, tol=tol, h_tol=SSD_H_TOL, kernel_ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


def kernels_phase(dev, flush, power: str) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ralt_score, ref
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.attention import quantize_kv
    from repro_torch.tiering import hotness

    g = torch.Generator(device=dev).manual_seed(0)
    ralt = [ralt_case(ops, ralt_score, dev, g, flush, n)
            for n in (N_PAGES, 16_777_216)]
    # the tiered run's record (one page id), the same at 16.8 M units, a
    # long id list by value and one through device memory; the expert
    # cache's (128 experts) and the embedding's (qwen3's vocab rows)
    record = [ralt_record_case(ops, hotness, dev, g, flush, n, k)
              for n, k in ((N_PAGES, 1), (16_777_216, 1),
                           (N_PAGES, ralt_score.param_ids()),
                           (N_PAGES, 5000), (128, 64), (151_936, 64))]
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
                  (4, 14, 2, 64, 4096, 3001, bf16),
                  # qwen3-moe's serving shape: G = 16, two slices of 8
                  (BATCH, 64, 4, 128, MAX_LEN, PROMPT + 1, bf16),
                  # gemma3's full 1024-slot ring (G 2, D 256), mixtral's
                  # serving shape (G 6), musicgen's (MHA, D 64)
                  (BATCH, 8, 4, 256, 1024, 1024, bf16),
                  (BATCH, 48, 8, 128, MAX_LEN, PROMPT + 1, bf16),
                  (BATCH, 32, 32, 64, MAX_LEN, PROMPT + 1, bf16),
                  # zamba2 (G 1, D 112): its serving shape, the step after
                  # the long prefill (the split path over 32,769 tokens)
                  # and the float32 hand-off check's first decoded token
                  (BATCH, 32, 32, 112, MAX_LEN, PROMPT + 1, bf16),
                  (1, 32, 32, 112, ZAMBA_LONG + DECODE_STEPS, ZAMBA_LONG + 1,
                   bf16),
                  (HANDOFF_BATCH, 32, 32, 112, HANDOFF_LEN + 1,
                   HANDOFF_LEN + 1, f32))]
    # the int8 cache: llama3's serving shape with the appended token (the
    # model's call), the long cache, qwen3's G 16 and gemma3's full D 256
    # ring with a wrapped slot (position 1,061)
    decode8 = [decode_int8_case(ops, ref, quantize_kv, dev, g, flush, *shape)
               for shape in ((BATCH, 32, 8, 128, MAX_LEN, PROMPT + 1, PROMPT),
                             (8, 32, 8, 128, 32_768, 30_001),
                             (BATCH, 64, 4, 128, MAX_LEN, PROMPT + 1, PROMPT),
                             (BATCH, 8, 4, 256, 1024, 1024, 1061 % 1024),
                             # zamba2's serving shape, D 112
                             (BATCH, 32, 32, 112, MAX_LEN, PROMPT + 1,
                              PROMPT))]
    # the placed serve's empty sequence shard: llama3's serving shape with
    # nothing filled, both kernels
    empty = [empty_shard_case(ops, ref, quantize_kv, dev, g, BATCH, 32, 8,
                              128, MAX_LEN // 2, int8)
             for int8 in (False, True)]
    flash = [flash_case(ops, fa, dev, g, flush, *shape)
             for shape in (
                 # the training path's shapes: stablelm-3b (D = 80, MHA)
                 # and llama3-8b's prefill (D = 128, G = 4); a ragged S;
                 # a window with D = 256; float32 at internvl2's widths
                 (1, TRAIN_SEQ, 32, 32, 80, None, bf16),
                 (1, PREFILL_LEN, 32, 8, 128, None, bf16),
                 (1, 4001, 32, 8, 128, None, bf16),
                 (1, 4096, 8, 4, 256, 96, bf16),
                 (1, 2048, 14, 2, 64, None, f32),
                 # qwen3-moe's prefill: G = 16, H = 64
                 (1, PREFILL_LEN, 64, 4, 128, None, bf16),
                 # gemma3's windowed prefill (D 256, window 1024) and
                 # mixtral's (G 6, window 4096)
                 (1, PREFILL_LEN, 8, 4, 256, 1024, bf16),
                 (1, MIXTRAL_PREFILL, 48, 8, 128, 4096, bf16),
                 # zamba2's prefill (D 112 = 64 + 32 + 16 columns, G 1);
                 # D 112 at G 4 with a window over a ragged S; the float32
                 # hand-off check's prefill
                 (1, PREFILL_LEN, 32, 32, 112, None, bf16),
                 (1, 3001, 32, 8, 112, 512, bf16),
                 (HANDOFF_BATCH, HANDOFF_LEN, 32, 32, 112, None, f32))]
    ssd_cases = [ssd_case(ops, ssd, dev, g, flush, *shape)
                 for shape in (
                     # mamba2-1.3b's prefill and training shape (4096
                     # tokens, bf16: the tensor-core passes); the same in
                     # float32 (the CUDA-core kernel); the hand-off
                     # check's 2 x 512 tokens in float32 and in bf16; the
                     # prefill shape under large decay
                     (1, 16, 256, 64, 64, 128, bf16),
                     (1, 16, 256, 64, 64, 128, f32),
                     (HANDOFF_BATCH, 2, 256, 64, 64, 128, f32),
                     (HANDOFF_BATCH, 2, 256, 64, 64, 128, bf16),
                     (1, 16, 256, 64, 64, 128, bf16, 40.0),
                     # zamba2's prefill (nh 112, hp 64, ns 64) and its
                     # float32 hand-off check
                     (1, 16, 256, 112, 64, 64, bf16),
                     (HANDOFF_BATCH, 2, 256, 112, 64, 64, f32))]
    torch.cuda.synchronize()
    emit("kernels", ralt_update=dict(
        tpu_counterpart="src/repro/kernels/ralt_score.py:78", cases=ralt),
        ralt_record=dict(
            tpu_counterpart="src/repro/kernels/ralt_score.py:78",
            cases=record),
        decode_attention=dict(
            tpu_counterpart="src/repro/kernels/decode_attention.py:106",
            cases=decode),
        decode_attention_int8=dict(
            tpu_counterpart="src/repro/kernels/decode_attention.py:106",
            cases=decode8),
        decode_empty_shard=empty,
        flash_attention=dict(
            tpu_counterpart="src/repro/kernels/flash_attention.py:111",
            cases=flash),
        ssd_scan=dict(tpu_counterpart="src/repro/kernels/ssd_scan.py:89",
                      cases=ssd_cases),
        peak_bytes_per_s=PEAK_BYTES, power_limit=power)
    bad = [c for c in ralt + record + decode + decode8 + empty + flash
           + ssd_cases if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    # the main path's shapes: the tracker's page table (one page a
    # record), the first generated token's decode step (bf16 and int8
    # caches), stablelm-3b's training attention, mamba2-1.3b's prefill
    # and training scan; and zamba2's: its prefill's attention and scan
    # and its serving decode step
    return {"ralt_update": ralt[0], "ralt_record": record[0],
            "decode_attention": decode[1], "decode_attention_int8": decode8[0],
            "flash_attention": flash[0], "ssd_scan": ssd_cases[0],
            "zamba2": {"flash_attention": flash[8],
                       "decode_attention": decode[11],
                       "ssd_scan": ssd_cases[5]}}


# ----------------------------------------------------------------------
# serve
# ----------------------------------------------------------------------
def reference_check(dev, arch: str = "llama3-8b", **over) -> float:
    """Logits of decode steps of `arch`'s smoke config (float32; `over`
    replaces fields, e.g. kv_quant), CUDA path against the CPU path that
    the tests hold to the reference: 12 steps into 16 slots, or 40 into
    64 past the 16-slot rings of a config with windowed layers."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(smoke_config(arch), **over)
    windowed = any(b.window for b in transformer.layer_blocks(cfg))
    steps, s_max = (40, 64) if windowed else (12, 16)
    cpu = torch.device("cpu")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     cpu)
    on_dev = tree_map(lambda t: t.to(dev), params)
    caches = (transformer.init_cache(cfg, 3, s_max, cpu),
              transformer.init_cache(cfg, 3, s_max, dev))
    rng = np.random.default_rng(5)
    err = 0.0
    for pos in range(steps):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3))
        want = transformer.decode_step(params, cfg, caches[0], toks, pos)
        got = transformer.decode_step(on_dev, cfg, caches[1], toks.to(dev),
                                      pos)
        err = max(err, float((got.cpu() - want).abs().max()))
    return err


def serve_run(eng, cfg, dev, requests: int = REQUESTS, prompt: int = PROMPT,
              decode_op: str = "decode_attention"
              ) -> tuple[dict, dict, dict, dict]:
    """`requests` requests of `prompt` random tokens and NEW new ones
    through `eng`, launches counted from zero, every step's logits
    checked for NaN; `decode_op` names the decode kernel the cache's
    dtype takes.  -> (results, checks, launches, {rid: tokens})."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import layer_blocks, padded_vocab
    from repro_torch.serving import engine

    # layers with a KV cache: every layer but zamba2's mamba2 layers
    attn_layers = sum(b.kind != "mamba2" for b in layer_blocks(cfg))
    rng = np.random.default_rng(0)
    for rid in range(requests):
        eng.submit(engine.Request(
            rid=rid, prompt=[int(t) for t in rng.integers(0, cfg.vocab,
                                                          prompt)],
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
    others = [op for op in ("decode_attention", "decode_attention_int8",
                            "decode_attention_int8_f32") if op != decode_op]
    out = dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               dtype=cfg.dtype, params=cfg.param_count(), batch=eng.batch,
               requests=requests, prompt_tokens=prompt, new_tokens=NEW,
               requests_completed=len(done), tokens=tokens,
               steps_used=eng.steps_used, wall_s=wall,
               tokens_per_s=tokens / wall, ms_per_step=wall * 1e3
               / eng.steps_used,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               decode_kernel=decode_op, decode_launches=launches[decode_op],
               ralt_launches=launches["ralt_update"],
               ralt_record_launches=launches["ralt_record"])
    V = padded_vocab(cfg)
    checks = {
        "every request completed": len(done) == requests and all(
            len(r.out) == NEW for r in done) and not eng.starved,
        "tokens < padded vocab": all(0 <= t < V for r in done
                                     for t in r.out),
        "no NaN logits": not bool(nan_seen),
        "decode kernel once per layer and step":
            launches[decode_op] == attn_layers * eng.steps_used,
        "no launch of another decode kernel": not any(launches[op]
                                                      for op in others),
    }
    return out, checks, launches, {r.rid: r.out for r in done}


def serve_phase(dev, power: str) -> tuple[dict, dict, float]:
    from repro_torch.configs import get_config
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
    out, checks, launches, tokens = serve_run(eng, cfg, dev)
    # the same requests again with the serving plane attached: the
    # plane reads, so the tokens and the decode launches are the same
    from repro_torch.obs.serving import ServingObservability
    obs = ServingObservability().attach(eng, "engine")
    eng.completed = []
    a_out, a_checks, a_launches, a_tokens = serve_run(eng, cfg, dev)
    spans = {name: obs.tracer.count(name, "B")
             for name in ("engine/prefill", "engine/decode")}
    attached = dict(wall_s=a_out["wall_s"], ms_per_step=a_out["ms_per_step"],
                    decode_launches=a_out["decode_launches"],
                    events=len(obs.tracer.events), spans=spans,
                    assigns=obs.tracer.count("engine/assign"),
                    dropped=obs.tracer.dropped,
                    trace_problems=obs.tracer.validate()[:5])
    emit("serve", **out, init_s=init_s,
         cuda_vs_cpu_logits_max_abs_err=ref_err, power_limit=power,
         attached=attached)
    checks.update({
        f"attached: {k}": v for k, v in a_checks.items()})
    checks.update({
        "attached: tokens equal the unattached run's": a_tokens == tokens,
        "attached: decode launches equal": a_launches["decode_attention"]
            == launches["decode_attention"],
        "attached: wave spans present": all(
            n == REQUESTS // BATCH for n in spans.values()),
        "attached: trace valid, nothing dropped":
            not attached["trace_problems"] and obs.tracer.dropped == 0})
    fail_on("serve", checks)
    return launches, tokens, out["ms_per_step"]


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


def tiered_pass(dev, cfg, hbm_bw: float, pcie_bw: float, obs=None):
    """A fresh `TieredKVCache` of `cfg` filled page by page, then READS
    hotspot single-page reads with launches counted from zero (`obs`
    attached first when given): (cache, load s, read wall s, launches,
    wrong elements)."""
    from repro_torch.kernels import ops
    from repro_torch.tiering import TieredKVCache

    t0 = time.perf_counter()
    kv = TieredKVCache(cfg, hbm_bw=hbm_bw, pcie_bw=pcie_bw, device=dev)
    if obs is not None:
        obs.attach(kv, "kv")
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
    return kv, load_s, wall, dict(ops.LAUNCHES), int(wrong)


def kv_state_mismatch(a, b) -> list[str]:
    """Fields of two `TieredKVCache`s' clocks and slot tables that
    differ (clock floats bit for bit)."""
    bad = [f"clock.{n}" for n in COUNTERS
           if getattr(a.clock, n) != getattr(b.clock, n)]
    bad += [n for n in ("tier", "slot_of", "page_of_slot", "version")
            if not np.array_equal(getattr(a, n), getattr(b, n))]
    if list(a.free_slots) != list(b.free_slots):
        bad.append("free_slots")
    if dict(a.staging) != dict(b.staging):
        bad.append("staging")
    if a.fast_hit_rate() != b.fast_hit_rate():
        bad.append("fast_hit_rate")
    return bad


def tiered_phase(dev, power: str) -> dict:
    from repro_torch.obs.serving import ServingObservability
    from repro_torch.tiering import KVTierConfig

    hbm_bw, pcie_bw = measured_bandwidths(dev)
    cfg = KVTierConfig(n_pages=N_PAGES, fast_slots=FAST_SLOTS,
                       page_tokens=16, kv_heads=8, head_dim=128,
                       n_layers=1, dtype="bfloat16")
    kv, load_s, wall, launches, wrong = tiered_pass(dev, cfg, hbm_bw,
                                                    pcie_bw)
    c = kv.clock
    out = dict(n_pages=N_PAGES, fast_slots=FAST_SLOTS,
               page_bytes=cfg.page_bytes, reads=READS,
               fast_hit_rate=kv.fast_hit_rate(), promoted=c.promoted,
               demoted=c.demoted, retained=c.retained, aborted=c.aborted,
               sweeps=c.sweeps, flushes=c.flushes, sim_s=c.total_s,
               hbm_bw_measured=hbm_bw, pcie_bw_measured=pcie_bw,
               load_s=load_s, wall_s=wall, reads_per_s=READS / wall,
               wrong_elements=wrong,
               ralt_record_launches=launches["ralt_record"],
               ralt_launches=launches["ralt_update"],
               decode_launches=launches["decode_attention"],
               power_limit=power)
    # the same reads on a fresh cache with the serving plane attached
    obs = ServingObservability()
    akv, _, a_wall, a_launches, a_wrong = tiered_pass(dev, cfg, hbm_bw,
                                                      pcie_bw, obs)
    differs = kv_state_mismatch(kv, akv)
    del kv, akv
    torch.cuda.empty_cache()
    out["attached"] = dict(
        wall_s=a_wall, us_per_read=a_wall / READS * 1e6,
        unattached_us_per_read=wall / READS * 1e6,
        ralt_record_launches=a_launches["ralt_record"],
        wrong_elements=a_wrong, differs=differs,
        events=len(obs.tracer.events), dropped=obs.tracer.dropped,
        instants={name: obs.tracer.count(name, "i") for name in (
            "page/retained", "page/promo_compaction", "page/promo_flush",
            "page/promo_abort")},
        spans={name: obs.tracer.count(name, "B")
               for name in ("kv/sweep", "kv/staging_flush")},
        metrics_samples=obs.metrics.n_samples,
        attribution_n_seen=obs.attr.n_seen,
        trace_problems=obs.tracer.validate()[:5])
    emit("tiered", **out)
    att = out["attached"]
    checks = {
        "hit rate beats fast_slots / n_pages":
            out["fast_hit_rate"] > FAST_SLOTS / N_PAGES,
        "fused tracker kernel once per read":
            launches["ralt_record"] == READS,
        "no other tracker launch": launches["ralt_update"] == 0,
        "every read returns its page": out["wrong_elements"] == 0,
        "attached: clock, hit rate and slot tables equal": not differs,
        "attached: ralt_record launches equal":
            a_launches["ralt_record"] == launches["ralt_record"],
        "attached: every read returns its page": a_wrong == 0,
        "attached: trace valid, nothing dropped":
            not att["trace_problems"] and att["dropped"] == 0,
        "attached: one record a read": att["attribution_n_seen"] == READS,
    }
    fail_on("tiered", checks)
    return launches


# ----------------------------------------------------------------------
# tracker
# ----------------------------------------------------------------------
def numpy_sampler(now, n, n_units):
    """Threshold draws shared by a card and a CPU tracker (the torch CPU
    and CUDA generators differ)."""
    return np.random.default_rng(now).integers(0, n_units, n)


def tracker_phase(dev, power: str) -> dict:
    """The tracker at N_PAGES units over TRACKER_READS single-page reads of
    the hotspot stream, limits refreshed every 64 reads as the tiered
    cache's sweeps do: the `HotTracker` on the card, the functional
    `record_accesses` / `update_limits` on the card and the `HotTracker`
    on the CPU, one numpy sampler (the torch CPU and CUDA generators
    differ); every state field bit for bit at every refresh."""
    from repro_torch.kernels import ops
    from repro_torch.tiering import HotTracker, hotness

    sampler = numpy_sampler
    cfg = tracker_config(N_PAGES)
    card = HotTracker(cfg, device=dev, sampler=sampler)
    cpu = HotTracker(cfg, device="cpu", sampler=sampler)
    state = hotness.init_state(cfg, dev)
    ops.reset_launches()
    mismatches, refreshes = [], 0
    for i, p in enumerate(hotspot_stream(N_PAGES, TRACKER_READS, seed=1)):
        card.record_ids([p])
        mask = torch.zeros(N_PAGES, dtype=torch.bool, device=dev)
        mask[p] = True
        state = hotness.record_accesses(state, mask, cfg)
        cpu.record_ids([p])
        if i % 64 == 63:
            card.refresh_limits()
            cpu.refresh_limits()
            state = hotness.update_limits(state, cfg, sampler)
            refreshes += 1
            for name, st in (("card", card.state), ("functional", state)):
                bad = state_mismatch({k: v.cpu() for k, v in st.items()},
                                     cpu.state)
                if bad:
                    mismatches.append(dict(read=i, tracker=name,
                                           fields=bad))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    out = dict(n_units=N_PAGES, reads=TRACKER_READS, refreshes=refreshes,
               now=int(card.state["now"]), mismatches=mismatches[:10],
               ralt_record_launches=launches["ralt_record"],
               ralt_launches=launches["ralt_update"], power_limit=power)
    emit("tracker", **out)
    checks = {
        "card and functional trackers match the CPU bit for bit":
            not mismatches,
        "slices advance": out["now"] > 0,
        "fused kernel once per HotTracker record":
            launches["ralt_record"] == TRACKER_READS,
        "RALT kernel once per functional record":
            launches["ralt_update"] == TRACKER_READS,
    }
    fail_on("tracker", checks)
    return launches


# ----------------------------------------------------------------------
# prefill
# ----------------------------------------------------------------------
def prefill_vs_decode(cfg, params, prompt, dev) -> dict:
    """The prefill step's last logits and k/v against what teacher-forced
    decode steps leave (`tests/test_arch_smoke.py:62-78`), as err/tol
    (at most 1 inside the allclose tolerance 2e-2) per layer and
    overall.  A windowed layer's ring of W slots holds the last W
    positions, position p in slot p % W; another layer's cache every
    position."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer

    last, cache = make_prefill_step(cfg)(params, {"tokens": prompt})
    decode_cache = transformer.init_cache(cfg, 1, prompt.shape[1], dev)
    with torch.no_grad():
        for pos in range(prompt.shape[1]):
            logits = transformer.decode_step(params, cfg, decode_cache,
                                             prompt[:, pos], pos)
    tol = TOL[torch.bfloat16]
    T, by_layer = prompt.shape[1], []
    for c, d in zip(cache, decode_cache):
        held = torch.arange(T - d["k"].shape[2], T, device=dev)
        slot = held % d["k"].shape[2]
        by_layer.append(max(excess(c[name][:, held],
                                   d[name][:, :, slot].transpose(1, 2), tol,
                                   tol) for name in ("k", "v")))
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
    fail_on("prefill", checks)
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
    fail_on("train", checks)
    return launches, losses


# ----------------------------------------------------------------------
# mamba2
# ----------------------------------------------------------------------
def decode_cache_from(cfg, cache, s_max: int, dev) -> list:
    """The decode cache that continues from a prefill step's `cache`:
    mamba2 states as they are, attention k/v (B, S, KV, hd) written
    head-major into the first S of `s_max` slots."""
    from repro_torch.models import transformer

    batch = next(iter(cache[0].values())).shape[0]
    out = transformer.init_cache(cfg, batch, s_max, dev)
    for o, c in zip(out, cache):
        for name, t in c.items():
            if name in ("k", "v"):
                o[name][:, :, :t.shape[1]] = t.transpose(1, 2)
            else:
                o[name].copy_(t)
    return out


def mamba2_handoff(cfg, params, prompt, dev) -> dict:
    """The prefill step over prompt[:, :-1] against teacher-forced decode
    steps over the same tokens: last logits and every layer's cache (a
    mamba2 layer's ssm and conv state, an attention layer's k/v), then
    the logits of the last token decoded from each cache; as err/tol (at
    most 1 inside allclose 2e-2).  Launches of the prefill counted from
    zero."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer

    B, T = prompt.shape[0], prompt.shape[1] - 1
    ops.reset_launches()
    last, cache = make_prefill_step(cfg)(params, {"tokens": prompt[:, :T]})
    launches = dict(ops.LAUNCHES)
    dcache = transformer.init_cache(cfg, B, T + 1, dev)
    tol = TOL[torch.bfloat16]

    def layer_over(c, d):
        if "ssm" in c:
            return max(excess(c[n], d[n], tol, tol) for n in ("ssm", "conv"))
        return max(excess(c[n], d[n][:, :, :T].transpose(1, 2), tol, tol)
                   for n in ("k", "v"))

    with torch.no_grad():
        for pos in range(T):
            logits = transformer.decode_step(params, cfg, dcache,
                                             prompt[:, pos], pos)
        by_layer = [layer_over(c, d) for c, d in zip(cache, dcache)]
        logits_over = excess(last, logits, tol, tol)
        nxt = [transformer.decode_step(params, cfg, c, prompt[:, T], T)
               for c in (decode_cache_from(cfg, cache, T + 1, dev), dcache)]
    next_over = excess(nxt[0], nxt[1], tol, tol)
    return dict(err_over_tol=max(by_layer + [logits_over, next_over]),
                logits_err_over_tol=logits_over,
                next_logits_err_over_tol=next_over,
                next_logits_max_abs_err=float((nxt[0] - nxt[1]).abs().max()),
                state_err_over_tol_by_layer=by_layer,
                ssd_launches=launches["ssd_scan"],
                flash_launches=launches["flash_attention"],
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
    fail_on("mamba2", checks)
    return launches


# ----------------------------------------------------------------------
# moe
# ----------------------------------------------------------------------
def moe_phase(dev, power: str, arch: str = MOE_ARCH, layers: int = MOE_LAYERS,
              prefill_len: int = PREFILL_LEN, phase: str = "moe") -> dict:
    """A MoE model (qwen3-moe-235b-a22b; mixtral-8x22b, its blocks
    windowed) at full width, cut to `layers` layers of its block: (a)
    prefill against teacher-forced decode at MOE_CHECK_LAYERS layers in
    float32 with cf = E/K, so that prefill drops nothing (the smoke
    configs' rule); (b) `ServeEngine` over REQUESTS requests (dropless
    decode); (c) one timed `prefill_len`-token prefill at the published
    cf, after an untimed one that counts the dropped assignments."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe
    from repro_torch.serving import engine
    from repro_torch.tree import tree_leaves, tree_map

    ref_err = reference_check(dev, arch)
    full = get_config(arch)
    block = full.stages[0][1][0]
    cfg = dataclasses.replace(full, stages=((layers, (block,)),))
    E, K, d, ff = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = engine.ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, seed=0,
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = eng.params
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in [params["lm_head"]] + [
                           w for layer in params["layers"]
                           for w in tree_leaves(layer)])
    # (a) the seeded bf16 weights of the first layers computed in float32
    cfg32 = dataclasses.replace(
        cfg, stages=((MOE_CHECK_LAYERS, (block,)),), dtype="float32",
        capacity_factor=E / K)
    params32 = {k: tree_map(lambda t: t.float(), v)
                for k, v in params.items() if k != "layers"}
    params32["layers"] = [tree_map(lambda t: t.float(), layer)
                          for layer in params["layers"][:MOE_CHECK_LAYERS]]
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (1, PREFILL_CHECK))).to(dev)
    ops.reset_launches()
    check = prefill_vs_decode(cfg32, params32, prompt, dev)
    check_launches = dict(ops.LAUNCHES)
    check_mem = torch.cuda.max_memory_allocated(dev)
    del params32
    torch.cuda.empty_cache()
    # (b) serve
    torch.cuda.reset_peak_memory_stats(dev)
    serve, serve_checks, launches, _ = serve_run(eng, cfg, dev)
    expert_bytes = layers * E * 3 * d * ff * 2
    serve.update(step_bytes=weight_bytes,
                 step_bound_ms=weight_bytes / PEAK_BYTES * 1e3,
                 expert_bytes=expert_bytes,
                 expert_bound_ms=expert_bytes / PEAK_BYTES * 1e3)
    # (c) prefill at the published capacity factor
    prefill = make_prefill_step(cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (1, prefill_len))).to(dev)
    kept, assigned, capacities = [], [], set()
    real = moe.moe_ffn

    def counting(p, x, c, dropless=False):
        xf = x.reshape(-1, x.shape[-1])
        C = moe.capacity(xf.shape[0], c, dropless)
        _, eidx = moe.route(p["router"], xf, c)
        kept.append(moe.kept(eidx, c.n_experts, C).sum())
        assigned.append(eidx.numel())
        capacities.add(C)
        return real(p, x, c, dropless)

    moe.moe_ffn = counting
    try:
        prefill(params, {"tokens": tokens})     # warm-up, same shape
    finally:
        moe.moe_ffn = real
    dropped = 1 - float(sum(kept)) / sum(assigned)
    dropped_by_layer = [1 - float(k) / a for k, a in zip(kept, assigned)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    last, _ = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = dict(ops.LAUNCHES)
    prefill_mem = torch.cuda.max_memory_allocated(dev)
    res = dict(
        model=cfg.name, layers=cfg.n_layers, full_layers=full.n_layers,
        reduced=[f"layers: {layers} of {full.n_layers}"],
        d_model=d, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        window=block.window,
        experts=E, top_k=K, expert_d_ff=ff, vocab=cfg.vocab,
        dtype=cfg.dtype, params=cfg.param_count(),
        full_params=full.param_count(), init_s=init_s,
        cuda_vs_cpu_smoke_logits_max_abs_err=ref_err,
        prefill_vs_decode_f32=dict(
            layers=MOE_CHECK_LAYERS, tokens=PREFILL_CHECK,
            capacity_factor=E / K, tol=TOL[torch.bfloat16],
            max_memory_allocated=check_mem,
            flash_launches=check_launches["flash_attention"],
            decode_launches=check_launches["decode_attention"], **check),
        serve=serve,
        prefill=dict(tokens=prefill_len,
                     capacity_factor=cfg.capacity_factor,
                     capacity=sorted(capacities),
                     dropped_share=dropped,
                     dropped_share_by_layer=dropped_by_layer,
                     prefill_s=prefill_s,
                     tokens_per_s=prefill_len / prefill_s,
                     max_memory_allocated=prefill_mem,
                     flash_launches=prefill_launches["flash_attention"],
                     finite=bool(torch.isfinite(last).all())),
        power_limit=power)
    emit(phase, **res)
    fail_on(phase, {
        "CUDA decode logits match the CPU path's (smoke, 1e-4)":
            ref_err <= 1e-4,
        "prefill matches teacher-forced decode (float32)":
            check["err_over_tol"] <= 1.0 and check["finite"],
        "check: flash once per layer, decode once per layer and step":
            check_launches["flash_attention"] == MOE_CHECK_LAYERS
            and check_launches["decode_attention"]
            == MOE_CHECK_LAYERS * PREFILL_CHECK,
        **serve_checks,
        "prefill: flash kernel once per layer":
            prefill_launches["flash_attention"] == layers,
        "prefill: finite logits": res["prefill"]["finite"],
        "prefill under 80 GB": prefill_mem < 80e9,
    })
    return launches


# ----------------------------------------------------------------------
# caches
# ----------------------------------------------------------------------
COUNTERS = ("fast_hits", "slow_hits", "promoted", "demoted", "retained",
            "aborted", "sweeps", "flushes", "hbm_s", "pcie_s")


def clock_mismatch(a, b) -> list[str]:
    return [k for k in COUNTERS if getattr(a.clock, k) != getattr(b.clock, k)]


def timed_replay(call, stream) -> tuple[list, float]:
    """[call(x) for x in stream] on the card, launches counted from zero;
    -> (results, host µs per call)."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [call(x) for x in stream]
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e6 / len(stream)


def caches_phase(dev, power: str) -> dict:
    """`TieredEmbedding` and `ExpertCache` at qwen3's widths on the card,
    each against a CPU twin of the same class fed the same stream and
    threshold draws (the twin shares the pinned host data)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.tiering import ExpertCache, TieredEmbedding

    cfg = get_config(MOE_ARCH)
    hbm_bw, pcie_bw = measured_bandwidths(dev)
    V, d, E = cfg.vocab, cfg.d_model, cfg.n_experts
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    # the embedding as `init_params` draws it first, vocab rows only
    table_dev = (torch.randn(padded_vocab(cfg), d, generator=g, device=dev)
                 * d ** -0.5).to(torch.bfloat16)[:V]
    table = torch.empty(table_dev.shape, dtype=table_dev.dtype,
                        pin_memory=True)
    table.copy_(table_dev)
    rng = np.random.default_rng(0)
    lookups = [np.minimum(rng.zipf(1.3, EMB_IDS) - 1, V - 1)
               for _ in range(EMB_LOOKUPS)]
    embs = [TieredEmbedding(table, EMB_FAST, EMB_STAGING, hbm_bw=hbm_bw,
                            pcie_bw=pcie_bw, device=where,
                            sampler=numpy_sampler)
            for where in (dev, "cpu")]
    outs, emb_us = timed_replay(embs[0].lookup, lookups)
    emb_launches = dict(ops.LAUNCHES)
    wrong = sum(int((o != table_dev[torch.from_numpy(ids).to(dev)]).sum())
                for o, ids in zip(outs, lookups))
    del outs, table_dev
    twin_wrong = sum(int((embs[1].lookup(ids) != table[ids]).sum())
                     for ids in lookups)
    card, twin = embs
    emb = dict(
        vocab=V, d_model=d, table_bytes=table.numel() * table.element_size(),
        fast_rows=EMB_FAST, staging_slots=EMB_STAGING, lookups=EMB_LOOKUPS,
        ids_per_lookup=EMB_IDS, fast_hit_rate=card.fast_hit_rate(),
        promoted=card.clock.promoted, demoted=card.clock.demoted,
        retained=card.clock.retained, flushes=card.clock.flushes,
        sim_s=card.clock.total_s, host_us_per_lookup=emb_us,
        wrong_elements=wrong, twin_wrong_elements=twin_wrong,
        clock_mismatches=clock_mismatch(card, twin),
        tracker_mismatches=state_mismatch(
            {k: v.cpu() for k, v in card.tracker.state.items()},
            twin.tracker.state),
        ralt_record_launches=emb_launches["ralt_record"])
    emb_checks = {
        "embedding: every lookup the exact gather, card and twin":
            wrong == 0 and twin_wrong == 0,
        "embedding: clocks and tracker state equal the CPU twin's":
            not emb["clock_mismatches"] and not emb["tracker_mismatches"]
            and card.fast_hit_rate() == twin.fast_hit_rate(),
        "embedding: slot tables, free list and staging equal the twin's":
            np.array_equal(card.slot_of_row, twin.slot_of_row)
            and np.array_equal(card.row_of_slot, twin.row_of_slot)
            and card.free == twin.free
            and list(card.staging) == list(twin.staging),
        "embedding: one ralt_record per lookup":
            emb_launches["ralt_record"] == EMB_LOOKUPS,
        "embedding: rows promoted": card.clock.promoted > 0,
    }
    del embs, card, twin, table
    # one layer's experts: (gate, up, down^T) of each, (3, d, ff) bf16
    layer = moe.init_moe(cfg, g, dev)
    blobs_dev = torch.stack([layer["w_gate"], layer["w_up"],
                             layer["w_down"].transpose(1, 2)], dim=1)
    del layer
    blobs = torch.empty(blobs_dev.shape, dtype=blobs_dev.dtype,
                        pin_memory=True)
    blobs.copy_(blobs_dev)
    del blobs_dev
    steps = [np.bincount(np.minimum(rng.zipf(1.4, EXPERT_DRAWS) - 1, E - 1),
                         minlength=E) for _ in range(EXPERT_STEPS)]
    ecs = [ExpertCache(blobs, EXPERT_FAST, EXPERT_SWAP, hbm_bw=hbm_bw,
                       pcie_bw=pcie_bw, device=where, sampler=numpy_sampler)
           for where in (dev, "cpu")]
    _, route_us = timed_replay(ecs[0].route, steps)
    ec_launches = dict(ops.LAUNCHES)
    for counts in steps:
        ecs[1].route(counts)
    card, twin = ecs
    bad_blobs = [int(e) for s, e in enumerate(card.expert_of_slot)
                 if e >= 0 and not torch.equal(card.cache[s].cpu(), blobs[e])]
    ec = dict(
        experts=E, blob_bytes=card.blob_bytes,
        host_bytes=blobs.numel() * blobs.element_size(),
        fast_experts=EXPERT_FAST, swap_every=EXPERT_SWAP, steps=EXPERT_STEPS,
        draws_per_step=EXPERT_DRAWS,
        resident_fraction=card.resident_fraction(steps[-1]),
        twin_resident_fraction=twin.resident_fraction(steps[-1]),
        fast_hit_rate=card.clock.fast_hits
        / (card.clock.fast_hits + card.clock.slow_hits),
        promoted=card.clock.promoted, demoted=card.clock.demoted,
        retained=card.clock.retained, sweeps=card.clock.sweeps,
        sim_s=card.clock.total_s, host_us_per_route=route_us,
        resident=int((card.expert_of_slot >= 0).sum()),
        resident_blobs_differing=bad_blobs,
        clock_mismatches=clock_mismatch(card, twin),
        tracker_mismatches=state_mismatch(
            {k: v.cpu() for k, v in card.tracker.state.items()},
            twin.tracker.state),
        ralt_record_launches=ec_launches["ralt_record"])
    ec_checks = {
        "experts: every resident blob its host blob":
            not bad_blobs and ec["resident"] > 0,
        "experts: clocks, tracker state and resident fraction equal the "
        "CPU twin's": not ec["clock_mismatches"]
            and not ec["tracker_mismatches"]
            and ec["resident_fraction"] == ec["twin_resident_fraction"],
        "experts: slot tables and free list equal the twin's":
            np.array_equal(card.slot_of, twin.slot_of)
            and np.array_equal(card.expert_of_slot, twin.expert_of_slot)
            and card.free == twin.free,
        "experts: one ralt_record per route":
            ec_launches["ralt_record"] == EXPERT_STEPS,
        "experts: blobs promoted": card.clock.promoted > 0,
    }
    emit("caches", embedding=emb, experts=ec, hbm_bw_measured=hbm_bw,
         pcie_bw_measured=pcie_bw, power_limit=power)
    fail_on("caches", {**emb_checks, **ec_checks})
    return ec_launches


# ----------------------------------------------------------------------
# window
# ----------------------------------------------------------------------
def timed_prefill(cfg, params, dev, tokens, frontend_emb=None) -> dict:
    """One timed prefill of `tokens` after an untimed warm-up of the same
    shape, launches counted from zero: seconds, tokens/s, peak memory,
    flash and ssd launches, finite logits."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step

    prefill = make_prefill_step(cfg)
    batch = {"tokens": tokens}
    if frontend_emb is not None:
        batch["frontend_emb"] = frontend_emb
    prefill(params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    last, _ = prefill(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens=tokens.shape[1], prefill_s=wall,
                tokens_per_s=tokens.shape[1] / wall,
                max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                flash_launches=ops.LAUNCHES["flash_attention"],
                ssd_launches=ops.LAUNCHES["ssd_scan"],
                finite=bool(torch.isfinite(last).all()))


def window_phase(dev, power: str) -> dict:
    """gemma3-4b at full width and depth (34 layers, 5 windowed of 1024
    to 1 global): (a) a WINDOW_CHECK_LEN-token prefill against
    teacher-forced decode past the rings' wrap, at its first stage's 6
    layers in float32; (b) `ServeEngine` over BATCH requests of
    WINDOW_PROMPT + NEW tokens, so that every windowed ring wraps; (c)
    one timed PREFILL_LEN-token prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import engine
    from repro_torch.tree import tree_map

    ref_err = reference_check(dev, WINDOW_ARCH)
    cfg = get_config(WINDOW_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = engine.ServeEngine(cfg, batch=BATCH,
                             max_len=WINDOW_PROMPT + NEW + 8, seed=0,
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = eng.params
    rings = sorted({c["k"].shape[2] for c in eng.cache})
    # (a) the seeded bf16 weights of the first stage computed in float32
    first = cfg.stages[0][1]
    cfg32 = dataclasses.replace(cfg, stages=((1, first),), dtype="float32")
    params32 = {k: tree_map(lambda t: t.float(), v)
                for k, v in params.items() if k != "layers"}
    params32["layers"] = [tree_map(lambda t: t.float(), layer)
                          for layer in params["layers"][:len(first)]]
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (1, WINDOW_CHECK_LEN))).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    check = prefill_vs_decode(cfg32, params32, prompt, dev)
    check_launches = dict(ops.LAUNCHES)
    check_mem = torch.cuda.max_memory_allocated(dev)
    del params32
    torch.cuda.empty_cache()
    # (b) serve past the wrap
    torch.cuda.reset_peak_memory_stats(dev)
    serve, serve_checks, launches, _ = serve_run(eng, cfg, dev,
                                                 requests=BATCH,
                                                 prompt=WINDOW_PROMPT)
    # (c) prefill
    prefill = timed_prefill(cfg, params, dev, torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, PREFILL_LEN))).to(dev))
    res = dict(
        model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        windowed_layers=sum(bool(b.window)
                            for b in transformer.layer_blocks(cfg)),
        window=first[0].window, ring_slots=rings,
        dtype=cfg.dtype, params=cfg.param_count(), init_s=init_s,
        cuda_vs_cpu_smoke_logits_max_abs_err=ref_err,
        prefill_vs_decode_f32=dict(
            layers=len(first), tokens=WINDOW_CHECK_LEN,
            tol=TOL[torch.bfloat16], max_memory_allocated=check_mem,
            flash_launches=check_launches["flash_attention"],
            decode_launches=check_launches["decode_attention"], **check),
        serve=serve, prefill=prefill, power_limit=power)
    emit("window", **res)
    fail_on("window", {
        "CUDA decode logits match the CPU path's past the wrap (smoke, "
        "1e-4)": ref_err <= 1e-4,
        "prefill matches teacher-forced decode past the wrap (float32)":
            check["err_over_tol"] <= 1.0 and check["finite"],
        "check: flash once per layer, decode once per layer and step":
            check_launches["flash_attention"] == len(first)
            and check_launches["decode_attention"]
            == len(first) * WINDOW_CHECK_LEN,
        "rings of the window beside the global layers' caches":
            rings == [first[0].window, WINDOW_PROMPT + NEW + 8],
        **serve_checks,
        "prefill: flash kernel once per layer":
            prefill["flash_launches"] == cfg.n_layers,
        "prefill: finite logits": prefill["finite"],
        "under 80 GB": max(check_mem, serve["max_memory_allocated"],
                           prefill["max_memory_allocated"]) < 80e9,
    })
    return launches


# ----------------------------------------------------------------------
# dense
# ----------------------------------------------------------------------
def dense_phase(dev, power: str) -> None:
    """minitron-8b and musicgen-large at full width and depth: each the
    CUDA decode path's smoke logits against the CPU path's and REQUESTS
    requests through `ServeEngine`; musicgen one timed PREFILL_LEN-token
    prefill whose first AUDIO_FRAMES positions are a seeded audio
    `frontend_emb`."""
    from repro_torch.configs import get_config
    from repro_torch.serving import engine

    runs, checks = {}, {}
    for arch in DENSE_ARCHS:
        ref_err = reference_check(dev, arch)
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats(dev)
        eng = engine.ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, seed=0,
                                 device=dev)
        serve, serve_checks, _, _ = serve_run(eng, cfg, dev)
        run = dict(params=cfg.param_count(), heads=cfg.n_heads,
                   kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                   cuda_vs_cpu_smoke_logits_max_abs_err=ref_err, serve=serve)
        checks.update({f"{arch}: {k}": ok for k, ok in serve_checks.items()})
        checks[f"{arch}: CUDA decode logits match the CPU path's (smoke, "
               "1e-4)"] = ref_err <= 1e-4
        checks[f"{arch}: under 80 GB"] = serve["max_memory_allocated"] < 80e9
        if cfg.frontend == "audio":
            g = torch.Generator(device=dev).manual_seed(4)
            frames = torch.randn(1, AUDIO_FRAMES, cfg.d_model, generator=g,
                                 device=dev).to(getattr(torch, cfg.dtype))
            tokens = torch.from_numpy(np.random.default_rng(4).integers(
                0, cfg.vocab, (1, PREFILL_LEN))).to(dev)
            run["prefill"] = prefill = timed_prefill(cfg, eng.params, dev,
                                                     tokens, frames)
            run["prefill"]["frontend_frames"] = AUDIO_FRAMES
            checks[f"{arch}: prefill: flash kernel once per layer"] = \
                prefill["flash_launches"] == cfg.n_layers
            checks[f"{arch}: prefill: finite logits"] = prefill["finite"]
        runs[arch] = run
        del eng
        torch.cuda.empty_cache()
    emit("dense", **runs, power_limit=power)
    fail_on("dense", checks)


# ----------------------------------------------------------------------
# int8
# ----------------------------------------------------------------------
def int8_phase(dev, power: str, bf16_tokens: dict, bf16_ms: float) -> dict:
    """llama3-8b at full width with the int8 KV cache (`kv_quant`): the
    CUDA int8 decode path's smoke logits against the CPU path's (float32:
    the float kernel's int8 instantiation), then the `serve` phase's
    REQUESTS requests on the same seeded weights through the int8 kernel,
    one launch a layer and step (append and attention), whose greedy
    tokens are compared with the bf16 cache's (`bf16_tokens`; reported,
    not gated: the weights are random) and whose ms a step is set beside
    the `serve` phase's (`bf16_ms`, the same call)."""
    from repro_torch.configs import get_config
    from repro_torch.serving import engine

    ref_err = reference_check(dev, "llama3-8b", kv_quant=True)
    cfg = dataclasses.replace(get_config("llama3-8b"), kv_quant=True)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = engine.ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, seed=0,
                             device=dev)
    cache_bytes = sum(t.numel() * t.element_size()
                      for c in eng.cache for t in c.values())
    bf16_bytes = 2 * cfg.n_layers * BATCH * cfg.n_kv_heads * MAX_LEN \
        * cfg.head_dim * 2
    serve, checks, launches, tokens = serve_run(
        eng, cfg, dev, decode_op="decode_attention_int8")
    pairs = [(a, b) for rid, out in tokens.items()
             for a, b in zip(out, bf16_tokens[rid])]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    emit("int8", **serve, cache_bytes=cache_bytes, bf16_cache_bytes=bf16_bytes,
         cache_share_of_bf16=cache_bytes / bf16_bytes,
         greedy_agreement_with_bf16=agree,
         bf16_ms_per_step=bf16_ms,
         int8_over_bf16_step=serve["ms_per_step"] / bf16_ms,
         cuda_vs_cpu_smoke_logits_max_abs_err=ref_err, power_limit=power)
    fail_on("int8", {
        **checks,
        "CUDA int8 decode logits match the CPU path's (smoke, 1e-4)":
            ref_err <= 1e-4,
        "int8 cache under 0.65 x the bf16 cache's bytes":
            cache_bytes < 0.65 * bf16_bytes,
    })
    return launches


# ----------------------------------------------------------------------
# zamba2
# ----------------------------------------------------------------------
def zamba2_cut(cfg):
    """zamba2's stages with their repeats cut to ZAMBA_REPEATS: the
    hybrid pattern and the shared block's reuse kept, 15 of 81 layers."""
    return dataclasses.replace(cfg, stages=tuple(
        (r, blocks) for r, (_, blocks) in zip(ZAMBA_REPEATS, cfg.stages)))


def reference_leaf_count(tree) -> int:
    """Leaves of a tree in the reference's layout (`convert.
    params_to_reference`), a stage's stacked leaf counted once per layer
    it holds and each ``shared`` leaf once: the tensors a layer-by-layer
    tree of the same model must have."""
    from repro_torch.tree import named_leaves

    return sum(leaf.shape[0] if name.startswith("stages/") else 1
               for name, leaf in named_leaves(tree))


def zamba2_phase(dev, power: str) -> dict:
    """zamba2-7b at full width (d_model 3584, 32 heads of 112, SSM 112 x
    64 heads with state 64): (a) the CUDA decode path's smoke logits
    against the CPU path's; (b) a 2 x 512-token prefill against 512
    teacher-forced decode steps at the cut depth in float32: last logits,
    every mamba2 layer's ssm and conv state, every shared occurrence's
    k/v; at full depth, from seeded bf16 weights: (c) REQUESTS requests
    through `ServeEngine`; (d) one timed PREFILL_LEN-token prefill; (e)
    one ZAMBA_LONG-token prefill and DECODE_STEPS greedy decode steps
    from its cache; then (f) training at the cut depth as `train_run`
    runs it, the flash kernel against the plain attention core on step
    0, AdamW's leaves counted against the reference's."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_to_reference
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention, transformer
    from repro_torch.serving import engine
    from repro_torch.tree import tree_leaves, tree_map

    ref_err = reference_check(dev, ZAMBA_ARCH)
    cfg = get_config(ZAMBA_ARCH)
    cut = zamba2_cut(cfg)

    def shared_count(c):
        return sum(b.kind == "shared_attn"
                   for b in transformer.layer_blocks(c))

    n_shared, n_cut_shared = shared_count(cfg), shared_count(cut)
    n_mamba, n_cut_mamba = (c.n_layers - n for c, n in
                            ((cfg, n_shared), (cut, n_cut_shared)))
    rng = np.random.default_rng(6)
    # (b) the hand-off at the cut depth, the seeded bf16 weights computed
    # in float32 (exact copies), as the mamba2 phase checks it
    g = torch.Generator(device=dev).manual_seed(0)
    params32 = tree_map(lambda t: t.float(),
                        transformer.init_params(cut, g, dev))
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (HANDOFF_BATCH, HANDOFF_LEN + 1))).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    handoff = mamba2_handoff(dataclasses.replace(cut, dtype="float32"),
                             params32, prompt, dev)
    handoff_mem = torch.cuda.max_memory_allocated(dev)
    del params32
    torch.cuda.empty_cache()
    # (c) serve at full depth
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = engine.ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, seed=0,
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = eng.params
    serve, serve_checks, serve_launches, _ = serve_run(eng, cfg, dev)
    del eng
    # (d) prefill at full depth
    prefill = timed_prefill(cfg, params, dev, torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, PREFILL_LEN))).to(dev))
    # (e) the long prefill, then greedy decode from its cache
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (1, ZAMBA_LONG))).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    long_launches = dict(ops.LAUNCHES)
    dcache = decode_cache_from(cfg, cache, ZAMBA_LONG + DECODE_STEPS, dev)
    del cache
    cache_bytes = sum(t.numel() * t.element_size() for c in dcache
                      for n, t in c.items() if n in ("k", "v"))
    tok = last.argmax(dim=-1)
    finite = bool(torch.isfinite(last).all())
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(DECODE_STEPS):
            logits = transformer.decode_step(params, cfg, dcache, tok,
                                             ZAMBA_LONG + i)
            tok = logits.argmax(dim=-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    decode_launches = dict(ops.LAUNCHES)
    finite = finite and bool(torch.isfinite(logits).all())
    long_mem = torch.cuda.max_memory_allocated(dev)
    del params, dcache, last, logits
    torch.cuda.empty_cache()
    # (f) training at the cut depth; AdamW's leaves counted as it runs
    updates = []
    adamw_update = steps.adamw_update

    def counting(params, grads, state, *args, **kw):
        leaves = tree_leaves(params)
        updates.append(dict(
            leaves=len(leaves), distinct=len({id(x) for x in leaves}),
            grad_leaves=len(tree_leaves(grads)),
            shared_grad_leaves=len(tree_leaves(grads.get("shared"))),
            shared_layers_empty=sum(grads["layers"][i] is None
                                    for i, b in enumerate(
                                        transformer.layer_blocks(cut))
                                    if b.kind == "shared_attn")))
        if len(updates) == 1:
            updates[0]["params"] = params
        return adamw_update(params, grads, state, *args, **kw)

    steps.adamw_update = counting
    try:
        train, train_launches = train_run(cut, dev, "flash_attention_fwd",
                                          fa.flash_attention_plain)
    finally:
        steps.adamw_update = adamw_update
    ref_leaves = reference_leaf_count(params_to_reference(
        updates[0].pop("params"), cut))
    torch.cuda.empty_cache()
    res = dict(
        model=cfg.name, layers=cfg.n_layers, shared_occurrences=n_shared,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, ssm_heads=cfg.ssm_heads,
        ssm_head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state,
        dtype=cfg.dtype, params=cfg.param_count(),
        cut=dict(stages="((2, 5 x mamba2 + shared_attn), (1, 3 x mamba2))",
                 layers=cut.n_layers, shared_occurrences=n_cut_shared,
                 params=cut.param_count(), used_by=["handoff", "train"]),
        cuda_vs_cpu_smoke_logits_max_abs_err=ref_err,
        handoff=dict(batch=HANDOFF_BATCH, tokens=HANDOFF_LEN,
                     compute="float32", tol=TOL[torch.bfloat16],
                     max_memory_allocated=handoff_mem, **handoff),
        serve=dict(**serve, init_s=init_s), prefill=prefill,
        long=dict(tokens=ZAMBA_LONG, batch=1, prefill_s=long_s,
                  tokens_per_s=ZAMBA_LONG / long_s,
                  flash_launches=long_launches["flash_attention"],
                  ssd_launches=long_launches["ssd_scan"],
                  kv_cache_bytes=cache_bytes, decode_steps=DECODE_STEPS,
                  decode_ms_per_step=decode_ms,
                  decode_launches=decode_launches["decode_attention"],
                  max_memory_allocated=long_mem),
        train=dict(**train, flash_launches=train_launches["flash_attention"],
                   ssd_launches=train_launches["ssd_scan"],
                   adamw_updates=updates, reference_leaves=ref_leaves),
        power_limit=power)
    emit("zamba2", **res)
    per_step = 2 * TRAIN_MICRO * TRAIN_STEPS   # forward and remat
    fail_on("zamba2", {
        "CUDA decode logits match the CPU path's (smoke, 1e-4)":
            ref_err <= 1e-4,
        "prefill hands decode its cache, every shared occurrence's k/v "
        "(float32, 2e-2)": handoff["err_over_tol"] <= 1.0,
        "hand-off: flash once per shared occurrence, ssd once per mamba2 "
        "layer": handoff["flash_launches"] == n_cut_shared
        and handoff["ssd_launches"] == n_cut_mamba,
        **serve_checks,
        "flash launches = 13 a full-depth prefill":
            prefill["flash_launches"] == long_launches["flash_attention"]
            == n_shared == 13,
        "ssd op calls = 68 a prefill":
            prefill["ssd_launches"] == long_launches["ssd_scan"]
            == n_mamba == 68,
        "decode launches = 13 x steps":
            decode_launches["decode_attention"] == n_shared * DECODE_STEPS,
        "finite logits": finite and prefill["finite"] and handoff["finite"],
        "finite losses": all(np.isfinite(train["losses"])),
        "train step 0 with the kernel within 2e-2 of the plain core":
            max(train["check_rel_err"].values()) <= 2e-2,
        "train: flash once per shared occurrence, pass, microbatch and "
        "step": train_launches["flash_attention"] == n_cut_shared * per_step,
        "train: ssd once per mamba2 layer, pass, microbatch and step":
            train_launches["ssd_scan"] == n_cut_mamba * per_step,
        "the shared block's gradient is one tensor, updated once a step":
            len(updates) == TRAIN_STEPS and all(
                u["leaves"] == u["distinct"] == u["grad_leaves"] == ref_leaves
                and u["shared_grad_leaves"] == len(attention.WEIGHTS)
                and u["shared_layers_empty"] == n_cut_shared
                for u in updates),
        "under 80 GB": max(handoff_mem, serve["max_memory_allocated"],
                           prefill["max_memory_allocated"], long_mem,
                           train["max_memory_allocated"]) < 80e9,
    })
    # the launches of the phase's main-path runs, each counted from zero
    return {"flash_attention": prefill["flash_launches"]
            + long_launches["flash_attention"]
            + train_launches["flash_attention"],
            "decode_attention": serve_launches["decode_attention"]
            + decode_launches["decode_attention"],
            "ssd_scan": prefill["ssd_launches"] + long_launches["ssd_scan"]
            + train_launches["ssd_scan"]}


# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# multidevice
# ----------------------------------------------------------------------
def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def serve_step_run(dev, want: dict) -> dict:
    """The `serve` phase's requests on its weights (llama3-8b, seed 0),
    driven through `make_serve_step` as the engine schedules them: waves
    of BATCH requests from a zeroed cache of MAX_LEN slots, the prompt
    teacher-forced, then each step's greedy token fed back.  -> the
    tokens' agreement with the engine's (`want`) and the launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer

    cfg = get_config("llama3-8b")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = transformer.init_params(cfg, g, dev)
    step = make_serve_step(cfg)
    rng = np.random.default_rng(0)                  # as `serve_run` draws
    prompts = np.stack([rng.integers(0, cfg.vocab, PROMPT)
                        for _ in range(REQUESTS)])
    ops.reset_launches()
    got, steps_used = {}, 0
    for w in range(0, REQUESTS, BATCH):
        wave = torch.from_numpy(prompts[w:w + BATCH]).to(dev, torch.int32)
        cache = transformer.init_cache(cfg, BATCH, MAX_LEN, dev)
        tok, out = wave[:, 0], []
        for t in range(PROMPT + NEW - 1):
            nxt, cache = step(params, cache, tok, t)
            steps_used += 1
            if t >= PROMPT - 1:
                out.append(nxt)
            tok = wave[:, t + 1] if t + 1 < PROMPT else nxt
        toks = torch.stack(out, 1).tolist()
        got.update({w + i: toks[i] for i in range(BATCH)})
    launches = ops.LAUNCHES["decode_attention"]
    return dict(requests=REQUESTS, steps=steps_used,
                tokens_equal_engine=got == want,
                decode_launches=launches,
                decode_launches_want=cfg.n_layers * steps_used)


def decode_cell_run(dev) -> dict:
    """The reference's decode_32k cell (`configs/shapes.py`) at batch
    MD_BATCH: each row prefilled alone from a seeded prompt of 32,768 -
    MD_STEPS tokens into the (B, KV, 32,768, hd) cache, then MD_STEPS
    `serve_step`s of the whole batch, each step timed to a sync."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves

    cfg = get_config("llama3-8b")
    shape = SHAPES["decode_32k"]
    B, S = MD_BATCH, shape.seq
    P = S - MD_STEPS
    torch.cuda.reset_peak_memory_stats(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = transformer.init_params(cfg, g, dev)
    cache = transformer.init_cache(cfg, B, S, dev)
    prefill = steps.make_prefill_step(cfg)
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, P))).to(dev)
    first = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(B):
        last, row = prefill(params, {"tokens": prompts[r:r + 1]})
        for c, lay in zip(cache, row):
            for name in ("k", "v"):
                c[name][r, :, :P] = lay[name][0].transpose(0, 1)
        first.append(last.argmax(-1))
        del row, last
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    serve_step = steps.make_serve_step(cfg)
    nan_seen = torch.zeros((), dtype=torch.bool, device=dev)
    decode_step = steps.decode_step

    def checked(*args):
        logits = decode_step(*args)
        nan_seen.logical_or_(torch.isnan(logits).any())
        return logits

    steps.decode_step = checked
    tok, outs, step_ms = torch.cat(first).to(torch.int32), [], []
    ops.reset_launches()
    try:
        for i in range(MD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, cache = serve_step(params, cache, tok, P + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(tok)
    finally:
        steps.decode_step = decode_step
    launches = ops.LAUNCHES["decode_attention"]
    embed = params["embed"]
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params)) \
        - embed.numel() * embed.element_size() \
        + B * cfg.d_model * embed.element_size()
    token_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim \
        * embed.element_size()
    cache_read = statistics.mean(B * (P + i + 1) * token_bytes
                                 for i in range(MD_STEPS))
    ms = statistics.median(step_ms)
    toks = torch.stack(outs)
    # the rate over the whole window, so that a stalled step counts
    return dict(cell=shape.name, batch=B, batch_of_cell=shape.batch,
                seq=S, prompt_tokens=P, steps=MD_STEPS,
                cache_bytes=sum(t.numel() * t.element_size()
                                for c in cache for t in c.values()),
                token_bytes=token_bytes, prefill_s_all_rows=prefill_s,
                ms_per_step=ms, ms_per_step_mean=statistics.mean(step_ms),
                ms_first_step=step_ms[0],
                tokens_per_s=B * MD_STEPS * 1e3 / sum(step_ms),
                tokens_per_s_at_median_step=B * 1e3 / ms,
                weight_bytes_read=weight_bytes, cache_bytes_read=cache_read,
                step_bound_ms=(weight_bytes + cache_read) / PEAK_BYTES * 1e3,
                decode_launches=launches,
                decode_launches_want=cfg.n_layers * MD_STEPS,
                tokens_in_vocab=bool(((toks >= 0) & (
                    toks < transformer.padded_vocab(cfg))).all()),
                nan_logits=bool(nan_seen),
                max_memory_allocated=torch.cuda.max_memory_allocated(dev))


def compress_check(grads, names, rank: int, world: int, group=None) -> dict:
    """`compressed_allreduce` over `grads` (named leaves), two rounds of
    error feedback, against the numpy rule on the host over the leaves
    named in `names`: each rank's int8 payload (captured where it enters
    `all_gather`) bit for bit, the mean and the error within 1e-6
    relative.  Every rank's x reaches the host through a gloo or NCCL
    all_gather of float32 copies (not the collective under test)."""
    import torch.distributed as dist
    from repro_torch.distributed import compression
    from repro_torch.tree import named_leaves

    leaves = named_leaves(grads)
    picked = [i for i, (n, _) in enumerate(leaves) if n in names]
    real = dist.all_gather
    worst = dict(payload_mismatches=0, mean_rel=0.0, err_rel=0.0)
    checked = 0
    e = compression.init_error_state(grads)
    for _ in range(2):
        sent = []

        def capture(parts, q8, group=None, **kw):
            sent.append(q8.clone() if len(sent) in picked else None)
            return real(parts, q8, group=group, **kw)

        dist.all_gather = capture
        try:
            out, e_new = compression.compressed_allreduce(grads, e, group)
        finally:
            dist.all_gather = real
        for i in picked:
            name, g = leaves[i]
            x = (g.float() + _leaf(e, name)).contiguous()
            xs = [torch.empty_like(x) for _ in range(world)]
            real(xs, x, group=group)
            xs = [t.cpu().numpy() for t in xs]
            amax = np.float32(max(np.abs(t).max() for t in xs))
            scale = np.maximum(amax / np.float32(127.0), np.float32(1e-12))
            qs = [np.clip(np.round(t / scale), -127, 127).astype(np.int8)
                  for t in xs]
            mean = sum(q.astype(np.float32) for q in qs) * scale \
                / np.float32(world)
            err = xs[rank] - qs[rank].astype(np.float32) * scale
            worst["payload_mismatches"] += int(
                (sent[i].cpu().numpy() != qs[rank]).sum())
            want = torch.from_numpy(mean).to(g.dtype).float().numpy()
            got = _leaf(out, name).float().cpu().numpy()
            worst["mean_rel"] = max(worst["mean_rel"], float(
                (np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max()))
            got = _leaf(e_new, name).cpu().numpy()
            worst["err_rel"] = max(worst["err_rel"], float(
                (np.abs(got - err) / np.maximum(np.abs(err), 1e-30)).max()))
            checked += g.numel()
        e = e_new
    return dict(leaves=len(leaves), leaves_checked=len(picked),
                elements_checked=checked, **worst)


def _leaf(tree, name: str):
    for key in name.split("/"):
        tree = tree[int(key) if isinstance(tree, list) else key]
    return tree


def checked_names() -> set:
    """The gradient leaves the numpy rule is checked on: the first
    layer's and the final norm (the whole tree would take minutes of
    numpy)."""
    from repro_torch.models.attention import WEIGHTS
    return {"final_norm"} | {f"layers/0/{w}" for w in WEIGHTS}


def layers_cut(cfg, n: int):
    (_, blocks), = cfg.stages
    return dataclasses.replace(cfg, stages=((n, blocks),))


def rank_loss_and_grads(cfg, params, dev, rank: int, world: int,
                        step: int = 0):
    """(loss, gradients) of this rank's own row of `step`'s batch of
    `world` rows, as `train` draws it (bf16 gradients, as the
    weights)."""
    from repro_torch.data.lm_pipeline import DataConfig, LMPipeline
    from repro_torch.launch import steps

    data = LMPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                 global_batch=world, seed=0))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(step, rank, world).items()}
    return steps.value_and_grad(params, cfg, batch, 1)


def rank_grads(cfg, params, dev, rank: int, world: int):
    """This rank's gradients of its own row of step 0's batch."""
    return rank_loss_and_grads(cfg, params, dev, rank, world)[1]


def nccl_train_run(dev, want_losses: list) -> dict:
    """stablelm-3b at full width through `train(mesh=...)` on a (1, 1)
    mesh over a one-rank NCCL group, MD_TRAIN_STEPS steps under each
    recipe with the `train` phase's seed, data and microbatching; then
    `compressed_allreduce` on that group over the trained weights'
    gradients."""
    import datetime
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import TrainOptions
    from repro_torch.launch.train import train

    cfg = get_config("stablelm-3b")
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for recipe in ("tp", "fsdp"):
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launches()
            params, opt, hist = train(
                cfg, steps=MD_TRAIN_STEPS, global_batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, mesh=mesh, recipe=recipe,
                topts=TrainOptions(microbatch=TRAIN_MICRO), log_every=100,
                device=dev)
            want = want_losses[:MD_TRAIN_STEPS]
            out[recipe] = dict(
                losses=hist["loss"], step_s=hist["step_s"],
                train_phase_losses=want,
                bit_for_bit=hist["loss"] == want,
                max_rel_err=max(abs(a - b) / abs(b)
                                for a, b in zip(hist["loss"], want)),
                flash_launches=ops.LAUNCHES["flash_attention"],
                max_memory_allocated=torch.cuda.max_memory_allocated(dev))
            del opt
            if recipe == "tp":
                del params
                torch.cuda.empty_cache()
        grads = rank_grads(cfg, params, dev, 0, 1)
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["compress"] = compress_check(grads, checked_names(), 0, 1)
        out["compress"]["s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    return out


RANK_SCRIPT = r"""
import datetime, json, sys
import torch, torch.distributed as dist
sys.path.insert(0, sys.argv[4])
import chip_smoke as cs
sys.path.insert(0, sys.argv[5])
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method="tcp://localhost:" + sys.argv[3],
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import train
from repro_torch.tree import tree_map
dev = torch.device("cuda", 0)
own, make = [], T.make_train_step
def spy(*args, **kw):               # this rank's own loss of each step
    step = make(*args, **kw)
    def spied(*a):
        out = step(*a)
        own.append(float(out[2]["rank_loss"]))
        return out
    spied.placement = step.placement
    return spied
T.make_train_step = spy
cfg = cs.layers_cut(get_config("stablelm-3b"), cs.MD_RANK_LAYERS)
mesh = make_mesh((world, 1), ("data", "model"))
ops.reset_launches()
params, opt, hist = train(cfg, steps=cs.MD_TRAIN_STEPS, global_batch=world,
                          seq_len=cs.TRAIN_SEQ, mesh=mesh, recipe="tp",
                          log_every=100, device=dev)
del opt
res = dict(losses=hist["loss"], own_losses=own, step_s=hist["step_s"],
           flash_launches=ops.LAUNCHES["flash_attention"],
           max_memory_allocated=torch.cuda.max_memory_allocated(dev))
# the whole trained weights (each rank holds its blocks of them)
plan = steps.plan_cell(cfg, ShapeSpec("train", "train", cs.TRAIN_SEQ,
                                      world), mesh, "tp")
params = tree_map(steps.placement_of(plan).gather_whole, params,
                  plan.param_specs)
grads = cs.rank_grads(cfg, params, dev, rank, world)
res["compress"] = cs.compress_check(grads, cs.checked_names(), rank,
                                    world)
print("RESULT " + json.dumps(res), flush=True)
dist.destroy_process_group()
"""


def gloo_ranks_run(dev, world: int = 2) -> dict:
    """`world` gloo ranks sharing the card (NCCL takes one rank a device),
    each a subprocess under one deadline: stablelm-3b cut to
    MD_RANK_LAYERS layers, global batch `world` x TRAIN_SEQ (a row a
    rank) for MD_TRAIN_STEPS steps of the placed train cell (the "tp"
    recipe on a (world, 1) mesh: the weights' d_model cut over "data"),
    against one process's run of the same cut (the global loss) and
    against one process's loss on each rank's own row (the rank's share
    of the loss rescaled to its tokens, `rank_loss`), at the weights of
    each step; then `compressed_allreduce` over gloo on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import TrainOptions
    from repro_torch.launch.train import train
    from repro_torch.models import transformer

    cfg = layers_cut(get_config("stablelm-3b"), MD_RANK_LAYERS)
    _, _, hist = train(cfg, steps=MD_TRAIN_STEPS, global_batch=world,
                       seq_len=TRAIN_SEQ, log_every=100, device=dev)
    row_losses = []                 # [step][row], one process
    for step in range(MD_TRAIN_STEPS):
        if step == 0:
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            params = transformer.init_params(cfg, g, dev)
        else:                       # the weights after `step` steps
            params, _, _ = train(
                cfg, steps=step, global_batch=world, seq_len=TRAIN_SEQ,
                topts=TrainOptions(total_steps=MD_TRAIN_STEPS),
                log_every=100, device=dev)
        row_losses.append([float(rank_loss_and_grads(
            cfg, params, dev, r, world, step)[0]) for r in range(world)])
        del params
        torch.cuda.empty_cache()
    port = str(free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world), port,
         str(ROOT), str(ROOT / "src")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(
                300 - (time.perf_counter() - t0), 1)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise SystemExit(f"multidevice rank {r} exited {p.returncode}:"
                             f"\n{err[-3000:]}")
    ranks = [json.loads(next(line[7:] for line in out.splitlines()
                             if line.startswith("RESULT ")))
             for out, _ in outs]

    def rel(a, b):
        return abs(a - b) / abs(b)

    return dict(world=world, layers=cfg.n_layers, params=cfg.param_count(),
                seq=TRAIN_SEQ, global_batch=world,
                one_process_losses=hist["loss"],
                one_process_row_losses=row_losses,
                one_process_step_s=hist["step_s"], ranks=ranks, wall_s=wall,
                # [step]: the worst rank's relative error of the dp mean
                # against one process, and of its own loss against one
                # process's on its row and on another rank's row
                mean_rel_err=[max(rel(rk["losses"][i], hist["loss"][i])
                                  for rk in ranks)
                              for i in range(MD_TRAIN_STEPS)],
                own_rel_err=[max(rel(rk["own_losses"][i], row_losses[i][r])
                                 for r, rk in enumerate(ranks))
                             for i in range(MD_TRAIN_STEPS)],
                own_rel_err_other_row=[
                    min(rel(rk["own_losses"][i], row_losses[i][o])
                        for r, rk in enumerate(ranks)
                        for o in range(world) if o != r)
                    for i in range(MD_TRAIN_STEPS)])


def multidevice_phase(dev, power: str, engine_tokens: dict,
                      train_losses: list) -> None:
    t0 = time.perf_counter()
    serve = serve_step_run(dev, engine_tokens)
    torch.cuda.empty_cache()
    cell = decode_cell_run(dev)
    torch.cuda.empty_cache()
    nccl = nccl_train_run(dev, train_losses)
    torch.cuda.empty_cache()
    gloo = gloo_ranks_run(dev)
    torch.cuda.empty_cache()
    emit("multidevice", name=torch.cuda.get_device_name(dev),
         power_limit=power, serve_step=serve, decode_32k=cell,
         train_nccl_world1=nccl, gloo_two_ranks=gloo,
         phase_s=time.perf_counter() - t0)
    flash_want = 2 * TRAIN_MICRO * MD_TRAIN_STEPS
    comp = [nccl["compress"]] + [r["compress"] for r in gloo["ranks"]]
    checks = {
        "serve_step tokens equal the engine's": serve["tokens_equal_engine"],
        "serve_step: decode kernel once per layer and step":
            serve["decode_launches"] == serve["decode_launches_want"],
        "decode_32k: decode kernel once per layer and step":
            cell["decode_launches"] == cell["decode_launches_want"],
        "decode_32k: tokens in vocab, no NaN logits":
            cell["tokens_in_vocab"] and not cell["nan_logits"],
        "NCCL world-1 train losses equal the train phase's bit for bit":
            all(nccl[r]["bit_for_bit"] for r in ("tp", "fsdp")),
        "NCCL world-1 train: flash kernel once per layer, pass, "
        "microbatch and step": all(
            nccl[r]["flash_launches"] == 32 * flash_want
            for r in ("tp", "fsdp")),
        "compression payload exact, mean and error within 1e-6": all(
            c["payload_mismatches"] == 0 and c["mean_rel"] <= 1e-6
            and c["err_rel"] <= 1e-6 for c in comp),
        # measured on an H100 at 700 W: the dp mean 8e-8 off at step 0
        # and 8.7e-6 at step 1; the rows' own losses are reported, and
        # each rank's is also held against the rows it should not see
        "two gloo ranks: the dp mean of the loss within 1e-6 of one "
        "process at step 0 and 1e-4 after": gloo["mean_rel_err"][0] <= 1e-6
            and max(gloo["mean_rel_err"][1:]) <= 1e-4,
        "two gloo ranks: each rank's own loss within 1e-6 of one process's "
        "on its row at step 0 and 1e-4 after": gloo["own_rel_err"][0] <= 1e-6
            and max(gloo["own_rel_err"][1:]) <= 1e-4,
        "two gloo ranks: each rank's own loss nearer its row's than any "
        "other row's": all(a < b for a, b in zip(
            gloo["own_rel_err"], gloo["own_rel_err_other_row"])),
        "two gloo ranks: flash kernel on every rank's layers": all(
            r["flash_launches"] == MD_RANK_LAYERS * 2 * MD_TRAIN_STEPS
            for r in gloo["ranks"]),
    }
    fail_on("multidevice", checks)


# ----------------------------------------------------------------------
# placed
# ----------------------------------------------------------------------
PLACED_SCRIPT = r"""
import datetime, json, sys
import numpy as np
import torch, torch.distributed as dist
sys.path.insert(0, sys.argv[4])
import chip_smoke as cs
sys.path.insert(0, sys.argv[5])
rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[6]
dist.init_process_group("gloo", init_method="tcp://localhost:" + sys.argv[3],
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=300))
print("RESULT " + json.dumps(cs.placed_rank(work, world)), flush=True)
dist.destroy_process_group()
"""


def zamba2_short(cfg):
    """zamba2 cut to PLACED_CHECK_LAYERS layers that keep a shared
    occurrence: three mamba2 layers and the shared block."""
    from repro_torch.models.config import Block
    return dataclasses.replace(cfg, stages=(
        (1, (Block("mamba2"),) * (PLACED_CHECK_LAYERS - 1)
         + (Block("shared_attn"),)),))


def placed_cfgs() -> dict:
    """The placed phase's models.  Served in bf16: llama3-8b and
    mamba2-1.3b at full width and depth, zamba2-7b at full width cut to
    15 layers (`zamba2_cut`: the shared block twice).  Prefilled in bf16
    (PLACED_PREFILL tokens, batch 1): llama3-8b at full depth (the
    "fsdp" recipe's context parallelism), mamba2-1.3b (its heads over
    "model"), qwen3-moe at PLACED_MOE_LAYERS under "ep".  The float32
    checks: llama3-8b and mamba2-1.3b at PLACED_CHECK_LAYERS layers,
    zamba2 at `zamba2_short`, qwen3-moe at PLACED_MOE_LAYERS."""
    from repro_torch.configs import get_config
    llama, mamba = get_config("llama3-8b"), get_config("mamba2-1.3b")
    zamba, qwen = get_config(ZAMBA_ARCH), get_config(MOE_ARCH)
    stable = get_config("stablelm-3b")

    def f32(cfg):
        return dataclasses.replace(cfg, dtype="float32")
    return {"llama3": llama, "mamba2": mamba, "zamba2": zamba2_cut(zamba),
            "qwen3": layers_cut(qwen, PLACED_MOE_LAYERS),
            "llama3_f32": f32(layers_cut(llama, PLACED_CHECK_LAYERS)),
            "mamba2_f32": f32(layers_cut(mamba, PLACED_CHECK_LAYERS)),
            "zamba2_f32": f32(zamba2_short(zamba)),
            "qwen3_f32": f32(layers_cut(qwen, PLACED_MOE_LAYERS)),
            # placed training
            "stablelm_f32": f32(layers_cut(stable, PLACED_CHECK_LAYERS)),
            "qwen3_train_f32": f32(layers_cut(qwen, 1)),
            "stablelm_timing": layers_cut(stable, PLACED_TIMING_LAYERS)}


# float32 checks: decode (PLACED_CHECK_STEPS steps of BATCH rows) and
# prefill (PLACED_PREFILL tokens, batch 1, under the dry run's recipe)
PLACED_DECODE_CHECKS = ("llama3_f32", "qwen3_f32", "mamba2_f32",
                        "zamba2_f32")
PLACED_PREFILL_CHECKS = {"llama3_f32": "fsdp", "mamba2_f32": "fsdp",
                         "qwen3_f32": "ep"}
PLACED_PREFILLS = {"llama3": "fsdp", "mamba2": "fsdp", "qwen3": "ep"}
# float32 train checks: name -> (model, recipe), batch 1 on (1, 2):
# context parallel, the sequence-sharded residual of sp = tp, the SSM's
# residual replicated over "model", expert parallelism
PLACED_TRAIN_CHECKS = {"stablelm_fsdp": ("stablelm_f32", "fsdp"),
                       "stablelm_tp": ("stablelm_f32", "tp"),
                       "mamba2_fsdp": ("mamba2_f32", "fsdp"),
                       "qwen3_ep": ("qwen3_train_f32", "ep")}
# each block's estimated error against its tree: 1e-5, but mamba2's.  Its
# gradients come back through the scan, whose decays magnify a rounding
# of its input by 1e2-1e5 (PR 23); placed, each rank sums its heads'
# share of the residual's gradient apart from the other's, so two
# placements, or one process and a placement, round the gradient of the
# embedding (most of the tree) 1e-5 apart at full width whatever the
# order (measured on an H100: 8.5e-6 in m and 2.3e-5 in v after one step
# from the same weights, where the loss and gradient norm agree within
# 1.8e-6)
PLACED_TRAIN_TOL = {"mamba2_fsdp": 1e-4}


def placed_check_tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(7).integers(0, vocab, (PLACED_CHECK_STEPS,
                                                         BATCH))


def placed_prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(8).integers(0, vocab, (1, PLACED_PREFILL))


def placed_prefill_plan(cfg, recipe: str, world: int):
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import MeshDesc
    from repro_torch.launch import steps
    return steps.plan_cell(cfg, ShapeSpec("prefill", "prefill",
                                          PLACED_PREFILL, 1),
                           MeshDesc(("data", "model"), (1, world)), recipe)


def cache_block_err(plan, got: list, want: list, rank: int) -> dict:
    """Per cache leaf name, the largest error of this rank's blocks `got`
    relative to the largest magnitude of `place` of the one-process cache
    `want` (on the CPU); a block of another shape fails."""
    from repro_torch.launch import steps
    placed = steps.place_cache(plan, want, rank=rank)
    err: dict = {}
    for g, w in zip(got, placed):
        for k, t in g.items():
            if tuple(t.shape) != tuple(w[k].shape):
                err[k] = math.inf
                continue
            e = float((t.cpu().float() - w[k].float()).abs().max()
                      / w[k].float().abs().max().clamp(min=1e-30))
            err[k] = max(err.get(k, 0.0), e)
    return err


def placed_params(plan, cfg, world: int, dev):
    """This rank's blocks of the weights drawn from seed 0, placed one
    rank at a time (so the full trees never coexist)."""
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.models.transformer import init_params
    params = None
    for r in range(world):
        if r == dist.get_rank():
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            full = init_params(cfg, g, dev)
            params = steps.place_params(plan, full)
            del full
            torch.cuda.empty_cache()
        dist.barrier()
    return params


def nbytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def placed_check(name: str, cfg, work: Path, world: int, dev) -> dict:
    """One float32 decode check on this rank: its blocks of the weights,
    then PLACED_CHECK_STEPS decode steps of BATCH rows, each step's
    gathered logits of this rank's rows against one process's, and its
    cache blocks after the last step against `place` of one process's
    cache."""
    import torch.distributed as dist
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.placement import local_bytes
    from repro_torch.distributed.sharding import MeshDesc
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.transformer import decode_step, param_shapes

    mesh = MeshDesc(("data", "model"), (1, world))
    plan = steps.plan_cell(cfg, ShapeSpec(name, "decode", PLACED_CHECK_STEPS,
                                          BATCH), mesh)
    base = torch.cuda.memory_allocated(dev)
    params = placed_params(plan, cfg, world, dev)
    cache = steps.init_placed_cache(plan, dev)
    allocated = torch.cuda.memory_allocated(dev) - base
    step = steps.make_serve_step(cfg, plan)
    plc = step.placement
    want = torch.load(work / f"{name}.pt")
    toks = torch.from_numpy(placed_check_tokens(cfg.vocab)).to(dev)
    rows = steps.local_rows(plan, torch.arange(BATCH)).tolist()
    err = 0.0
    ops.reset_launches()
    for pos in range(PLACED_CHECK_STEPS):
        with torch.no_grad():
            lg = decode_step(params, cfg, cache,
                             steps.local_rows(plan, toks[pos]), pos,
                             place=plc)
        got = plc.all_gather(lg, plan.vocab_entry, 1).cpu()
        w = want[pos][rows]
        err = max(err, float((got - w).abs().max() / w.abs().max()))
    launches = dict(ops.LAUNCHES)
    cache_err = cache_block_err(plan, cache, torch.load(
        work / f"{name}_cache.pt"), dist.get_rank())
    weights, cache_bytes = nbytes(params), nbytes(cache)
    del params, cache
    torch.cuda.empty_cache()
    return dict(model=cfg.name, layers=cfg.n_layers, steps=PLACED_CHECK_STEPS,
                rows=rows, max_rel_err=err, cache_rel_err=cache_err,
                weight_bytes=weights,
                local_bytes=local_bytes(param_shapes(cfg), plan.param_specs,
                                        mesh),
                cache_bytes=cache_bytes, memory_allocated=allocated,
                launches=launches, traffic=dict(plc.traffic))


def placed_prefill(name: str, cfg, recipe: str, world: int, dev,
                   work: Path | None = None) -> dict:
    """One placed prefill on this rank: PLACED_PREFILL tokens at batch 1
    under `recipe`, timed; with `work`, its last logits and cache blocks
    against one process's (`{name}_prefill.pt`)."""
    import torch.distributed as dist
    from repro_torch.distributed.placement import local_bytes
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.transformer import param_shapes

    plan = placed_prefill_plan(cfg, recipe, world)
    base = torch.cuda.memory_allocated(dev)
    params = placed_params(plan, cfg, world, dev)
    allocated = torch.cuda.memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    step = steps.make_prefill_step(cfg, plan)
    batch = steps.local_batch(plan, {"tokens": torch.from_numpy(
        placed_prompt(cfg.vocab)).to(dev)})
    ops.reset_launches()
    dist.barrier()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = step(params, batch)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    out = dict(model=cfg.name, layers=cfg.n_layers, recipe=recipe,
               tokens=PLACED_PREFILL, seq_entry=plan.seq_entry,
               tp=list(plan.binding["tp"]), prefill_s=seconds,
               launches=dict(ops.LAUNCHES), weight_bytes=nbytes(params),
               local_bytes=local_bytes(param_shapes(cfg), plan.param_specs,
                                       plan.binding["mesh"]),
               cache_bytes=nbytes(cache), memory_allocated=allocated,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               traffic=dict(step.placement.traffic),
               finite=bool(torch.isfinite(logits).all()))
    if work is not None:
        want_logits, want_cache = torch.load(work / f"{name}_prefill.pt")
        out["max_rel_err"] = float((logits.cpu() - want_logits).abs().max()
                                   / want_logits.abs().max())
        out["cache_rel_err"] = cache_block_err(plan, cache, want_cache,
                                               dist.get_rank())
    del params, cache, logits
    torch.cuda.empty_cache()
    return out


def train_topts():
    """The placed train checks' options: the reference's defaults, whose
    warmup takes the first steps at 1/100 and 2/100 of the peak
    learning rate.  AdamW moves each weight by up to the learning rate
    whatever its gradient, so an element whose gradient is a nearly
    cancelling sum moves by a rounding-sized accident; at the peak rate
    (3e-4 at the first step, a 1.5 % change of a weight of d ** -0.5 at
    full width) the second step's gradients of two runs drift apart by
    1e-4 of their tree on one card (mamba2-1.3b), at 3e-6 they stay
    within its rounding."""
    from repro_torch.launch.steps import TrainOptions
    return TrainOptions()


def train_batch(vocab: int, rows: int, seq: int, dev) -> dict:
    tok = np.random.default_rng(9).integers(0, vocab, (rows, seq + 1))
    tok = torch.from_numpy(tok.astype(np.int32)).to(dev)
    return {"tokens": tok[:, :-1].contiguous(),
            "labels": tok[:, 1:].contiguous()}


def train_plan(cfg, recipe: str, rows: int, seq: int, world: int):
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import MeshDesc
    from repro_torch.launch import steps
    return steps.plan_cell(cfg, ShapeSpec("train_4k", "train", seq, rows),
                           MeshDesc(("data", "model"), (1, world)), recipe)


def sketch(t, seed: int) -> tuple[float, torch.Tensor]:
    """(the L2 norm of `t`, PLACED_SKETCH Gaussian projections of it), in
    float64, the projections drawn on the card from `seed` a slice at a
    time: the same numbers for the same block in any process, so that
    two blocks' sketches differ by the sketch of their difference."""
    x = t.detach().reshape(-1)
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    out = torch.zeros(PLACED_SKETCH, dtype=torch.float64, device=x.device)
    sq = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.numel(), SKETCH_CHUNK):
        c = x[i:i + SKETCH_CHUNK].double()
        out += torch.randn(PLACED_SKETCH, c.numel(), generator=g,
                           dtype=torch.float64, device=x.device) @ c
        sq += c.square().sum()
    return float(sq.sqrt()), out.cpu()


TRAIN_KINDS = ("params", "m", "v")


def state_sketches(params, opt) -> dict:
    """{kind: {leaf: sketch}} of a placed state (or of one rank's views of
    a whole one), seeded by kind and leaf."""
    from repro_torch.tree import named_leaves
    trees = {"params": params, "m": opt["m"], "v": opt["v"]}
    return {kind: {name: sketch(t, 1_000_003 * k + i) for i, (name, t) in
                   enumerate(named_leaves(trees[kind]))}
            for k, kind in enumerate(TRAIN_KINDS)}


def sketch_errs(got: dict, want: dict) -> dict:
    """Per kind, the worst leaf's estimated L2 norm of the blocks'
    difference (the root mean square of the sketches' difference)
    relative to the L2 norm of this rank's blocks of the wanted tree, and
    relative to the wanted block's own."""
    out = {}
    for kind in TRAIN_KINDS:
        tree = math.sqrt(sum(n ** 2 for n, _ in want[kind].values()))
        est = {name: float((got[kind][name][1] - w).square().mean().sqrt())
               for name, (_, w) in want[kind].items()}
        worst = max(est, key=est.get)
        own = max(est, key=lambda n: est[n] / max(want[kind][n][0], 1e-30))
        out[kind] = dict(leaf=worst, rel_tree=est[worst] / tree, own_leaf=own,
                         rel_own=est[own] / max(want[kind][own][0], 1e-30))
    return out


def placed_train_one_process(dev, work: Path) -> None:
    """The float32 train checks on one process, before the ranks start:
    PLACED_TRAIN_STEPS steps of each model from the seeded weights; each
    step's loss and gradient norm, and for each check and rank the
    sketches of that rank's blocks of the parameters and moments after
    each step (`train_<check>_<rank>.pt`)."""
    from repro_torch.distributed.placement import local_shard, spec_leaves
    from repro_torch.launch import steps
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map_with_path

    cfgs = placed_cfgs()
    topts = train_topts()
    for model in dict.fromkeys(m for m, _ in PLACED_TRAIN_CHECKS.values()):
        cfg = cfgs[model]
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        params = init_params(cfg, g, dev)
        opt = adamw_init(params, topts.opt)
        step = steps.make_train_step(cfg, topts)
        batch = train_batch(cfg.vocab, 1, PLACED_TRAIN_SEQ, dev)
        checks = {name: train_plan(cfg, recipe, 1, PLACED_TRAIN_SEQ,
                                   PLACED_WORLD)
                  for name, (m_, recipe) in PLACED_TRAIN_CHECKS.items()
                  if m_ == model}
        torch.cuda.reset_peak_memory_stats(dev)
        losses, norms = [], []
        sketches = {(name, r): [] for name in checks
                    for r in range(PLACED_WORLD)}
        for i in range(PLACED_TRAIN_STEPS):
            params, opt, m = step(params, opt, i, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            for name, plan in checks.items():
                mesh = plan.binding["mesh"]
                specs = dict(spec_leaves(plan.param_specs))
                for r in range(PLACED_WORLD):
                    at = {"data": 0, "model": r}

                    def view(tree):
                        return tree_map_with_path(lambda n, t: local_shard(
                            t, specs[n], mesh, at), tree)
                    sketches[(name, r)].append(state_sketches(
                        view(params), {"m": view(opt["m"]),
                                       "v": view(opt["v"])}))
        peak = torch.cuda.max_memory_allocated(dev)
        for (name, r), sk in sketches.items():
            torch.save(dict(losses=losses, norms=norms, peak=peak,
                            sketches=sk), work / f"train_{name}_{r}.pt")
        del params, opt, step, batch, sketches
        torch.cuda.empty_cache()


def placed_train_check(name: str, model: str, recipe: str, work: Path,
                       world: int, dev) -> dict:
    """One float32 train check on this rank: its blocks of the seeded
    weights and zero moments, PLACED_TRAIN_STEPS placed steps at batch 1
    of PLACED_TRAIN_SEQ tokens, each step's loss and gradient norm and
    the final blocks' sketches against one process's; the bytes it holds
    against `local_bytes`, and the flash and ssd launches."""
    import torch.distributed as dist
    from repro_torch.distributed.placement import local_bytes
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import adamw_init

    cfg = placed_cfgs()[model]
    topts = train_topts()
    plan = train_plan(cfg, recipe, 1, PLACED_TRAIN_SEQ, world)
    base = torch.cuda.memory_allocated(dev)
    params = placed_params(plan, cfg, world, dev)
    opt = adamw_init(params, topts.opt)
    resident = nbytes(params) + nbytes([opt["m"], opt["v"]])
    torch.cuda.reset_peak_memory_stats(dev)
    step = steps.make_train_step(cfg, topts, plan)
    batch = steps.local_batch(plan, train_batch(cfg.vocab, 1,
                                                PLACED_TRAIN_SEQ, dev))
    want = torch.load(work / f"train_{name}_{dist.get_rank()}.pt")
    ops.reset_launches()
    losses, norms, errs = [], [], []
    for i in range(PLACED_TRAIN_STEPS):
        params, opt, m = step(params, opt, i, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        with torch.no_grad():       # not counted: the kernels ran above
            launches = dict(ops.LAUNCHES)
            errs.append(sketch_errs(state_sketches(params, opt),
                                    want["sketches"][i]))
    peak = torch.cuda.max_memory_allocated(dev) - base
    out = dict(
        model=cfg.name, layers=cfg.n_layers, recipe=recipe,
        seq_entry=plan.seq_entry, batch_entry=plan.batch_entry,
        tp=list(plan.binding["tp"]), tokens=PLACED_TRAIN_SEQ,
        losses=losses, norms=norms, one_process_losses=want["losses"],
        one_process_norms=want["norms"],
        loss_rel_err=max(abs(a - b) / abs(b) for a, b in
                         zip(losses + norms, want["losses"] + want["norms"])),
        block_errs=errs, resident_bytes=resident,
        local_bytes=3 * local_bytes(param_shapes(cfg), plan.param_specs,
                                    plan.binding["mesh"]),
        peak_bytes=peak, one_process_peak=want["peak"],
        flash_launches=launches["flash_attention"],
        ssd_launches=launches["ssd_scan"],
        traffic=dict(step.placement.traffic))
    del params, opt, step, batch
    torch.cuda.empty_cache()
    return out


def placed_train_timing(world: int, dev) -> dict:
    """The bf16 timing on this rank: stablelm-3b at PLACED_TIMING_LAYERS
    layers under "fsdp" (the dry run's recipe; PLACED_TIMING_BATCH rows
    of TRAIN_SEQ tokens, a row a rank, every weight cut over both axes
    and gathered for its use), PLACED_TRAIN_STEPS steps, each timed
    between barriers and its collectives' bytes counted."""
    import torch.distributed as dist
    from repro_torch.distributed.placement import local_bytes
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import adamw_init

    cfg = placed_cfgs()["stablelm_timing"]
    topts = steps.TrainOptions()
    plan = train_plan(cfg, "fsdp", PLACED_TIMING_BATCH, TRAIN_SEQ, world)
    base = torch.cuda.memory_allocated(dev)
    params = placed_params(plan, cfg, world, dev)
    opt = adamw_init(params, topts.opt)
    resident = nbytes(params) + nbytes([opt["m"], opt["v"]])
    torch.cuda.reset_peak_memory_stats(dev)
    step = steps.make_train_step(cfg, topts, plan)
    batch = steps.local_batch(plan, train_batch(
        cfg.vocab, PLACED_TIMING_BATCH, TRAIN_SEQ, dev))
    plc = step.placement
    ops.reset_launches()
    step_s, traffic, losses = [], [], []
    for i in range(PLACED_TRAIN_STEPS):
        before = dict(plc.traffic)
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, i, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        traffic.append({k: v - before.get(k, 0)
                        for k, v in plc.traffic.items()})
    p_bytes = local_bytes(param_shapes(cfg), plan.param_specs,
                          plan.binding["mesh"])
    out = dict(model=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
               recipe="fsdp", rows=batch["tokens"].shape[0], seq=TRAIN_SEQ,
               batch_entry=plan.batch_entry, losses=losses, step_s=step_s,
               tokens_per_s=[batch["tokens"].numel() / t for t in step_s],
               traffic=traffic, resident_bytes=resident,
               local_bytes=p_bytes + 2 * p_bytes * 4
               // torch.empty(0, dtype=getattr(torch, cfg.dtype))
               .element_size(),
               peak_bytes=torch.cuda.max_memory_allocated(dev) - base,
               flash_launches=ops.LAUNCHES["flash_attention"])
    del params, opt, step, batch
    torch.cuda.empty_cache()
    return out


def placed_rank(work: str, world: int) -> dict:
    """One gloo rank of the `placed` phase on cuda:0 (a (1, world) mesh):
    the float32 decode and prefill checks, llama3-8b in bf16 through
    `serve.serve_placed` forced on the engine's tokens, mamba2-1.3b and
    zamba2 served free running, and the bf16 prefills."""
    from repro_torch.distributed.placement import local_bytes
    from repro_torch.distributed.sharding import MeshDesc
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_placed
    from repro_torch.models.transformer import param_shapes

    dev = torch.device("cuda", 0)
    work = Path(work)
    cfgs = placed_cfgs()
    out = {name: placed_check(name, cfgs[name], work, world, dev)
           for name in PLACED_DECODE_CHECKS}
    for name, recipe in PLACED_PREFILL_CHECKS.items():
        out[f"{name}_prefill"] = placed_prefill(name, cfgs[name], recipe,
                                                world, dev, work)
    spec = json.loads((work / "placed.json").read_text())
    mesh = MeshDesc(("data", "model"), (1, world))
    prompts = np.asarray(spec["prompts"])
    for name in ("llama3", "mamba2", "zamba2"):
        cfg = cfgs[name]
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        base = torch.cuda.memory_allocated(dev)
        res = serve_placed(cfg, mesh, prompts if name == "llama3"
                           else prompts[:, :PLACED_SSM_PROMPT] % cfg.vocab,
                           NEW if name == "llama3" else PLACED_SSM_NEW,
                           batch=BATCH, device=dev,
                           teacher=np.asarray(spec["teacher"])
                           if name == "llama3" else None)
        plan = res.pop("plan")
        res["memory_allocated"] -= base
        out[name] = dict(
            res, launches=dict(ops.LAUNCHES), model=cfg.name,
            layers=cfg.n_layers,
            local_bytes=local_bytes(param_shapes(cfg), plan.param_specs,
                                    mesh),
            max_memory_allocated=torch.cuda.max_memory_allocated(dev))
        torch.cuda.empty_cache()
    for name, recipe in PLACED_PREFILLS.items():
        out[f"{name}_prefill"] = placed_prefill(name, cfgs[name], recipe,
                                                world, dev)
    out["train_timing"] = placed_train_timing(world, dev)
    for name, (model, recipe) in PLACED_TRAIN_CHECKS.items():
        out[f"train_{name}"] = placed_train_check(name, model, recipe, work,
                                                  world, dev)
    return out


def placed_one_process(dev, work: Path, engine_tokens: dict) -> None:
    """What the ranks are held to, computed here before they start (and
    freed): each float32 decode check's logits and final cache, each
    float32 prefill check's last logits and cache; the first
    PLACED_REQUESTS of the `serve` phase's requests with the engine's
    tokens."""
    from repro_torch.launch import steps
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_params)

    cfgs = placed_cfgs()

    def weights(cfg):
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        return init_params(cfg, g, dev)

    def host(cache):
        return [{k: t.cpu() for k, t in c.items()} for c in cache]

    for name in PLACED_DECODE_CHECKS:
        cfg = cfgs[name]
        params = weights(cfg)
        cache = init_cache(cfg, BATCH, PLACED_CHECK_STEPS, dev)
        toks = torch.from_numpy(placed_check_tokens(cfg.vocab)).to(dev)
        with torch.no_grad():
            want = torch.stack([decode_step(params, cfg, cache, toks[pos],
                                            pos).cpu()
                                for pos in range(PLACED_CHECK_STEPS)])
        torch.save(want, work / f"{name}.pt")
        torch.save(host(cache), work / f"{name}_cache.pt")
        del params, cache
        torch.cuda.empty_cache()
    for name in PLACED_PREFILL_CHECKS:
        cfg = cfgs[name]
        params = weights(cfg)
        tokens = torch.from_numpy(placed_prompt(cfg.vocab)).to(dev)
        logits, cache = steps.make_prefill_step(cfg)(params,
                                                     {"tokens": tokens})
        torch.save((logits.cpu(), host(cache)), work / f"{name}_prefill.pt")
        del params, cache, logits
        torch.cuda.empty_cache()
    placed_train_one_process(dev, work)
    rng = np.random.default_rng(0)                 # as `serve_run` draws
    prompts = [[int(t) for t in rng.integers(0, cfgs["llama3"].vocab,
                                             PROMPT)]
               for _ in range(REQUESTS)][:PLACED_REQUESTS]
    (work / "placed.json").write_text(json.dumps(dict(
        prompts=prompts,
        teacher=[engine_tokens[r] for r in range(PLACED_REQUESTS)])))


def run_placed_ranks(work: Path, world: int) -> list:
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", PLACED_SCRIPT, str(r), str(world), port,
         str(ROOT), str(ROOT / "src"), str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(
                PLACED_DEADLINE - (time.perf_counter() - t0), 1)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise SystemExit(f"placed rank {r} exited {p.returncode}:"
                             f"\n{err[-3000:]}")
    return [json.loads(next(line[7:] for line in out.splitlines()
                            if line.startswith("RESULT ")))
            for out, _ in outs]


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at |x|."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def placed_phase(dev, power: str, engine_tokens: dict) -> dict:
    """Two gloo ranks sharing the card, a (1, 2) mesh: llama3-8b (full
    width and depth, bf16) served by the placed decode step forced on the
    engine's tokens; mamba2-1.3b (full) and zamba2-7b (full width, 15
    layers) served free running; bf16 prefills of PLACED_PREFILL tokens
    (llama3-8b full under "fsdp", context parallel; mamba2-1.3b full under
    "fsdp", its heads over "model"; qwen3-moe at 2 layers under "ep");
    float32 decode and prefill checks against one process: logits and
    every cache block."""
    import tempfile
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.placement import spec_leaves
    from repro_torch.distributed.sharding import MeshDesc
    from repro_torch.launch import plan as planner
    from repro_torch.launch import steps
    from repro_torch.models.transformer import layer_blocks, param_shapes
    from repro_torch.tree import named_leaves

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        placed_one_process(dev, work, engine_tokens)
        t1 = time.perf_counter()
        ranks = run_placed_ranks(work, PLACED_WORLD)
        ranks_s = time.perf_counter() - t1
    cfgs = placed_cfgs()
    cfg = cfgs["llama3"]
    want = {r: engine_tokens[r] for r in range(PLACED_REQUESTS)}
    got, gaps = {}, {}
    for rk in ranks:
        got.update({int(k): v for k, v in rk["llama3"]["tokens"].items()})
        gaps.update({int(k): v for k, v in rk["llama3"]["gaps"].items()})
    misses = [dict(request=r, step=i, gap=gaps[r][i]) for r in want
              for i, (a, b) in enumerate(zip(got[r], want[r])) if a != b]
    n = sum(len(v) for v in want.values())
    # the model's bytes, and those every rank holds whole (the norms)
    shapes = dict(named_leaves(param_shapes(cfg)))
    whole = sum(t.numel() * t.element_size() for t in shapes.values())
    plan = steps.plan_cell(cfg, ShapeSpec("serve", "decode", MAX_LEN, BATCH),
                           MeshDesc(("data", "model"), (1, PLACED_WORLD)))
    kept = sum(shapes[k].numel() * shapes[k].element_size()
               for k, spec in spec_leaves(plan.param_specs)
               if not any(spec))

    def served(name):
        return [dict(
            {k: r[k] for k in ("weight_bytes", "local_bytes", "cache_bytes",
                               "memory_allocated", "max_memory_allocated",
                               "steps", "wall_s", "traffic")},
            allocated_over_resident=r["memory_allocated"]
            / (r["weight_bytes"] + r["cache_bytes"]),
            ms_per_step=r["wall_s"] * 1e3 / r["steps"],
            requests=len(r["tokens"]),
            decode_launches=r["launches"]["decode_attention"],
            ssd_launches=r["launches"]["ssd_scan"])
            for r in (rk[name] for rk in ranks)]

    serve = dict(
        model=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
        requests=PLACED_REQUESTS, forced_tokens=n,
        agreement_with_engine=1 - len(misses) / n, mismatches=misses,
        max_mismatch_gap=max((m["gap"] for m in misses), default=0.0),
        one_process_weight_bytes=whole, replicated_weight_bytes=kept,
        ranks=served("llama3"))
    ssm_serve = {name: dict(model=cfgs[name].name,
                            layers=cfgs[name].n_layers,
                            shared_occurrences=sum(
                                b.kind == "shared_attn"
                                for b in layer_blocks(cfgs[name])),
                            ranks=served(name))
                 for name in ("mamba2", "zamba2")}
    prefills = {name: [rk[f"{name}_prefill"] for rk in ranks]
                for name in PLACED_PREFILLS}
    checks = {name: [rk[name] for rk in ranks]
              for name in PLACED_DECODE_CHECKS}
    prefill_checks = {name: [rk[f"{name}_prefill"] for rk in ranks]
                      for name in PLACED_PREFILL_CHECKS}
    train_checks = {name: [rk[f"train_{name}"] for rk in ranks]
                    for name in PLACED_TRAIN_CHECKS}
    timing = [rk["train_timing"] for rk in ranks]
    planned = planner.plan_one(
        cfgs["stablelm_timing"], ShapeSpec("train_4k", "train", TRAIN_SEQ,
                                           PLACED_TIMING_BATCH),
        f"1x{PLACED_WORLD}", recipe="fsdp", arch="stablelm-3b")
    train_timing = dict(
        ranks=timing, planned_collective=planned["collective_by_kind"],
        planned_bytes=planned["bytes_per_device"],
        gathered_bytes=[[t.get("all_gather", 0) for t in r["traffic"]]
                        for r in timing],
        planned_gathered_bytes=planned["collective_by_kind"].get(
            "all_gather", 0),
        step_s=[r["step_s"] for r in timing],
        tokens_per_s_a_rank=[r["tokens_per_s"] for r in timing],
        peak_over_planned=[r["peak_bytes"] / planned["bytes_per_device"][
            "peak"] for r in timing])
    emit("placed", name=torch.cuda.get_device_name(dev), power_limit=power,
         world=PLACED_WORLD, mesh=[1, PLACED_WORLD], serve=serve,
         ssm_serve=ssm_serve, prefills=prefills, float32_checks=checks,
         float32_prefill_checks=prefill_checks,
         float32_train_checks=train_checks, train_timing=train_timing,
         ranks_s=ranks_s,
         phase_s=time.perf_counter() - t0,
         timing_note="gloo ranks sharing one card: every collective is "
                     "staged through the host; the times are no speed")
    held = [r for c in checks.values() for r in c] + serve["ranks"] + [
        r for v in ssm_serve.values() for r in v["ranks"]]
    all_prefills = [r for c in (prefills, prefill_checks) for v in c.values()
                    for r in v]
    zamba = ssm_serve["zamba2"]
    fail_on("placed", {
        "float32 decode checks within 1e-5 of one process on every rank: "
        "logits and every cache block": all(
            r["max_rel_err"] <= 1e-5
            and max(r["cache_rel_err"].values()) <= 1e-5
            for c in checks.values() for r in c),
        "float32 prefill checks within 1e-5 of one process on every rank: "
        "last logits and every cache block": all(
            r["max_rel_err"] <= 1e-5
            and max(r["cache_rel_err"].values()) <= 1e-5
            for c in prefill_checks.values() for r in c),
        "every rank holds local_bytes of weights: llama3's half of all but "
        "the replicated norms": all(
            r["weight_bytes"] == r["local_bytes"]
            for r in held + all_prefills) and all(
            r["weight_bytes"] == (whole - kept) // PLACED_WORLD + kept
            for r in serve["ranks"]),
        # over what the rank held before the cell (cuBLAS's workspaces,
        # which the first products of a process allocate, among it)
        "memory_allocated for the cell within 1% of its weights and "
        "cache":
            all(abs(r["memory_allocated"] / (r["weight_bytes"]
                                             + r["cache_bytes"]) - 1) <= 0.01
                for r in held),
        "decode kernel once per attention layer and step on every rank "
        "(zamba2: each shared occurrence; mamba2: none)": all(
            r["decode_launches"] == cfg.n_layers * r["steps"]
            for r in serve["ranks"]) and all(
            r["decode_launches"] == zamba["shared_occurrences"] * r["steps"]
            for r in zamba["ranks"]) and all(
            r["decode_launches"] == 0
            for r in ssm_serve["mamba2"]["ranks"]),
        "every request served": all(
            r["requests"] == PLACED_REQUESTS for r in held
            if "requests" in r),
        "prefills: flash once per attention layer, ssd once per mamba2 "
        "layer, finite logits": all(
            r["finite"] and r["launches"]["flash_attention"]
            == sum(b.kind != "mamba2" for b in layer_blocks(cfgs[name]))
            and r["launches"]["ssd_scan"]
            == sum(b.kind == "mamba2" for b in layer_blocks(cfgs[name]))
            for c in (prefills, prefill_checks) for name, v in c.items()
            for r in v),
        "llama3's prefill context parallel, mamba2's on heads over model":
            all(r["seq_entry"] == "model" and r["tp"] == []
                for r in prefills["llama3"]) and all(
                r["seq_entry"] is None and r["tp"] == ["model"]
                for r in prefills["mamba2"]),
        "float32 train checks within 1e-5 of one process on every rank: "
        "loss and gradient norm of both steps, every parameter and moment "
        "block after each step (estimated from its sketches, against its "
        "tree; mamba2's 1e-4, PLACED_TRAIN_TOL)": all(
            r["loss_rel_err"] <= 1e-5
            and all(e["rel_tree"] <= PLACED_TRAIN_TOL.get(name, 1e-5)
                    for step in r["block_errs"] for e in step.values())
            for name, c in train_checks.items() for r in c),
        "placed train: every rank holds local_bytes of parameters and "
        "moments": all(r["resident_bytes"] == r["local_bytes"]
                       for c in list(train_checks.values()) + [timing]
                       for r in c),
        "placed train: flash once per attention layer, ssd once per mamba2 "
        "layer, in the forward and the recompute of each step": all(
            r["flash_launches"] == 2 * PLACED_TRAIN_STEPS * sum(
                b.kind != "mamba2" for b in layer_blocks(
                    cfgs[PLACED_TRAIN_CHECKS[name][0]]))
            and r["ssd_launches"] == 2 * PLACED_TRAIN_STEPS * sum(
                b.kind == "mamba2" for b in layer_blocks(
                    cfgs[PLACED_TRAIN_CHECKS[name][0]]))
            for name, c in train_checks.items() for r in c) and all(
            r["flash_launches"] == 2 * PLACED_TRAIN_STEPS
            * PLACED_TIMING_LAYERS for r in timing),
        "placed train bf16 timing: finite losses, each step's collective "
        "bytes the planner's dry count": all(
            all(math.isfinite(x) for x in r["losses"])
            and all(t == planned["collective_by_kind"] for t in r["traffic"])
            for r in timing),
        "placed train: context parallel, sp = tp, the SSM's replicated "
        "residual and expert parallelism among the checks": all(
            r["seq_entry"] == "model" and r["tp"] == []
            for r in train_checks["stablelm_fsdp"]) and all(
            r["seq_entry"] == "model" and r["tp"] == ["model"]
            for r in train_checks["stablelm_tp"]) and all(
            r["seq_entry"] is None and r["tp"] == ["model"]
            for r in train_checks["mamba2_fsdp"]),
        # bf16 with random weights: near-flat logits, so a tie within bf16
        # rounding can go either way; forced on the engine's tokens, the
        # placed argmax may differ from the engine's only at such a tie
        "forced on the engine's tokens, every mismatch a bf16 near tie":
            serve["max_mismatch_gap"] <= 2 * bf16_ulp(PLACED_LOGIT_SCALE),
    })
    return serve


def plan_line(dev, power: str) -> None:
    """The planner (`launch/plan.py`) under 1x1 against the card: each
    model a phase builds, its parameter bytes against the bytes that
    `init_params` leaves allocated, as requested of the caching allocator
    (within 1%) and as it holds them in blocks (`memory_allocated`,
    rounded up to its block sizes; reported); and its peak estimates
    beside peaks measured by earlier runs of this script (PERF.md §5-§6),
    reported."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import plan
    from repro_torch.models.transformer import init_params

    models = [(a, get_config(a)) for a in (
        "llama3-8b", "stablelm-3b", "mamba2-1.3b", "gemma3-4b",
        "minitron-8b", "musicgen-large", "zamba2-7b")]
    models += [(MOE_ARCH, layers_cut(get_config(MOE_ARCH), MOE_LAYERS)),
               (MIXTRAL_ARCH, layers_cut(get_config(MIXTRAL_ARCH),
                                         MIXTRAL_LAYERS))]
    one = ShapeSpec("decode_32k", "decode", 64, 1)
    rows = []
    for arch, cfg in models:
        planned = plan.plan_one(cfg, one, "1x1", arch=arch)[
            "bytes_per_device"]["params"]
        torch.cuda.empty_cache()
        before = (torch.cuda.memory_allocated(dev), torch.cuda.memory_stats(
            dev)["requested_bytes.all.current"])
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        params = init_params(cfg, g, dev)
        got = torch.cuda.memory_allocated(dev) - before[0]
        asked = torch.cuda.memory_stats(dev)[
            "requested_bytes.all.current"] - before[1]
        del params
        torch.cuda.empty_cache()
        rows.append(dict(arch=arch, layers=cfg.n_layers, planned=planned,
                         requested=asked, ratio=asked / planned,
                         memory_allocated=got,
                         allocated_ratio=got / planned))
    # earlier measured peaks (PERF.md: PR 20's zamba2 long prefill, PR 15's
    # stablelm train step, PR 21's decode_32k at batch 8)
    peaks = []
    for arch, shape, micro, measured in (
            ("zamba2-7b", ShapeSpec("prefill_32k", "prefill", ZAMBA_LONG, 1),
             1, 26.33e9),
            ("stablelm-3b", ShapeSpec("train_4k", "train", TRAIN_SEQ,
                                      TRAIN_BATCH), TRAIN_MICRO, 46.73e9),
            ("llama3-8b", ShapeSpec("decode_32k", "decode", 32_768,
                                    MD_BATCH), 1, 63.59e9)):
        rec = plan.plan_one(get_config(arch), shape, "1x1", arch=arch,
                            microbatch=micro)
        peaks.append(dict(arch=arch, shape=dataclasses.asdict(shape),
                          microbatch=micro,
                          planned_peak=rec["bytes_per_device"]["peak"],
                          planned=rec["bytes_per_device"],
                          measured_peak_earlier_run=measured))
    emit("plan", name=torch.cuda.get_device_name(dev), power_limit=power,
         params_1x1=rows, peaks=peaks)
    fail_on("plan", {
        "1x1 parameter bytes within 1% of the bytes init_params "
        "requested": all(abs(r["ratio"] - 1) <= 0.01 for r in rows)})


# ----------------------------------------------------------------------
# lsm: the HotRAP engine (`repro_torch.core`) on the card
# ----------------------------------------------------------------------
def json_mismatches(want, got, path: str = "") -> list[str]:
    """Paths where two JSON-like trees differ: a missing key, a length, a
    type or a value.  Floats must be equal: one ulp apart is a
    mismatch."""
    if type(want) is not type(got):
        return [f"{path}: {type(want).__name__} != {type(got).__name__}"]
    if isinstance(want, np.ndarray):
        if want.shape != got.shape:
            return [f"{path}: shape {want.shape} != {got.shape}"]
        bad = np.flatnonzero((want != got).reshape(-1))
        return ([f"{path}[{int(bad[0])}]: {want.reshape(-1)[bad[0]]!r} != "
                 f"{got.reshape(-1)[bad[0]]!r}"] if len(bad) else [])
    if isinstance(want, dict):
        out = [f"{path}/{k}: missing" for k in
               sorted(set(want).symmetric_difference(got), key=str)]
        for k in want:
            if k in got:
                out += json_mismatches(want[k], got[k], f"{path}/{k}")
        return out
    if isinstance(want, (list, tuple)):
        if len(want) != len(got):
            return [f"{path}: length {len(want)} != {len(got)}"]
        return [m for i, (a, b) in enumerate(zip(want, got))
                for m in json_mismatches(a, b, f"{path}[{i}]")]
    if want != got and not (want != want and got != got):   # NaN == NaN
        return [f"{path}: {want!r} != {got!r}"]
    return []


def lsm_outcomes(outcomes: list) -> dict:
    """`run_workload`'s per-op outcomes as arrays: each get's (seq, vlen)
    ((-1, -1) for a miss), each put's seq, each scan's records."""
    gets, puts, scan_lens, scans = [], [], [], []
    for r in outcomes:
        if r is None or isinstance(r, tuple):
            gets.append(r or (-1, -1))
        elif isinstance(r, list):
            scan_lens.append(len(r))
            scans.extend(r)
        else:
            puts.append(r)
    return {"gets": np.array(gets, np.int64).reshape(-1, 2),
            "puts": np.array(puts, np.int64),
            "scan_lens": np.array(scan_lens, np.int64),
            "scans": np.array(scans, np.int64).reshape(-1, 3)}


def lsm_digest(db, result, outcomes: list) -> dict:
    """What a run must reproduce: `RunResult.to_json()`, every op's
    outcome, and each level's runs (by content and position, never by
    sid: sids come from a process-wide counter)."""
    return {"result": result.to_json(), "outcomes": lsm_outcomes(outcomes),
            "levels": [[(s.tier, s.level, s.keys.cpu().numpy(),
                         s.seqs.cpu().numpy(), s.vlens.cpu().numpy())
                        for s in level] for level in db.levels]}


def lsm_mismatches(want: dict, got: dict) -> list[str]:
    """Every difference between two `lsm_digest`s: result fields (floats
    bit for bit), outcomes (the first differing get, put or scan record)
    and level runs."""
    out = json_mismatches(want["result"], got["result"], "result")
    for name, a in want["outcomes"].items():
        b = got["outcomes"][name]
        if a.shape != b.shape:
            out.append(f"outcomes/{name}: shape {a.shape} != {b.shape}")
        elif not np.array_equal(a, b):
            i = int(np.flatnonzero((a != b).reshape(len(a), -1).any(1))[0])
            out.append(f"outcomes/{name}[{i}]: {a[i].tolist()} != "
                       f"{b[i].tolist()}")
    if [len(x) for x in want["levels"]] != [len(x) for x in got["levels"]]:
        out.append("levels: table counts differ")
    else:
        for li, (wl, gl) in enumerate(zip(want["levels"], got["levels"])):
            for j, (w, g) in enumerate(zip(wl, gl)):
                if w[:2] != g[:2] or not all(
                        np.array_equal(a, b) for a, b in zip(w[2:], g[2:])):
                    out.append(f"levels[{li}][{j}] differs")
    return out


def host_ints(a) -> np.ndarray:
    """A tensor's or an array's values as a host int64 array."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).astype(np.int64)


def shard_digest(db) -> dict:
    """One engine's state that recovery, sharding and migration must
    reproduce: each level's tables by content and position (never by
    sid), the memtables, `seq`, the current Version's pins, and with a
    WAL its durable half (the synced records, the counters, the
    horizon) and `recovery_info`."""
    d = {"levels": [[(s.tier, s.level, host_ints(s.keys), host_ints(s.seqs),
                      host_ints(s.vlens)) for s in level]
                    for level in db.levels],
         "memtable": sorted(db.memtable.items()),
         "imm_memtables": [sorted(m.items()) for m in db.imm_memtables],
         "seq": db.seq, "version_refs": db.version.refs}
    dur = db.durability
    if dur is not None:
        wal, man = dur.wal, dur.manifest
        d["durable"] = {
            "horizon": dur.horizon(), "durable_seq": wal.durable_seq,
            "synced": [list(r) for r in wal._synced],
            "buffered": len(wal._buffer),
            "appended_records": wal.appended_records, "syncs": wal.syncs,
            "synced_bytes": wal.synced_bytes, "manifest_edits": man.edits,
            "flushed_through": man.flushed_through,
            "inherited_seq": dur.inherited_seq, "retired": dur.retired}
    info = getattr(db, "recovery_info", None)
    if info is not None:
        d["recovery_info"] = dict(info)
    return d


def engine_digest(db) -> dict:
    """`shard_digest` of an engine, or of every shard of a cluster with
    its fences, cluster seq, topology records, repartitioner and
    arbiter state and `recovery_info`."""
    if not hasattr(db, "shards"):
        return shard_digest(db)
    d = {"shards": [shard_digest(sh) for sh in db.shards],
         "bounds": [int(b) for b in db._bounds_list],
         "global_seq": db.global_seq}
    if db.durability is not None:
        d["topology"] = [dict(r) for r in db.durability.topology]
    if db.repartitioner is not None:
        d["repartition"] = db.repartitioner.snapshot()
    if db.hot_budget is not None:
        d["hot_budget"] = db.hot_budget.snapshot()
    info = getattr(db, "recovery_info", None)
    if info is not None:
        d["recovery_info"] = dict(info)
    return d


def count_syncs(fn):
    """(fn(), the host syncs it made), counted by CUDA's sync debug
    mode's warnings."""
    import warnings
    count = [0]

    def seen(message, *args, **kw):
        count[0] += "synchroniz" in str(message)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, count[0]


def lsm_load(system: str, scale: str, device, shard_cfg=None,
             **overrides) -> tuple:
    """A loaded engine of `system` at `scale` (a cluster when
    `shard_cfg`, a function of the key count, gives its ShardConfig;
    `overrides` replace LSMConfig fields) and its load's wall seconds
    (deep copies give each cell the same start)."""
    from repro_torch.core import baselines, runner
    cfg = dataclasses.replace(runner.default_config(scale), **overrides)
    n_keys = runner.db_key_count(cfg, LSM_VALUE)
    db = (baselines.make_system(system, cfg, device=device)
          if shard_cfg is None else baselines.make_sharded_system(
              system, cfg, shard_cfg(n_keys), device=device))
    t0 = time.perf_counter()
    runner.load_db(db, n_keys, LSM_VALUE)
    if db.device.type == "cuda":
        torch.cuda.synchronize()
    return db, n_keys, time.perf_counter() - t0


def lsm_run(loaded, system: str, mix: str, dist: str, n_keys: int,
            n_ops: int, syncs: bool = False, obs=None,
            name: str = "db") -> tuple:
    """One cell on a clone of a loaded engine (its tensors copied on its
    device; `obs` attached to the clone as `name` when given): (engine,
    RunResult, outcomes, wall seconds, host syncs or None)."""
    import copy

    from repro_torch.core import runner
    from repro_torch.data import workloads
    db = copy.deepcopy(loaded)
    if obs is not None:
        obs.attach(db, name=name)
    wl = workloads.ycsb(mix, workloads.KeyDist(dist, n_keys), n_ops,
                        LSM_VALUE, seed=0)
    outcomes: list = []
    cuda = db.device.type == "cuda"

    def go():
        res = runner.run_workload(db, wl, name=system,
                                  results_out=outcomes)
        if cuda:
            torch.cuda.synchronize()
        return res

    t0 = time.perf_counter()
    res, n_syncs = count_syncs(go) if syncs else (go(), None)
    return db, res, outcomes, time.perf_counter() - t0, n_syncs


def lsm_workload(mix: str, n_keys: int, n_ops: int, seed: int):
    from repro_torch.data import workloads
    return workloads.ycsb(mix, workloads.KeyDist("hotspot", n_keys), n_ops,
                          LSM_VALUE, seed=seed)


def synced(db) -> None:
    if db.device.type == "cuda":
        torch.cuda.synchronize()


def run_digest(db, result, outcomes: list) -> dict:
    """What a cluster or recovery cell must reproduce: the run's
    `RunResult.to_json()`, every op's outcome and the engine's state
    (`engine_digest`); compared with `json_mismatches`."""
    return {"result": result.to_json(), "outcomes": lsm_outcomes(outcomes),
            "engine": engine_digest(db)}


def on_card_rows(db) -> dict:
    """Every tensor of an engine or of every shard of a cluster, and of
    the tables its manifests keep (the WAL's registry), and whether all
    of them lie on the card; their distinct bytes."""
    from repro_torch.core.sstable import storage_bytes
    shards = getattr(db, "shards", [db])
    reg = [t for sh in shards if sh.durability is not None
           for sst in sh.durability.manifest.sstables.values()
           for t in sst.tensors()]
    ts = db.tensors()
    return {"tensors": len(ts), "on_cuda": all(t.is_cuda for t in ts + reg),
            "device_bytes": db.device_bytes(),
            "registry_bytes": storage_bytes(reg)}


def obs_digest(obs) -> dict:
    """What an attached `Observability` recorded, as JSON-like trees: the
    trace document (`Tracer.to_dict`: names, phases, pid/tid, args,
    timestamps), the metrics series and the attribution summary."""
    from repro_torch.obs import jsonify
    return {"trace": obs.tracer.to_dict(),
            "metrics": jsonify(obs.metrics.to_json()),
            "attribution": jsonify(obs.attr.summary())}


def without_attribution(digest: dict) -> dict:
    """A `run_digest` or `lsm_digest` without its RunResult's
    attribution, the one field an attached plane adds to a run."""
    return {**digest, "result": {k: v for k, v in digest["result"].items()
                                 if k != "attribution"}}


def plane_checks(base: dict, attached: dict, obs) -> dict:
    """An attached run against the same run unattached: the same digest
    but for the attribution (the plane only reads), a stack-balanced
    monotone trace, and no event dropped."""
    return {"read_only": not json_mismatches(without_attribution(base),
                                             without_attribution(attached)),
            "trace_valid": not obs.tracer.validate(),
            "no_dropped_events": obs.tracer.dropped == 0}


def event_counts(obs) -> dict:
    """Events recorded, by name."""
    out: dict = {}
    for ev in obs.tracer.events:
        out[ev["name"]] = out.get(ev["name"], 0) + 1
    return out


def sanitized_run(loaded, n_keys: int) -> tuple:
    """`hotrap` RW (LSM_TINY_OPS ops) on a clone of a loaded engine under
    `sanitize_db(check_every=LSM_SANITIZE_EVERY)` (its books reset after
    the wrap, so every counted op crosses the proxy), then `close()`:
    ({"run": lsm_digest, "report": the close report} or {"error": the
    SanitizeError}, row)."""
    import copy

    from repro_torch.core import SanitizeError, runner, sanitize_db
    db = sanitize_db(copy.deepcopy(loaded), check_every=LSM_SANITIZE_EVERY)
    db.reset_storage()          # the sanitizer counts ops from here
    outs: list = []
    t0 = time.perf_counter()
    try:
        res = runner.run_workload(db, lsm_workload("RW", n_keys,
                                                   LSM_TINY_OPS, 0),
                                  name="hotrap", results_out=outs)
        report = db.close()
    except SanitizeError as e:
        return {"error": str(e)[:300]}, {"cell": "hotrap/RW/sanitized",
                                          "error": str(e)[:300]}
    synced(db)
    wall = time.perf_counter() - t0
    return ({"run": lsm_digest(db, res, outs), "report": report},
            {"cell": "hotrap/RW/sanitized", "ops": LSM_TINY_OPS,
             "wall_s": wall, "us_per_op": wall / LSM_TINY_OPS * 1e6,
             "report": report})


def compared_cells(device, card: bool = False) -> tuple:
    """The compared systems at tiny (LSM_COMPARED under LSM_COMPARED_OPS on
    hotspot-5%) and `hotrap` RW under the sanitizer: ({key: digest},
    [row]); the twin runs them on the CPU."""
    digests, rows = {}, []
    for system in LSM_COMPARED:
        loaded, n_keys, load_s = lsm_load(system, "tiny", device)
        for mix, n_ops in LSM_COMPARED_OPS.items():
            db, res, outs, wall, _ = lsm_run(loaded, system, mix, "hotspot",
                                              n_keys, n_ops)
            digests[("tiny", system, mix, "hotspot")] = lsm_digest(db, res,
                                                                   outs)
            rows.append({"cell": f"{system}/{mix}/hotspot", "ops": n_ops,
                         "load_wall_s": load_s, "wall_s": wall,
                         "us_per_op": wall / n_ops * 1e6,
                         "fd_hit_rate": res.fd_hit_rate,
                         "throughput": res.throughput,
                         **(engine_on_card(db) if card else {})})
            del db
        del loaded
    loaded, n_keys, _ = lsm_load("hotrap", "tiny", device)
    digests[("tiny", "hotrap", "RW", "sanitized")], row = sanitized_run(
        loaded, n_keys)
    rows.append(row)
    return digests, rows


def sas_scale_cell(device, n_ops: int, card: bool = False) -> tuple:
    """`sas_cache` under hotspot-5% RO at LSM_SCALE, `n_ops` ops: (digest,
    row); on the card also its host syncs over LSM_SAS_SYNC_OPS ops."""
    loaded, n_keys, load_s = lsm_load("sas_cache", LSM_SCALE, device)
    db, res, outs, wall, _ = lsm_run(loaded, "sas_cache", "RO", "hotspot",
                                     n_keys, n_ops)
    row = {"cell": f"{LSM_SCALE}/sas_cache/RO/hotspot", "keys": n_keys,
           "ops": n_ops, "load_wall_s": load_s, "run_wall_s": wall,
           "us_per_op": wall / n_ops * 1e6,
           "sim_ops_per_s": res.throughput, "fd_hit_rate": res.fd_hit_rate,
           "secondary_hits": db.secondary.hits,
           "secondary_misses": db.secondary.misses}
    digest = lsm_digest(db, res, outs)
    if card:
        row.update(engine_on_card(db))
        del db
        _, _, _, _, n_syncs = lsm_run(loaded, "sas_cache", "RO", "hotspot",
                                      n_keys, LSM_SAS_SYNC_OPS, syncs=True)
        row["syncs_per_op"] = n_syncs / LSM_SAS_SYNC_OPS
    return digest, row


def wal_cell(loaded, n_keys: int, site: str) -> tuple:
    """`site` armed at its LSM_WAL_HITS-th visit during 20,000 RW ops on a
    clone of a loaded WAL engine, `TieredLSM.recover`, then
    LSM_AFTER_OPS more ops: (digest, row, recovered engine)."""
    import copy

    from repro_torch.core import crashpoints, runner
    db = copy.deepcopy(loaded)
    wl = lsm_workload("RW", n_keys, LSM_TINY_OPS, 0)
    more = lsm_workload("RW", n_keys, LSM_AFTER_OPS, 1)
    before, after = [], []
    t0 = time.perf_counter()
    crashed, rec = crashpoints.crash_recover(
        db, lambda d: runner.run_workload(d, wl, name="hotrap",
                                          results_out=before),
        site, LSM_WAL_HITS[site])
    recovered = engine_digest(rec)
    res = runner.run_workload(rec, more, name="hotrap", results_out=after)
    synced(rec)
    wall = time.perf_counter() - t0
    digest = {"crashed": crashed, "before": lsm_outcomes(before),
              "recovered": recovered, "after": run_digest(rec, res, after)}
    return digest, {"cell": f"wal/{site}", "crashed": crashed,
                    "wall_s": wall, "recovery": rec.recovery_info,
                    **on_card_rows(rec)}, rec


def split_merge_cell(loaded, n_keys: int, sanitize: bool = False) -> tuple:
    """Three RW segments on a clone of the loaded range cluster: a split
    of shard 0 forced before the second (its cutover lands inside it), a
    merge of shards 1 and 2 before the third; with `sanitize` the clone
    runs under the sanitizer and its `close()` report joins the
    digest."""
    import copy

    from repro_torch.core import runner, sanitize_db
    db = copy.deepcopy(loaded)
    if sanitize:
        db = sanitize_db(db, check_every=LSM_SANITIZE_EVERY)
        db.reset_storage()      # the sanitizer counts ops from here
    rep = db.repartitioner
    parts = []
    t0 = time.perf_counter()
    for seg in range(3):
        if seg == 1:
            assert rep.force_split(0)
        if seg == 2:
            rep.drain()
            assert rep.force_merge(1)
        outs: list = []
        res = runner.run_workload(db, lsm_workload("RW", n_keys,
                                                   LSM_SEGMENT_OPS, seg),
                                  name="hotrap", results_out=outs)
        parts.append(run_digest(db, res, outs))
    rep.drain()
    report = db.close() if sanitize else None
    synced(db)
    row = {"cell": "range2/split+merge" + ("/sanitized" if sanitize else ""),
           "wall_s": time.perf_counter() - t0,
           "splits": rep.n_splits, "merges": rep.n_merges,
           "bounds": list(db._bounds_list), **on_card_rows(db)}
    digest = {"segments": parts, "engine": engine_digest(db)}
    if sanitize:
        row["report"] = digest["report"] = report
    return digest, row, db


def migration_crash_cell(loaded, n_keys: int, site: str) -> tuple:
    """A split of shard 0 forced after one RW segment on a clone of the
    loaded range cluster, `site` armed during the next; then
    `ShardedTieredLSM.recover` and LSM_AFTER_OPS more ops."""
    import copy

    from repro_torch.core import crashpoints, runner
    db = copy.deepcopy(loaded)
    before, after = [], []

    def drive(d):
        runner.run_workload(d, lsm_workload("RW", n_keys, LSM_SEGMENT_OPS,
                                            0), results_out=before)
        assert d.repartitioner.force_split(0)
        runner.run_workload(d, lsm_workload("RW", n_keys, LSM_SEGMENT_OPS,
                                            1), results_out=before)

    t0 = time.perf_counter()
    crashed, rec = crashpoints.crash_recover(db, drive, site)
    recovered = engine_digest(rec)
    res = runner.run_workload(rec, lsm_workload("RW", n_keys, LSM_AFTER_OPS,
                                                2), results_out=after)
    synced(rec)
    digest = {"crashed": crashed, "before": lsm_outcomes(before),
              "recovered": recovered, "after": run_digest(rec, res, after)}
    return digest, {"cell": f"range2/{site}", "crashed": crashed,
                    "wall_s": time.perf_counter() - t0,
                    "recovery": rec.recovery_info,
                    "version_refs": [sh.version.refs for sh in rec.shards],
                    **on_card_rows(rec)}, rec


def hash4(n_keys: int):
    from repro_torch.core.shards import ShardConfig
    return ShardConfig(n_shards=4)


def range2(n_keys: int):
    """Two range shards over the loaded keys, split and merged only when
    forced, the migration stream at its default rate."""
    from repro_torch.core.shards import ShardConfig
    return ShardConfig(n_shards=2, partitioning="range", key_space=n_keys,
                       repartition=True, repartition_interval_ops=10 ** 9)


def kv_shape(n_keys: int):
    """`configs/hotrap_kv.py`'s cluster shape (4 hash shards, HotBudget)."""
    from repro_torch.configs import hotrap_kv
    return hotrap_kv.shard_config()


def durable_cluster_cells(device, card: bool = False) -> tuple:
    """The WAL and cluster cells of the lsm phase on `device`: ({key:
    digest}, [row]); the twin runs them on the CPU with `card` False,
    which skips the timed-only runs (`rocksdb_tiered`, HotRAP RO at
    medium) and the sync counts."""
    digests, rows = {}, []
    loaded, n_keys, load_s = lsm_load("hotrap", "tiny", device, wal=True)
    rows.append({"cell": "wal/load", "wall_s": load_s})
    for site in LSM_WAL_HITS:
        digests[("wal", site)], row, _ = wal_cell(loaded, n_keys, site)
        rows.append(row)
    loaded, n_keys, load_s = lsm_load("hotrap", "tiny", device, hash4)
    rows.append({"cell": "hash4/load", "wall_s": load_s})
    for mix, n_ops in LSM_CLUSTER_OPS.items():
        db, res, outs, wall, _ = lsm_run(loaded, "hotrap", mix, "hotspot",
                                         n_keys, n_ops)
        digests[("hash4", mix)] = run_digest(db, res, outs)
        rows.append({"cell": f"hash4/{mix}", "ops": n_ops, "wall_s": wall,
                     "us_per_op": wall / n_ops * 1e6,
                     "rebalances": db.hot_budget.n_rebalances,
                     "shares": db.hot_budget.snapshot()["shares"],
                     **on_card_rows(db)})
    # RW again with the observability plane attached
    from repro_torch.obs import Observability
    obs = Observability()
    n_ops = LSM_CLUSTER_OPS["RW"]
    db, res, outs, wall, _ = lsm_run(loaded, "hotrap", "RW", "hotspot",
                                     n_keys, n_ops, obs=obs, name="hash4")
    attached = run_digest(db, res, outs)
    digests[("hash4", "RW", "attached")] = {"run": attached,
                                            "plane": obs_digest(obs)}
    rows.append({"cell": "hash4/RW/attached", "ops": n_ops, "wall_s": wall,
                 "us_per_op": wall / n_ops * 1e6,
                 "events": len(obs.tracer.events),
                 "dropped": obs.tracer.dropped,
                 "metrics_samples": obs.metrics.n_samples,
                 "attribution_n_seen": obs.attr.n_seen,
                 **plane_checks(digests[("hash4", "RW")], attached, obs)})
    loaded, n_keys, load_s = lsm_load("hotrap", "tiny", device, range2,
                                      wal=True)
    rows.append({"cell": "range2/load", "wall_s": load_s})
    digests[("range2", "split+merge")], row, _ = split_merge_cell(loaded,
                                                                 n_keys)
    rows.append(row)
    digests[("range2", "split+merge", "sanitized")], row, _ = \
        split_merge_cell(loaded, n_keys, sanitize=True)
    rows.append(row)
    for site in LSM_MIGRATION_SITES:
        digests[("range2", site)], row, _ = migration_crash_cell(
            loaded, n_keys, site)
        rows.append(row)
    del loaded
    scale = []
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    systems = ("hotrap", "rocksdb_tiered") if card else ("hotrap",)
    for system in systems:
        loaded, n_keys, load_s = lsm_load(system, LSM_SCALE, device,
                                          kv_shape, wal=True)
        for mix in (("RW", "RO") if system == "hotrap" else ("RO",)):
            if not card and mix == "RO":
                continue
            db, res, outs, wall, _ = lsm_run(loaded, system, mix, "hotspot",
                                             n_keys, LSM_SCALE_OPS)
            if mix == "RW":
                digests[(LSM_SCALE, "kv4", mix)] = run_digest(db, res, outs)
            unattached_digest = digests.get((LSM_SCALE, "kv4", mix))
            row = {"cell": f"{LSM_SCALE}/kv4/{system}/{mix}",
                   "keys": n_keys, "ops": LSM_SCALE_OPS,
                   "load_wall_s": load_s, "run_wall_s": wall,
                   "us_per_op": wall / LSM_SCALE_OPS * 1e6,
                   "sim_ops_per_s": res.throughput,
                   "fd_hit_rate": res.fd_hit_rate,
                   "durability": res.durability, **on_card_rows(db)}
            del db
            if card:
                _, _, _, _, n_syncs = lsm_run(loaded, system, mix, "hotspot",
                                              n_keys, LSM_SYNC_OPS,
                                              syncs=True)
                row["syncs_per_op"] = n_syncs / LSM_SYNC_OPS
                row["max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated(device)
                if mix == "RW":
                    row["attached"] = attached_scale_run(
                        loaded, system, n_keys, unattached_digest)
            scale.append(row)
        del loaded
    return digests, rows, scale


def attached_scale_run(loaded, system: str, n_keys: int,
                       unattached: dict) -> dict:
    """The medium cluster's RW run again with `Observability()` attached:
    its digest against the unattached run's, its cost (µs an op, host
    syncs an op over LSM_SYNC_OPS ops, each with a plane of its own),
    its events by name, and its trace exported to a temporary file."""
    import tempfile

    from repro_torch.obs import Observability
    obs = Observability()
    db, res, outs, wall, _ = lsm_run(loaded, system, "RW", "hotspot",
                                     n_keys, LSM_SCALE_OPS, obs=obs,
                                     name="kv4")
    row = {"run_wall_s": wall, "us_per_op": wall / LSM_SCALE_OPS * 1e6,
           "events": len(obs.tracer.events), "dropped": obs.tracer.dropped,
           "events_by_name": event_counts(obs),
           "metrics_samples": obs.metrics.n_samples,
           "attribution_n_seen": obs.attr.n_seen,
           **plane_checks(unattached, run_digest(db, res, outs), obs)}
    del db
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "kv4_trace.json"
        t0 = time.perf_counter()
        obs.export(trace_path=str(path))
        row["export_s"] = time.perf_counter() - t0
        row["trace_file_bytes"] = path.stat().st_size
    _, _, _, _, n_syncs = lsm_run(loaded, system, "RW", "hotspot", n_keys,
                                  LSM_SYNC_OPS, syncs=True,
                                  obs=Observability(), name="kv4")
    row["syncs_per_op"] = n_syncs / LSM_SYNC_OPS
    return row


def lsm_twin(out_path: str) -> None:
    """The CPU twin of the lsm phase's checked cells: every tiny cell and
    the scale cell held to it, their digests pickled to `out_path`."""
    import pickle
    torch.set_num_threads(1)     # the engine's ops are small: one thread
    digests, walls = {}, {}
    loads: dict = {}
    for system, mix, dist in LSM_TINY_CELLS:
        if system not in loads:
            db, n_keys, _ = lsm_load(system, "tiny", "cpu")
            loads[system] = (db, n_keys)
        loaded, n_keys = loads[system]
        db, res, outs, wall, _ = lsm_run(loaded, system, mix, dist, n_keys,
                                          LSM_TINY_OPS)
        digests[("tiny", system, mix, dist)] = lsm_digest(db, res, outs)
        walls[f"tiny/{system}/{mix}/{dist}"] = wall
    system, mix = LSM_TWIN_SCALE_CELL
    db, n_keys, load_s = lsm_load(system, LSM_SCALE, "cpu")
    walls[f"{LSM_SCALE}/{system}/load"] = load_s
    db, res, outs, wall, _ = lsm_run(db, system, mix, "hotspot", n_keys,
                                      LSM_SCALE_OPS)
    digests[(LSM_SCALE, system, mix, "hotspot")] = lsm_digest(db, res,
                                                               outs)
    walls[f"{LSM_SCALE}/{system}/{mix}"] = wall
    del db
    new, rows = compared_cells("cpu")
    digests.update(new)
    walls.update({f"tiny/{r['cell']}": r.get("wall_s") for r in rows})
    new, rows, scale = durable_cluster_cells("cpu")
    digests.update(new)
    walls.update({r["cell"]: r.get("wall_s", r.get("run_wall_s"))
                  for r in rows + scale})
    with open(out_path, "wb") as f:
        pickle.dump({"digests": digests, "walls": walls}, f)


def lsm_twin_sas(out_path: str, n_ops: str) -> None:
    """The CPU twin of the medium `sas_cache` RO cell, `n_ops` ops."""
    import pickle
    torch.set_num_threads(1)
    digest, row = sas_scale_cell("cpu", int(n_ops))
    with open(out_path, "wb") as f:
        pickle.dump({"digest": digest, "row": row}, f)


LSM_TWIN_SCRIPT = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import chip_smoke
getattr(chip_smoke, sys.argv[3])(*sys.argv[4:])
"""


def start_lsm_twin(out_path: Path, fn: str = "lsm_twin", *args):
    """A CPU twin of the lsm phase (`fn` of this module, given `out_path`
    and `args`), a subprocess that works while the card runs the phase's
    cells."""
    with open(out_path.with_suffix(".err"), "w") as err:
        return subprocess.Popen(
            [sys.executable, "-c", LSM_TWIN_SCRIPT, str(ROOT),
             str(ROOT / "src"), fn, str(out_path), *map(str, args)],
            stdout=subprocess.DEVNULL, stderr=err)


def twin_result(twin, out_path: Path, deadline: float) -> dict:
    """Wait for a twin subprocess (killed past `deadline` s) and load
    what it pickled; exits the script if the twin failed."""
    import pickle
    try:
        twin.wait(timeout=deadline)
    finally:
        stop(twin)
    if twin.returncode:
        err = out_path.with_suffix(".err").read_text()
        raise SystemExit(f"lsm twin exited {twin.returncode}:\n{err[-3000:]}")
    with open(out_path, "rb") as f:
        return pickle.load(f)


def stop(proc) -> None:
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def engine_on_card(db) -> dict:
    """Every tensor the engine holds (SSTables, blooms, GroupViews, RALT
    runs) and whether all of them lie on the card."""
    ts = db.tensors()
    return {"tensors": len(ts), "on_cuda": all(t.is_cuda for t in ts),
            "group_views": len(db._view_cache.views()),
            "device_bytes": db.device_bytes()}


def lsm_phase(dev, power: str) -> dict:
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        twin_out = Path(tmp) / "lsm_twin.pkl"
        twins = [start_lsm_twin(twin_out)]
        try:
            return lsm_cells(dev, power, twins, twin_out)
        finally:
            for twin in twins:
                stop(twin)


def lsm_cells(dev, power: str, twins: list, twin_out: Path) -> dict:
    """The engine at `default_config("tiny")` (22,528 keys of 1,000 B):
    `hotrap` and `rocksdb_tiered` under the RO, RW, WH, UH and SR mixes
    on hotspot-5% and `hotrap` under RO on zipfian and uniform, 20,000
    ops each, every cell's digest (`lsm_digest`) against the CPU twin's;
    then at `default_config("medium")` (64 MiB FD : 640 MiB SD, 720,896
    keys): `hotrap` and `rocksdb_tiered` under hotspot-5% RO and RW,
    200,000 ops each, timed, HotRAP's RO run against its CPU twin.  Then
    the compared systems, the sanitizer and the observability plane
    (`compared_cells`, `durable_cluster_cells`), and `sas_cache` RO at
    `medium` against a second CPU twin started once the tiny `sas_cache`
    RO cell has set its op count."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)            # the context, if none yet
    torch.cuda.reset_peak_memory_stats(dev)
    tiny, failures, loads = {}, {}, {}
    for system, mix, dist in LSM_TINY_CELLS:
        if system not in loads:
            loads[system] = lsm_load(system, "tiny", dev)
        loaded, n_keys, _ = loads[system]
        db, res, outs, wall, n_syncs = lsm_run(
            loaded, system, mix, dist, n_keys, LSM_TINY_OPS, syncs=True)
        key = ("tiny", system, mix, dist)
        tiny[key] = (lsm_digest(db, res, outs), {
            "cell": f"{system}/{mix}/{dist}", "wall_s": wall,
            "syncs_per_op": n_syncs / LSM_TINY_OPS,
            "fd_hit_rate": res.fd_hit_rate, "throughput": res.throughput,
            **engine_on_card(db)})
        del db
    scale, scale_digest = [], None
    tiny_loads = {s: v[2] for s, v in loads.items()}
    del loads, loaded
    # the compared systems and the sanitized run; their per-key reads
    # set the medium sas_cache cell's op count, whose twin starts now
    t_compared = time.perf_counter()
    compared, compared_rows = compared_cells(dev, card=True)
    compared_s = time.perf_counter() - t_compared
    sas_us = next(r["us_per_op"] for r in compared_rows
                  if r["cell"] == "sas_cache/RO/hotspot")
    sas_ops = min(LSM_SCALE_OPS, int(LSM_SAS_BUDGET_S / (sas_us * 1e-6))
                  // 1000 * 1000)
    sas_out = twin_out.with_name("lsm_twin_sas.pkl")
    twins.append(start_lsm_twin(sas_out, "lsm_twin_sas", sas_ops))
    for system in ("hotrap", "rocksdb_tiered"):
        loaded, n_keys, load_s = lsm_load(system, LSM_SCALE, dev)
        for mix in ("RO", "RW"):
            db, res, outs, wall, _ = lsm_run(loaded, system, mix, "hotspot",
                                              n_keys, LSM_SCALE_OPS)
            if (system, mix) == LSM_TWIN_SCALE_CELL:
                scale_digest = lsm_digest(db, res, outs)
            # host syncs a run makes, counted over a clone's first ops
            _, _, _, _, n_syncs = lsm_run(loaded, system, mix, "hotspot",
                                          n_keys, LSM_SYNC_OPS, syncs=True)
            scale.append({
                "cell": f"{system}/{mix}/hotspot", "keys": n_keys,
                "ops": LSM_SCALE_OPS, "load_wall_s": load_s,
                "run_wall_s": wall, "us_per_op": wall / LSM_SCALE_OPS * 1e6,
                "syncs_per_op": n_syncs / LSM_SYNC_OPS,
                "sim_ops_per_s": res.throughput,
                "fd_hit_rate": res.fd_hit_rate, **engine_on_card(db),
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev)})
            del db
    del loaded
    torch.cuda.empty_cache()
    t_durable = time.perf_counter()
    durable, durable_rows, durable_scale = durable_cluster_cells(dev,
                                                                 card=True)
    durable_s = time.perf_counter() - t_durable
    torch.cuda.empty_cache()
    t_sas = time.perf_counter()
    sas_digest, sas_row = sas_scale_cell(dev, sas_ops, card=True)
    sas_row["planned_from_tiny_us_per_op"] = sas_us
    sas_s = time.perf_counter() - t_sas
    # the CPU twins have run beside the card's cells
    twin_res = twin_result(twins[0], twin_out, LSM_TWIN_DEADLINE)
    sas_twin = twin_result(twins[1], sas_out, LSM_TWIN_DEADLINE)
    sas_row["twin_run_wall_s"] = sas_twin["row"]["run_wall_s"]
    sas_row["twin_load_wall_s"] = sas_twin["row"]["load_wall_s"]
    bad = lsm_mismatches(sas_twin["digest"], sas_digest)
    if bad:
        failures[sas_row["cell"]] = bad[:5]
    for key, digest in compared.items():
        if key[-1] == "sanitized":
            bad = json_mismatches(twin_res["digests"][key], digest)
        else:
            bad = lsm_mismatches(twin_res["digests"][key], digest)
        if bad:
            failures["/".join(key)] = bad[:5]
    for key, (digest, row) in tiny.items():
        bad = lsm_mismatches(twin_res["digests"][key], digest)
        row["equals_cpu_twin"] = not bad
        if bad:
            failures["/".join(key)] = bad[:5]
    key = (LSM_SCALE,) + LSM_TWIN_SCALE_CELL + ("hotspot",)
    bad = lsm_mismatches(twin_res["digests"][key], scale_digest)
    if bad:
        failures["/".join(key)] = bad[:5]
    for dkey, digest in durable.items():
        bad = json_mismatches(twin_res["digests"][dkey], digest)
        if bad:
            failures["/".join(dkey)] = bad[:5]
    rows_by = {r["cell"]: r for r in durable_rows}
    by = {r["cell"]: r for r in scale}
    hot, tiered = by["hotrap/RO/hotspot"], by["rocksdb_tiered/RO/hotspot"]
    out = {
        "name": torch.cuda.get_device_name(dev), "power_limit": power,
        "tiny": [row for _, row in tiny.values()],
        "tiny_loads_wall_s": tiny_loads,
        "scale": scale,
        "scale_note": ("sim_ops_per_s and fd_hit_rate come from StorageSim's "
                       "device model (paper Table 1), not from the card; "
                       "wall times, syncs and bytes are the card's"),
        "reduced": ("default_config('medium'): 64 MiB FD : 640 MiB SD, the "
                    "paper's 10 GB : 100 GB at about 1/150, ratio kept"),
        "durable": durable_rows, "durable_scale": durable_scale,
        "durable_s": durable_s,
        "durable_note": ("wal/*: hotrap with the WAL at tiny, crashed at the "
                         "site, recovered, 2,000 more ops; hash4: 4 hash "
                         "shards with HotBudget at tiny; range2: 2 range "
                         "shards with the WAL, split+merge forced, crashed "
                         "at each migration site; medium/kv4: "
                         "configs/hotrap_kv.shard_config()'s shape over "
                         "default_config('medium') with the WAL; "
                         "registry_bytes: the tables the manifests keep"),
        "compared": compared_rows, "compared_s": compared_s,
        "medium_sas_cache": sas_row, "medium_sas_cache_s": sas_s,
        "compared_note": ("mutant, sas_cache, prismdb at tiny, their reads "
                          "per key; hotrap/RW/sanitized and range2 "
                          "split+merge/sanitized under sanitize_db("
                          f"check_every={LSM_SANITIZE_EVERY}); "
                          "hash4/RW/attached and medium/kv4 RW 'attached' "
                          "with Observability(); medium sas_cache RO at "
                          f"{sas_ops} ops (LSM_SAS_BUDGET_S at the tiny "
                          "cell's us an op)"),
        "twin_walls_s": twin_res["walls"], "failures": failures,
        "phase_s": time.perf_counter() - t_phase}
    emit("lsm", **out)
    sanitized = rows_by["range2/split+merge/sanitized"]
    plane = rows_by["hash4/RW/attached"]
    kv4 = next(r for r in durable_scale
               if r["cell"] == f"{LSM_SCALE}/kv4/hotrap/RW")["attached"]
    checks = {
        "tiny_cells_equal_cpu_twin": all(
            r["equals_cpu_twin"] for _, r in tiny.values()),
        "scale_hotrap_ro_equals_cpu_twin": key_ok(failures, key),
        "engine_tensors_on_cuda": all(
            r["on_cuda"] and r["tensors"] > 0
            for r in [row for _, row in tiny.values()] + scale),
        "scan_views_on_cuda": all(
            r["group_views"] > 0 for _, r in tiny.values()
            if "/SR/" in r["cell"]),
        "hotrap_beats_tiered_throughput":
            hot["sim_ops_per_s"] > tiered["sim_ops_per_s"],
        "hotrap_beats_tiered_fd_hit_rate":
            hot["fd_hit_rate"] > tiered["fd_hit_rate"],
        "durable_cells_equal_cpu_twin": not any(
            "/".join(k) in failures for k in durable),
        "medium_kv4_rw_equals_cpu_twin": key_ok(
            failures, (LSM_SCALE, "kv4", "RW")),
        "every_armed_site_fired": all(
            rows_by[f"wal/{site}"]["crashed"] for site in LSM_WAL_HITS)
            and all(rows_by[f"range2/{site}"]["crashed"]
                    for site in LSM_MIGRATION_SITES),
        "split_and_merge_ran": (rows_by["range2/split+merge"]["splits"],
                                rows_by["range2/split+merge"]["merges"])
            == (1, 1),
        "no_version_ref_leaks_after_migration_crashes": all(
            rows_by[f"range2/{site}"]["version_refs"]
            == [1] * len(rows_by[f"range2/{site}"]["version_refs"])
            for site in LSM_MIGRATION_SITES),
        "durable_tensors_on_cuda": all(
            r["on_cuda"] and r["tensors"] > 0
            for r in durable_scale + [r for r in durable_rows
                                      if "on_cuda" in r]),
        "compared_cells_equal_cpu_twin": not any(
            "/".join(k) in failures for k in compared),
        "compared_tensors_on_cuda": all(
            r["on_cuda"] and r["tensors"] > 0 for r in compared_rows
            if "on_cuda" in r),
        "sanitized_hotrap_rw_without_error": "error" not in compared[
            ("tiny", "hotrap", "RW", "sanitized")],
        "sanitized_split_merge_equals_cpu_twin": key_ok(
            failures, ("range2", "split+merge", "sanitized")),
        "sanitized_split_merge_checked_both_cutovers":
            sanitized["report"]["checks_cutovers_checked"] >= 2,
        "hash4_plane_equals_cpu_twin": key_ok(
            failures, ("hash4", "RW", "attached")),
        "hash4_plane_read_only": plane["read_only"],
        "hash4_trace_valid_nothing_dropped":
            plane["trace_valid"] and plane["no_dropped_events"],
        "medium_kv4_plane_read_only": kv4["read_only"],
        "medium_kv4_trace_valid_nothing_dropped":
            kv4["trace_valid"] and kv4["no_dropped_events"],
        "medium_sas_cache_ro_equals_cpu_twin": sas_row["cell"]
            not in failures,
        "medium_sas_cache_on_cuda": sas_row["on_cuda"]}
    fail_on("lsm", checks)
    return out


def key_ok(failures: dict, key: tuple) -> bool:
    return "/".join(key) not in failures


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
    # registers and spills of the kernels redesigned for Hopper
    emit("ptxas", **{name: _build.ptxas_report(name)
                     for name in ("flash_attention", "decode_attention",
                                  "decode_attention_int8", "ssd_scan")})
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    main_shapes = kernels_phase(dev, flush, power)
    del flush
    # each phase's model is freed when its function returns; each
    # kernel's launches are those of the phase that is its main path
    serve_launches, bf16_tokens, bf16_ms = serve_phase(dev, power)
    launches = {"decode_attention": serve_launches["decode_attention"],
                "ralt_record": tiered_phase(dev, power)["ralt_record"],
                "ralt_update": tracker_phase(dev, power)["ralt_update"]}
    torch.cuda.empty_cache()
    prefill_phase(dev, power)
    torch.cuda.empty_cache()
    train_launches, train_losses = train_phase(dev, power)
    launches["flash_attention"] = train_launches["flash_attention"]
    torch.cuda.empty_cache()
    launches["ssd_scan"] = mamba2_phase(dev, power)["ssd_scan"]
    torch.cuda.empty_cache()
    moe_phase(dev, power)
    torch.cuda.empty_cache()
    caches_phase(dev, power)
    torch.cuda.empty_cache()
    window_phase(dev, power)
    torch.cuda.empty_cache()
    moe_phase(dev, power, MIXTRAL_ARCH, MIXTRAL_LAYERS, MIXTRAL_PREFILL,
              "mixtral")
    torch.cuda.empty_cache()
    dense_phase(dev, power)
    torch.cuda.empty_cache()
    launches["decode_attention_int8"] = int8_phase(
        dev, power, bf16_tokens, bf16_ms)["decode_attention_int8"]
    torch.cuda.empty_cache()
    for name, n in zamba2_phase(dev, power).items():
        launches[name] += n
    torch.cuda.empty_cache()
    multidevice_phase(dev, power, bf16_tokens, train_losses)
    torch.cuda.empty_cache()
    placed_phase(dev, power, bf16_tokens)
    torch.cuda.empty_cache()
    plan_line(dev, power)
    torch.cuda.empty_cache()
    lsm_phase(dev, power)
    sources = {
        "ralt_update": ("src/repro_torch/csrc/ralt_score.cu",
                        "src/repro/kernels/ralt_score.py:78"),
        "ralt_record": ("src/repro_torch/csrc/ralt_score.cu",
                        "src/repro/kernels/ralt_score.py:78"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:106"),
        "decode_attention_int8": (
            "src/repro_torch/csrc/decode_attention_int8.cu",
            "src/repro/kernels/decode_attention.py:106"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:111"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:89")}
    def numbers(case):
        return {"max_abs_err": case["max_abs_err"], "ms": case["kernel_ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"],
                **shares(case["kernel_ms"], case["bound_ms"],
                         case["library_ms"])}

    # a kernel that zamba2's path runs at another shape carries that
    # shape's numbers too
    zamba = main_shapes["zamba2"]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **numbers(main_shapes[name]),
         **({"zamba2": dict(shape=zamba[name]["shape"],
                            **numbers(zamba[name]))}
            if name in zamba else {})}
        for name, (src, tpu) in sources.items()]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
