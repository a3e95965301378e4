"""Host and device cost of the tiered KV cache's reads, by part.

    PYTHONPATH=src python -m repro_torch.launch.profile_tiered

Needs one CUDA card.  Builds `chip_smoke.py`'s tiered cache (llama3-8b's
KV widths, one layer a page: 65,536 pages of 64 KiB, 8,192 fast slots),
writes every page, replays WARMUP reads of the hotspot stream of
`benchmarks/tiered_serving.py:49-64`, then measures the next READS reads
twice:

  * untraced: host µs per read, split by timing the cache's parts with
    a perf_counter: tracker record (`_record`), page gather
    (`_gather_fast`), slow-page copy (`_fetch_slow`), flush
    (`_maybe_flush`, which promotes only when the staging list is full),
    sweep (`sweep`) and the rest of `read_pages`;
  * traced (torch.profiler, CPU and CUDA activities, TRACED reads): the
    device operations per read by part and kind (kernels, copies by
    direction, memsets) with their device µs, every host sync the trace
    shows (cudaStreamSynchronize, cudaDeviceSynchronize,
    cudaEventSynchronize, a synchronous cudaMemcpy) with the part and the
    operator it came from, and the device's idle share over the window;
  * last, the host µs of the tracker's record alone in a tight loop.

It times whatever `repro_torch` is on the path, so the same script
measures another tree (`PYTHONPATH=<tree>/src`); a part that tree does
not have is reported as null and its time falls in the rest.  Prints
the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import Counter, defaultdict
from contextlib import nullcontext

import numpy as np
import torch

N_PAGES, FAST_SLOTS = 65_536, 8_192
WARMUP, READS, TRACED = 1_000, 4_000, 1_000
PARTS = {"tracker record": "_record", "page gather": "_gather_fast",
         "slow-page copy": "_fetch_slow", "flush": "_maybe_flush",
         "sweep": "sweep"}
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def hotspot_stream(n_pages, n_ops, seed=0):
    """The hotspot generator of `benchmarks/tiered_serving.py:49-64`."""
    rng = np.random.default_rng(seed)
    for _ in range(n_ops):
        n_hot = max(n_pages // 20, 1)
        p = int(rng.integers(0, n_hot)) if rng.random() < 0.95 \
            else int(rng.integers(0, n_pages))
        yield p % n_pages


def make_cache(dev):
    """The tiered run's cache with every page written.  The bandwidths
    only scale `SimClock`, which this script does not read."""
    from ..tiering import KVTierConfig, TieredKVCache
    cfg = KVTierConfig(n_pages=N_PAGES, fast_slots=FAST_SLOTS,
                       page_tokens=16, kv_heads=8, head_dim=128,
                       n_layers=1, dtype="bfloat16")
    kv = TieredKVCache(cfg, hbm_bw=1.0, pcie_bw=1.0, device=dev)
    shape = (cfg.n_layers, cfg.page_tokens, cfg.kv_heads, cfg.head_dim)
    for p in range(N_PAGES):
        val = torch.full(shape, (p % 97) / 8, dtype=torch.bfloat16)
        kv.write_page(p, val, -val)
    torch.cuda.synchronize()
    return kv


class Parts:
    """Wraps the cache's parts (and `read_pages`) with a host timer and,
    while `traced`, a `record_function` span of the part's name."""

    def __init__(self, kv):
        self.host_s = defaultdict(float)
        self.traced = False
        self.present = {}
        for name, attr in {**PARTS, "read": "read_pages"}.items():
            fn = getattr(kv, attr, None)
            self.present[name] = fn is not None
            if fn is not None:
                setattr(kv, attr, self._wrap(name, fn))

    def _wrap(self, name, fn):
        from torch.profiler import record_function

        def part(*args, **kw):
            ctx = record_function(name) if self.traced else nullcontext()
            t0 = time.perf_counter()
            with ctx:
                out = fn(*args, **kw)
            self.host_s[name] += time.perf_counter() - t0
            return out
        return part

    def reset(self):
        self.host_s.clear()


def host_split(kv, parts, pages) -> dict:
    """Host µs per read by part, untraced; the device drained at the end
    (its wait counts in `read` wall only)."""
    parts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in pages:
        kv.read_pages([p])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(pages)
    us = {name: (parts.host_s[name] / n * 1e6 if parts.present[name]
                 else None) for name in PARTS}
    read_us = parts.host_s["read"] / n * 1e6
    us["rest of read_pages"] = read_us - sum(v for v in us.values() if v)
    return dict(reads=n, wall_us_per_read=wall / n * 1e6,
                reads_per_s=n / wall, read_pages_us=read_us, parts_us=us)


def _part_of(e) -> str:
    while e is not None:
        if e.name in PARTS or e.name == "read":
            return e.name if e.name in PARTS else "rest of read_pages"
        e = e.cpu_parent
    return "outside read_pages"


def _op_of(e) -> str:
    """The innermost operator (aten or a part) above a runtime call."""
    e = e.cpu_parent
    while e is not None and e.name.startswith("cuda"):
        e = e.cpu_parent
    return "none" if e is None else e.name


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy " + name.split()[1]
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def trace(kv, parts, pages) -> dict:
    """Device operations per read by part, host syncs and idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    parts.traced = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            for p in pages:
                kv.read_pages([p])
            torch.cuda.synchronize()
    parts.traced = False
    events = prof.events()
    n = len(pages)
    (window,) = [e for e in events if e.name == "window"]
    w0, w1 = window.time_range.start, window.time_range.end
    spans = {*PARTS, "read", "window"}
    # the device timeline also carries the record_function spans
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name not in spans]
    ops, by_op, dev_us = Counter(), Counter(), defaultdict(float)
    attributed = Counter()
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        part = _part_of(e)
        for k in e.kernels:
            if k.name in spans:
                continue
            ops[(part, _kind(k.name))] += 1
            by_op[(part, e.name, _kind(k.name))] += 1
            dev_us[part] += k.duration
            attributed[k.name] += 1
    by_name = Counter(e.name for e in device)
    # launches from the kernels' own libraries (ctypes) carry no runtime
    # record the profiler links to an operator: counted by name
    unattributed = by_name - attributed
    syncs = Counter((e.name, _part_of(e), _op_of(e)) for e in events
                    if e.device_type == DeviceType.CPU and e.name in SYNCS)
    busy, end = 0.0, w0
    for a, b in sorted((max(e.time_range.start, w0),
                        min(e.time_range.end, w1)) for e in device):
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(
        reads=n, window_us=w1 - w0,
        device_ops_per_read=len(device) / n,
        device_ops_per_read_by_part={
            f"{part} / {kind}": c / n
            for (part, kind), c in sorted(ops.items())},
        device_ops_per_read_by_operator={
            f"{part} / {op} / {kind}": c / n
            for (part, op, kind), c in by_op.most_common(20)},
        unattributed_device_ops_per_read={
            name[:100]: c / n for name, c in unattributed.most_common(10)},
        device_us_per_read_by_part={k: v / n for k, v in sorted(
            dev_us.items())},
        device_ops_by_name=dict(by_name.most_common(25)),
        host_syncs_per_read={f"{name} in {part} under {op}": c / n
                             for (name, part, op), c in syncs.most_common()},
        device_idle_share=1.0 - busy / (w1 - w0))


def tracker_alone(kv, pages) -> float:
    """Host µs of one tracker record in a tight loop over `pages` (run
    after the windows above, which it does not touch)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in pages:
        kv.tracker.record_ids(np.asarray([p], np.int64))
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / len(pages) * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=READS)
    ap.add_argument("--traced", type=int, default=TRACED)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_tiered needs a CUDA device")
    dev = torch.device("cuda", 0)
    import repro_torch
    kv = make_cache(dev)
    parts = Parts(kv)
    stream = list(hotspot_stream(N_PAGES, WARMUP + args.reads + args.traced))
    for p in stream[:WARMUP]:
        kv.read_pages([p])
    host = host_split(kv, parts, stream[WARMUP:WARMUP + args.reads])
    traced = trace(kv, parts, stream[WARMUP + args.reads:])
    c = kv.clock
    alone = tracker_alone(kv, stream[WARMUP:WARMUP + args.reads])
    res = dict(package=str(repro_torch.__file__), n_pages=N_PAGES,
               fast_slots=FAST_SLOTS, warmup=WARMUP,
               parts_present=parts.present, host=host, traced=traced,
               tracker_record_alone_host_us=alone,
               fast_hit_rate=kv.fast_hit_rate(), promoted=c.promoted,
               demoted=c.demoted, sweeps=c.sweeps, flushes=c.flushes)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps({"profile_tiered": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
