"""One llama3-8b decode step split by operation, bf16 cache against the
int8 cache (`kv_quant`), in one process on one card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode

Needs one CUDA card.  Builds llama3-8b at full width and depth (random
bf16 weights from a seed) and two decode caches of `chip_smoke.py`'s
serving shape (batch 4, 168 slots), filled with random rows up to
position 128, one bf16 and one int8 with float32 scales.  Then, for each
cache, in the order bf16, int8, int8, bf16:

  * untraced: ms per decode step (host clock, the device drained after
    every step, as the serving engine's argmax does), median of STEPS;
  * traced (torch.profiler, CPU and CUDA activities, TRACED steps): the
    host µs and device µs per step of each operation the step runs
    directly (aten operators, and two spans this script adds: `decode
    attention`, the model's call of the decode kernel's entry point, and
    `quantize_kv`, the model's call of the int8 quantizer), the calls of
    each per layer, the device operations per layer, the kernels the
    port's own libraries launch (which the profiler links to no
    operator) by name, and the device's idle share over the steps.

It times whatever `repro_torch` is on the path, so the same script
measures another tree (copy it into that tree's `src/repro_torch/launch/`
and run it there); an entry point a tree does not have is not wrapped.
Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
from collections import Counter, defaultdict
from contextlib import nullcontext

import torch

BATCH, S_MAX, POS = 4, 168, 128
STEPS, TRACED = 20, 5
# the model's calls this script wraps in a span: (module, attribute)
SPANS = {"decode attention": (("kernels.ops", "decode_attention_head_major"),
                              ("kernels.ops", "decode_attention_int8_append")),
         "quantize_kv": (("models.attention", "quantize_kv"),)}


class Spans:
    """Wraps the model's calls of SPANS in a `record_function` span while
    `traced` is set."""

    def __init__(self):
        import importlib
        self.traced = False
        self.present = {}
        for span, targets in SPANS.items():
            for mod_name, attr in targets:
                mod = importlib.import_module(f"repro_torch.{mod_name}")
                fn = getattr(mod, attr, None)
                self.present[f"{mod_name}.{attr}"] = fn is not None
                if fn is not None:
                    setattr(mod, attr, self._wrap(span, fn))

    def _wrap(self, span, fn):
        from torch.profiler import record_function

        def call(*args, **kw):
            with record_function(span) if self.traced else nullcontext():
                return fn(*args, **kw)
        return call


def make_cache(cfg, dev, g):
    """The decode cache of `cfg` with random rows in slots [0, POS)."""
    from ..models import transformer
    cache = transformer.init_cache(cfg, BATCH, S_MAX, dev)
    for c in cache:
        for name, t in c.items():
            if t.dtype == torch.int8:
                t[:, :, :POS] = torch.randint(-127, 128, t[:, :, :POS].shape,
                                              generator=g, device=dev,
                                              dtype=torch.int8)
            elif name.endswith("scale"):
                t[:, :, :POS] = torch.rand(t[:, :, :POS].shape, generator=g,
                                           device=dev) * 0.05
            else:
                t[:, :, :POS] = torch.randn(t[:, :, :POS].shape, generator=g,
                                            device=dev).to(t.dtype)
    return cache


def steps(params, cfg, cache, n: int, dev) -> list[float]:
    """ms of each of `n` decode steps from POS, the device drained after
    each."""
    from ..models import transformer
    toks = torch.arange(BATCH, device=dev)
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        logits = transformer.decode_step(params, cfg, cache, toks,
                                         POS + i % (S_MAX - POS))
        toks = logits.argmax(-1) % cfg.vocab
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _top(e):
    """The operation directly under a `step` span that `e` runs in."""
    while e.cpu_parent is not None and e.cpu_parent.name != "step":
        e = e.cpu_parent
    return e if e.cpu_parent is not None else None


def trace(params, cfg, cache, spans, dev, n: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..models import transformer
    toks = torch.arange(BATCH, device=dev)
    torch.cuda.synchronize()
    spans.traced = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            for i in range(n):
                with record_function("step"):
                    logits = transformer.decode_step(
                        params, cfg, cache, toks, POS + i % (S_MAX - POS))
                    toks = logits.argmax(-1) % cfg.vocab
                torch.cuda.synchronize()
    spans.traced = False
    events = prof.events()
    (window,) = [e for e in events if e.name == "window"]
    w0, w1 = window.time_range.start, window.time_range.end
    names = {"window", "step", *SPANS}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name not in names]
    L = cfg.n_layers
    calls, host_us, dev_us = Counter(), defaultdict(float), defaultdict(float)
    attributed = Counter()
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.cpu_parent is not None and e.cpu_parent.name == "step":
            calls[e.name] += 1
            host_us[e.name] += e.cpu_time_total
        if e.kernels and (top := _top(e)) is not None:
            for k in e.kernels:
                if k.name not in names:
                    dev_us[top.name] += k.duration
                    attributed[k.name] += 1
    by_name, by_name_us = Counter(), defaultdict(float)
    for e in device:
        by_name[e.name] += 1
        by_name_us[e.name] += e.time_range.end - e.time_range.start
    unattributed = by_name - attributed
    busy, end = 0.0, w0
    for a, b in sorted((max(e.time_range.start, w0),
                        min(e.time_range.end, w1)) for e in device):
        if b > end:
            busy += b - max(a, end)
            end = b
    step_us = [e.cpu_time_total for e in events if e.name == "step"
               and e.device_type == DeviceType.CPU]
    ops = sorted(calls, key=lambda k: -host_us[k])
    return dict(
        steps=n, traced_ms_per_step=statistics.median(step_us) / 1e3,
        device_us_per_step=busy / n, device_idle_share=1.0 - busy / (w1 - w0),
        device_ops_per_layer=len(device) / n / L,
        operations={k: dict(calls_per_layer=calls[k] / n / L,
                            host_us_per_step=host_us[k] / n,
                            device_us_per_step=dev_us[k] / n)
                    for k in ops},
        unattributed_kernels={
            name[:80]: dict(per_layer=c / n / L,
                            device_us_per_step=by_name_us[name] / n)
            for name, c in unattributed.most_common(10)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--traced", type=int, default=TRACED)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_decode needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    import repro_torch
    from ..configs import get_config
    from ..models import transformer

    spans = Spans()
    cfgs = {"bf16": get_config("llama3-8b")}
    cfgs["int8"] = dataclasses.replace(cfgs["bf16"], kv_quant=True)
    g = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(cfgs["bf16"], g, dev)
    caches = {k: make_cache(c, dev, g) for k, c in cfgs.items()}
    for k in cfgs:                                     # warm up
        steps(params, cfgs[k], caches[k], 3, dev)
    ms = defaultdict(list)
    for k in ("bf16", "int8", "int8", "bf16"):
        ms[k] += steps(params, cfgs[k], caches[k], args.steps // 2, dev)
    res = dict(package=str(repro_torch.__file__), model="llama3-8b",
               batch=BATCH, slots=S_MAX, position=POS,
               wrapped=spans.present, cache={})
    for k, cfg in cfgs.items():
        res["cache"][k] = dict(
            ms_per_step=statistics.median(ms[k]), ms_each=ms[k],
            traced=trace(params, cfg, caches[k], spans, dev, args.traced))
    res["int8_over_bf16_step"] = (res["cache"]["int8"]["ms_per_step"]
                                  / res["cache"]["bf16"]["ms_per_step"])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps({"profile_decode": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
