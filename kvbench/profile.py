"""The device's timeline over a traced stretch of rounds, read from
`torch.profiler`'s trace in memory: busy seconds (the union of every
kernel, copy and set on the card), the top device operations, and the
idle time by the harness span the host was in."""
from __future__ import annotations

import contextlib

import torch

TRACED = "kvbench.traced"       # the whole traced stretch
PREFIX = "kvbench."             # harness spans: kvbench.gen, ...


def span(name: str, on: bool):
    """A `record_function` range named `kvbench.<name>` when `on`."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(PREFIX + name)


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")()
                                               * 1000)


def _events(prof) -> list[tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every traced event."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        out.append((e.name(), e.device_type() == cuda, start,
                    start + _ns(e, "duration")))
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type and template arguments."""
    return name.removeprefix("void ").split("<", 1)[0]


def _union(iv: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(prof) -> dict | None:
    """busy_s and window_s of the traced stretch, and its breakdown;
    None where the trace holds no device operation."""
    evs = _events(prof)
    win = [(a, b) for n, dev, a, b in evs if n == TRACED and not dev]
    if not win:
        return None
    w0, w1 = win[0]
    dev_ops = [(n, max(a, w0), min(b, w1)) for n, dev, a, b in evs
               if dev and not n.startswith(PREFIX) and b > w0 and a < w1]
    if not dev_ops:
        return None
    busy = _union([(a, b) for _, a, b in dev_ops])
    by_op: dict[str, int] = {}
    for n, a, b in dev_ops:
        by_op[_short(n)] = by_op.get(_short(n), 0) + (b - a)
    spans = sorted((a, b, n[len(PREFIX):]) for n, dev, a, b in evs
                   if not dev and n.startswith(PREFIX) and n != TRACED)
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    by_span: dict[str, int] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        host = next((n for s0, s1, n in spans if s0 <= mid < s1), "harness")
        by_span[host] = by_span.get(host, 0) + (b - a)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": (w1 - w0) / 1e9,
            "breakdown": {"device_ops": [[n, v / 1e9] for n, v in top],
                          "idle_gaps": [[n, v / 1e9] for n, v in idle]}}
