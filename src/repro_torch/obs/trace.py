"""Flight recorder, the port of `repro.obs.trace`: a typed event bus
exported as Chrome/Perfetto ``trace_event`` JSON.

Every event carries a *track* — a slash-separated path like
``"repartition/shard3"`` or ``"repartition/shard3/FD"`` — whose first
component becomes the Perfetto *process* and whose full path becomes
the *thread*, so a cluster run renders as one process group per
attached engine with one lane per shard plus one per device, and the
cluster-scope machinery (router, HotBudget, Repartitioner, sanitizer)
on its own lanes.

Timestamps come from a ``clock`` callable returning *simulated*
seconds (`Observability.now` wires it to the cluster's bottleneck
device wall, ``StorageSim.sim_time``): spans measure how much
simulated device time elapsed inside them, which is the quantity the
paper's claims are about.  Wall-clock tracers (kernel benches, and
``Observability(clock="wall")``) pass ``time.perf_counter`` instead;
`self_times` then splits the host's time among the spans.  Emitted
timestamps are clamped monotone so a ``reset_storage()``
mid-attachment can never produce a trace Perfetto refuses to order.

With ``mirror`` set to a prefix, every span also opens and closes a
`torch.profiler` range named ``<mirror><name>`` while a profiler is
recording, so the spans land on the profiler's timeline beside the
device's kernels, on its clock.  The check costs about 0.16 us a span
when no profiler records.

The recorder is bounded: past ``max_events`` new events are counted in
``dropped`` instead of stored, so tracing can stay on for a whole
benchmark sweep without unbounded memory.

Events live on the host.  Their ``args`` are host Python numbers,
strings and booleans (an instrumentation site converts any device value
before it emits), so ``export`` is a plain ``json.dump``.

Event kinds (Trace Event Format phases):

  ``B``/``E``  nested spans (``begin``/``end``/``span``)
  ``i``        instants (``instant``) — thread-scoped
  ``C``        counters (``counter``) — one stacked-area lane per name
"""
from __future__ import annotations

import json

import torch

__all__ = ["Tracer"]


class Tracer:
    """Append-only, bounded, monotonically-timestamped event recorder."""

    def __init__(self, clock=None, max_events: int = 400_000,
                 enabled: bool = True):
        self.clock = clock                # callable -> seconds (sim or wall)
        self.enabled = enabled
        self.max_events = max_events
        self.events: list[dict] = []
        self.dropped = 0
        self._last_us = 0.0
        self._depth: dict[str, list[str]] = {}   # track -> open-span stack
        self.mirror: str | None = None    # profiler range prefix, if any
        self._ranges: dict[str, list] = {}     # track -> open range handles

    # -- core ----------------------------------------------------------
    def _ts(self) -> float:
        t = self.clock() if self.clock is not None else 0.0
        us = float(t) * 1e6
        if us < self._last_us:            # reset_storage / clock rebinds
            us = self._last_us
        self._last_us = us
        return us

    def _push(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    # -- emitters ------------------------------------------------------
    def begin(self, track: str, name: str, args: dict | None = None) -> None:
        if not self.enabled:
            return
        self._depth.setdefault(track, []).append(name)
        ev = {"track": track, "name": name, "ph": "B", "ts": self._ts()}
        if args:
            ev["args"] = args
        self._push(ev)
        if self.mirror is not None:
            self._ranges.setdefault(track, []).append(
                torch.ops.profiler._record_function_enter_new(
                    self.mirror + name, None)
                if torch._C._autograd._profiler_enabled() else None)

    def end(self, track: str, name: str | None = None,
            args: dict | None = None) -> None:
        if not self.enabled:
            return
        stack = self._depth.get(track)
        if stack:
            opened = stack.pop()
            name = name or opened
        if self.mirror is not None:
            handles = self._ranges.get(track)
            handle = handles.pop() if handles else None
            if handle is not None:
                torch.ops.profiler._record_function_exit(handle)
        ev = {"track": track, "name": name or "?", "ph": "E",
              "ts": self._ts()}
        if args:
            ev["args"] = args
        self._push(ev)

    def span(self, track: str, name: str, args: dict | None = None):
        """``with tracer.span(...):`` — B on entry, E on exit (also on
        exceptions, so traces stay stack-balanced)."""
        return _Span(self, track, name, args)

    def instant(self, track: str, name: str,
                args: dict | None = None) -> None:
        if not self.enabled:
            return
        ev = {"track": track, "name": name, "ph": "i", "ts": self._ts(),
              "s": "t"}
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, track: str, name: str, values: dict) -> None:
        """One multi-series counter sample (Perfetto stacked area)."""
        if not self.enabled:
            return
        self._push({"track": track, "name": name, "ph": "C",
                    "ts": self._ts(), "args": values})

    def close_open(self, args: dict | None = None) -> int:
        """Close every open span on every track (crash salvage: when an
        injected crash unwinds the engine mid-span, the spans it was
        inside ended with the process — emitting their E events keeps
        the recovered trace stack-balanced).  Returns spans closed."""
        closed = 0
        for track, stack in self._depth.items():
            while stack:
                self.end(track, args=args)
                closed += 1
        return closed

    # -- integrity -----------------------------------------------------
    def validate(self) -> list[str]:
        """Schema self-check used by tests and ``export``: monotone
        timestamps, B/E stack discipline per track, required fields.
        Returns human-readable problems (empty == valid)."""
        problems: list[str] = []
        last_ts = 0.0
        stacks: dict[str, list[str]] = {}
        for i, ev in enumerate(self.events):
            for field in ("track", "name", "ph", "ts"):
                if field not in ev:
                    problems.append(f"event {i}: missing {field!r}")
            ts = ev.get("ts", 0.0)
            if ts < last_ts:
                problems.append(f"event {i}: ts {ts} < previous {last_ts}")
            last_ts = max(last_ts, ts)
            ph, track = ev.get("ph"), ev.get("track", "?")
            if ph == "B":
                stacks.setdefault(track, []).append(ev.get("name", "?"))
            elif ph == "E":
                stack = stacks.setdefault(track, [])
                if not stack:
                    problems.append(
                        f"event {i}: E {ev.get('name')!r} on {track!r} "
                        f"with no open span")
                else:
                    opened = stack.pop()
                    if ev.get("name") not in (None, "?", opened):
                        problems.append(
                            f"event {i}: E {ev.get('name')!r} closes "
                            f"B {opened!r} on {track!r}")
        for track, stack in stacks.items():
            for name in stack:
                problems.append(f"unclosed span {name!r} on {track!r}")
        return problems

    # -- export --------------------------------------------------------
    def _track_ids(self) -> dict[str, tuple[int, int]]:
        """track path -> (pid, tid): first path component is the
        process, the full path is the thread, in first-seen order."""
        pids: dict[str, int] = {}
        tids: dict[str, tuple[int, int]] = {}
        for ev in self.events:
            track = ev["track"]
            if track in tids:
                continue
            top = track.split("/", 1)[0]
            if top not in pids:
                pids[top] = len(pids)
            tids[track] = (pids[top], len(tids))
        return tids

    def to_dict(self) -> dict:
        """The full Trace Event Format document (Perfetto-loadable)."""
        tids = self._track_ids()
        out: list[dict] = []
        seen_meta: set[tuple] = set()
        for track, (pid, tid) in tids.items():
            top = track.split("/", 1)[0]
            if ("p", pid) not in seen_meta:
                seen_meta.add(("p", pid))
                out.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": top}})
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": track}})
        for ev in self.events:
            pid, tid = tids[ev["track"]]
            e = {"name": ev["name"], "ph": ev["ph"], "ts": ev["ts"],
                 "pid": pid, "tid": tid}
            if "s" in ev:
                e["s"] = ev["s"]
            if "args" in ev:
                e["args"] = ev["args"]
            out.append(e)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    # -- queries (tests / smoke gates) ---------------------------------
    def names(self) -> set[str]:
        return {ev["name"] for ev in self.events}

    def count(self, name: str, ph: str | None = None) -> int:
        return sum(1 for ev in self.events
                   if ev["name"] == name and (ph is None or ev["ph"] == ph))

    def self_times(self) -> dict[str, dict]:
        """{span name: {"count", "total_s", "self_s"}} over the closed
        spans recorded: a span's self time is its duration less the part
        its child spans on the same track cover.  Seconds of the
        tracer's clock."""
        out: dict[str, dict] = {}
        stacks: dict[str, list[list]] = {}     # track -> [[name, ts, kids]]
        for ev in self.events:
            ph = ev["ph"]
            if ph == "B":
                stacks.setdefault(ev["track"], []).append(
                    [ev["name"], ev["ts"], 0.0])
            elif ph == "E":
                stack = stacks.get(ev["track"])
                if not stack:
                    continue
                name, ts, kids = stack.pop()
                dur = ev["ts"] - ts
                if stack:
                    stack[-1][2] += dur
                row = out.setdefault(name, {"count": 0, "total_s": 0.0,
                                            "self_s": 0.0})
                row["count"] += 1
                row["total_s"] += dur / 1e6
                row["self_s"] += (dur - kids) / 1e6
        return out


class _Span:
    __slots__ = ("tracer", "track", "name", "args")

    def __init__(self, tracer: Tracer, track: str, name: str,
                 args: dict | None):
        self.tracer, self.track, self.name, self.args = \
            tracer, track, name, args

    def __enter__(self):
        self.tracer.begin(self.track, self.name, self.args)
        return self

    def __exit__(self, *exc):
        self.tracer.end(self.track, self.name)
        return False
