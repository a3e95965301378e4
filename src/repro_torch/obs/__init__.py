"""Observability plane of the port (`repro.obs`): flight-recorder
tracing, cadenced metrics, and sampled latency attribution for the
simulated cluster.

Compiled out by default
-----------------------
Every engine object carries a class-level ``_obs = NULL_OBS`` whose
``enabled`` flag is False, and every instrumentation site in the
engine is guarded by a single attribute check::

    if self._obs.enabled:
        self._obs.tracer.instant(...)

so an unattached engine pays one attribute load + branch per site and
allocates nothing.

Attaching
---------
``Observability().attach(db, name="walk")`` wires the plane into a
plain `TieredLSM` or a `ShardedTieredLSM` cluster (unwrapping a
`SanitizedDB` proxy): the tracer's clock becomes the cluster's
simulated bottleneck wall, every live shard gets a stable track name
(``walk/shard0`` …), and the router's ``_new_shard`` factory is hooked
— the same pattern the Sanitizer uses — so shards born from future
repartition cutovers inherit the plane and fresh track lanes.
`run_workload` discovers the plane via ``db._obs``; nothing else needs
threading through.

The plane lives on the host whatever the engine's device: the clock is
`StorageSim.sim_time` (a host float), the events, series and reservoir
are host lists and numpy arrays.  It is read-only: it may read device
counters and engine stats but never charges simulated I/O or writes
counters (`tests/test_torch_obs.py` holds an attached run's state to
the unattached run's).

Wall mode
---------
``Observability(clock="wall")`` runs the same tracer on
``time.perf_counter``: it times the host's work inside the engine.
The engine's wall-only spans (``get`` and its parts, ``put``, the
``ralt/*`` spans) and the index-build counters fire in this mode alone,
each behind one ``obs.wall`` check, so a simulated-clock trace stays
the reference's.  The metrics registry and the attribution sampler
ride the simulated clock and are off; so are the ``promo/get`` and
``promo/scan`` instants, whose arguments copy RALT's answers to the
host.  While `torch.profiler` records, every span is mirrored as a
profiler range named ``repro_torch/<name>`` (`MIRROR_PREFIX`), on the
timeline of the device's kernels.  ``tracer.self_times()`` splits a
run's host time by span; `detach` puts the null plane back.
"""
from __future__ import annotations

import time

import numpy as np

from .attribution import AttributionSampler
from .metrics import (LatencyHistogram, MetricsRegistry, Series,
                      TierLatencyHistogram)
from .trace import Tracer

__all__ = ["Observability", "NULL_OBS", "Tracer", "MetricsRegistry",
           "LatencyHistogram", "TierLatencyHistogram", "Series",
           "AttributionSampler", "jsonify", "ServingObservability",
           "NULL_SERVING_OBS", "MIRROR_PREFIX"]

# the profiler ranges a wall-mode plane opens: repro_torch/<span name>
MIRROR_PREFIX = "repro_torch/"


def jsonify(obj):
    """Recursively convert numpy scalars/arrays so json.dumps works."""
    if isinstance(obj, dict):
        return {str(k): jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonify(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return [jsonify(v) for v in obj.tolist()]
    return obj


class Observability:
    """Tracer + metrics + attribution behind one ``enabled`` flag."""

    def __init__(self, enabled: bool = True, trace: bool = True,
                 metrics: bool = True, attribution: bool = True,
                 metrics_interval_s: float = 0.02,
                 attr_capacity: int = 65536,
                 max_events: int = 400_000, clock: str = "sim"):
        if clock not in ("sim", "wall"):
            raise ValueError(f"clock {clock!r} is neither 'sim' nor 'wall'")
        self.enabled = enabled
        # wall mode: the host's clock, and the engine's wall-only spans
        self.wall = enabled and clock == "wall"
        self.tracer = Tracer(max_events=max_events,
                             enabled=enabled and trace)
        if self.wall:
            self.tracer.clock = time.perf_counter
            self.tracer.mirror = MIRROR_PREFIX
        self.metrics = MetricsRegistry(
            interval_s=metrics_interval_s,
            enabled=enabled and metrics and not self.wall)
        self.attr = AttributionSampler(capacity=attr_capacity)
        self.attribution = enabled and attribution and not self.wall
        self._db = None
        self._next_shard_id = 0
        self._hooked = None       # (cluster, its own _new_shard or None)

    # -- clock ---------------------------------------------------------
    def now(self) -> float:
        """Cluster sim-time: the busiest device wall across shards."""
        db = self._db
        if db is None:
            return 0.0
        storages = getattr(db, "storages", None)
        if storages:
            return max(st.sim_time for st in storages)
        return db.storage.sim_time

    # -- attachment ----------------------------------------------------
    def attach(self, db, name: str = "db") -> "Observability":
        """Wire this plane into a (possibly sanitized) engine."""
        target = getattr(db, "_db", db)      # unwrap SanitizedDB
        self._db = target
        if not self.wall:
            self.tracer.clock = self.now
        shards = getattr(target, "shards", None)
        if shards is None:
            self._wire(target, name)
            return self
        target._obs = self
        target._obs_track = name
        for sh in shards:
            self._adopt(sh, name)
        own = target.__dict__.get("_new_shard")
        self._hooked = (target, own)
        orig = own or target._new_shard

        def _new_shard(_orig=orig, _self=self, _name=name):
            sh = _orig()
            _self._adopt(sh, _name)
            return sh

        target._new_shard = _new_shard
        if getattr(target, "hot_budget", None) is not None:
            target.hot_budget._obs = self
            target.hot_budget._obs_track = f"{name}/cluster"
        if getattr(target, "repartitioner", None) is not None:
            target.repartitioner._obs = self
            target.repartitioner._obs_track = f"{name}/cluster"
        return self

    def _adopt(self, sh, prefix: str) -> None:
        self._wire(sh, f"{prefix}/shard{self._next_shard_id}")
        self._next_shard_id += 1

    def _wire(self, engine, track: str) -> None:
        """One engine, and its RALT, on `track`."""
        engine._obs = self
        engine._obs_track = track
        ralt = getattr(engine, "ralt", None)
        if ralt is not None:
            ralt._obs = self
            ralt._obs_track = track

    def detach(self, db) -> None:
        """Undo `attach`: every object it wired reads the class-level
        `NULL_OBS` again, and a cluster's ``_new_shard`` is its own."""
        target = getattr(db, "_db", db)
        wired = [target, *getattr(target, "shards", ()),
                 getattr(target, "hot_budget", None),
                 getattr(target, "repartitioner", None)]
        wired += [getattr(x, "ralt", None) for x in wired]
        for x in wired:
            if x is not None and x.__dict__.get("_obs") is self:
                del x._obs
                x.__dict__.pop("_obs_track", None)
        if self._hooked is not None and self._hooked[0] is target:
            own = self._hooked[1]
            if own is None:
                del target._new_shard
            else:
                target._new_shard = own
            self._hooked = None
        if self._db is target:
            self._db = None

    # -- runner hook (once per chunk of ops) ---------------------------
    def on_ops(self, db, k: int) -> None:
        """One cadence check per chunk of `k` ops.  Sampling rides the
        *simulated* clock (`maybe_sample` compares `now()` against the
        next sample time), so a per-chunk check shifts each sample by
        at most one chunk of sim time — the series cadence is that of a
        per-op check while the recorder does 1/k the work."""
        del k  # cadence is sim-time-driven; the count documents intent
        m = self.metrics
        if m.enabled:
            m.maybe_sample(self.now(), getattr(db, "_db", db), self.tracer)

    # -- export --------------------------------------------------------
    def export(self, trace_path: str | None = None,
               metrics_path: str | None = None) -> None:
        if trace_path:
            self.tracer.export(trace_path)
        if metrics_path:
            import json
            with open(metrics_path, "w") as f:
                json.dump(jsonify(self.metrics.to_json()), f)


# The compiled-out default: every engine's class-level `_obs`.
# enabled=False short-circuits every instrumentation site; the
# sub-objects exist so even a buggy unguarded call is a harmless no-op.
NULL_OBS = Observability(enabled=False)

# The serving-half plane (tiering components + ServeEngine) lives in
# .serving; imported last so it can reuse this module's helpers.
from .serving import NULL_SERVING_OBS, ServingObservability  # noqa: E402
