"""Observability for the serving half, the port of `repro.obs.serving`:
the same compiled-out-by-default plane as the core, attached to the
tiering components (`TieredKVCache`, `ExpertCache`, `TieredEmbedding`)
and the `ServeEngine`.

The serving half has no `StorageSim`; simulated time is the sum of the
attached components' `SimClock` walls (`hbm_s + pcie_s`) — each clock
is monotone, so the sum is a valid trace clock.  The plane reads those
clocks and the pool/page-table aggregates but never charges device or
PCIe time, never mutates a page table and never calls into the
components' data or maintenance plane (`sweep`, `flush_promote`,
`rebalance`, `read_pages`, `write_page`, …); `tests/test_torch_serving_obs.py`
holds an attached component's tables, clock and outputs to the
unattached one's.

Everything it reads is host state: `SimClock`'s fields are Python
numbers and the free lists and staging sets host containers, so a sample
costs no device sync, and trace args are host numbers (`json.dumps` in
`export` takes them as they are).

Three legs, mirroring `repro_torch.obs.Observability`:

  * `Tracer` (shared class) — spans for eviction sweeps, bulk staging
    flushes, expert rebalances, prefill/decode waves; instants for the
    three page-level pathways (`page/retained`,
    `page/promo_compaction`, `page/promo_flush`), promotion aborts on
    version mismatch (`page/promo_abort`), slot assignment and engine
    starvation.
  * `ServingMetricsRegistry` — cadenced series per attached component:
    device-pool occupancy, staging-list depth, page hit rate by tier,
    and cumulative PCIe promotion/demotion bytes, mirrored onto trace
    counter lanes.
  * `TokenAttributionSampler` — reservoir-sampled per-token records
    (component kind, pages gathered, pages fetched from host, sim-time
    cost, behind-sweep flag) feeding the "why slow" table.

Every instrumentation site in the tiering/serving modules is guarded
by one attribute check (``if self._obs.enabled:``) against the
class-level ``_obs = NULL_SERVING_OBS``: an unattached component pays
one attribute load + branch per site and allocates nothing.
"""
from __future__ import annotations

import numpy as np

from .metrics import Series
from .trace import Tracer

__all__ = ["ServingObservability", "ServingMetricsRegistry",
           "TokenAttributionSampler", "NULL_SERVING_OBS", "KIND_NAMES",
           "component_sample"]

KIND_NAMES = ("kv", "emb", "expert", "engine")
KIND_CODES = {name: i for i, name in enumerate(KIND_NAMES)}


def _unit_bytes(comp) -> int:
    """Bytes moved per promoted/demoted unit, duck-typed per component:
    KV pages, embedding rows, or expert blobs."""
    cfg = getattr(comp, "cfg", None)
    if cfg is not None and hasattr(cfg, "page_bytes"):
        return cfg.page_bytes
    for attr in ("row_bytes", "blob_bytes"):
        b = getattr(comp, attr, None)
        if b is not None:
            return int(b)
    return 0


def _fast_capacity(comp) -> int:
    cfg = getattr(comp, "cfg", None)
    if cfg is not None and hasattr(cfg, "fast_slots"):
        return cfg.fast_slots
    for attr in ("fast_rows", "fast_experts"):
        c = getattr(comp, attr, None)
        if c is not None:
            return int(c)
    return 0


def component_sample(comp) -> dict[str, float]:
    """One read-only sample of a tiering component's aggregates.
    Everything here is a read of public counters — no charge APIs, no
    page-table writes (the lint enforces it)."""
    out: dict[str, float] = {}
    clock = getattr(comp, "clock", None)
    if clock is None:
        return out
    unit = _unit_bytes(comp)
    hits = clock.fast_hits + clock.slow_hits
    out["page_hit_rate"] = clock.fast_hits / hits if hits else 0.0
    out["promoted_bytes"] = clock.promoted * unit
    out["demoted_bytes"] = clock.demoted * unit
    out["pcie_s"] = clock.pcie_s
    out["hbm_s"] = clock.hbm_s
    cap = _fast_capacity(comp)
    free = getattr(comp, "free_slots", None)
    if free is None:
        free = getattr(comp, "free", None)
    if cap and free is not None:
        out["hbm_occupancy"] = (cap - len(free)) / cap
    staging = getattr(comp, "staging", None)
    if staging is not None:
        out["staging_depth"] = float(len(staging))
    return out


class ServingMetricsRegistry:
    """Cadenced read-only sampler over the attached serving components.

    Series are created lazily as ``<track>/<metric>`` so one registry
    covers any mix of components; each is the same fixed-capacity ring
    buffer the core plane uses."""

    METRICS = ("hbm_occupancy", "staging_depth", "page_hit_rate",
               "promoted_bytes", "demoted_bytes", "pcie_s", "hbm_s")

    def __init__(self, interval_s: float = 1e-4, capacity: int = 4096,
                 enabled: bool = True):
        self.enabled = enabled
        self.interval_s = interval_s
        self.capacity = capacity
        self.series: dict[str, Series] = {}
        self._next_t = 0.0
        self.n_samples = 0

    def _series(self, name: str) -> Series:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = Series(name, self.capacity)
        return s

    def maybe_sample(self, now: float, components, tracer=None) -> None:
        if not self.enabled or now < self._next_t:
            return
        self._next_t = now + self.interval_s
        self._sample(now, components, tracer)

    def _sample(self, now: float, components, tracer) -> None:
        self.n_samples += 1
        for comp, track in components:
            sample = component_sample(comp)
            for metric, value in sample.items():
                self._series(f"{track}/{metric}").append(now, value)
            if tracer is not None and tracer.enabled and sample:
                tracer.counter(track, "pool", {
                    k: round(float(sample[k]), 6)
                    for k in ("hbm_occupancy", "staging_depth",
                              "page_hit_rate") if k in sample})
                tracer.counter(track, "pcie_bytes", {
                    k: float(sample[k]) for k in
                    ("promoted_bytes", "demoted_bytes") if k in sample})

    def to_json(self) -> dict:
        out = {"interval_s": self.interval_s, "n_samples": self.n_samples,
               "series": {}}
        for name, s in self.series.items():
            t, v = s.values()
            out["series"][name] = {"t": [round(float(x), 9) for x in t],
                                   "v": [float(x) for x in v]}
        return out


class TokenAttributionSampler:
    """Bounded reservoir (Algorithm R) of per-token gather records.

    One record per data-plane access (a KV page gather, an embedding
    lookup, an expert-routing step): which component kind served it,
    how many units were gathered and how many came from the host tier,
    the simulated cost of the access, and whether it landed behind a
    maintenance pass (eviction sweep / staging flush / rebalance) that
    ran inside the same access."""

    def __init__(self, capacity: int = 65536, seed: int = 0):
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self.lat = np.zeros(capacity)
        self.kind = np.zeros(capacity, dtype=np.int8)
        self.units = np.zeros(capacity, dtype=np.int32)
        self.host_units = np.zeros(capacity, dtype=np.int32)
        self.behind_sweep = np.zeros(capacity, dtype=bool)
        self.n_kept = 0
        self.n_seen = 0

    def observe(self, kind: str, lat: float, units: int, host_units: int,
                behind_sweep: bool) -> None:
        self.n_seen += 1
        if self.n_kept < self.capacity:
            slot = self.n_kept
            self.n_kept += 1
        else:
            slot = int(self._rng.integers(0, self.n_seen))
            if slot >= self.capacity:
                return
        self.lat[slot] = lat
        self.kind[slot] = KIND_CODES.get(kind, 0)
        self.units[slot] = units
        self.host_units[slot] = host_units
        self.behind_sweep[slot] = behind_sweep

    def table(self, q: float = 0.99) -> dict:
        """Why-slow composition of the tail above the q-quantile,
        grouped by (component kind, served-from)."""
        n = self.n_kept
        if n == 0:
            return {"q": q, "threshold_us": 0.0, "n_sampled": 0,
                    "n_tail": 0, "rows": []}
        lat = self.lat[:n]
        thresh = float(np.quantile(lat, q))
        tail = lat >= thresh
        host = self.host_units[:n] > 0
        rows = []
        for code, kname in enumerate(KIND_NAMES):
            for served, smask in (("hbm", ~host), ("host", host)):
                mask = tail & (self.kind[:n] == code) & smask
                cnt = int(mask.sum())
                if cnt == 0:
                    continue
                rows.append({
                    "kind": kname,
                    "served": served,
                    "count": cnt,
                    "share": cnt / max(1, int(tail.sum())),
                    "mean_lat_us": float(lat[mask].mean()) * 1e6,
                    "mean_units": float(self.units[:n][mask].mean()),
                    "mean_host_units":
                        float(self.host_units[:n][mask].mean()),
                    "behind_sweep":
                        int(self.behind_sweep[:n][mask].sum()),
                })
        rows.sort(key=lambda r: -r["count"])
        return {"q": q, "threshold_us": thresh * 1e6, "n_sampled": n,
                "n_seen": self.n_seen, "n_tail": int(tail.sum()),
                "rows": rows}

    def format_table(self, q: float = 0.99, title: str = "") -> str:
        t = self.table(q)
        head = (f"p{int(q * 1000) / 10:g} token attribution"
                f"{' — ' + title if title else ''}: "
                f"threshold {t['threshold_us']:.2f}us, "
                f"{t['n_tail']}/{t['n_sampled']} sampled accesses in tail")
        if not t["rows"]:
            return head + "\n  (no sampled accesses)"
        cols = (f"  {'kind':<7} {'served':<6} {'count':>6} {'share':>6} "
                f"{'mean_us':>9} {'units':>6} {'host':>5} {'sweep':>6}")
        lines = [head, cols]
        for r in t["rows"]:
            lines.append(
                f"  {r['kind']:<7} {r['served']:<6} {r['count']:>6} "
                f"{r['share']:>6.2f} {r['mean_lat_us']:>9.2f} "
                f"{r['mean_units']:>6.1f} {r['mean_host_units']:>5.1f} "
                f"{r['behind_sweep']:>6}")
        return "\n".join(lines)

    def summary(self, q: float = 0.99) -> dict:
        return self.table(q)


class ServingObservability:
    """Tracer + serving metrics + token attribution behind one flag.

    ``attach(component, name=...)`` wires any tiering component or the
    `ServeEngine`; the trace clock becomes the sum of the attached
    components' `SimClock` walls (each monotone, so the sum is too —
    the tracer additionally clamps against benchmark clock resets)."""

    def __init__(self, enabled: bool = True, trace: bool = True,
                 metrics: bool = True, attribution: bool = True,
                 metrics_interval_s: float = 1e-4,
                 attr_capacity: int = 65536,
                 max_events: int = 400_000):
        self.enabled = enabled
        self.tracer = Tracer(max_events=max_events,
                             enabled=enabled and trace)
        self.tracer.clock = self.now
        self.metrics = ServingMetricsRegistry(
            interval_s=metrics_interval_s, enabled=enabled and metrics)
        self.attr = TokenAttributionSampler(capacity=attr_capacity)
        self.attribution = enabled and attribution
        self._components: list[tuple[object, str]] = []

    # -- clock ---------------------------------------------------------
    def now(self) -> float:
        """Serving sim-time: total simulated device seconds across the
        attached components' clocks."""
        t = 0.0
        for comp, _ in self._components:
            clock = getattr(comp, "clock", None)
            if clock is not None:
                t += clock.total_s
        return t

    # -- attachment ----------------------------------------------------
    def attach(self, comp, name: str = "serving") -> "ServingObservability":
        comp._obs = self
        comp._obs_track = name
        self._components.append((comp, name))
        return self

    # -- component hook (once per data-plane access) -------------------
    def on_access(self) -> None:
        m = self.metrics
        if m.enabled:
            m.maybe_sample(self.now(), self._components, self.tracer)

    # -- export --------------------------------------------------------
    def export(self, trace_path: str | None = None,
               metrics_path: str | None = None) -> None:
        if trace_path:
            self.tracer.export(trace_path)
        if metrics_path:
            import json

            from . import jsonify
            with open(metrics_path, "w") as f:
                json.dump(jsonify(self.metrics.to_json()), f)


# The compiled-out default: every tiering/serving class's `_obs`.
NULL_SERVING_OBS = ServingObservability(enabled=False)
