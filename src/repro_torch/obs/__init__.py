"""Observability of the port: the metrics plane and a disabled stand-in
for the tracer and attribution.

`obs/metrics.py` is the reference's histograms and series (numpy on the
host).  Engine objects carry a class-level ``_obs = NULL_OBS`` whose
``enabled`` flag is False, and every instrumentation site guards on
``if self._obs.enabled:``, so the sites never run.  The sub-objects of
the null plane accept every call the sites make and do nothing, so even
an unguarded call is a harmless no-op.  The tracer, attribution and the
serving plane are a later slice (ROADMAP Queue 1); `obs/serving.py`
holds the serving half's stand-in.
"""
from __future__ import annotations

import numpy as np

from .metrics import (LatencyHistogram, MetricsRegistry, Series,  # noqa: F401
                      TierLatencyHistogram)

__all__ = ["NULL_OBS", "MetricsRegistry", "LatencyHistogram",
           "TierLatencyHistogram", "Series", "jsonify"]


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


class _NoOp:
    """Accepts any method call and does nothing."""

    def __getattr__(self, name):
        return self._noop

    @staticmethod
    def _noop(*args, **kw):
        return None


class _NullObs:
    enabled = False
    attribution = False
    tracer = _NoOp()
    attr = _NoOp()
    metrics = _NoOp()

    def on_ops(self, db, k: int) -> None:
        del db, k


# The compiled-out default: every engine's class-level `_obs`.
NULL_OBS = _NullObs()
