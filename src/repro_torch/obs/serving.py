"""Disabled observability plane of the port.

The reference attaches a tracer, metrics and attribution to its tiering
and serving classes (`repro.obs.serving`).  The port keeps only the
class-level `_obs = NULL_SERVING_OBS` attribute and the
``if self._obs.enabled:`` guards at the instrumentation sites; with the
plane below they never run.  The real plane is a later slice.
"""
from __future__ import annotations


class _NullServingObs:
    enabled = False
    attribution = False


NULL_SERVING_OBS = _NullServingObs()
