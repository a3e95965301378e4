"""Deterministic crash-point injection for the durability subsystem:
the port of `repro.core.crashpoints` (pure Python, copied).

Its armed registry `_armed` is this module's own: arming a site here
does not arm the reference's, and the reverse.

A *crash site* is a named place in the engine where a real process
could die with durable state mid-transition: during a flush's manifest
edit, a compaction install, a checker promotion install, the
repartitioner's pre-copy stream, or the cluster topology commit at
cutover.  Sites are compiled out by default — every injection point is
one module-level ``hit(site)`` call that returns immediately unless the
registry has been armed — and deterministic: ``arm(site, hits=k)``
makes the k-th visit to that site raise :class:`CrashError`, so a test
replays the exact same crash every run.

Crash semantics in a simulated process
--------------------------------------
There is no real process to kill, so "crash" means: the exception
propagates out of the engine and the caller discards the engine object
wholesale.  Durable state — the WAL's synced records, the manifest's
complete edits, the SSTable registry, the topology log
(see core/wal.py) — is frozen at the instant of the raise because
nothing runs after it; recovery builds a *fresh* engine from those
objects alone (``TieredLSM.recover`` / ``ShardedTieredLSM.recover``).
The in-memory state of the crashed engine is never consulted, exactly
as a restarted process never sees its predecessor's heap.

``crash_recover`` is the standard harness: arm a site, drive the
workload until the crash fires, recover, and hand back the recovered
engine plus what happened — tests then assert oracle equivalence and
sanitizer invariants on the recovered engine.
"""
from __future__ import annotations

__all__ = ["CRASH_SITES", "CrashError", "arm", "disarm", "armed", "hit",
           "crash_recover"]

# The registered taxonomy (docs/ARCHITECTURE.md "Durability & crash
# recovery").  Each name is an injection point inside the engine:
#
#   mid-flush              during a flush's manifest edit write
#   mid-compaction         during a compaction install's manifest edit
#   mid-promotion-install  during a checker promotion's manifest edit
#   mid-migration-stream   inside the repartitioner's pre-copy stream
#   mid-cutover            during the cluster topology commit record
CRASH_SITES = ("mid-flush", "mid-compaction", "mid-promotion-install",
               "mid-migration-stream", "mid-cutover")


class CrashError(RuntimeError):
    """The simulated process died at an armed crash site."""

    def __init__(self, site: str):
        super().__init__(f"injected crash at {site}")
        self.site = site


# site -> remaining visits before the crash fires.  Module-level so the
# engine needs no plumbing: any armed site crashes whichever engine
# reaches it first (tests arm exactly one engine's workload at a time).
_armed: dict[str, int] = {}


def arm(site: str, hits: int = 1) -> None:
    """Crash on the ``hits``-th visit to ``site`` (1 = next visit)."""
    if site not in CRASH_SITES:
        raise ValueError(f"unknown crash site {site!r} "
                         f"(choose from {CRASH_SITES})")
    if hits < 1:
        raise ValueError("hits must be >= 1")
    _armed[site] = hits


def disarm(site: str | None = None) -> None:
    """Disarm one site, or all of them (``None``)."""
    if site is None:
        _armed.clear()
    else:
        _armed.pop(site, None)


def armed() -> dict[str, int]:
    """Snapshot of the armed sites (site -> remaining visits)."""
    return dict(_armed)


def hit(site: str, obs=None, track: str = "db") -> None:
    """One visit to an injection site.  Free when nothing is armed.

    When the countdown expires, a ``crash_injected`` instant lands on
    the caller's observability track (if a plane is attached) at the
    exact simulated time of the crash, then :class:`CrashError` raises.
    """
    if not _armed:
        return
    left = _armed.get(site)
    if left is None:
        return
    if left > 1:
        _armed[site] = left - 1
        return
    del _armed[site]
    if obs is not None and obs.enabled:
        obs.tracer.instant(track, "crash_injected", {"site": site})
        # the spans the engine is inside die with the process: close
        # them so the salvaged trace stays stack-balanced
        obs.tracer.close_open({"crashed": site})
    raise CrashError(site)


def crash_recover(db, drive, site: str, hits: int = 1, obs=None):
    """Arm ``site``, run ``drive(db)`` until the crash fires, recover.

    ``db`` may be a ``TieredLSM``, a ``ShardedTieredLSM``, or a
    ``SanitizedDB`` proxy over either (the proxy is unwrapped — the
    crashed sanitizer's hooks die with the crashed engine).  Returns
    ``(crashed, recovered)`` where ``crashed`` says whether the armed
    site actually fired (a drive that finishes without reaching the
    site recovers from a clean shutdown image instead) and
    ``recovered`` is the fresh engine rebuilt from durable state.
    ``obs``, when given, is attached to the recovered engine before
    replay so the ``recovery`` span lands on its trace.
    """
    arm(site, hits)
    try:
        drive(db)
        crashed = False
    except CrashError:
        crashed = True
    finally:
        disarm()
    target = getattr(db, "_db", db)       # unwrap SanitizedDB
    recovered = type(target).recover(target, obs=obs)
    return crashed, recovered
