"""The invariant lint suite (PR 6): every pass catches its seeded
fixture violations, the real tree lints clean, and the rule mechanics
(typed receivers, escape analysis, waivers, owner exemptions) hold on
focused snippets.

The checker lives at the repo root (`tools/check`), outside `src/`, so
the tests put the repo root on sys.path themselves.
"""
import pathlib
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.check import all_passes, run_checks, self_test  # noqa: E402
from tools.check.base import Source  # noqa: E402
from tools.check.immutability import ImmutabilityPass  # noqa: E402
from tools.check.pallas_purity import PallasPurityPass  # noqa: E402
from tools.check.pins import PinReleasePass  # noqa: E402
from tools.check.stats_discipline import StatsDisciplinePass  # noqa: E402
from tools.check.vectorization import VectorizationPass  # noqa: E402


def _src(path: str, code: str) -> Source:
    return Source(pathlib.Path(path), text=textwrap.dedent(code))


# ----------------------------------------------------------------------
# suite-level: fixtures and the real tree
# ----------------------------------------------------------------------
def test_self_test_is_green():
    checks, errors = self_test()
    assert checks == 7
    assert errors == [], "\n".join(errors)


def test_fixtures_are_not_vacuous():
    # every fixture must seed at least two violations — a pass that
    # detects nothing cannot silently "succeed"
    fixture_dir = REPO / "tools" / "check" / "fixtures"
    fixtures = sorted(fixture_dir.glob("*_cases.py"))
    assert len(fixtures) == 7
    for f in fixtures:
        assert f.read_text().count("# EXPECT:") >= 2, f.name


def test_real_tree_lints_clean():
    findings = run_checks([REPO / "src"])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_pass_registry_names():
    assert [p.name for p in all_passes()] == [
        "immutability", "pins", "stats", "vectorization", "pallas"]


# ----------------------------------------------------------------------
# immutability mechanics
# ----------------------------------------------------------------------
def test_immutability_flags_typed_receiver():
    s = _src("pkg/other.py", """\
        def f(db):
            v = db.version.ref()
            v.levels = []
            return v
        """)
    assert [f.line for f in ImmutabilityPass().run(s)] == [3]


def test_immutability_owner_module_exempt():
    code = """\
        class Version:
            def ref(self):
                self.refs += 1
                return self
        """
    assert ImmutabilityPass().run(
        _src("src/repro/core/version.py", code)) == []
    # the same stores outside the owner module are violations
    assert ImmutabilityPass().run(_src("src/elsewhere.py", code)) != []


def test_immutability_self_store_on_unrelated_class_ok():
    s = _src("pkg/tracker.py", """\
        class RaltRun:
            def __init__(self):
                self.bloom = object()
        """)
    assert ImmutabilityPass().run(s) == []


def test_immutability_list_producer_through_concat():
    s = _src("pkg/other.py", """\
        def f(inputs: list[SSTable], nexts):
            merged = inputs + nexts
            for s in merged:
                s.tier = "SD"
        """)
    assert [f.line for f in ImmutabilityPass().run(s)] == [4]


# ----------------------------------------------------------------------
# pin/release mechanics
# ----------------------------------------------------------------------
def test_pins_require_finally():
    bad = _src("pkg/a.py", """\
        def f(db):
            v = db.version.ref()
            n = len(v.levels)
            v.unref()
            return n
        """)
    out = PinReleasePass().run(bad)
    assert len(out) == 1 and "try/finally" in out[0].message

    good = _src("pkg/a.py", """\
        def f(db):
            v = db.version.ref()
            try:
                return len(v.levels)
            finally:
                v.unref()
        """)
    assert PinReleasePass().run(good) == []


def test_pins_flag_never_released():
    s = _src("pkg/a.py", """\
        def f(db):
            v = db.version.acquire()
            return len(v.levels)
        """)
    out = PinReleasePass().run(s)
    assert len(out) == 1 and "never released" in out[0].message


def test_pins_escape_transfers_ownership():
    s = _src("pkg/a.py", """\
        def f(db, pins):
            v = db.version.ref()
            pins.append(v)

        def g(db):
            sv = Superversion(db.version.ref(), [])
            return sv
        """)
    assert PinReleasePass().run(s) == []


# ----------------------------------------------------------------------
# stats discipline mechanics
# ----------------------------------------------------------------------
def test_stats_device_writes_flagged_outside_storage():
    code = """\
        def f(d):
            d.fg_time += 1.0
        """
    assert len(StatsDisciplinePass().run(_src("pkg/a.py", code))) == 1
    assert StatsDisciplinePass().run(
        _src("src/repro/core/storage.py", code)) == []


def test_stats_obs_plane_is_read_only():
    code = """\
        def sample(db, storage):
            busy = storage.device_totals()
            db.stats.gets  # read
            storage.rand_read("SD", 4096, fg=True, component="obs")
        """
    # inside src/repro/obs/: the charge call is flagged, the reads pass
    out = StatsDisciplinePass().run(_src("src/repro/obs/metrics.py", code))
    assert len(out) == 1 and "never charges" in out[0].message
    # the same code outside the plane uses the public API legitimately
    assert StatsDisciplinePass().run(_src("benchmarks/x.py", code)) == []


def test_stats_obs_serving_rule_covers_tiering():
    code = """\
        def sample(kv):
            depth = len(kv.staging)  # read
            rate = kv.clock.fast_hits / 2  # read
            kv.clock.pcie_s += 1e-6
            kv.tier[3] = 0
            kv.free_slots.append(1)
            kv.sweep()
        """
    # inside src/repro/obs/: charge, table stores, mutators all flagged
    out = StatsDisciplinePass().run(_src("src/repro/obs/serving.py", code))
    assert len(out) == 4, out
    # the same code in a tiering component owns that state legitimately
    assert StatsDisciplinePass().run(
        _src("src/repro/tiering/kvcache.py", code)) == []


def test_stats_engine_counters_owned_by_core():
    code = """\
        def f(db):
            db.stats.gets = 0
        """
    assert len(StatsDisciplinePass().run(_src("benchmarks/x.py", code))) == 1
    assert StatsDisciplinePass().run(
        _src("src/repro/core/lsm.py", code)) == []


# ----------------------------------------------------------------------
# vectorization mechanics
# ----------------------------------------------------------------------
def test_vectorization_registry_and_waiver():
    code = """\
        def run_workload(ops, db):
            for op in ops:
                db.get(op)
            # lint: allow-loop (two fixed tiers)
            for tier in ("FD", "SD"):
                db.get(tier)
        """
    out = VectorizationPass().run(_src("x/core/runner.py", code))
    assert [f.line for f in out] == [2]
    # same code in a non-hot file: nothing flagged
    assert VectorizationPass().run(_src("x/core/other.py", code)) == []


def test_vectorization_covers_the_batched_storage_primitives():
    code = """\
        def access_many(self, sids, blks):
            for key in zip(sids, blks):
                self.access(key)

        def rand_read_many(self, is_sd, nbytes):
            # lint: allow-loop (two fixed tiers)
            for tier in ("FD", "SD"):
                self.dev[tier]
            for sd in is_sd:
                self.rand_read(sd, nbytes)
        """
    out = VectorizationPass().run(_src("x/core/storage.py", code))
    assert [f.line for f in out] == [2, 9]


def test_vectorization_covers_the_ports_columnar_checker():
    """The port's Checker functions are hot (an unwaived per-record loop
    is flagged); the reference's per-record Checker is not."""
    code = """\
        def _checker_body(self, immpc):
            for key, seq, vlen in immpc.records:
                self.check(key)
            # lint: allow-loop (under half a table of survivors)
            for k, s, v in hot:
                self.mpc.insert(k, s, v)

        def _newer_in_snapshot(self, keys, seqs, immpc):
            for key in keys:
                self.walk(key)

        def _snapshot_probes(self, keys, version):
            # lint: allow-loop (the FD levels)
            for level in version.levels:
                for key in keys:
                    level.probe(key)

        def _probe_events(sel, rank, sid, sd, rows):
            for row in rows:
                yield row
        """
    out = VectorizationPass().run(_src("src/repro_torch/core/lsm.py", code))
    assert [f.line for f in out] == [2, 9, 15, 19]
    assert VectorizationPass().run(_src("src/repro/core/lsm.py", code)) == []


# ----------------------------------------------------------------------
# pallas purity mechanics
# ----------------------------------------------------------------------
def test_pallas_traced_branch_and_numpy():
    s = _src("pkg/kernels/k.py", """\
        import numpy as np
        import jax.numpy as jnp
        from jax.experimental import pallas as pl

        def kern(x_ref, o_ref, *, flip):
            x = x_ref[...]
            if x.sum() > 0:
                x = -x
            if flip:
                x = x[::-1]
            o_ref[...] = jnp.asarray(np.asarray(x))
        """)
    out = PallasPurityPass().run(s)
    msgs = " | ".join(f.message for f in out)
    assert len(out) == 2
    assert "Python 'if' on traced" in msgs and "host numpy" in msgs


def test_pallas_closure_over_outer_scope():
    s = _src("pkg/kernels/k.py", """\
        from jax.experimental import pallas as pl

        def launch(x, scale):
            def kern(x_ref, o_ref):
                o_ref[...] = x_ref[...] * scale
            return pl.pallas_call(kern, out_shape=None)(x)
        """)
    out = PallasPurityPass().run(s)
    assert len(out) == 1 and "closes over" in out[0].message


def test_pallas_static_kwonly_specialization_ok():
    s = _src("pkg/kernels/k.py", """\
        import functools
        from jax.experimental import pallas as pl

        def kern(x_ref, o_ref, *, causal):
            i = pl.program_id(0)
            if causal:
                o_ref[...] = x_ref[...]

        def launch(x):
            k = functools.partial(kern, causal=True)
            return pl.pallas_call(k, out_shape=None)(x)
        """)
    assert PallasPurityPass().run(s) == []
