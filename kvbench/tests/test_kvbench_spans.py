"""The engine's wall-clock spans on the profiler's timeline of a traced
round: under `torch.profiler` each span of an attached
`Observability(clock="wall")` is a range nested inside the harness's
`kvbench.multi_get` or `kvbench.put_many` range of its round."""
import torch

from kvbench import engine, harness, profile, ycsb
from kvbench.tests import tiny
from repro_torch.obs import MIRROR_PREFIX, Observability


def _events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every host event of a CPU trace."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_engine_spans_nest_inside_the_harness_ranges():
    cell = "hotrap-medium.rw-hotspot5"
    ov = tiny.overrides(cell)
    found = harness.resolve(tiny.ROOT, cell)
    config = {**found["config"], **ov["config"]}
    traffic = {**found["traffic"], **ov["traffic"]}
    vlen = config["value_len"]
    db = engine.build(config, 5, "cpu")
    engine.load(db, ycsb.load_keys(int(config["n_keys"]), 5), vlen, False)
    stream = ycsb.Stream(traffic, int(config["n_keys"]), 5)
    log = harness.Log()
    for _ in range(40):
        harness.run_round(db, stream, log, vlen)
    obs = Observability(clock="wall").attach(db)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            harness.run_round(db, stream, log, vlen, traced=True)
    obs.detach(db)
    evs = _events(prof)
    outer = {n: [(a, b) for m, a, b in evs if m == profile.PREFIX + n]
             for n in ("multi_get", "put_many")}
    assert len(outer["multi_get"]) == len(outer["put_many"]) == 4
    inner = [(m[len(MIRROR_PREFIX):], a, b) for m, a, b in evs
             if m.startswith(MIRROR_PREFIX)]
    assert {"get", "get/mem", "get/fd", "get/commit", "get/answer",
            "ralt/record", "put"} <= {n for n, _, _ in inner}
    gets = [(a, b) for n, a, b in inner if n == "get"]
    for n, a, b in inner:
        home = (outer["put_many"] if n == "put" else outer["multi_get"]
                if n == "get" or n.startswith("get/")
                else outer["multi_get"] + outer["put_many"])
        assert any(a0 <= a and b <= b0 for a0, b0 in home), n
        if n.startswith("get/"):
            assert any(a0 <= a and b <= b0 for a0, b0 in gets), n
    assert obs.tracer.validate() == []
    assert len(gets) == obs.tracer.count("get", "B") == 4
