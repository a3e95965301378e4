"""The harness: imports no JAX, finds what a cell needs by name, refuses
to run without a card or without the program."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from kvbench.tests import tiny

ROOT = tiny.ROOT


def _env(**kw):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(kw)
    return env


def test_harness_imports_no_jax_nor_the_jax_package():
    """Top-level names compared whole: `repro_torch` begins with
    `repro`."""
    code = ("import sys; sys.path[:0] = [{r!r}, {s!r}]\n"
            "import kvbench.harness, kvbench.control, kvbench.engine\n"
            "import kvbench.syncs, kvbench.profile\n"
            "from kvbench.harness import resolve\n"
            "from pathlib import Path\n"
            "for w in ('hotrap-medium.rw-hotspot5',):\n"
            "    resolve(Path({r!r}), w)\n"
            "import repro_torch.core, repro_torch.configs.hotrap_kv\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            "{{'jax', 'jaxlib', 'flax', 'repro'}}))").format(
        r=str(ROOT), s=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_benchmark_reads_nothing_of_the_jax_harness():
    for p in (ROOT / "kvbench").rglob("*.py"):
        text = p.read_text()
        for word in ("bench_history", "benchmarks/", "benchmarks."):
            assert word not in text or p.parent.name == "tests", (p, word)


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "kvbench/run.py", "--workload",
         "hotrap-medium.ro-hotspot5", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_run_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "kvbench", tmp_path / "kvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "kvbench/run.py", "--workload",
         "hotrap-medium.ro-hotspot5", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_manifest_is_well_formed():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        found = __import__("kvbench.harness",
                           fromlist=["resolve"]).resolve(ROOT, w["name"])
        assert found["readers"] and found["end_to_end"]
    for m in bench["per_layer"]:
        assert (ROOT / "kvbench" / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", names)) <= set(names)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


@pytest.mark.parametrize("trace", [False, True])
def test_new_config_traffic_and_metric_need_only_new_files(tmp_path, trace):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with new entries in BENCHMARK.json, are found by name; no
    file that was there is edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "kvbench", tmp_path / "kvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "kvbench").rglob("*")
              if p.is_file()}
    kv = tmp_path / "kvbench"
    cfg = json.loads((kv / "configs" / "hotrap-medium.json").read_text())
    cfg["engine"]["lsm"]["retention"] = False
    (kv / "configs" / "hotrap-noretain.json").write_text(json.dumps(cfg))
    mix = json.loads((kv / "traffic" / "rw-hotspot5.json").read_text())
    mix.update(mix="UH", why="50% reads, 50% updates")
    (kv / "traffic" / "uh-hotspot5.json").write_text(json.dumps(mix))
    (kv / "metrics" / "gets_per_round.py").write_text(
        "def read(rec):\n    return rec['gets'] / 1.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0],
                             "name": "hotrap-noretain",
                             "file": "kvbench/configs/hotrap-noretain.json"})
    cell = "hotrap-noretain.uh-hotspot5"
    bench["workloads"].append({"name": cell, "config": "hotrap-noretain",
                               "traffic": "uh-hotspot5", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "gets_per_round", "unit": "gets",
                               "better": "higher",
                               "source": "host_clock", "layer": "client",
                               "moves": "ops_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = tiny.run(cell, seconds=0.3, trace=trace, root=tmp_path)
    assert res["correct"], res["checks"]
    want = "gets_per_round" if trace else "ops_per_s"
    assert want in res["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_profile_summary_reads_busy_time_and_idle_gaps():
    """busy_s is the union of device operations inside the traced
    stretch; each idle gap goes to the harness span the host was in."""
    import torch
    from kvbench import profile

    class Ev:
        def __init__(self, name, dev, a, b):
            self.n, self.d, self.a, self.b = name, dev, a, b

        def name(self):
            return self.n

        def device_type(self):
            return (torch.autograd.DeviceType.CUDA if self.d
                    else torch.autograd.DeviceType.CPU)

        def start_ns(self):
            return self.a

        def duration_ns(self):
            return self.b - self.a

    evs = [Ev(profile.TRACED, False, 0, 1000),
           Ev("kvbench.multi_get", False, 0, 600),
           Ev("kvbench.put_many", False, 600, 1000),
           Ev(profile.TRACED, True, 0, 1000),       # the range on the card
           Ev("void k<int>(int*)", True, 100, 300),
           Ev("void k<long>(long*)", True, 200, 400),
           Ev("Memcpy DtoH (Device -> Pageable)", True, 700, 800)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return evs
    s = profile.summarize(Prof)
    assert s["busy_s"] == 400e-9 and s["window_s"] == 1000e-9
    assert s["breakdown"]["device_ops"] == [["k", 400e-9],
                                            ["Memcpy DtoH (Device -> "
                                             "Pageable)", 100e-9]]
    assert dict(s["breakdown"]["idle_gaps"]) == {"multi_get": 400e-9,
                                                 "put_many": 200e-9}
