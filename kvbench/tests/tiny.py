"""A cell's configuration and traffic cut to the engine's `tiny` scale
(22,528 keys, 2 MiB FD : 20 MiB SD) and rounds of 64 ops, for CPU
tests; and a copy of the benchmark with a durable configuration added as
data alone."""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the 4-shard hash cluster with a group-committed WAL
# (`hotrap-kv4-wal.json` beside this file) under the rw-hotspot5 mix
KV4 = "hotrap-kv4-wal.rw-hotspot5"
SCALE_KEYS = ("fd_size", "sd_size", "target_sstable_bytes",
              "memtable_bytes", "block_cache_bytes")


def durable_root(tmp: Path) -> Path:
    """`tmp` made a copy of the benchmark whose BENCHMARK.json also
    names the configuration `hotrap-kv4-wal` and the cell `KV4`."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp)
    shutil.copytree(ROOT / "kvbench", tmp / "kvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(Path(__file__).parent / "hotrap-kv4-wal.json",
                tmp / "kvbench" / "configs")
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append(
        {**bench["configs"][0], "name": "hotrap-kv4-wal",
         "file": "kvbench/configs/hotrap-kv4-wal.json"})
    bench["workloads"].append({"name": KV4, "config": "hotrap-kv4-wal",
                               "traffic": "rw-hotspot5", "chips": 1,
                               "why": "durable cluster"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def overrides(cell: str, round_ops: int = 64, warmup_ops: int = 2048,
              root: Path = ROOT, lsm: dict | None = None) -> dict:
    from repro_torch.core import runner
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = next(w["config"] for w in bench["workloads"]
                  if w["name"] == cell)
    cfg = json.loads((root / "kvbench" / "configs"
                      / f"{config}.json").read_text())
    t = dataclasses.asdict(runner.default_config("tiny"))
    lsm = {**cfg["engine"]["lsm"], **{k: t[k] for k in SCALE_KEYS},
           **(lsm or {})}
    return {"config": {"engine": dict(cfg["engine"], lsm=lsm),
                       "n_keys": runner.db_key_count(
                           runner.default_config("tiny"), cfg["value_len"])},
            "traffic": {"round_ops": round_ops, "warmup_ops": warmup_ops}}


def run(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
        trace: bool = False, root: Path = ROOT, lsm: dict | None = None,
        **kw) -> dict:
    from kvbench.harness import run_cell
    return run_cell(root, cell, seed, seconds, trace, device="cpu",
                    overrides=overrides(cell, root=root, lsm=lsm), **kw)
