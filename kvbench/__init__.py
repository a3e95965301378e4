"""The benchmark of the PyTorch port's HotRAP engine (`repro_torch.core`).

`python3 kvbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the root `BENCHMARK.json` once and
prints its result as the last line of standard output.  Configurations
(`configs/`), traffic mixes (`traffic/`) and per-layer metric readers
(`metrics/`) are found by the names that `BENCHMARK.json` gives them.
"""
