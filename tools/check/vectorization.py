"""Pass 4 — hot-path vectorization.

The per-op cost model only holds if the hot path stays O(numpy-call)
per *batch*, not per key: a Python `for` over per-op or per-key arrays
in the workload driver, the shard router, or the merge-scan assembly
turns the simulated engine into a Python interpreter benchmark.  This
pass maintains an explicit registry of hot functions and flags every
`for` statement inside them.

Loops that are structurally per-*shard*, per-*level*, or per-*tier*
(bounded by topology, not by batch size) are legitimate; they carry a
`# lint: allow-loop (<reason>)` waiver on the loop line or in the
comment block directly above.  `while` loops and comprehensions are not
flagged: the known hot-path offenders are all `for` statements, and
comprehensions over sources/levels are topology-bounded by
construction.
"""
from __future__ import annotations

import ast

from .base import Finding, LintPass, Source

# path suffix -> function names that constitute the hot path there
HOT_FUNCTIONS: dict[str, set[str]] = {
    "core/runner.py": {"run_workload", "_run_segment"},
    "core/shards.py": {"shard_of", "_shard_ids", "get", "put", "delete",
                       "multi_get", "put_many", "scan", "scan_range",
                       "_fold_fanout"},
    "core/scan.py": {"build_sources", "merge_scan", "_merge_two",
                     "_merge_heap", "_view_source"},
    # batched engine read/write paths (ISSUE 8): resolution must stay
    # columnar — only the waived stateful commit/topology loops remain
    "core/lsm.py": {"multi_get", "put_many", "_multi_get_fallback",
                    "_put_many_fallback", "_batch_probe_group",
                    "_batch_view_get", "_batch_walk_levels",
                    "_batch_probe_sst", "_commit_per_key"},
    # the port's columnar Checker (the reference's stays per record):
    # waived loops over the FD levels, L0's tables, the pinned
    # imm-memtables and the reinsertion of under half a table
    "repro_torch/core/lsm.py": {"_checker_body", "_newer_in_snapshot",
                                "_snapshot_probes", "_probe_events"},
    "core/ralt.py": {"record_access_many", "record_range_access"},
    # the columnar multi_get commit: one waived LRU replay loop, the
    # charges in whole columns
    "core/storage.py": {"access_many", "rand_read_many"},
}


class VectorizationPass(LintPass):
    name = "vectorization"
    description = ("no Python for-loops over per-op/per-key data in "
                   "registered hot functions (waive with lint: allow-loop)")

    def __init__(self, hot: dict[str, set[str]] | None = None):
        self.hot = HOT_FUNCTIONS if hot is None else hot

    def run(self, src: Source) -> list[Finding]:
        fnames: set[str] = set()
        for suffix, names in self.hot.items():
            if src.matches(suffix):
                fnames |= names
        if not fnames:
            return []
        findings: list[Finding] = []
        for fn in ast.walk(src.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name not in fnames:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.For):
                    continue
                if src.waived(node.lineno, "loop"):
                    continue
                findings.append(self.finding(
                    src, node,
                    f"Python for-loop in hot function '{fn.name}' — "
                    f"vectorize with numpy, or waive a topology-bounded "
                    f"loop with '# lint: allow-loop (<reason>)'"))
        return findings
