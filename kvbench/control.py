"""The control: the plain reference put in the program's place with one
of the configuration's guarantees broken, run through a whole cell, to
show that the comparison which decides `correct` fails it.

    python3 kvbench/control.py --workload <cell> --seed <n> --seconds <s>

prints the run's result line; `correct` must come out false.  The
benchmark's own runs never run it.

`ForgetSD` is the step that would tempt a later change: serve every
read from the fast device alone.  The store keeps only its newest
fd_size / (key_bytes + value_len) writes, so a record that has sunk to
the slow device is no longer visible: it breaks "every acknowledged put
is visible to every later read".
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


class ForgetSD:
    """A store that forgets every write but its newest `capacity`."""

    def __init__(self, capacity: int):
        from kvbench.reference.store import PlainStore
        self.capacity = capacity
        self.store = PlainStore()

    def put(self, key: int, vlen: int) -> int:
        return int(self.put_many(np.array([key]), vlen)[0])

    def put_many(self, keys, vlen) -> np.ndarray:
        return self.store.put_many(np.asarray(keys, np.int64), int(vlen))

    def flush_all(self) -> None:
        pass

    def multi_get(self, keys) -> list:
        s, v = self.store.multi_get(np.asarray(keys, np.int64))
        kept = s > self.store.seq - self.capacity
        return [(q, n) if k and q else None
                for q, n, k in zip(s.tolist(), v.tolist(), kept.tolist())]

    @classmethod
    def recover(cls, crashed: "ForgetSD") -> "ForgetSD":
        return crashed


def build(config: dict, seed: int, device: str):
    """The control store, `ForgetSD`, at the configuration's FD size."""
    lsm = config["engine"]["lsm"]
    return ForgetSD(int(lsm["fd_size"])
                    // (int(config["key_bytes"]) + int(config["value_len"])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from kvbench.harness import run_cell
    res = run_cell(ROOT, args.workload, args.seed, args.seconds, False,
                   device="cpu", system=build)
    for name, c in res["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
