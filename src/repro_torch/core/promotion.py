"""Promotion caches (paper §3.1, §3.3, §3.4).

Host dicts, as in `repro.core.promotion`.

The *mutable promotion cache* (mPC) is an in-memory map absorbing
records read from SD.  It sits between the last FD level and the first
SD level in the read path.  When it reaches the SSTable target size it
is frozen into an *immutable promotion cache* (immPC) together with a
pinned ``Superversion`` (core/version.py: the published Version plus
the immutable memtables at freeze time); a background Checker later
consults RALT, filters out records with newer versions (frozen-snapshot
search + the `updated`-field protocol of Fig. 5), and bulk-flushes the
hot survivors to L0.  The Superversion reference is what makes the
Checker's step-8 search sound: compactions installed after the freeze
publish *new* Versions and never mutate the pinned one.
"""
from __future__ import annotations

import dataclasses
import itertools

from .version import Superversion

_immpc_ids = itertools.count()


class MutablePromotionCache:
    """key -> (seq, vlen).  In memory; lookups are free of device I/O."""

    def __init__(self):
        self.data: dict[int, tuple[int, int]] = {}
        self.bytes = 0

    def __len__(self):
        return len(self.data)

    def __contains__(self, key: int) -> bool:
        return key in self.data

    def get(self, key: int):
        return self.data.get(key)

    def insert(self, key: int, seq: int, vlen: int, key_bytes: int) -> None:
        prev = self.data.get(key)
        if prev is not None:
            if prev[0] >= seq:
                return
            self.bytes -= key_bytes + prev[1]
        self.data[key] = (seq, vlen)
        self.bytes += key_bytes + vlen

    def extract_range(self, lo: int, hi: int, key_bytes: int
                      ) -> list[tuple[int, int, int]]:
        """Remove and return [(key, seq, vlen)] with lo <= key <= hi."""
        out = [(k, sv[0], sv[1]) for k, sv in self.data.items()
               if lo <= k <= hi]
        for k, s, v in out:
            del self.data[k]
            self.bytes -= key_bytes + v
        out.sort()
        return out


@dataclasses.dataclass
class ImmutablePromotionCache:
    """Frozen record list + the Fig. 5 concurrency-control state.

    ``sv`` pins the Superversion captured under the (simulated) DB mutex
    at freeze time; the Checker searches only it and releases the pin
    when done."""
    records: list[tuple[int, int, int]]          # (key, seq, vlen) sorted
    sv: Superversion                             # pinned frozen read view
    updated: set[int] = dataclasses.field(default_factory=set)
    iid: int = dataclasses.field(default_factory=lambda: next(_immpc_ids))
    key_set: frozenset = None

    def __post_init__(self):
        if self.key_set is None:
            self.key_set = frozenset(k for k, _, _ in self.records)
