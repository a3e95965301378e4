"""A plain key-value store: key -> newest (seq, vlen), with every write
logged, and the durability rule of a group-committed, partitioned WAL.

It imports nothing of the program and takes nothing the program made:
it is handed the load order and the rounds the benchmark generated, and
works out every seq itself (one per write, in order, from 1).
"""
from __future__ import annotations

import numpy as np

_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


class PlainStore:
    """Every acknowledged write is visible to every later read."""

    def __init__(self):
        self.seq = 0
        self.seqs = np.zeros(1 << 16, dtype=np.int64)   # by key; 0: none
        self.vlens = np.zeros(1 << 16, dtype=np.int64)
        self._log: list[tuple[np.ndarray, np.ndarray, int]] = []

    def _room(self, top: int) -> None:
        if top >= len(self.seqs):
            n = max(top + 1, 2 * len(self.seqs))
            self.seqs = np.concatenate(
                [self.seqs, np.zeros(n - len(self.seqs), np.int64)])
            self.vlens = np.concatenate(
                [self.vlens, np.zeros(n - len(self.vlens), np.int64)])

    def put_many(self, keys: np.ndarray, vlen: int) -> np.ndarray:
        """Apply writes in order; returns their seqs."""
        keys = np.asarray(keys, dtype=np.int64)
        acks = np.arange(self.seq + 1, self.seq + 1 + len(keys),
                         dtype=np.int64)
        self.seq += len(keys)
        if len(keys):
            self._room(int(keys.max()))
            # the last write of a key repeated in the batch wins
            uk, first_rev = np.unique(keys[::-1], return_index=True)
            last = len(keys) - 1 - first_rev
            self.seqs[uk] = acks[last]
            self.vlens[uk] = vlen
            self._log.append((keys, acks, int(vlen)))
        return acks

    def multi_get(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(seq, vlen) of each key's newest write; (0, 0) if none."""
        keys = np.asarray(keys, dtype=np.int64)
        inside = keys < len(self.seqs)
        s = np.zeros(len(keys), np.int64)
        v = np.zeros(len(keys), np.int64)
        s[inside] = self.seqs[keys[inside]]
        v[inside] = self.vlens[keys[inside]]
        return s, v

    def write_log(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keys, seqs, vlens) of every write, in seq order."""
        if not self._log:
            return (np.zeros(0, np.int64),) * 3
        return (np.concatenate([k for k, _, _ in self._log]),
                np.concatenate([s for _, s, _ in self._log]),
                np.concatenate([np.full(len(k), v, np.int64)
                                for k, _, v in self._log]))


def shard_of(keys: np.ndarray, durability: dict) -> np.ndarray:
    """The shard each key lives on under the configuration's stated
    partitioning: "hash" routes by the high 32 bits of the key times
    0x9E3779B97F4A7C15 (mod 2**64), modulo the shard count."""
    n = int(durability["n_shards"])
    if durability["partitioning"] != "hash":
        raise ValueError("the reference knows hash partitioning only")
    h = (np.asarray(keys, dtype=np.int64).astype(np.uint64) * _HASH_MULT) \
        >> np.uint64(32)
    return (h % np.uint64(n)).astype(np.int64)


def readback_mismatches(store: PlainStore, keys: np.ndarray,
                        got_seq: np.ndarray, got_vlen: np.ndarray,
                        durability: dict | None) -> int:
    """How many of `keys` read back other than the guarantees allow.

    Without durability every key must read its newest write.  After a
    crash and recovery of a group-committed WAL, each shard keeps a
    prefix of its writes, in seq order, that leaves out at most
    `group_commit_records - 1` of its newest: so a key reads the newest
    of its writes at or below its shard's cut, and one cut per shard
    must explain every key of the shard.  The count is the least number
    of keys that any admissible cuts leave unexplained."""
    keys = np.asarray(keys, dtype=np.int64)
    want_s, want_v = store.multi_get(keys)
    bad = (got_seq != want_s) | (got_vlen != want_v)
    if durability is None:
        return int(bad.sum())
    lost_max = int(durability["group_commit_records"]) - 1
    wk, ws, wv = store.write_log()
    w_shard = shard_of(wk, durability)
    k_shard = shard_of(keys, durability)
    total = 0
    for sh in range(int(durability["n_shards"])):
        mine = k_shard == sh
        seqs_sh = ws[w_shard == sh]
        keys_sh = wk[w_shard == sh]
        cut0 = max(len(seqs_sh) - lost_max, 0)
        tail_seqs = seqs_sh[cut0:]
        tail_keys = set(keys_sh[cut0:].tolist())
        # keys with no write in the tail read their newest write under
        # every admissible cut
        in_tail = np.isin(keys, list(tail_keys)) & mine
        total += int((bad & mine & ~in_tail).sum())
        if not in_tail.any():
            continue
        hist = {k: list(zip(ws[wk == k].tolist(), wv[wk == k].tolist()))
                for k in set(keys[in_tail].tolist())}
        cuts = [int(tail_seqs[0]) - 1] + [int(q) for q in tail_seqs]
        best = None
        for cut in cuts:
            miss = 0
            for i in np.flatnonzero(in_tail).tolist():
                k = int(keys[i])
                live = [w for w in hist[k] if w[0] <= cut]
                want = live[-1] if live else (0, 0)
                miss += (int(got_seq[i]), int(got_vlen[i])) != want
            best = miss if best is None else min(best, miss)
        total += best
    return total
