"""SSTable: an immutable sorted run held as tensors on the engine's device.

The port of `repro.core.sstable`.  A record's logical ("HotRAP") size is
key_size + value_len; values are simulated by their `seq` (global
sequence number), which doubles as the version payload.  Data is
organised into simulated 16 KiB blocks; a per-SSTable bloom filter (10
bits/key, k=7) avoids touching SSTables that cannot contain the key.

Where the port differs from the numpy reference:

* keys are int64 (YCSB keys are dense indices; the largest key is
  2**63 - 1, `core/scan.py:MAX_KEY`), since CUDA has few uint64 ops;
* the bloom hash multipliers are the reference's uint64 constants as
  two's-complement int64: the product wraps to the same 64 bits, and the
  logical ``>> 33`` is ``(h >> 33) & (2**31 - 1)``;
* the bloom bits are a bool tensor with one element per bit, built by
  storing True at every hashed index (each store writes the same value,
  so their order does not matter); `nbytes` reports the reference's
  ``ceil(nbits / 64) * 8`` bytes;
* `n`, `min_key`, `max_key`, `size_bytes` and `n_blocks` are Python ints
  computed once at construction (one device-to-host copy per table), so
  level bisects and compaction planning never touch device memory.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

KEY_BYTES = 24          # paper: ~24 B keys
BLOCK_BYTES = 16 * 1024  # paper: 16 KiB blocks (Meta practice)

_sstable_ids = itertools.count()

TOMBSTONE_VLEN = 0xFFFFFFFF

# 64-bit odd multipliers (splitmix-style) for k independent hashes, as
# in `repro.core.sstable.BloomFilter._MULTS`
MULTS_U64 = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB,
             0xD6E8FEB86659FD93, 0xA5A5A5A5A5A5A5A5 | 1, 0xC2B2AE3D27D4EB4F,
             0x165667B19E3779F9, 0x27D4EB2F165667C5)
_MASK64 = (1 << 64) - 1
_LOW31 = (1 << 31) - 1


def as_int64(m: int) -> int:
    """The two's-complement int64 with the same 64 bits as uint64 `m`."""
    return m - (1 << 64) if m >= 1 << 63 else m


MULTS = tuple(as_int64(m) for m in MULTS_U64)
_MULT_TENSORS: dict = {}


def _mults(k: int, device: torch.device) -> torch.Tensor:
    t = _MULT_TENSORS.get(device)
    if t is None:
        t = _MULT_TENSORS[device] = torch.tensor(MULTS, dtype=torch.int64,
                                                 device=device)
    return t[:k]


def lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """`np.lexsort(keys)` on tensors: the permutation that sorts by the
    last key, ties by the one before, ..., ties of all keys by position.
    Stable sorts, the least significant key first."""
    n = len(keys[0])
    order = torch.arange(n, device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


class BloomFilter:
    """Multiply-shift bloom filter over int64 keys, bit for bit the
    reference's over the same keys (false positives included)."""

    def __init__(self, keys: torch.Tensor, bits_per_key: int = 10):
        n = max(len(keys), 1)
        self.k = max(1, min(8, int(round(bits_per_key * 0.69))))
        self.nbits = max(64, n * bits_per_key)
        self.bits = torch.zeros(self.nbits, dtype=torch.bool,
                                device=keys.device)
        if len(keys):
            self.bits[self._index(keys)] = True

    def _index(self, keys: torch.Tensor) -> torch.Tensor:
        """(len(keys), k) bit indices."""
        h = keys.reshape(-1, 1) * _mults(self.k, keys.device)
        return ((h >> 33) & _LOW31) % self.nbits

    def may_contain(self, key: int) -> bool:
        idx = [(((int(key) * m) & _MASK64) >> 33) % self.nbits
               for m in MULTS_U64[: self.k]]
        return bool(self.bits[idx].all())

    def may_contain_many(self, keys: torch.Tensor) -> torch.Tensor:
        """Bool tensor on the keys' device."""
        if len(keys) == 0:
            return torch.zeros(0, dtype=torch.bool, device=keys.device)
        return self.bits[self._index(keys)].all(dim=1)

    @property
    def nbytes(self) -> int:
        return (self.nbits + 63) // 64 * 8


def record_sizes(vlens: torch.Tensor) -> torch.Tensor:
    """HotRAP size of each record (tombstones carry 0 value bytes)."""
    return torch.where(vlens == TOMBSTONE_VLEN, 0, vlens) + KEY_BYTES


class SSTable:
    """Immutable sorted run.  `tier` is "FD" or "SD"."""

    __slots__ = ("sid", "keys", "seqs", "vlens", "tier", "level",
                 "bloom", "record_bytes", "block_of", "n_blocks",
                 "created_at", "being_compacted", "compacted", "n",
                 "min_key", "max_key", "size_bytes")

    def __init__(self, keys: torch.Tensor, seqs: torch.Tensor,
                 vlens: torch.Tensor, tier: str, level: int,
                 created_at: int, bits_per_key: int = 10,
                 meta: tuple[int, int, int, int] | None = None):
        """`keys`, `seqs`, `vlens`: int64 tensors on one device.  `meta`
        is (min_key, max_key, size_bytes, n_blocks) when the caller
        already holds them on the host (`split_into_sstables`)."""
        assert len(keys) == len(seqs) == len(vlens)
        self.sid = next(_sstable_ids)
        self.keys = keys.contiguous()
        self.seqs = seqs.contiguous()
        self.vlens = vlens.contiguous()
        self.tier = tier
        self.level = level
        self.created_at = created_at
        self.n = len(keys)
        sizes = record_sizes(self.vlens)
        self.record_bytes = sizes
        # Block assignment: records packed into 16 KiB blocks by byte offset.
        cum = torch.cumsum(sizes, 0)
        self.block_of = (cum - sizes) // BLOCK_BYTES
        if not self.n:
            meta = (None, None, 0, -1)
        elif meta is None:
            meta = tuple(torch.stack([self.keys[0], self.keys[-1], cum[-1],
                                      self.block_of[-1]]).tolist())
            meta = meta[:3] + (meta[3] + 1,)
        self.min_key, self.max_key, self.size_bytes, self.n_blocks = meta
        self.n_blocks = max(self.n_blocks, 0)
        self.bloom = BloomFilter(self.keys, bits_per_key)
        self.being_compacted = False
        self.compacted = False

    # ------------------------------------------------------------------
    def overlaps(self, lo: int, hi: int) -> bool:
        return not (self.max_key < lo or self.min_key > hi)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.keys, self.seqs, self.vlens, self.record_bytes,
                self.block_of, self.bloom.bits)

    # -- sanctioned mutation ------------------------------------------
    # `tier`/`level`/`being_compacted`/`compacted` are *placement and
    # lifecycle bookkeeping*, not data: the record arrays, fences and
    # bloom stay frozen for the SSTable's whole life.  All writes to
    # them go through the methods below so the immutability lint
    # (tools/check) can flag any other attribute store on an SSTable.

    def retarget(self, tier: str | None = None,
                 level: int | None = None) -> None:
        """Re-place the table (compaction install)."""
        if tier is not None:
            self.tier = tier
        if level is not None:
            self.level = level

    def mark_compacting(self) -> None:
        """Flag the table as a live compaction input (§3.3: promotions
        into a table being compacted must abort at install)."""
        self.being_compacted = True

    def finish_compaction(self) -> None:
        """The table's records have been rewritten elsewhere; it is no
        longer a valid promotion target."""
        self.being_compacted = False
        self.compacted = True

    def recover_placement(self, tier: str, level: int) -> None:
        """Crash recovery (core/wal.py): the recovered manifest's
        Version is the placement truth — re-target the table and clear
        compaction bookkeeping a crash may have left half-advanced (a
        live recovered table is by definition not mid-compaction).
        Host attributes only: a recovered table shares its tensors with
        the crashed engine's."""
        self.retarget(tier=tier, level=level)
        self.being_compacted = False
        self.compacted = False

    def find(self, key: int) -> tuple[int, int, int] | None:
        """Returns (seq, vlen, block_idx) or None. No I/O charged here."""
        if not self.n:
            return None
        i = torch.searchsorted(self.keys, int(key))
        ic = i.clamp(max=self.n - 1)
        i, k, seq, vlen, blk = torch.stack(
            [i, self.keys[ic], self.seqs[ic], self.vlens[ic],
             self.block_of[ic]]).tolist()
        if i < self.n and k == key:
            return seq, vlen, blk
        return None

    def probe_many(self, keys: np.ndarray) -> np.ndarray:
        """Probe the table for every key of a host int64 array, in one
        device-to-host copy: a (5, len(keys)) host array of rows (bloom
        says maybe, found, seq, vlen, block of the insertion point)."""
        kd = torch.from_numpy(keys).to(self.keys.device)
        pos = torch.searchsorted(self.keys, kd)
        posc = pos.clamp(max=self.n - 1)
        found = (pos < self.n) & (self.keys[posc] == kd)
        return torch.stack([self.bloom.may_contain_many(kd).long(),
                            found.long(), self.seqs[posc], self.vlens[posc],
                            self.block_of[posc]]).cpu().numpy()

    def miss_block(self, key: int) -> int:
        """The data block a probe of an absent `key` reads after a bloom
        false positive (the block its insertion point falls in)."""
        if not self.n:
            return 0
        i = torch.searchsorted(self.keys, int(key)).clamp(max=self.n - 1)
        return int(self.block_of[i])

    def range_bounds(self, lo: int, hi: int) -> tuple[int, int]:
        """Record index range [a, b) covering keys in [lo, hi]."""
        return bounds(self.keys, lo, hi)

    # record chunk converted per block_iter step: large enough to keep the
    # device->host copies few, small enough that limit-bounded scans
    # never copy a whole SSTable tail they won't consume
    _ITER_CHUNK = 512

    def block_iter(self, lo: int, hi: int):
        """Cursor over records with lo <= key <= hi, in key order.

        Yields (key, seq, vlen, block_idx) lazily (in _ITER_CHUNK record
        chunks, one device-to-host copy each).  No I/O is charged here:
        the block_idx stream lets the caller charge each data block
        exactly once as the cursor walks into it (see core/scan.py).
        """
        a, b = self.range_bounds(lo, hi)
        for start in range(a, b, self._ITER_CHUNK):
            end = min(start + self._ITER_CHUNK, b)
            yield from zip(*torch.stack(
                [self.keys[start:end], self.seqs[start:end],
                 self.vlens[start:end],
                 self.block_of[start:end]]).tolist())


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind `tensors` (views of one
    storage count once)."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def bounds(keys: torch.Tensor, lo: int, hi: int) -> tuple[int, int]:
    """[a, b): the positions of sorted `keys` within [lo, hi], in one
    device-to-host copy."""
    if not len(keys):
        return 0, 0
    a = torch.searchsorted(keys, int(lo))
    b = torch.searchsorted(keys, int(hi), right=True)
    return tuple(torch.stack([a, b]).tolist())


def merge_runs(runs: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
               drop_tombstones: bool = False, device=None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k-way merge of (keys, seqs, vlens) runs, newest-seq wins per key.

    Concatenate + lexsort by (key, -seq), keep the first occurrence of
    each key.
    """
    if not runs:
        e = torch.zeros(0, dtype=torch.int64, device=device)
        return e, e.clone(), e.clone()
    keys = torch.cat([r[0] for r in runs])
    seqs = torch.cat([r[1] for r in runs])
    vlens = torch.cat([r[2] for r in runs])
    order = lexsort([-seqs, keys])
    keys, seqs, vlens = keys[order], seqs[order], vlens[order]
    keep = torch.ones(len(keys), dtype=torch.bool, device=keys.device)
    keep[1:] = keys[1:] != keys[:-1]
    if drop_tombstones:
        keep &= vlens != TOMBSTONE_VLEN
    return keys[keep], seqs[keep], vlens[keep]


def split_into_sstables(keys: torch.Tensor, seqs: torch.Tensor,
                        vlens: torch.Tensor, tier: str, level: int,
                        created_at: int, target_bytes: int) -> list[SSTable]:
    """Splits a merged run into SSTables of ~target_bytes each.

    The cut points follow the reference's loop over the byte prefix sum,
    run on a host copy of it; each table's (min_key, max_key, size_bytes,
    n_blocks) comes from the same copy and one gather of the boundary
    keys, so the split costs two device-to-host copies in all."""
    n = len(keys)
    if n == 0:
        return []
    cum = torch.cumsum(record_sizes(vlens), 0).cpu().numpy()
    sizes = np.diff(cum, prepend=0)
    cuts = []
    start = 0
    while start < n:
        # last index with cum - cum_start <= target
        base = int(cum[start] - sizes[start])
        end = int(np.searchsorted(cum, base + target_bytes)) + 1
        end = min(max(end, start + 1), n)
        cuts.append((start, end, base))
        start = end
    ends = torch.tensor([e - 1 for _, e, _ in cuts], device=keys.device)
    firsts = torch.tensor([s for s, _, _ in cuts], device=keys.device)
    mins, maxs = torch.stack([keys[firsts], keys[ends]]).tolist()
    out = []
    for j, (s, e, base) in enumerate(cuts):
        size = int(cum[e - 1]) - base
        last_block = (size - int(sizes[e - 1])) // BLOCK_BYTES
        out.append(SSTable(keys[s:e], seqs[s:e], vlens[s:e], tier, level,
                           created_at,
                           meta=(mins[j], maxs[j], size, last_block + 1)))
    return out
