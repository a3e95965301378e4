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
_MULTS_NP = np.array(MULTS_U64, dtype=np.uint64)
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


def bloom_index_host(keys: np.ndarray, k: int, nbits) -> np.ndarray:
    """`BloomFilter._index` on the host: the (len(keys), k) bit indices
    of host int64 `keys`, `nbits` one bit count or one a key (the
    uint64 products wrap as the device's int64 ones do)."""
    h = keys.astype(np.uint64)[:, None] * _MULTS_NP[:k]
    nb = np.asarray(nbits, dtype=np.uint64).reshape(-1, 1)
    return ((h >> np.uint64(33)) % nb).astype(np.int64)


def bloom_k(bits_per_key: int) -> int:
    """Hashes a key of a bloom filter with `bits_per_key` bits a key."""
    return max(1, min(8, int(round(bits_per_key * 0.69))))


def bloom_nbits(n: int, bits_per_key: int) -> int:
    """Bits of the bloom filter over `n` keys."""
    return max(64, max(n, 1) * bits_per_key)


class BloomFilter:
    """Multiply-shift bloom filter over int64 keys, bit for bit the
    reference's over the same keys (false positives included)."""

    def __init__(self, keys: torch.Tensor, bits_per_key: int = 10):
        self.k = bloom_k(bits_per_key)
        self.nbits = bloom_nbits(len(keys), bits_per_key)
        self.bits = torch.zeros(self.nbits, dtype=torch.bool,
                                device=keys.device)
        if len(keys):
            self.bits[self._index(keys)] = True

    @classmethod
    def of_bits(cls, bits: torch.Tensor, n: int,
                bits_per_key: int) -> "BloomFilter":
        """The filter over `n` keys whose bits the caller already set
        (`split_into_sstables`, `sstable_from_host`)."""
        f = cls.__new__(cls)
        f.k = bloom_k(bits_per_key)
        f.nbits = bloom_nbits(n, bits_per_key)
        f.bits = bits
        return f

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
                 meta: tuple[int, int, int, int] | None = None,
                 built: tuple[torch.Tensor, ...] | None = None):
        """`keys`, `seqs`, `vlens`: int64 tensors on one device.  `meta`
        is (min_key, max_key, size_bytes, n_blocks) when the caller
        already holds them on the host, and `built` the table's record
        sizes, blocks and bloom bits when the caller already made them
        on the device (both from `split_into_sstables`)."""
        assert len(keys) == len(seqs) == len(vlens)
        self.sid = next(_sstable_ids)
        self.keys = keys.contiguous()
        self.seqs = seqs.contiguous()
        self.vlens = vlens.contiguous()
        self.tier = tier
        self.level = level
        self.created_at = created_at
        self.n = len(keys)
        if built is None:
            sizes = record_sizes(self.vlens)
            # Block assignment: records packed into 16 KiB blocks by
            # byte offset.
            cum = torch.cumsum(sizes, 0)
            block_of = (cum - sizes) // BLOCK_BYTES
        else:
            sizes, block_of, bits = built
        self.record_bytes = sizes
        self.block_of = block_of
        if not self.n:
            meta = (None, None, 0, -1)
        elif meta is None:
            meta = tuple(torch.stack([self.keys[0], self.keys[-1], cum[-1],
                                      self.block_of[-1]]).tolist())
            meta = meta[:3] + (meta[3] + 1,)
        self.min_key, self.max_key, self.size_bytes, self.n_blocks = meta
        self.n_blocks = max(self.n_blocks, 0)
        self.bloom = (BloomFilter(self.keys, bits_per_key) if built is None
                      else BloomFilter.of_bits(bits, self.n, bits_per_key))
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
        m, bloom = len(keys), self.bloom
        # the keys and their bloom bit indices (hashed on the host) in
        # one copy to the device
        d = torch.from_numpy(np.concatenate(
            [keys, bloom_index_host(keys, bloom.k, bloom.nbits).reshape(-1)])
        ).to(self.keys.device)
        kd = d[:m]
        pos = torch.searchsorted(self.keys, kd)
        posc = pos.clamp(max=self.n - 1)
        found = (pos < self.n) & (self.keys[posc] == kd)
        may = bloom.bits[d[m:].view(m, bloom.k)].all(dim=1)
        return torch.stack([may.long(), found.long(), self.seqs[posc],
                            self.vlens[posc],
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
    rows = torch.stack([torch.cat([r[i] for r in runs]) for i in range(3)])
    rows = rows[:, lexsort([-rows[1], rows[0]])]
    keys = rows[0]
    keep = torch.ones(len(keys), dtype=torch.bool, device=keys.device)
    keep[1:] = keys[1:] != keys[:-1]
    if drop_tombstones:
        keep &= rows[2] != TOMBSTONE_VLEN
    # the three columns in one gather (one copy of the kept count)
    return rows[:, keep].unbind(0)


def sstable_from_host(cols: np.ndarray, tier: str, level: int,
                      created_at: int, bits_per_key: int,
                      device: torch.device) -> SSTable:
    """The SSTable of sorted host records `cols` (n, 3) of (key, seq,
    vlen), built on the host and sent to the device in one copy: its
    record sizes, blocks and bloom bits are the reference's numpy
    arithmetic (the bloom's uint64 products wrap as the device's int64
    ones do), so the table equals the one `SSTable` builds from the
    same records on the device."""
    n = len(cols)
    keys, seqs, vlens = cols.T
    sizes = np.where(vlens == TOMBSTONE_VLEN, 0, vlens) + KEY_BYTES
    cum = np.cumsum(sizes)
    block_of = (cum - sizes) // BLOCK_BYTES
    nbits = bloom_nbits(n, bits_per_key)
    bits = np.zeros(-(-nbits // 8) * 8, dtype=np.bool_)
    bits[bloom_index_host(keys, bloom_k(bits_per_key), nbits)] = True
    rows = np.stack([keys, seqs, vlens, sizes, block_of])
    buf = np.concatenate([rows.reshape(-1).view(np.uint8),
                          bits.view(np.uint8)])
    dev = torch.from_numpy(buf).to(device)
    kd, sd, vd, szd, bd = dev[:40 * n].view(torch.int64).view(5, n)
    return SSTable(kd, sd, vd, tier, level, created_at, bits_per_key,
                   meta=(int(keys[0]), int(keys[-1]), int(cum[-1]),
                         int(block_of[-1]) + 1),
                   built=(szd, bd, dev[40 * n:40 * n + nbits].view(
                       torch.bool)))


def split_into_sstables(keys: torch.Tensor, seqs: torch.Tensor,
                        vlens: torch.Tensor, tier: str, level: int,
                        created_at: int, target_bytes: int,
                        bits_per_key: int = 10) -> list[SSTable]:
    """Splits a merged run into SSTables of ~target_bytes each.

    The cut points follow the reference's loop over the byte prefix sum,
    run on a host copy of it; each table's (min_key, max_key, size_bytes,
    n_blocks) comes from the same copy and one gather of the boundary
    keys, so the split costs two device-to-host copies in all.  Every
    table's record sizes, blocks and bloom bits are views of three
    tensors made for the whole run, in one set of launches: a table's
    blocks count from its own first byte, and its bloom bits, at their
    offset in the run's, from its own bit count."""
    n = len(keys)
    if n == 0:
        return []
    dev = keys.device
    sizes_d = record_sizes(vlens)
    cum_d = torch.cumsum(sizes_d, 0)
    cum = cum_d.cpu().numpy()
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
    firsts, ends, bases = (np.array(c, dtype=np.int64) for c in zip(*cuts))
    lens = ends - firsts
    nbits = np.maximum(64, lens * bits_per_key)
    bit_off = np.cumsum(nbits) - nbits
    per_rec = np.repeat(np.stack([bases, nbits, bit_off]), lens, axis=1)
    host = torch.from_numpy(np.concatenate(
        [per_rec.reshape(-1), firsts, ends - 1])).to(dev)
    base_r, nbits_r, off_r = host[:3 * n].view(3, n)
    block_of = (cum_d - sizes_d - base_r) // BLOCK_BYTES
    k = bloom_k(bits_per_key)
    h = keys.reshape(-1, 1) * _mults(k, dev)
    bits = torch.zeros(int(nbits.sum()), dtype=torch.bool, device=dev)
    bits[((h >> 33) & _LOW31) % nbits_r[:, None] + off_r[:, None]] = True
    mins, maxs = torch.stack([keys[host[3 * n:3 * n + len(cuts)]],
                              keys[host[3 * n + len(cuts):]]]).tolist()
    out = []
    for j, (s, e, base) in enumerate(cuts):
        size = int(cum[e - 1]) - base
        last_block = (size - int(sizes[e - 1])) // BLOCK_BYTES
        off = int(bit_off[j])
        out.append(SSTable(keys[s:e], seqs[s:e], vlens[s:e], tier, level,
                           created_at, bits_per_key,
                           meta=(mins[j], maxs[j], size, last_block + 1),
                           built=(sizes_d[s:e], block_of[s:e],
                                  bits[off:off + int(nbits[j])])))
    return out
