"""Deterministic, shardable, resumable LM data pipeline (a numpy-only
copy of `repro/data/lm_pipeline.py`, so the port imports nothing of
`repro`; tokens are bit-identical).

Synthetic-but-learnable token streams: a seeded mixture of Zipf
unigrams and repeated n-gram motifs (so a small model's loss visibly
drops within a few hundred steps — used by examples/train_tiny_lm.py).

Determinism contract (the fault-tolerance substrate relies on it):
`batch_at(step, shard, num_shards)` is a pure function of
(seed, step, shard) — restarting from a checkpoint at step k replays
the identical stream with no data loss or duplication, and elastic
re-sharding (changing num_shards) keeps per-step global batches
identical as long as global_batch % num_shards == 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_motifs: int = 64        # learnable structure
    motif_len: int = 16
    zipf_s: float = 1.2


class LMPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._motifs = rng.integers(
            0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len), dtype=np.int32)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_s
        self._zipf_p = p / p.sum()

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        """-> dict(tokens, labels) of (global_batch/num_shards, seq)."""
        cfg = self.cfg
        if cfg.global_batch % num_shards:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of num_shards {num_shards}")
        rows = cfg.global_batch // num_shards
        # independent stream per (step, global row): resharding-stable
        row0 = shard * rows
        out = np.empty((rows, cfg.seq_len + 1), np.int32)
        for r in range(rows):
            rng = np.random.default_rng(
                (cfg.seed, step, row0 + r))
            seq = rng.choice(cfg.vocab, size=cfg.seq_len + 1,
                             p=self._zipf_p).astype(np.int32)
            # stamp motifs over ~half the sequence: predictable structure
            n_stamp = (cfg.seq_len // cfg.motif_len) // 2
            for _ in range(n_stamp):
                m = rng.integers(0, cfg.n_motifs)
                pos = rng.integers(0, cfg.seq_len + 1 - cfg.motif_len)
                seq[pos:pos + cfg.motif_len] = self._motifs[m]
            out[r] = seq
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
