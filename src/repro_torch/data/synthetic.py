"""Deterministic synthetic LM data pipeline: seeded, step-indexed, sharded.

Stateless by construction - batch ``i`` is a pure function of (seed, i) - so
a restarted job resumes mid-epoch exactly (fault tolerance requirement),
and each data shard draws only its slice (no host reads the global batch).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-chain-ish structure so the tiny-train example has learnable
    # signal (pure uniform noise has no decreasing loss)
    structure: float = 0.8


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # a fixed random transition table: next-token = f(prev) w.p.
        # `structure`, else uniform
        self._next = rng.integers(0, cfg.vocab_size,
                                  size=cfg.vocab_size).astype(np.int32)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        """Batch for `step`, restricted to this host's shard rows."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        rows = cfg.global_batch // num_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + shard)
        toks = np.empty((rows, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=rows)
        flip = rng.random((rows, cfg.seq_len)) < cfg.structure
        rand = rng.integers(0, cfg.vocab_size, size=(rows, cfg.seq_len))
        for t in range(cfg.seq_len):
            toks[:, t + 1] = np.where(flip[:, t], self._next[toks[:, t]],
                                      rand[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterate(self, start_step: int = 0, shard: int = 0,
                num_shards: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, shard, num_shards)
            step += 1
