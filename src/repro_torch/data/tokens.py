"""Deterministic LM token pipeline with checkpointable state (the
reference's ``data/tokens.py``, numpy only).

Synthetic but learnable streams: a Markov chain over the vocab (each token
has ``branching`` likely successors, 5% of steps draw a random token), so a
small LM's loss falls measurably within a few hundred steps.

``batch(step)`` is a pure function of (seed, step, shard), drawn in the
reference's order from the same numpy generator, so its batches equal the
reference's bit for bit: any worker can recompute any other's batch, and a
restart resumes at the step its checkpoint records.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 32
    seed: int = 0
    num_shards: int = 1
    shard: int = 0
    branching: int = 4  # Markov branching factor (lower = more learnable)


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        if cfg.global_batch % cfg.num_shards:
            raise ValueError(f"global_batch {cfg.global_batch} does not split into "
                             f"{cfg.num_shards} shards")
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # the fixed Markov table: each token's `branching` likely successors
        self.table = rng.integers(0, cfg.vocab_size,
                                  (cfg.vocab_size, cfg.branching)).astype(np.int32)

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.num_shards

    def batch(self, step: int) -> dict:
        """``{"tokens", "labels"}``, each (local_batch, seq_len) int32, the
        labels the tokens shifted by one."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, step, c.shard))
        b = self.local_batch
        toks = np.zeros((b, c.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, c.vocab_size, b)
        branch = rng.integers(0, c.branching, (b, c.seq_len))
        noise = rng.random((b, c.seq_len)) < 0.05
        rand_tok = rng.integers(0, c.vocab_size, (b, c.seq_len))
        for t in range(c.seq_len):
            nxt = self.table[toks[:, t], branch[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state(self, step: int) -> dict:
        return {"step": step, "seed": self.cfg.seed, "num_shards": self.cfg.num_shards}

    def iterate(self, start_step: int) -> Iterator[tuple[int, dict]]:
        step = start_step
        while True:
            yield step, self.batch(step)
            step += 1
