"""Deterministic, stateless-resumable, shard-aware synthetic token pipeline
(a verbatim copy of the JAX package's ``data/pipeline.py``: numpy only, so
``batch_at(step)`` gives the same bytes in both packages).

Every batch is a pure function of (seed, step, shard) — there is no iterator
state to checkpoint or lose: after a restart (even with a different DP width)
``batch_at(step)`` reproduces exactly the batch the failed run would have
seen. That property is what makes the elastic-restart story in
``checkpoint/manager.py`` complete.

The synthetic stream is a mixture of Zipf-distributed unigrams and short
Markov-ish repeats, so a ~100M model shows a real, declining loss curve
(structure to learn) rather than flat noise.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    repeat_prob: float = 0.35
    repeat_span: int = 16


class TokenPipeline:
    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        # fixed zipf table (top of the vocab reserved for specials)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()

    def batch_at(self, step: int) -> np.ndarray:
        """(local_batch, seq_len + 1) int32 tokens for this step and shard."""
        cfg = self.cfg
        out = np.empty((self.local_batch, cfg.seq_len + 1), dtype=np.int32)
        for i in range(self.local_batch):
            row_id = step * cfg.global_batch + self.shard * self.local_batch + i
            rng = np.random.default_rng((cfg.seed << 32) ^ row_id)
            seq = rng.choice(cfg.vocab, size=cfg.seq_len + 1, p=self._probs)
            # inject learnable structure: copy short spans backwards
            n_rep = rng.binomial(max(cfg.seq_len // cfg.repeat_span, 1), cfg.repeat_prob)
            for _ in range(n_rep):
                span = int(rng.integers(4, cfg.repeat_span))
                if cfg.seq_len + 1 < 2 * span + 1:
                    continue
                src = int(rng.integers(0, cfg.seq_len + 1 - 2 * span))
                dst = src + span + int(rng.integers(0, span))
                dst = min(dst, cfg.seq_len + 1 - span)
                seq[dst : dst + span] = seq[src : src + span]
            out[i] = seq
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
