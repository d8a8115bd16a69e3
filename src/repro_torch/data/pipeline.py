"""Deterministic, shardable token pipeline: ``repro.data.pipeline``,
copied (the port imports nothing of the reference; the module is
numpy only, so batches are bit-equal to the reference's).

Synthetic corpus (no external data ships with the repo): a seeded
mixture of Zipf-distributed token draws with injected repeated n-grams
so language-model losses actually decrease during the example training
runs.  Determinism is per (seed, step, host): any host can regenerate
any step's shard -- which is what makes the fault-tolerance loop's
restore-and-replay exact, and what lets elastic re-sharding change the
host count without disturbing the global batch sequence.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    ngram_repeat: int = 8     # repeat period that makes loss learnable

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The full GLOBAL batch for a step (host-sliced by caller or
        via host_batch_at)."""
        rng = np.random.default_rng((self.seed, step))
        B, S = self.global_batch, self.seq_len
        raw = rng.zipf(1.35, size=(B, S + 1)).astype(np.int64)
        tokens = (raw * 2654435761 % (self.vocab_size - 1) + 1).astype(np.int32)
        # inject periodic structure: token[t] depends on token[t-k]
        k = self.ngram_repeat
        tokens[:, k:] = np.where(rng.uniform(size=(B, S + 1 - k)) < 0.5,
                                 tokens[:, :-k], tokens[:, k:])
        return {"tokens": tokens[:, :S],
                "labels": tokens[:, 1:S + 1]}

    def host_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        g = self.batch_at(step)
        per = self.global_batch // self.n_hosts
        sl = slice(self.host_id * per, (self.host_id + 1) * per)
        return {k: v[sl] for k, v in g.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.host_batch_at(step)
            step += 1
