"""Deterministic synthetic token pipeline for LM training (a copy of the
JAX package's `data/tokens.py`, which is numpy only).

Sequences are sampled from a fixed random bigram chain (vocab-restricted),
so they carry learnable structure — training loss demonstrably decreases.
Batches are a pure function of (seed, step): the iterator state is just the
step counter, which makes checkpoint-resume exact (bitwise) and sharding-
agnostic. This is the property a production loader needs at multi-pod
scale (restore data position from the step id, no host-local cursors).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    active_vocab: int = 256     # bigram chain lives on a vocab subset

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.active_vocab, self.vocab)
        # sparse-ish bigram transition table: each symbol has 8 likely successors
        succ = rng.integers(0, v, size=(v, 8))
        self._succ = succ.astype(np.int64)
        self._v = v

    def batch(self, step: int) -> dict:
        """Pure function of step -> {tokens, targets} [B, S] int32."""
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        seq = np.empty((b, s + 1), dtype=np.int64)
        seq[:, 0] = rng.integers(0, self._v, size=b)
        choices = rng.integers(0, 8, size=(b, s))
        mix = rng.random((b, s)) < 0.1          # 10% uniform noise
        noise = rng.integers(0, self._v, size=(b, s))
        for t in range(s):
            nxt = self._succ[seq[:, t], choices[:, t]]
            seq[:, t + 1] = np.where(mix[:, t], noise[:, t], nxt)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "targets": seq[:, 1:].astype(np.int32)}
