"""Deterministic synthetic LM token pipeline (port of `repro.data.tokens`).

Batches are a pure function of (seed, step): after a crash and a restore at
step k the pipeline makes exactly the batches k, k + 1, ... again, with no
state to checkpoint.  Tokens follow a Markov bigram sampler with low-rank
structure, so the loss has something to learn.  The sampler is the
reference's numpy code, so its tokens equal the reference's bit for bit.

The transition table is dense, (vocab, vocab) float32, and so is its
cumulative sum: at a vocabulary of 151,936 each would be 92 GB.  A model
of a large vocabulary trains on a pipeline of a smaller ``vocab`` (its
token ids are valid ids of the model's).  A batch walks its sequence one
position at a time on the host, so a caller on the card builds it on a
thread ahead of its step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticTokenPipeline"]


@dataclasses.dataclass
class SyntheticTokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bigram_rank: int = 8  # low-rank bigram structure: a learnable signal

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        u = rng.normal(size=(self.vocab, self.bigram_rank)).astype(np.float32)
        v = rng.normal(size=(self.bigram_rank, self.vocab)).astype(np.float32)
        logits = (u @ v) / np.sqrt(self.bigram_rank)
        z = logits - logits.max(axis=1, keepdims=True)
        p = np.exp(2.0 * z)
        self._trans = (p / p.sum(axis=1, keepdims=True)).astype(np.float32)
        self._cum = np.cumsum(self._trans, axis=1)

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The Markov batch of ``step``: {"tokens", "labels"} (B, S) int32,
        a pure function of (seed, step)."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        b, s = self.global_batch, self.seq_len
        toks = np.empty((b, s), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b)
        u = rng.random(size=(b, s))
        for t in range(1, s):
            c = self._cum[toks[:, t - 1]]
            toks[:, t] = (u[:, t, None] < c).argmax(axis=1)
        return {"tokens": toks, "labels": toks.copy()}

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.host_batch(step)
            step += 1
