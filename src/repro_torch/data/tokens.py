"""Token data pipeline for LM training (port of `repro.data.tokens`; numpy
only, so its batches are bit-equal to the reference's for the same seed
and step).

The corpus is an order-2 Markov chain over the vocabulary with Zipf-ish
marginals, generated on the fly with zero disk footprint.  `Batcher`
yields host-side numpy batches; the trainer moves them to its device (a
rank of a consensus mode takes its rows of the global batch).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class MarkovCorpus:
    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 8):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        self.branch = branch
        # each (prev token) maps to `branch` likely successors
        self.succ = rng.integers(0, vocab_size, size=(vocab_size, branch))
        self.probs = rng.dirichlet(np.ones(branch) * 0.5, size=vocab_size)

    def sample(self, rng: np.random.Generator, batch: int, seq: int):
        out = np.empty((batch, seq), np.int32)
        cur = rng.integers(0, self.vocab, size=batch)
        out[:, 0] = cur
        for t in range(1, seq):
            choice = np.array([
                rng.choice(self.branch, p=self.probs[c]) for c in cur])
            cur = self.succ[cur, choice]
            # occasional resets keep the chain mixing
            reset = rng.random(batch) < 0.02
            cur = np.where(reset, rng.integers(0, self.vocab, batch), cur)
            out[:, t] = cur
        return out


class Batcher:
    """Deterministic, restartable batch stream: batch `step` is drawn from
    `np.random.default_rng((seed, step))`."""

    def __init__(self, vocab_size: int, batch: int, seq: int, *,
                 seed: int = 0, frontend_len: int = 0, d_model: int = 0):
        self.corpus = MarkovCorpus(vocab_size, seed)
        self.batch, self.seq = batch, seq
        self.frontend_len, self.d_model = frontend_len, d_model
        self.seed = seed
        self.step = 0

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        out = {"tokens": self.corpus.sample(rng, self.batch, self.seq)}
        if self.frontend_len > 0:
            out["frontend"] = rng.standard_normal(
                (self.batch, self.frontend_len, self.d_model)).astype(
                    np.float32)
        return out
