"""Deterministic data pipeline: synthetic corpus + text-file loader +
sharded batching.

The synthetic corpus is a second-order Markov chain over a Zipf-weighted
vocabulary with long-range "topic" state — it has learnable structure at
multiple ranges, so training-loss comparisons between architectures are
meaningful (a model with better long-context pathways reaches lower loss;
used by the paper-parity benchmark).  Generation is stateless-seeded:
batch ``i`` of epoch ``e`` is reproducible from (seed, e, i) alone, so the
pipeline needs no shuffle buffers and restarts exactly after preemption
(production requirement; paired with checkpointing).

A copy of ``src/repro/data/pipeline.py`` (numpy only): the port imports
nothing of the JAX package, and its batches are bit-equal to JAX's.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data import tokenizer


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 512
    seq_len: int = 256
    batch_size: int = 8
    seed: int = 0
    kind: str = "synthetic"          # synthetic | text
    text_path: str = ""
    n_topics: int = 16
    zipf_a: float = 1.2


class SyntheticCorpus:
    """Markov-chain corpus with topic structure (see module docstring)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, T = cfg.vocab_size, cfg.n_topics
        # Zipf-ish unigram prior per topic
        ranks = np.arange(1, V + 1, dtype=np.float64)
        base = 1.0 / ranks ** cfg.zipf_a
        self.topic_prior = np.stack([
            base[rng.permutation(V)] for _ in range(T)])
        self.topic_prior /= self.topic_prior.sum(-1, keepdims=True)
        # sparse bigram boosts per topic: each token prefers a few followers
        self.follow = rng.integers(0, V, size=(T, V, 4))
        self.topic_stay = 0.995          # long topic persistence

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        V, T = self.cfg.vocab_size, self.cfg.n_topics
        out = np.empty(n, np.int32)
        topic = int(rng.integers(T))
        prev = int(rng.integers(V))
        for i in range(n):
            if rng.random() > self.topic_stay:
                topic = int(rng.integers(T))
            if rng.random() < 0.5:       # bigram continuation
                out[i] = self.follow[topic, prev, int(rng.integers(4))]
            else:                        # topic unigram
                out[i] = rng.choice(V, p=self.topic_prior[topic])
            prev = int(out[i])
        return out


class TextCorpus:
    def __init__(self, cfg: DataConfig):
        with open(cfg.text_path, "r", encoding="utf-8",
                  errors="replace") as f:
            self.ids = tokenizer.encode(f.read())
        if cfg.vocab_size < tokenizer.VOCAB_SIZE:
            raise ValueError("vocab too small for byte tokenizer")

    def window(self, rng: np.random.Generator, n: int) -> np.ndarray:
        start = int(rng.integers(0, max(1, len(self.ids) - n - 1)))
        return self.ids[start:start + n].astype(np.int32)


def batches(cfg: DataConfig, epoch: int = 0,
            steps: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"tokens": (B, L+1)} batches — callers slice input/target."""
    corpus = TextCorpus(cfg) if cfg.kind == "text" else SyntheticCorpus(cfg)
    step = 0
    while steps is None or step < steps:
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + epoch) * 1_000_003 + step)
        rows = []
        for b in range(cfg.batch_size):
            r = np.random.default_rng(rng.integers(2**63))
            if cfg.kind == "text":
                rows.append(corpus.window(r, cfg.seq_len + 1))
            else:
                rows.append(corpus.sample(r, cfg.seq_len + 1))
        yield {"tokens": np.stack(rows)}
        step += 1
