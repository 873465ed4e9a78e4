"""Synthetic LM token stream for transformer-client training and the
end-to-end ~100M example.

A seeded order-1 Markov chain over a Zipf-distributed vocabulary with
sticky "topic" states: non-trivial (learnable) structure so loss curves
actually move, fully procedural so no dataset download is needed.

A copy of ``repro.data.lm_stream`` (numpy only): the same seeds give the
same tokens, so the port and the JAX package train on the same batches.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class LMStreamConfig:
    vocab_size: int = 32768
    num_topics: int = 32
    topic_vocab: int = 2048        # tokens reachable from each topic
    topic_stay_prob: float = 0.98
    zipf_a: float = 1.2
    seed: int = 0


class LMStream:
    """Stateless batch sampler: (tokens, labels) int32 arrays."""

    def __init__(self, cfg: LMStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # per-topic vocabulary subsets + zipf weights over them
        self.topic_tokens = np.stack([
            rng.choice(cfg.vocab_size, size=cfg.topic_vocab, replace=False)
            for _ in range(cfg.num_topics)])
        ranks = np.arange(1, cfg.topic_vocab + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_a)
        self.token_probs = w / w.sum()

    def sample(self, batch: int, seq_len: int, seed: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        topics = rng.integers(0, cfg.num_topics, size=batch)
        toks = np.empty((batch, seq_len + 1), np.int64)
        for t in range(seq_len + 1):
            switch = rng.random(batch) > cfg.topic_stay_prob
            topics = np.where(switch,
                              rng.integers(0, cfg.num_topics, size=batch),
                              topics)
            pick = rng.choice(cfg.topic_vocab, size=batch, p=self.token_probs)
            toks[:, t] = self.topic_tokens[topics, pick]
        return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))

    def batches(self, batch: int, seq_len: int, start_seed: int = 1
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        s = start_seed
        while True:
            yield self.sample(batch, seq_len, s)
            s += 1
