"""Seeds in place of JAX's PRNG keys.

A "seed" here is a non-negative Python int.  ``split_seed`` and
``fold_in`` derive independent child seeds through numpy's
``SeedSequence`` hashing (the roles of ``jax.random.split`` and
``jax.random.fold_in``); ``generator`` turns a seed into the explicit CPU
``torch.Generator`` every draw of the port goes through.  The streams
differ from JAX's threefry streams, so parity tests inject the
reference's draws instead of reproducing them.
"""
from __future__ import annotations

import numpy as np
import torch


def split_seed(seed: int, n: int) -> np.ndarray:
    """``n`` child seeds of ``seed``, (n,) int64 in [0, 2**63)."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return (state >> np.uint64(1)).astype(np.int64)


def fold_in(seed: int, data: int) -> int:
    """One child seed of ``seed`` addressed by ``data``."""
    state = np.random.SeedSequence([int(seed), int(data)]) \
        .generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))
