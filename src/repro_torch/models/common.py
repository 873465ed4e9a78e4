"""Shared model machinery: spec stacking and the model base class.

The port of the serving half of ``repro.models.common``; the chunked
cross-entropy and the dry-run input specs belong to training and the
HLO accounting (``ROADMAP.md`` queue 1, items 6.3 and 6.7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import param as P


def stack_specs(specs, n: int):
    """Prepend a stacked ('layers', n) axis to every leaf spec."""
    if isinstance(specs, dict):
        return {k: stack_specs(v, n) for k, v in specs.items()}
    return dataclasses.replace(specs, shape=(n,) + specs.shape,
                               axes=("layers",) + specs.axes)


def take_layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: take_layer(v, i) for k, v in tree.items()}
    return tree[i]


class LMBase:
    """Interface every model family implements."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ---- parameters ----
    def param_specs(self) -> Dict[str, Any]:
        raise NotImplementedError

    def init(self, gen: torch.Generator, device: DeviceLike = None):
        """Parameters drawn from ``gen`` (on its own device), placed on
        ``device`` (default: the GPU)."""
        return P.materialize(self.param_specs(), gen,
                             device=resolve_device(device))

    # ---- serving ----
    def prefill(self, params, batch):
        """Returns the last-token logits (B, 1, V) — used by serve
        drivers."""
        raise NotImplementedError

    def decode_step(self, params, cache, batch):
        """batch: {'token': (B,1), 'pos': (B,)}.  Returns (logits, cache)."""
        raise NotImplementedError

    def cache_specs(self, batch: int, max_len: int):
        raise NotImplementedError
