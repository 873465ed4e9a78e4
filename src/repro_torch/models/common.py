"""Shared model machinery: spec stacking, chunked cross-entropy, base
class.

The port of ``repro.models.common``; the dry-run input specs belong to
the HLO accounting (``ROADMAP.md`` queue 1, item 6.7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

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


def unstack(tree):
    """Every layer of a stacked tree, as a list of trees of views.  One
    ``unbind`` a leaf: autograd stacks the layers' gradients once, where
    indexing each layer would add a full-size zero-padded gradient a
    layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def spec_zeros(specs, device):
    """Zeros of a tree (dicts and tuples) of specs on ``device``: a
    model's empty decode cache."""
    if isinstance(specs, dict):
        return {k: spec_zeros(v, device) for k, v in specs.items()}
    if isinstance(specs, tuple):
        return tuple(spec_zeros(v, device) for v in specs)
    return torch.zeros(specs.shape, dtype=getattr(torch, specs.dtype),
                       device=device)


def maybe_checkpoint(on: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward pass when ``on`` and
    autograd is recording (``jax.checkpoint``'s counterpart: the values
    and gradients are the same either way)."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _xent_piece(xi, table, li, mi):
    logits = torch.einsum("bcd,vd->bcv", xi.float(), table.float())
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, li[..., None].long())[..., 0]
    return torch.sum((logz - ll) * mi), torch.sum(mi)


def chunked_softmax_xent(x, table, labels, mask=None, chunk: int = 512):
    """Next-token CE without materializing (B, S, V) fp32 logits.

    Per-sequence-chunk fp32 logits of the fp32 table, each chunk
    recomputed in the backward pass: peak logits memory is one chunk's.
    x: (B,S,D) final hidden; table: (V,D); labels (B,S) int; mask (B,S)
    or None.  JAX's ``lax.scan`` over chunks is a Python loop that adds
    in the same order."""
    b, s, d = x.shape
    if s % chunk or s <= chunk:
        chunk = s
    nll = cnt = 0.0
    for c0 in range(0, s, chunk):
        li = labels[:, c0:c0 + chunk]
        mi = (torch.ones(li.shape, dtype=torch.float32, device=x.device)
              if mask is None else mask[:, c0:c0 + chunk].float())
        a, c = maybe_checkpoint(True, _xent_piece, x[:, c0:c0 + chunk],
                                table, li, mi)
        nll, cnt = nll + a, cnt + c
    return nll / torch.clamp(cnt, min=1.0)


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

    # ---- training ----
    def loss(self, params, batch):
        """(loss, {"ce", "aux"}) of a {"tokens", "labels"} batch;
        differentiable in ``params``."""
        raise NotImplementedError

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
