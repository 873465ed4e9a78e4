"""Shared model machinery: spec stacking, chunked cross-entropy, base
class (with the dry run's input specs): the port of
``repro.models.common``.

On a mesh (``ctx``) the cross-entropy is vocab-parallel: the logits stay
sharded on 'vocab', their logsumexp is reduced over that axis, and the
label's logit is picked by a mask, each rank from its own vocab slice
(no gather across a sharded dim).  ``LMBase.init`` on a ``DeviceMesh``
draws each leaf's shard on its own rank, and ``write_layer`` writes a
layer of a sharded decode state in place, each rank its own shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import param as P
from repro_torch.nn.layers import NO_SHARD, ShardCtx, on_mesh_of


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


def write_layer(stack: torch.Tensor, i: int, new: torch.Tensor) -> None:
    """``stack[i] = new``, in place (a layer-stacked decode state).  On a
    mesh each rank writes its own shard: ``new`` is laid out as layer
    ``i`` of ``stack`` (its dim d split as the stack's dim d + 1; the
    rules never split the layer dim), and the local tensors line up."""
    if isinstance(stack, DTensor):
        want = [Shard(p.dim - 1) if isinstance(p, Shard) else Replicate()
                for p in stack.placements]
        new = on_mesh_of(new, stack).redistribute(stack.device_mesh,
                                                  want).to_local()
        stack = stack.to_local()
    stack[i] = new.to(stack.dtype)


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


def _xent_piece(xi, table, li, mi, ctx=NO_SHARD):
    logits = torch.einsum("bcd,vd->bcv", xi.float(), table.float())
    if not isinstance(logits, DTensor):
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, li[..., None].long())[..., 0]
        return torch.sum((logz - ll) * mi), torch.sum(mi)
    # vocab-parallel: each rank reduces its own vocab slice, and DTensor
    # combines the slices over 'model' (max, then sums)
    logits = ctx.constrain(logits, "batch", None, "vocab")
    m = logits.detach().amax(-1, keepdim=True)
    logz = (logits - m).exp().sum(-1).log() + m[..., 0]
    vocab = on_mesh_of(torch.arange(logits.shape[-1],
                                    device=logits.device), logits)
    ll = torch.where(vocab == li[..., None], logits, 0.0).sum(-1)
    return torch.sum((logz - ll) * mi), torch.sum(mi)


def chunked_softmax_xent(x, table, labels, mask=None, chunk: int = 512,
                         ctx: ShardCtx = NO_SHARD):
    """Next-token CE without materializing (B, S, V) fp32 logits.

    Per-sequence-chunk fp32 logits of the fp32 table, each chunk
    recomputed in the backward pass: peak logits memory is one chunk's.
    x: (B,S,D) final hidden; table: (V,D); labels (B,S) int; mask (B,S)
    or None.  JAX's ``lax.scan`` over chunks is a Python loop that adds
    in the same order.  With DTensor inputs the logits are constrained
    to ('batch', None, 'vocab') (``src/repro/models/common.py:52``) and
    reduced vocab-parallel (``_xent_piece``)."""
    b, s, d = x.shape
    if s % chunk or s <= chunk:
        chunk = s
    nll = cnt = 0.0
    for c0 in range(0, s, chunk):
        li = labels[:, c0:c0 + chunk]
        mi = (torch.ones(li.shape, dtype=torch.float32, device=x.device)
              if mask is None else mask[:, c0:c0 + chunk].float())
        if isinstance(li, DTensor) and not isinstance(mi, DTensor):
            mi = on_mesh_of(mi, li).redistribute(li.device_mesh,
                                                 li.placements)
        a, c = maybe_checkpoint(True, _xent_piece, x[:, c0:c0 + chunk],
                                table, li, mi, ctx)
        nll, cnt = nll + a, cnt + c
    return nll / torch.clamp(cnt, min=1.0)


class LMBase:
    """Interface every model family implements."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ---- parameters ----
    def param_specs(self) -> Dict[str, Any]:
        raise NotImplementedError

    def init(self, gen: torch.Generator, device: DeviceLike = None, *,
             mesh=None, rules=None):
        """Parameters drawn from ``gen`` (on its own device), placed on
        ``device`` (default: the GPU).  With ``mesh`` (a ``DeviceMesh``)
        and ``rules`` each leaf is a DTensor laid out by the rules, and
        each rank draws only its own shard (``P.materialize_on_mesh``:
        no rank ever holds a whole leaf)."""
        if mesh is not None:
            from repro_torch.nn import sharding as shd
            specs = self.param_specs()
            return P.materialize_on_mesh(
                specs, gen.initial_seed(), mesh,
                shd.tree_shardings(specs, shd.mesh_view(mesh), rules))
        return P.materialize(self.param_specs(), gen,
                             device=resolve_device(device))

    # ---- training ----
    def loss(self, params, batch, ctx: ShardCtx = NO_SHARD):
        """(loss, {"ce", "aux"}) of a {"tokens", "labels"} batch;
        differentiable in ``params``."""
        raise NotImplementedError

    # ---- serving ----
    def prefill(self, params, batch, ctx: ShardCtx = NO_SHARD):
        """Returns the last-token logits (B, 1, V) — used by serve
        drivers."""
        raise NotImplementedError

    def decode_step(self, params, cache, batch, ctx: ShardCtx = NO_SHARD):
        """batch: {'token': (B,1), 'pos': (B,)}.  Returns (logits, cache)."""
        raise NotImplementedError

    def cache_specs(self, batch: int, max_len: int):
        raise NotImplementedError

    # ---- dry-run inputs ----
    def input_specs(self, shape: InputShape) -> Dict[str, Any]:
        """``ShapeDtype`` stand-ins for every model input (``P.abstract``
        makes ``meta`` tensors of them)."""
        cfg = self.cfg
        i32 = "int32"
        if shape.kind == "train":
            text = shape.seq_len - self._frontend_len()
            d = {"tokens": P.ShapeDtype((shape.global_batch, text), i32),
                 "labels": P.ShapeDtype((shape.global_batch, text), i32)}
        elif shape.kind == "prefill":
            text = shape.seq_len - self._frontend_len()
            d = {"tokens": P.ShapeDtype((shape.global_batch, text), i32)}
        else:  # decode
            d = {"token": P.ShapeDtype((shape.global_batch, 1), i32),
                 "pos": P.ShapeDtype((shape.global_batch,), i32)}
            return d
        fl = self._frontend_len()
        if fl:
            d["embeds"] = P.ShapeDtype(
                (shape.global_batch, fl, cfg.frontend.embed_dim), "bfloat16")
        return d

    def _frontend_len(self) -> int:
        fe = self.cfg.frontend
        if fe.kind != "none" and self.cfg.encdec is None:
            return fe.num_embeds
        return 0

    # window to use for a decode shape (ring-buffer cache for long ctx)
    def decode_cache_len(self, shape: InputShape) -> int:
        cfg = self.cfg
        if cfg.sliding_window is not None and shape.seq_len > cfg.sliding_window \
                and cfg.use_sliding_for_long and shape.name == "long_500k":
            return cfg.sliding_window
        return shape.seq_len
