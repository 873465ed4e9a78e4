"""The train step: the port of the step of
``repro.launch.steps.make_train_bundle`` as one plain torch function.

JAX's bundle also carries the step's shardings and abstract arguments
for its dry run; on one GPU there is nothing to shard, and the prefill
and decode bundles and the sharding helpers wait for the accounting and
model-parallel slice (``ROADMAP.md`` queue 1, item 6.7).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import build_model
from repro_torch.nn.param import tree_leaves, tree_map
from repro_torch.optim import adamw, apply_updates


def value_and_grad(loss_fn, params):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params)``: ((loss,
    aux), grads), the gradients a tree like ``params`` from
    ``torch.autograd.grad`` over its leaves (zeros for a leaf the loss
    does not use, as in JAX)."""
    req = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = loss_fn(req)
    grads = iter(torch.autograd.grad(loss, tree_leaves(req),
                                     allow_unused=True))

    def grad(p):                   # tree_map walks tree_leaves' order
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return (loss.detach(), tree_map(torch.Tensor.detach, aux)), \
        tree_map(grad, req)


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4,
                    opt_state_dtype: torch.dtype = torch.bfloat16):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss, metrics)``: the loss and its gradients, ``adamw(lr,
    weight_decay=0.1)``'s update (moments stored in ``opt_state_dtype``,
    JAX's default bf16) and ``apply_updates``, at a constant learning
    rate as in JAX.  ``batch``: {"tokens", "labels"} (B, S) int tensors
    on the parameters' device."""
    model = build_model(cfg)
    opt = adamw(lr, weight_decay=0.1, state_dtype=opt_state_dtype)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(
            lambda p: model.loss(p, batch), params)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, loss, metrics

    return train_step
