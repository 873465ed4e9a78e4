"""Optimizers over nested dicts of tensors: the port of
``repro.optim.optimizers``.

An ``Optimizer`` is an (init, update) pair, in the optax calling
convention the JAX package uses:

    opt = adamw(lr_schedule, weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

State mirrors the parameters' tree; ``step`` is an int32 tensor on the
parameters' device, so a step reads nothing back to the host.  The
arithmetic is JAX's, in its order (``adamw``: ``b2 = 0.95`` and ``eps``
outside the square root, decoupled decay on the masked leaves); this is
not ``torch.optim.AdamW``, whose ``eps`` and decay sit elsewhere.

DTensor parameters (a mesh) get DTensor state laid out as they are, and
a replicated ``step``: every update is then elementwise on each rank's
shard, and ``global_norm``'s sums are reduced over the mesh by DTensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.nn.layers import on_mesh_of
from repro_torch.nn.param import tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]   # step -> lr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.full_like(step, lr, dtype=torch.float32)


def _first(tree) -> torch.Tensor:
    return tree_leaves(tree)[0]


def _step0(params) -> torch.Tensor:
    """The int32 step counter 0 on the parameters' device (replicated on
    their mesh when they are DTensors)."""
    p = _first(params)
    return on_mesh_of(torch.zeros((), dtype=torch.int32, device=p.device),
                      p)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD(+momentum) — the paper's local training optimizer (Sec. V)."""
    sched = _as_schedule(lr)

    def init(params):
        mu = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
              if momentum else None)
        return {"step": _step0(params), "mu": mu}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = sched(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.float(),
                          state["mu"], grads)
            if nesterov:
                upd = tree_map(
                    lambda m, g: -(lr_t * (momentum * m + g.float())),
                    mu, grads)
            else:
                upd = tree_map(lambda m: -lr_t * m, mu)
            return upd, {"step": step, "mu": mu}
        upd = tree_map(lambda g: -lr_t * g.float(), grads)
        return upd, {"step": step, "mu": None}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          mask: Optional[Callable[[Any], Any]] = None,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW with optional weight-decay mask (True leaves get decayed;
    by default the leaves with ndim >= 2).

    ``state_dtype=torch.bfloat16`` halves the moments' memory: they are
    accumulated in fp32 and stored rounded."""
    sched = _as_schedule(lr)

    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=state_dtype)
        return {"step": _step0(params),
                "m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        t = step.float()
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        m = tree_map(lambda mm, g: (b1 * mm.float() + (1 - b1) * g.float()
                                    ).to(state_dtype), state["m"], grads)
        v = tree_map(lambda vv, g: (b2 * vv.float() + (1 - b2)
                                    * torch.square(g.float())
                                    ).to(state_dtype), state["v"], grads)
        wd_tree = (mask(params) if mask is not None
                   else tree_map(lambda p: p.dim() >= 2, params))

        def upd(mm, vv, p, use_wd):
            mm = mm.float()
            vv = vv.float()
            step_dir = (mm / c1) / (torch.sqrt(vv / c2) + eps)
            if weight_decay:
                step_dir = step_dir + on_mesh_of(torch.where(
                    torch.as_tensor(use_wd, device=p.device),
                    weight_decay, 0.0), p) * p.float()
            return -lr_t * step_dir

        updates = tree_map(upd, m, v, params, wd_tree)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
