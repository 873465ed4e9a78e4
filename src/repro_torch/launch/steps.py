"""Step functions and their sharding metadata, shared by the dry run and
the trainer: the port of ``repro.launch.steps``.

A ``StepBundle`` holds a plain torch step (``fn``), ``meta`` tensors that
stand in for its arguments (``abstract_args``: shapes and dtypes, no
storage), the ``NamedSharding`` trees of its inputs and outputs
(``nn/sharding``), and ``donate_argnums``, the arguments whose storage
the step's outputs may reuse.  The port runs no partitioner: the
shardings say what each device would hold on a mesh, which is what the
dry run reckons (``launch/dryrun.py``); running a step on a mesh of
cards is ``ROADMAP.md`` queue 1, item 6.8.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.api import build_model
from repro_torch.nn import param as P
from repro_torch.nn import sharding as shd
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


def _apply_param_dtype(specs, cfg: ModelConfig):
    """Plumb cfg.param_dtype into every float32 ParamSpec (bf16 parameters
    halve FSDP all-gather and gradient reduce traffic on the 100B+
    configs; moments/updates still accumulate in fp32)."""
    if cfg.param_dtype == "float32":
        return specs
    return tree_map(lambda s: dataclasses.replace(s, dtype=cfg.param_dtype)
                    if s.dtype == "float32" else s, specs)


@dataclasses.dataclass
class StepBundle:
    """A step with all of its sharding metadata."""
    fn: Any                       # the plain torch step function
    in_shardings: Tuple
    out_shardings: Any
    abstract_args: Tuple          # meta tensors matching fn's args
    donate_argnums: Tuple[int, ...] = ()


def batch_shardings(inputs: Dict[str, Any], mesh,
                    rules) -> Dict[str, shd.NamedSharding]:
    """First dim of every input is the global batch."""
    out = {}
    for k, v in inputs.items():
        axes = ["batch"] + [None] * (v.ndim - 1)
        spec = shd.activation_spec(mesh, rules, *axes, dims=v.shape)
        out[k] = shd.NamedSharding(mesh, spec)
    return out


def opt_state_shardings(opt_state_abs, param_shardings, mesh):
    """m/v mirror the parameter shardings; scalars are replicated."""
    rep = shd.NamedSharding(mesh, shd.PartitionSpec())
    res = {"step": rep}
    for k in ("m", "v", "mu"):
        if k in opt_state_abs and opt_state_abs[k] is not None:
            res[k] = param_shardings
        elif k in opt_state_abs:
            res[k] = None
    return res


def _logits_sharding(mesh, rules, cfg: ModelConfig, batch: int):
    """The (B, 1, V) last-token logits that prefill and decode return."""
    return shd.NamedSharding(mesh, shd.activation_spec(
        mesh, rules, "batch", None, "vocab",
        dims=(batch, 1, cfg.vocab_size)))


def make_train_bundle(cfg: ModelConfig, shape: InputShape, mesh,
                      rules, *, lr: float = 3e-4,
                      opt_state_dtype=torch.bfloat16) -> StepBundle:
    model = build_model(cfg)
    opt = adamw(lr, weight_decay=0.1, state_dtype=opt_state_dtype)

    specs = _apply_param_dtype(model.param_specs(), cfg)
    params_abs = P.abstract(specs)
    params_shard = shd.tree_shardings(specs, mesh, rules)
    opt_abs = opt.init(params_abs)
    opt_shard = opt_state_shardings(opt_abs, params_shard, mesh)
    inputs = model.input_specs(shape)
    in_batch_shard = batch_shardings(inputs, mesh, rules)

    rep = shd.NamedSharding(mesh, shd.PartitionSpec())
    out_metrics = {"ce": rep, "aux": rep}
    return StepBundle(
        fn=make_train_step(cfg, lr=lr, opt_state_dtype=opt_state_dtype),
        in_shardings=(params_shard, opt_shard, in_batch_shard),
        out_shardings=(params_shard, opt_shard, rep, out_metrics),
        abstract_args=(params_abs, opt_abs, P.abstract(inputs)),
        donate_argnums=(0, 1),
    )


def make_prefill_bundle(cfg: ModelConfig, shape: InputShape, mesh,
                        rules) -> StepBundle:
    model = build_model(cfg)
    specs = _apply_param_dtype(model.param_specs(), cfg)
    params_shard = shd.tree_shardings(specs, mesh, rules)
    inputs = model.input_specs(shape)
    in_batch_shard = batch_shardings(inputs, mesh, rules)

    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return StepBundle(
        fn=prefill_step,
        in_shardings=(params_shard, in_batch_shard),
        out_shardings=_logits_sharding(mesh, rules, cfg, shape.global_batch),
        abstract_args=(P.abstract(specs), P.abstract(inputs)),
    )


def make_decode_bundle(cfg: ModelConfig, shape: InputShape, mesh,
                       rules) -> StepBundle:
    model = build_model(cfg)
    specs = _apply_param_dtype(model.param_specs(), cfg)
    params_shard = shd.tree_shardings(specs, mesh, rules)

    cache_len = model.decode_cache_len(shape)
    cache_specs = model.cache_specs(shape.global_batch, cache_len)
    cache_shard = shd.tree_shardings(cache_specs, mesh, rules)
    inputs = model.input_specs(shape)
    in_batch_shard = batch_shardings(inputs, mesh, rules)

    def serve_step(params, cache, batch):
        return model.decode_step(params, cache, batch)

    return StepBundle(
        fn=serve_step,
        in_shardings=(params_shard, cache_shard, in_batch_shard),
        out_shardings=(_logits_sharding(mesh, rules, cfg,
                                        shape.global_batch), cache_shard),
        abstract_args=(P.abstract(specs), P.abstract(cache_specs),
                       P.abstract(inputs)),
        donate_argnums=(1,),
    )


def make_bundle(cfg: ModelConfig, shape: InputShape, mesh, rules,
                **kw) -> StepBundle:
    if shape.kind == "train":
        return make_train_bundle(cfg, shape, mesh, rules, **kw)
    if shape.kind == "prefill":
        return make_prefill_bundle(cfg, shape, mesh, rules)
    return make_decode_bundle(cfg, shape, mesh, rules)
