"""Rank functions for ``tests/test_torch_mesh.py``: each runs in every rank
of a ``gloo`` world that ``repro_torch.launch.mesh.launch`` starts, and
returns its results (full tensors) on rank 0.  Kept apart from the test
file so that the ranks import the port and not JAX."""
import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import InputShape
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch.serve import generate
from repro_torch.models.api import build_model
from repro_torch.nn import sharding as shd
from repro_torch.nn.layers import ShardCtx
from repro_torch.nn.param import tree_leaves
from repro_torch.optim import adamw

RULES = shd.DEFAULT_RULES


def f32_config(name, **over):
    """``name``'s ``reduced()`` config in fp32 compute."""
    return dataclasses.replace(tconfigs.get_config(name).reduced(),
                               dtype="float32", **over)


def _shard_shapes_agree(params, shardings) -> bool:
    return all(tuple(p.to_local().shape) == s.shard_shape(p.shape)
               for p, s in zip(tree_leaves(params), tree_leaves(shardings)))


def _flash_layouts(dm, seed=0):
    """The flash op on DTensor q, k, v laid out as the rules lay them out
    (batch on 'data'; heads and kv heads on 'model' where they divide it)
    for GQA 8/2, MQA 8/1 and GQA 8/4: each output against the plain
    version on the full tensors, and the output's placements (the
    layout the op's sharding rule let DTensor pick)."""
    rng = np.random.default_rng(seed)
    names = dm.mesh_dim_names
    out = {}
    for h, kv in ((8, 2), (8, 1), (8, 4)):
        full = [torch.as_tensor(rng.normal(size=(4, 16, n, 16)),
                                dtype=torch.float32)
                for n in (h, kv, kv)]
        placed = []
        for t in full:
            pl = [Shard(0) if name == "data" else
                  (Shard(2) if t.shape[2] % dm.shape[i] == 0
                   and t.shape[2] > 1 else Replicate())
                  for i, name in enumerate(names)]
            placed.append(distribute_tensor(t, dm, pl, src_data_rank=None))
        got = fa.flash_attention(*placed, causal=True)
        ref = fa.flash_attention_plain(*full, causal=True)
        out[(h, kv)] = dict(err=float((got.full_tensor() - ref).abs().max()),
                            placements=[repr(p) for p in got.placements],
                            inputs=[[repr(p) for p in t.placements]
                                    for t in placed])
    return out


def lm_steps_on_meshes(meshes, *args):
    """``lm_steps`` on each (data, model) shape of ``meshes``, every one a
    ``DeviceMesh`` over the same ranks: {shape: results} on rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    out = {m: lm_steps(init_device_mesh("cpu", m,
                                        mesh_dim_names=mesh_lib.MESH_AXES),
                       *args) for m in meshes}
    return out if dist.get_rank() == 0 else None


def lm_steps(dm, llama_np, repro_np, prompt, decode_steps, train_batches,
             gen_len, gen_prompt):
    """llama3.2-1b.reduced() (fp32): the prefill on the dot and kernel
    routes, ``decode_steps`` decode steps (the prompt's tokens fed in
    turn) and ``serve.generate`` (the prompt's first ``gen_prompt``
    tokens, ``gen_len`` new ones, the decode's cache length) on the mesh
    ``dm``; repro-100m.reduced() (fp32): three train steps through the
    train bundle; the flash op's layouts.  Weights: the JAX trees
    given."""
    b, s = prompt.shape
    prompt = torch.as_tensor(prompt)
    out = {"mesh": dict(zip(dm.mesh_dim_names, dm.shape))}
    cfg = f32_config("llama3.2-1b")
    params = convert.lm_params_from_jax(llama_np, "cpu")
    shape_ok = []
    for route in ("dot", "kernel"):
        bundle = steps.make_prefill_bundle(
            dataclasses.replace(cfg, attention_impl=route),
            InputShape("t", s, b, "prefill"), dm, RULES)
        dp = shd.distribute(params, bundle.in_shardings[0], dm)
        shape_ok.append(_shard_shapes_agree(dp, bundle.in_shardings[0]))
        logits = steps.on_mesh(bundle, dm)(dp, {"tokens": prompt})
        out[f"prefill_{route}"] = shd.full(logits)
        out[f"prefill_{route}_placements"] = [repr(p)
                                              for p in logits.placements]

    bundle = steps.make_decode_bundle(
        cfg, InputShape("t", s + gen_len, b, "decode"), dm, RULES)
    run = steps.on_mesh(bundle, dm)
    cache = shd.distribute(build_model(cfg).init_cache(b, s + gen_len,
                                                       device="cpu"),
                           bundle.in_shardings[1], dm)
    shape_ok.append(_shard_shapes_agree(cache, bundle.in_shardings[1]))
    storage = cache["k"].to_local().data_ptr()
    logits = []
    for i in range(decode_steps):
        lg, after = run(dp, cache, {"token": prompt[:, i:i + 1],
                                    "pos": torch.full((b,), i)})
        logits.append(shd.full(lg))
    out["decode"] = torch.stack(logits)
    out["cache_in_place"] = after["k"] is cache["k"] \
        and cache["k"].to_local().data_ptr() == storage
    out["cache"] = shd.full(cache)
    out["generate"] = generate(build_model(cfg), params,
                               prompt[:, :gen_prompt], gen_len, s + gen_len,
                               ShardCtx(dm, RULES))

    rcfg = f32_config("repro-100m")
    rparams = convert.lm_params_from_jax(repro_np, "cpu")
    bundle = steps.make_train_bundle(
        rcfg, InputShape("t", train_batches[0]["tokens"].shape[1],
                         train_batches[0]["tokens"].shape[0], "train"), dm,
        RULES, opt_state_dtype=torch.float32)
    run = steps.on_mesh(bundle, dm)
    p = shd.distribute(rparams, bundle.in_shardings[0], dm)
    shape_ok.append(_shard_shapes_agree(p, bundle.in_shardings[0]))
    st = adamw(3e-4, weight_decay=0.1, state_dtype=torch.float32).init(p)
    losses = []
    for batch in train_batches:
        p, st, loss, _ = run(p, st, {k: torch.as_tensor(v)
                                     for k, v in batch.items()})
        losses.append(float(shd.full(loss)))
    out["train_losses"] = losses
    out["train_params"] = shd.full(p)
    out["train_step"] = int(shd.full(st["step"]))
    out["shard_shapes_ok"] = shape_ok
    out["flash"] = _flash_layouts(dm)
    return out


def fail_on_rank(bad):
    """Raise on rank ``bad``; the others wait in a collective."""
    import torch.distributed as dist
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.barrier()


def hang():
    """Never return."""
    import time
    while True:
        time.sleep(1)
