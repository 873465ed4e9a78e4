"""Rank functions for ``tests/test_torch_mesh*.py``: each runs in every
rank of a ``gloo`` world that ``repro_torch.launch.mesh.launch`` starts,
and returns its results (full tensors) on rank 0; and ``fake_counts``,
the same steps counted on a fake process group in a child process
(``python _torch_mesh_ranks.py jobs.pkl counts.pkl``).  Kept apart from
the test files so that the ranks import the port and not JAX."""
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
from repro_torch.launch.hlo import StepCounter
from repro_torch.launch.serve import generate
from repro_torch.models.api import build_model
from repro_torch.nn import sharding as shd
from repro_torch.nn.layers import ShardCtx
from repro_torch.optim import adamw

RULES = shd.DEFAULT_RULES


def counted_on_mesh(bundle, dm, counts, key):
    """``steps.on_mesh(bundle, dm)`` whose first call runs ``bundle.fn``
    alone under ``launch.hlo.StepCounter`` (the arguments laid out before
    it, the results after, as ``on_mesh`` lays them out): this rank's
    FLOPs, bytes and collectives go into ``counts[key]``, with the dtype
    of each batch input."""
    def run(*args):
        args = tuple(shd.distribute(a, s, dm)
                     for a, s in zip(args, bundle.in_shardings))
        if key in counts:
            out = bundle.fn(*args)
        else:
            with StepCounter() as c:
                out = bundle.fn(*args)
            counts[key] = dict(c.analysis().as_dict(), batch={
                k: str(v.dtype).removeprefix("torch.")
                for k, v in args[-1].items()})
        return shd.distribute(out, bundle.out_shardings, dm)
    return run


def fake_counts(jobs):
    """Rank 0's count of each step of ``jobs`` on a ``"fake"`` process
    group of four ranks (``launch.dryrun.rank0_count``: the arguments
    DTensors over ``meta`` shards): {key: (arch, attention_impl, kind,
    (batch, seq), mesh shape, rule set, {batch input: dtype})} -> {key:
    counts as ``counted_on_mesh`` keeps them}.  The batch inputs take the
    dtypes the live worlds feed; every config is ``f32_config``'s, with
    ``attention_impl`` where it is not None."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dryrun
    out = {}
    with dryrun.fake_world(4):
        meshes = {}
        for key, (name, impl, kind, (b, s), shape, rules, dtypes) \
                in jobs.items():
            if shape not in meshes:
                meshes[shape] = init_device_mesh(
                    "cpu", shape, mesh_dim_names=mesh_lib.MESH_AXES)
            kw = dict(opt_state_dtype=torch.float32) if kind == "train" \
                else {}
            over = {} if impl is None else dict(attention_impl=impl)
            bundle = steps.make_bundle(
                f32_config(name, **over),
                InputShape("t", s, b, kind), meshes[shape],
                shd.RULE_SETS[rules], **kw)
            values = list(bundle.abstract_args)
            values[-1] = {k: torch.empty(v.shape, device="meta",
                                         dtype=getattr(torch, dtypes[k]))
                          for k, v in values[-1].items()}
            _, a = dryrun.rank0_count(bundle, meshes[shape], tuple(values))
            out[key] = dict(a.as_dict(), batch=dtypes)
    return out



def f32_config(name, **over):
    """``name``'s ``reduced()`` config in fp32 compute."""
    return dataclasses.replace(tconfigs.get_config(name).reduced(),
                               dtype="float32", **over)


def _shard_shapes_agree(params, shardings) -> bool:
    return all(tuple(p.to_local().shape) == s.shard_shape(p.shape)
               for p, s in zip(_leaves(params), _leaves(shardings)))


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


def _decode_gqa_layouts(dm, seed=0):
    """A decode attention's query (4, 1, 8, 16) laid out as the models lay
    it out (batch on 'data', heads on 'model'), against K/V caches (4, 12,
    kv, 16) laid out as the rules lay them out (kv heads on 'model' where
    they divide it, else replicated) for GQA 8/2, MQA 8/1 and GQA 8/4:
    ``_repeat_kv`` against the plain repeat, each rank's repeated K shape,
    ``dot_attention``'s output and the cache's gradient through it
    against the plain tensors'."""
    from repro_torch.nn import attention
    rng = np.random.default_rng(seed)
    names = dm.mesh_dim_names
    out = {}

    def place(t, heads):
        pl = [Shard(0) if name == "data" else
              Shard(2) if heads and t.shape[2] % dm.shape[i] == 0
              and t.shape[2] > 1 else Replicate()
              for i, name in enumerate(names)]
        return distribute_tensor(t, dm, pl, src_data_rank=None)

    mask = torch.ones((1, 1, 1, 12), dtype=torch.bool)
    w = torch.as_tensor(rng.normal(size=(4, 1, 8, 16)), dtype=torch.float32)
    for h, kv in ((8, 2), (8, 1), (8, 4)):
        q, k, v = (torch.as_tensor(rng.normal(size=shape),
                                   dtype=torch.float32)
                   for shape in ((4, 1, h, 16), (4, 12, kv, 16),
                                 (4, 12, kv, 16)))
        ref_k = k.repeat_interleave(h // kv, dim=2)
        k_ref = k.clone().requires_grad_(True)
        ref = attention.dot_attention(
            q, k_ref.repeat_interleave(h // kv, dim=2),
            v.repeat_interleave(h // kv, dim=2), mask, dtype=torch.float32)
        (ref * w).sum().backward()
        dq = place(q, True)
        dk = place(k, True).detach().requires_grad_(True)
        big_k = attention._repeat_kv(dk, h, dq)
        got = attention.dot_attention(
            dq, big_k, attention._repeat_kv(place(v, True), h, dq),
            attention.on_mesh_of(mask, dq), dtype=torch.float32)
        (got * place(w, True)).sum().backward()
        out[(h, kv)] = dict(
            repeat_err=float((big_k.detach().full_tensor()
                              - ref_k).abs().max()),
            local_k=tuple(big_k.to_local().shape),
            cache=[repr(p) for p in dk.placements],
            err=float((got.detach().full_tensor()
                       - ref.detach()).abs().max()),
            grad_err=float((dk.grad.full_tensor()
                            - k_ref.grad).abs().max()))
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
    train bundle; the flash op's layouts.  Each step's first call is
    counted (``counted_on_mesh``: ``out["counts"]``).  Weights: the JAX
    trees given."""
    b, s = prompt.shape
    prompt = torch.as_tensor(prompt)
    out = {"mesh": dict(zip(dm.mesh_dim_names, dm.shape)), "counts": {}}
    cfg = f32_config("llama3.2-1b")
    params = convert.lm_params_from_jax(llama_np, "cpu")
    shape_ok = []
    for route in ("dot", "kernel"):
        bundle = steps.make_prefill_bundle(
            dataclasses.replace(cfg, attention_impl=route),
            InputShape("t", s, b, "prefill"), dm, RULES)
        dp = shd.distribute(params, bundle.in_shardings[0], dm)
        shape_ok.append(_shard_shapes_agree(dp, bundle.in_shardings[0]))
        logits = counted_on_mesh(bundle, dm, out["counts"],
                                 f"prefill_{route}")(dp, {"tokens": prompt})
        out[f"prefill_{route}"] = shd.full(logits)
        out[f"prefill_{route}_placements"] = [repr(p)
                                              for p in logits.placements]

    bundle = steps.make_decode_bundle(
        cfg, InputShape("t", s + gen_len, b, "decode"), dm, RULES)
    run = counted_on_mesh(bundle, dm, out["counts"], "decode")
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
    run = counted_on_mesh(bundle, dm, out["counts"], "train")
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
    out["decode_gqa"] = _decode_gqa_layouts(dm)
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


# ------------------------------------------------ rwkv6, zamba2, MoE, encdec
def _leaves(tree):
    """The tensors of nested dicts and tuples, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _recording(store, fn):
    """``fn`` that first notes its tensor arguments' shapes and strides."""
    def rec(*args, **kw):
        store.append([(tuple(a.shape), tuple(a.stride()))
                      if isinstance(a, torch.Tensor) else a
                      for a in list(args) + list(kw.values())])
        return fn(*args, **kw)
    return rec


def _gla_layouts(dm, seed=0):
    """The ``gla_chunked`` op on DTensor inputs laid out as the models lay
    them out (batch on 'data', heads on 'model'), both variants, with a
    bonus and an initial state: (y, state) gathered against the
    unsharded op, and the output placements DTensor picked."""
    from repro_torch.kernels.ssm_scan import ops as ss
    rng = np.random.default_rng(seed)
    names = dm.mesh_dim_names
    b, l, h, dk, dv = 4, 40, 8, 16, 16
    out = {}
    for variant in ("rwkv", "mamba"):
        def t(*shape, neg=False):
            a = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
            return -a.abs() * 0.1 if neg else a

        q, k, lw = t(b, l, h, dk), t(b, l, h, dk), t(b, l, h, dk, neg=True)
        v, bonus, s0 = t(b, l, h, dv), t(h, dk), t(b, h, dk, dv)
        ref = ss.gla_chunked(q, k, v, lw, chunk=16, variant=variant,
                             bonus=bonus, initial_state=s0)

        def place(x, batch, heads):
            pl = [Shard(batch) if name == "data" and batch is not None
                  else Shard(heads) if name == "model" else Replicate()
                  for name in names]
            return distribute_tensor(x, dm, pl, src_data_rank=None)

        got = ss.gla_chunked(*(place(x, 0, 2) for x in (q, k, v, lw)),
                             chunk=16, variant=variant,
                             bonus=place(bonus, None, 0),
                             initial_state=place(s0, 0, 1))
        out[variant] = dict(
            y_err=float((got[0].full_tensor() - ref[0]).abs().max()),
            state_err=float((got[1].full_tensor() - ref[1]).abs().max()),
            placements=[[repr(p) for p in g.placements] for g in got])
    return out


def family_steps(dm, rules_name, name, jax_np, inp):
    """``name``'s reduced() fp32 config on the mesh ``dm`` under the rule
    set ``rules_name``, weights JAX's tree ``jax_np``: a prefill through
    the prefill bundle (the scans and flash on their kernel routes, the
    calls at the ``ssm_scan`` op recorded with their local shapes), the
    MoE routing on the mesh and a prefill with ``inp["pins"]`` pinning
    it, ``inp["decode"]`` decode steps through the decode bundle (the
    encoder-decoder's cross cache built on the mesh), the loss's
    gradients, and two train steps through the train bundle; for an
    attention-free family, ``_gla_layouts``.  Each bundle's first call
    is counted (``counted_on_mesh``: ``out["counts"]``).  Results
    gathered to full CPU tensors."""
    from repro_torch.kernels.ssm_scan import ops as ss
    rules = shd.RULE_SETS[rules_name]
    cfg = f32_config(name, attention_impl="kernel")
    model = build_model(cfg)
    ctx = ShardCtx(dm, rules)
    params = convert.lm_params_from_jax(jax_np, "cpu")
    prompt = torch.as_tensor(inp["prompt"])
    b, s = prompt.shape
    batch = {"tokens": prompt}
    if cfg.encdec is not None:
        batch["src_embeds"] = torch.as_tensor(inp["src"])
    out = {"mesh": dict(zip(dm.mesh_dim_names, dm.shape)), "gla_calls": [],
           "counts": {}}

    bundle = steps.make_prefill_bundle(cfg, InputShape("t", s, b,
                                                       "prefill"), dm, rules)
    dp = shd.distribute(params, bundle.in_shardings[0], dm)
    out["shard_shapes_ok"] = _shard_shapes_agree(dp, bundle.in_shardings[0])
    plain = ss.gla_chunked_plain
    ss.gla_chunked_plain = _recording(out["gla_calls"], plain)
    try:
        logits = counted_on_mesh(bundle, dm, out["counts"],
                                 "prefill")(dp, batch)
    finally:
        ss.gla_chunked_plain = plain
    out["prefill"] = shd.full(logits)
    out["prefill_placements"] = [repr(p) for p in logits.placements]
    db = shd.distribute(batch, bundle.in_shardings[1], dm)
    if cfg.moe is not None:
        out["routing"] = shd.full(model.routing(dp, db, ctx))
        out["prefill_pinned"] = shd.full(model.prefill(
            dp, dict(db, expert_ids=torch.as_tensor(inp["pins"])), ctx))

    bundle = steps.make_decode_bundle(
        cfg, InputShape("t", s, b, "decode"), dm, rules)
    run = counted_on_mesh(bundle, dm, out["counts"], "decode")
    cache = model.init_cache(b, s, device="cpu")
    if cfg.encdec is not None:
        cache["cross"] = model.build_cross_cache(
            dp, model._encode(dp, db["src_embeds"], ctx), ctx)
        out["cross_placements"] = [repr(p)
                                   for p in cache["cross"]["k"].placements]
    cache = shd.distribute(cache, bundle.in_shardings[1], dm)
    out["cache_shapes_ok"] = _shard_shapes_agree(cache,
                                                 bundle.in_shardings[1])
    logits = []
    for i in range(inp["decode"]):
        lg, after = run(dp, cache, {"token": prompt[:, i:i + 1],
                                    "pos": torch.full((b,), i)})
        logits.append(shd.full(lg))
    out["decode"] = torch.stack(logits)
    out["cache_in_place"] = all(x is y for x, y in zip(_leaves(after),
                                                       _leaves(cache)))
    out["cache"] = shd.full(cache)

    bundle = steps.make_train_bundle(cfg, InputShape("t", s, b, "train"), dm,
                                     rules, opt_state_dtype=torch.float32)
    tbatch = dict(batch, labels=torch.as_tensor(inp["labels"][0]))
    dtb = shd.distribute(tbatch, bundle.in_shardings[2], dm)
    (loss, _), grads = steps.value_and_grad(
        lambda p: model.loss(p, dtb, ctx), dp)
    out["loss"], out["grads"] = float(shd.full(loss)), shd.full(grads)
    run = counted_on_mesh(bundle, dm, out["counts"], "train")
    st = adamw(3e-4, weight_decay=0.1, state_dtype=torch.float32).init(dp)
    p, losses = dp, []
    for labels in inp["labels"]:
        p, st, loss, metrics = run(p, st, dict(batch,
                                               labels=torch.as_tensor(labels)))
        losses.append((float(shd.full(loss)),
                       float(shd.full(metrics["aux"]))))
    out["train_losses"] = losses
    if cfg.arch_type == "ssm":
        out["gla"] = _gla_layouts(dm)
    return out


def families_on_meshes(runs, names, jax_trees, inp):
    """``family_steps`` of each of ``names`` on each (mesh shape, rule
    set) of ``runs``, every mesh over the same ranks: {(name, shape,
    rules): results} on rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    for shape, rules in runs:
        dm = init_device_mesh("cpu", shape,
                              mesh_dim_names=mesh_lib.MESH_AXES)
        for name in names:
            out[(name, shape, rules)] = family_steps(
                dm, rules, name, jax_trees[name], inp[name])
    return out if dist.get_rank() == 0 else None


if __name__ == "__main__":
    # python _torch_mesh_ranks.py jobs.pkl counts.pkl: fake_counts
    import pickle
    import sys
    with open(sys.argv[1], "rb") as f:
        jobs = pickle.load(f)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(fake_counts(jobs), f)
