#!/usr/bin/env python3
"""Readings of the port's DTensor meshes: two on four ``gloo`` ranks of
the CPU at a family's ``reduced()`` config (parameters drawn from a
seed; a mesh draws them as one process does), one on a fake group.

``gap``: where a sharded mesh's bf16 logits part from one process's.
Each family's bf16 prefill on the mesh is held against the same
prefill in one process (max |dlogit|, the share of rows whose argmax
agrees), twice: as the port runs it (DTensor's bf16 products, each
rank rounding its partial sums before they are added in bf16), and
with every bf16 product, on the mesh and in the one process alike,
taken in fp32 and rounded to bf16 once, a DTensor's partial sums
reduced in fp32 before that rounding (``Fp32Products``), and then with
that done on the mesh alone, against one process as it runs: the gap
the mesh would keep if it reduced its partial sums in fp32 (ROADMAP §3
item 1).  The floor of these gaps: one process with its products in
fp64 against the same in fp32 (``Fp64Products``), which moves nothing
but fp32's rounding of the sums.

``collectives``: which tensors DTensor's redistributions move on rank
0 in a prefill: each collective's result shape, dtype and count, and
the bytes by collective, as ``launch.hlo.StepCounter`` counts them (a
collective's result bytes, twice that for an all-reduce).

``layer``: rank 0 of one full-width zamba2-7b mamba layer (a prefill
of ``--batch`` x ``--seq`` and a decode step at ``--batch``, bf16) on a
``"fake"`` process group of four over ``meta`` shards, for each layout
of ``in_proj`` (``nn.mamba.in_proj`` and the candidates in
``IN_PROJ``): its collective bytes by collective, the bytes of one
prefill and ``--decode-steps`` decode steps, and its FLOPs over an even
share of the layer's count in one process.

``train``: the bf16 loss and gradients of one training batch
(``launch.steps.value_and_grad``, as the train step takes them) on the
mesh against one process: |dloss| and, over the gradient leaves, the
largest ||g_mesh - g_one|| / ||g_one||; as the port runs it, and with
every bf16 product in fp32 on both sides (``Fp32Products``).

``floor``: one process's prefill in ``--dtype`` at full width (or
``--reduced``; depth ``--layers``, default the config's) on
``--device``, against the same prefill with every product in fp64
(``WideProducts``): the floor of the products' summation order, below
which no mesh's split of the sums can be told apart.

    PYTHONPATH=src python3 tools/mesh_bf16_gap.py gap
    PYTHONPATH=src python3 tools/mesh_bf16_gap.py gap --archs zamba2-7b \\
        --meshes 1x4 --batch 2 --seq 64
    PYTHONPATH=src python3 tools/mesh_bf16_gap.py collectives \\
        --archs grok-1-314b --meshes 4x1 --rules expert_parallel
    PYTHONPATH=src python3 tools/mesh_bf16_gap.py layer --meshes \\
        1x4,4x1,2x2 --batch 4 --seq 2048
    PYTHONPATH=src python3 tools/mesh_bf16_gap.py train --meshes 1x4,4x1
    python3 tools/mesh_bf16_gap.py floor --archs zamba2-7b --device cuda \\
        --batch 2 --seq 256
"""
import argparse
import contextlib
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from repro_torch.launch.hlo import StepCounter  # noqa: E402

PRODUCTS = (torch.einsum, torch.matmul, torch.Tensor.matmul,
            torch.Tensor.__matmul__)


class WideProducts(TorchFunctionMode):
    """Each product (``einsum``, ``matmul``, ``@``) with an operand of
    dtype ``narrow`` taken with its ``narrow`` operands widened to
    ``wide``, and its result cast back to ``narrow`` once; a DTensor
    product's partial sums are reduced in ``wide`` before that cast."""

    def __init__(self, narrow: torch.dtype, wide: torch.dtype):
        super().__init__()
        self.narrow, self.wide = narrow, wide

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in PRODUCTS or not any(
                isinstance(a, torch.Tensor) and a.dtype == self.narrow
                for a in args):
            return func(*args, **kwargs)
        out = func(*(a.to(self.wide) if isinstance(a, torch.Tensor)
                     and a.dtype == self.narrow else a for a in args),
                   **kwargs)
        if isinstance(out, DTensor):
            out = out.redistribute(out.device_mesh, [
                Replicate() if p.is_partial() else p
                for p in out.placements])
        return out.to(self.narrow)


class Fp32Products(WideProducts):
    """Each product of bf16 tensors taken in fp32 and rounded to bf16
    once; a DTensor product's partial sums are reduced in fp32 before
    the rounding."""

    def __init__(self):
        super().__init__(torch.bfloat16, torch.float32)


class Fp64Products(WideProducts):
    """``Fp32Products`` in fp64: one process's products under it and
    under ``Fp32Products`` differ only by fp32's rounding of the sums,
    which flips a bf16 rounding here and there: the floor of any change
    of summation order in fp32."""

    def __init__(self):
        super().__init__(torch.bfloat16, torch.float64)


class Collectives(StepCounter):
    """``launch.hlo.StepCounter`` on this rank: ``seen`` is each
    collective DTensor runs, {(collective, result shape, dtype): [count,
    bytes]} (the counter's rule: result bytes, twice that for an
    all-reduce)."""

    @property
    def seen(self):
        return dict(self.buffers)


def _in_proj_as_stored(p, x, dtype, ctx):
    """x whole on d_model, the weight as its spec lays it out: each
    rank's own rows (or part of d_model) and columns (ROADMAP item
    j)."""
    from repro_torch.nn.layers import mm
    x = ctx.constrain(x, "batch", None, None)
    return ctx.constrain(mm(x, p["in_proj"], dtype), *WHOLE_ROWS)


def _in_proj_gathered_on_data(p, x, dtype, ctx):
    """x whole on d_model, the weight gathered on 'data' (its columns
    kept on 'model')."""
    from repro_torch.nn.layers import mm
    x = ctx.constrain(x, "batch", None, None)
    w = ctx.constrain(p["in_proj"].to(dtype), None, "heads")
    return ctx.constrain(mm(x, w, dtype), *WHOLE_ROWS)


# in_proj's output laid out as nn.mamba's: each rank's rows, every column
WHOLE_ROWS = ("batch", None, None)
# the in_proj layouts ``layer`` counts beside nn.mamba.in_proj's
IN_PROJ = {"as stored": _in_proj_as_stored,
           "weight gathered on 'data'": _in_proj_gathered_on_data}


def _mamba_layer_counts(meshes, b, s):
    """{(layout, mesh): {"prefill": HloAnalysis, "decode": ...}} of rank
    0 on a fake group of four, and {"prefill": flops, "decode": flops}
    of the layer in one process, all on ``meta``."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MESH_AXES
    from repro_torch.nn import mamba
    from repro_torch.nn import sharding as shd
    from repro_torch.nn.layers import NO_SHARD, ShardCtx
    from repro_torch.nn.param import ParamSpec

    cfg = get_config("zamba2-7b")
    d = cfg.d_model
    specs = dict(p=mamba.mamba_specs(cfg),
                 x=ParamSpec((b, s, d), ("batch", None, "embed_act"),
                             dtype="bfloat16"),
                 x1=ParamSpec((b, 1, d), ("batch", None, "embed_act"),
                              dtype="bfloat16"),
                 state=mamba.mamba_state_specs(b, cfg))
    meta = shd._tree_map_specs(lambda sp: torch.empty(
        sp.shape, dtype=getattr(torch, sp.dtype), device="meta"), specs)

    def run(t, ctx):
        with StepCounter() as pre:
            mamba.mamba_block(t["p"], t["x"], cfg, ctx=ctx)
        with StepCounter() as dec:
            mamba.mamba_decode(t["p"], t["x1"], cfg, state=t["state"],
                               ctx=ctx)
        return {"prefill": pre.analysis(), "decode": dec.analysis()}

    whole = {k: a.flops for k, a in run(meta, NO_SHARD).items()}
    out = {}
    layouts = {"weight gathered on 'model' (nn.mamba.in_proj)":
               mamba.in_proj, **IN_PROJ}
    kept = mamba.in_proj
    with dryrun.fake_world(4):
        for mesh in meshes:
            dm = init_device_mesh("cpu", mesh, mesh_dim_names=MESH_AXES)
            ctx = ShardCtx(dm, shd.DEFAULT_RULES)
            args = dryrun.rank0_args(meta, shd.tree_shardings(
                specs, shd.mesh_view(dm), ctx.rules), dm)
            for name, fn in layouts.items():
                mamba.in_proj = fn
                try:
                    out[(name, mesh)] = run(args, ctx)
                finally:
                    mamba.in_proj = kept
    return out, whole


def _config(arch):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(),
                               dtype="bfloat16", attention_impl="kernel")


def _batch(cfg, b, s, seed):
    gen = torch.Generator().manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen)}
    if cfg.encdec is not None:
        batch["src_embeds"] = torch.randn(b, cfg.encdec.encoder_seq,
                                          cfg.d_model, generator=gen)
    return batch


def _prefill_on_mesh(arch, model_axis, rules, b, s, seed, mode):
    """Rank function: ``arch``'s bf16 prefill through the prefill bundle
    on the ('data', 'model') mesh of this world, under ``mode`` (None,
    ``Fp32Products`` or ``Collectives``).  Rank 0 returns the gathered
    logits and, for ``Collectives``, what it saw."""
    import torch.distributed as dist
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models.api import build_model
    from repro_torch.nn import sharding as shd

    dm = mesh_lib.make_device_mesh(model_axis, device_type="cpu")
    cfg = _config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(seed),
                                   "cpu", mesh=dm,
                                   rules=shd.RULE_SETS[rules])
    bundle = steps.make_prefill_bundle(cfg, InputShape("t", s, b, "prefill"),
                                       dm, shd.RULE_SETS[rules])
    run = steps.on_mesh(bundle, dm)
    batch = _batch(cfg, b, s, seed)
    seen = None
    if mode is None:
        logits = run(params, batch)
    else:
        with mode() as m:
            logits = run(params, batch)
        seen = getattr(m, "seen", None)
    logits = shd.full(logits).float()
    return (logits, seen) if dist.get_rank() == 0 else None


def _train_batch(cfg, b, s, seed):
    batch = _batch(cfg, b, s, seed)
    gen = torch.Generator().manual_seed(seed + 2)
    batch["labels"] = torch.randint(0, cfg.vocab_size, (b, s),
                                    generator=gen)
    return batch


def _grads(model, params, batch, ctx, mode):
    """(loss, gradient leaves) of ``model.loss``, full tensors."""
    from repro_torch.launch import steps
    from repro_torch.nn import sharding as shd
    from repro_torch.nn.param import tree_leaves
    with mode():
        (loss, _), grads = steps.value_and_grad(
            lambda p: model.loss(p, batch, ctx), params)
    return float(shd.full(loss)), [g.float() for g in
                                   tree_leaves(shd.full(grads))]


def _grads_on_mesh(arch, model_axis, rules, b, s, seed, mode):
    """Rank function: ``arch``'s bf16 loss and gradients of one batch on
    the ('data', 'model') mesh of this world, laid out as the train
    bundle lays them out, under ``mode``; rank 0 returns them."""
    import torch.distributed as dist
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models.api import build_model
    from repro_torch.nn import sharding as shd
    from repro_torch.nn.layers import ShardCtx

    dm = mesh_lib.make_device_mesh(model_axis, device_type="cpu")
    cfg, rule_set = _config(arch), shd.RULE_SETS[rules]
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu",
                        mesh=dm, rules=rule_set)
    bundle = steps.make_train_bundle(cfg, InputShape("t", s, b, "train"),
                                     dm, rule_set)
    params = shd.distribute(params, bundle.in_shardings[0], dm)
    batch = shd.distribute(_train_batch(cfg, b, s, seed),
                           bundle.in_shardings[2], dm)
    out = _grads(model, params, batch, ShardCtx(dm, rule_set), mode)
    return out if dist.get_rank() == 0 else None


def _grads_apart(a, ref):
    """|dloss| and the largest relative gradient gap over the leaves."""
    rel = max(float((g - r).norm() / r.norm().clamp_min(1e-30))
              for g, r in zip(a[1], ref[1]))
    return abs(a[0] - ref[0]), rel


def _floor(arch, layers, b, s, seed, dtype, device, reduced):
    """One process's ``dtype`` prefill at full width (or ``reduced()``),
    as it runs and with its products in fp64: max |dlogit| and the
    argmax agreement."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    over = {} if layers is None else {"num_layers": layers}
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              dtype=dtype, attention_impl="kernel", **over)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(seed), device)
    batch = {k: v.to(device) for k, v in _batch(cfg, b, s, seed).items()}
    with torch.no_grad():
        ref = model.prefill(params, batch).float()
        with WideProducts(getattr(torch, dtype), torch.float64):
            wide = model.prefill(params, batch).float()
    return _apart(wide, ref)


def _one_process(arch, b, s, seed, mode):
    from repro_torch.models.api import build_model
    cfg = _config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    with mode():
        return model.prefill(params, _batch(cfg, b, s, seed)).float()


def _apart(a, ref):
    rows = a.argmax(-1) == ref.argmax(-1)
    return float((a - ref).abs().max()), float(rows.float().mean())


def main(argv=None):
    from repro_torch.launch import mesh as mesh_lib
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("gap", "collectives", "layer",
                                     "train", "floor"))
    ap.add_argument("--archs", default="zamba2-7b,rwkv6-1.6b")
    ap.add_argument("--meshes", default="1x4,2x2")
    ap.add_argument("--rules", default="default")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-steps", type=int, default=64)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="floor: the config's reduced() widths")
    a = ap.parse_args(argv)
    if a.what == "floor":
        for arch in a.archs.split(","):
            gap, share = _floor(arch, a.layers, a.batch, a.seq, a.seed,
                                a.dtype, a.device, a.reduced)
            print(f"[floor] {arch} {a.dtype} prefill ({a.batch}, {a.seq}) "
                  f"at {'reduced()' if a.reduced else 'full width'}, "
                  f"{a.layers or 'every'} layer(s), on "
                  f"{a.device}, one process, products in fp64 against as "
                  f"it runs: max |dlogit| {gap:.4g}, argmax equal in "
                  f"{share:.4f} of the rows")
        return
    if a.what == "train":
        from repro_torch.models.api import build_model
        from repro_torch.nn.layers import NO_SHARD
        for arch in a.archs.split(","):
            cfg = _config(arch)
            model = build_model(cfg)
            params = model.init(torch.Generator().manual_seed(a.seed), "cpu")
            batch = _train_batch(cfg, a.batch, a.seq, a.seed)
            for mode in (contextlib.nullcontext, Fp32Products):
                ref = _grads(model, params, batch, NO_SHARD, mode)
                for mesh in a.meshes.split(","):
                    d, m = (int(x) for x in mesh.split("x"))
                    got = mesh_lib.launch(
                        _grads_on_mesh, d * m, device_type="cpu",
                        timeout=600, args=(arch, m, a.rules, a.batch,
                                           a.seq, a.seed, mode))[0]
                    dloss, rel = _grads_apart(got, ref)
                    how = "as the port runs it" if mode is \
                        contextlib.nullcontext else \
                        "every bf16 product in fp32 (one process too)"
                    print(f"[train] {arch} bf16 loss and gradients "
                          f"({a.batch}, {a.seq}) on ({d}, {m}) {a.rules}, "
                          f"{how}: |dloss| from one process {dloss:.4g}, "
                          f"largest gradient gap {rel:.4g} of its leaf's "
                          f"norm")
        return
    if a.what == "layer":
        meshes = [tuple(int(x) for x in m.split("x"))
                  for m in a.meshes.split(",")]
        counts, whole = _mamba_layer_counts(meshes, a.batch, a.seq)
        for (name, mesh), c in counts.items():
            pre, dec = c["prefill"], c["decode"]
            gb = (pre.collective_bytes
                  + a.decode_steps * dec.collective_bytes) / 1e9
            print(f"[layer] zamba2-7b mamba layer, in_proj {name}, on "
                  f"{mesh}, rank 0: prefill ({a.batch}, {a.seq}) "
                  f"{pre.collective_bytes / 1e9:.4f} GB "
                  f"{pre.per_collective}, FLOPs {pre.flops * 4 / whole['prefill']:.4f} "
                  f"of an even share; decode ({a.batch}) "
                  f"{dec.collective_bytes / 1e9:.5f} GB "
                  f"{dec.per_collective}, FLOPs "
                  f"{dec.flops * 4 / whole['decode']:.4f} of an even "
                  f"share; prefill + {a.decode_steps} decode steps "
                  f"{gb:.4f} GB")
        return
    for arch in a.archs.split(","):
        refs = {mode: _one_process(arch, a.batch, a.seq, a.seed,
                                   mode or contextlib.nullcontext)
                for mode in (None, Fp32Products, Fp64Products)} \
            if a.what == "gap" else {}
        if refs:
            gap, share = _apart(refs[Fp64Products], refs[Fp32Products])
            print(f"[gap] {arch} bf16 prefill ({a.batch}, {a.seq}), one "
                  f"process, products in fp64 against in fp32 (the floor): "
                  f"max |dlogit| {gap:.4g}, argmax equal in {share:.4f} "
                  f"of the rows")
        for mesh in a.meshes.split(","):
            d, m = (int(x) for x in mesh.split("x"))
            modes = (None, Fp32Products) if a.what == "gap" \
                else (Collectives,)
            for mode in modes:
                logits, seen = mesh_lib.launch(
                    _prefill_on_mesh, d * m, device_type="cpu",
                    timeout=600, args=(arch, m, a.rules, a.batch, a.seq,
                                       a.seed, mode))[0]
                where = f"{arch} bf16 prefill ({a.batch}, {a.seq}) on " \
                    f"({d}, {m}) {a.rules}"
                if a.what == "gap":
                    gap, share = _apart(logits, refs[mode])
                    how = "as the port runs it" if mode is None else \
                        "every bf16 product in fp32, rounded once (one " \
                        "process too)"
                    print(f"[gap] {where}, {how}: max |dlogit| from one "
                          f"process {gap:.4g}, argmax equal in "
                          f"{share:.4f} of the rows")
                    if mode is not None:
                        gap, share = _apart(logits, refs[None])
                        print(f"[gap] {where}, every bf16 product in fp32 "
                              f"on the mesh alone: max |dlogit| from one "
                              f"process as it runs {gap:.4g}, argmax "
                              f"equal in {share:.4f} of the rows")
                    continue
                total = {}
                for (name, shape, dtype), (n, nbytes) in sorted(
                        seen.items(), key=lambda kv: -kv[1][1]):
                    total[name] = total.get(name, 0) + nbytes
                    print(f"[collectives] {where}, rank 0: {name} "
                          f"{shape} {dtype} x{n}, {nbytes:,} bytes")
                print(f"[collectives] {where}, rank 0, bytes by "
                      f"collective: {total}")


if __name__ == "__main__":
    main()
