#!/usr/bin/env python3
"""Two readings of the port's DTensor meshes, on four ``gloo`` ranks of
the CPU at a family's ``reduced()`` config (parameters drawn from a
seed; a mesh draws them as one process does).

``gap``: where a sharded mesh's bf16 logits part from one process's.
Each family's bf16 prefill on the mesh is held against the same
prefill in one process (max |dlogit|, the share of rows whose argmax
agrees), twice: as the port runs it, and with every bf16 product, on
the mesh and in the one process alike, taken in fp32 and rounded to
bf16 once, a DTensor's partial sums reduced in fp32 before that
rounding (``Fp32Products``), and then with that done on the mesh
alone, against one process as it runs.  If the second and third gaps
close, the first is the rounding of each rank's partial bf16 sums, not
a fault of the mesh code.  The floor of that second gap: one process with its products
in fp64 against the same in fp32 (``Fp64Products``), which moves
nothing but fp32's rounding of the sums.

``collectives``: which tensors DTensor's redistributions move on rank
0 in a prefill: each collective's result shape, dtype and count, and
the bytes by collective, as ``launch.hlo.StepCounter`` counts them (a
collective's result bytes, twice that for an all-reduce).

    PYTHONPATH=src python3 tools/mesh_bf16_gap.py gap
    PYTHONPATH=src python3 tools/mesh_bf16_gap.py gap --archs zamba2-7b \\
        --meshes 1x4 --batch 2 --seq 64
    PYTHONPATH=src python3 tools/mesh_bf16_gap.py collectives \\
        --archs grok-1-314b --meshes 4x1 --rules expert_parallel
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


class Fp32Products(TorchFunctionMode):
    """Each product (``einsum``, ``matmul``, ``@``) of bf16 tensors
    taken in ``WIDE`` (fp32) and rounded to bf16 once; a DTensor
    product's partial sums are reduced in ``WIDE`` before the
    rounding."""
    WIDE = torch.float32

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in PRODUCTS and any(isinstance(a, torch.Tensor)
                                    and a.dtype == torch.bfloat16
                                    for a in args):
            out = func(*(a.to(self.WIDE) if isinstance(a, torch.Tensor)
                         and a.dtype == torch.bfloat16 else a
                         for a in args), **kwargs)
            if isinstance(out, DTensor):
                out = out.redistribute(out.device_mesh, [
                    Replicate() if p.is_partial() else p
                    for p in out.placements])
            return out.to(torch.bfloat16)
        return func(*args, **kwargs)


class Fp64Products(Fp32Products):
    """``Fp32Products`` in fp64: one process's products under it and
    under ``Fp32Products`` differ only by fp32's rounding of the sums,
    which flips a bf16 rounding here and there: the floor of any change
    of summation order in fp32."""
    WIDE = torch.float64


class Collectives(StepCounter):
    """``launch.hlo.StepCounter`` on this rank: ``seen`` is each
    collective DTensor runs, {(collective, result shape, dtype): [count,
    bytes]} (the counter's rule: result bytes, twice that for an
    all-reduce)."""

    @property
    def seen(self):
        return dict(self.buffers)


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
    ap.add_argument("what", choices=("gap", "collectives"))
    ap.add_argument("--archs", default="zamba2-7b,rwkv6-1.6b")
    ap.add_argument("--meshes", default="1x4,2x2")
    ap.add_argument("--rules", default="default")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
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
