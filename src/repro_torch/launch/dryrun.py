"""Dry run: count every (arch x input-shape x mesh) combination's step on
``meta`` tensors (no allocation, no card), reckon each device's resident
bytes from the sharding rules, and emit the roofline terms.  The port of
``repro.launch.dryrun``, which lowers and compiles each step for 512
forced host devices and reads each device's share from the compiled
module.

What a record holds, and how it differs from JAX's:
  * per-device resident bytes are exact: the step's arguments plus its
    outputs minus what ``donate_argnums`` lets the outputs reuse, each
    leaf at its ``NamedSharding.shard_shape`` (JAX's ``hbm_resident``
    without the temporaries, which a trace on ``meta`` cannot see:
    ``temp_size_in_bytes`` is null);
  * FLOPs, bytes and collectives are rank 0's (``"per_device":
    "rank0"``): on a mesh larger than one card the step runs as the
    DTensor program the ranks of a live mesh run, over a ``"fake"``
    process group of the mesh's size (``fake_world``: this process is
    rank 0, a collective moves nothing and returns a buffer of its
    result's shape) and a ``DeviceMesh`` of the mesh's shape; each
    argument is a DTensor over a ``meta`` shard of rank 0's shape, laid
    out by the bundle's ``in_shardings``; ``bundle.fn`` alone runs under
    ``launch/hlo.StepCounter``, which counts rank 0's local ops and the
    ``_c10d_functional`` collectives DTensor inserts (a collective's
    result bytes, twice that for an all-reduce, as JAX's walk counts
    them).  ``collectives`` gives each collective's count and bytes;
    ``1x1`` runs the plain step with no process group (collective bytes
    0);
  * the layouts are the port's: DTensor picks each op's layout from the
    placements it is given, where XLA's partitioner picks its own, so
    the collectives may differ from JAX's even where the FLOPs agree.
    The mesh is a ``"cpu"`` mesh, on which DTensor moves a shard from
    one dim to another by an all-gather and a slice where the cards
    (NCCL) run an all-to-all: such a move counts the gathered bytes;
  * a number here is a reckoning on ``meta`` (``"counted_on"``), not a
    measurement on a device.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multi-pod | --both-meshes | --one-card] \\
        [--rules default] [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch.hlo import StepCounter
from repro_torch.launch.mesh import HW, abstract_mesh
from repro_torch.launch.roofline import derive_roofline
from repro_torch.launch.steps import make_bundle
from repro_torch.nn import sharding as shd
from repro_torch.nn.sharding import RULE_SETS, NamedSharding

# the JAX package's assigned architectures (repro.configs.ASSIGNED)
ASSIGNED = [
    "grok-1-314b", "granite-34b", "rwkv6-1.6b", "minitron-8b",
    "llama3.2-1b", "gemma-7b", "seamless-m4t-large-v2",
    "llama4-scout-17b-a16e", "zamba2-7b", "internvl2-2b",
]

# JAX's single-pod and multi-pod meshes, and one card
MESHES: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}


def skip_reason(cfg, shape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("no sub-quadratic path: enc-dec cross-attention over the "
                "full 524k memory (see DESIGN.md §4)")
    return None


def _pairs(values, shardings):
    """(tensor, NamedSharding) for every leaf of two trees of one
    structure (dicts, tuples, lists; a None leaf holds nothing)."""
    if isinstance(shardings, NamedSharding):
        yield values, shardings
    elif isinstance(shardings, dict):
        if set(values) != set(shardings):
            raise ValueError(f"tree keys {sorted(values)} vs shardings "
                             f"{sorted(shardings)}")
        for k in shardings:
            yield from _pairs(values[k], shardings[k])
    elif isinstance(shardings, (tuple, list)):
        if len(values) != len(shardings):
            raise ValueError(f"{len(values)} values vs {len(shardings)} "
                             f"shardings")
        for v, s in zip(values, shardings):
            yield from _pairs(v, s)
    elif shardings is not None or values is not None:
        raise ValueError(f"no sharding for a {type(values).__name__}")


def _shard_leaves(values, shardings):
    """(per-device shape, dtype, bytes) of every leaf."""
    out = []
    for t, sh in _pairs(values, shardings):
        shape = sh.shard_shape(t.shape)
        n = 1
        for d in shape:
            n *= d
        out.append((shape, t.dtype, n * t.element_size()))
    return out


def resident_bytes(bundle, outputs) -> Dict[str, int]:
    """Per-device argument, output and aliased bytes of a step (JAX's
    ``memory_analysis`` fields): a donated argument leaf is aliased to an
    output leaf of its per-device shape and dtype, each output taken once."""
    args = [_shard_leaves(a, s) for a, s in
            zip(bundle.abstract_args, bundle.in_shardings)]
    outs = _shard_leaves(outputs, bundle.out_shardings)
    free = {}
    for shape, dtype, nb in outs:
        free[(shape, dtype)] = free.get((shape, dtype), 0) + 1
    alias = 0
    for i in bundle.donate_argnums:
        for shape, dtype, nb in args[i]:
            if free.get((shape, dtype), 0):
                free[(shape, dtype)] -= 1
                alias += nb
    return {"argument_size_in_bytes": sum(nb for a in args for *_, nb in a),
            "output_size_in_bytes": sum(nb for *_, nb in outs),
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": None}


@contextlib.contextmanager
def fake_world(size: int):
    """A ``"fake"`` process group of ``size`` ranks for the block, this
    process rank 0 (``FakeStore``: no peer is started and no byte moves).
    A fake group of that size already in place is used as it is; any
    other process group refuses the count."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != size:
            raise RuntimeError(
                f"the partitioned count needs a fake process group of "
                f"{size} ranks; this process holds a "
                f"{dist.get_backend()!r} group of {dist.get_world_size()}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank0_args(values, shardings, device_mesh):
    """``values`` (a tree of ``meta`` tensors) as DTensors on
    ``device_mesh``, each laid out by the ``NamedSharding`` at its place
    in ``shardings`` over a ``meta`` local tensor of rank 0's shard
    shape: the arguments as a mesh holds them, made without a scatter."""
    if isinstance(shardings, NamedSharding):
        from torch.distributed.tensor import DTensor
        local = torch.empty(shardings.shard_shape(values.shape),
                            dtype=values.dtype, device="meta")
        return DTensor.from_local(
            local, device_mesh, shd.placements(shardings.spec, device_mesh),
            run_check=False, shape=values.shape, stride=values.stride())
    if isinstance(shardings, dict):
        return {k: rank0_args(values[k], shardings[k], device_mesh)
                for k in shardings}
    if isinstance(shardings, (tuple, list)):
        return type(values)(rank0_args(v, s, device_mesh)
                            for v, s in zip(values, shardings))
    return values                       # a None leaf


def rank0_count(bundle, device_mesh, values=None):
    """(outputs, ``HloAnalysis``) of rank 0 running ``bundle.fn`` on
    ``device_mesh``: its arguments (``values``, by default the bundle's
    ``abstract_args``) laid out by ``rank0_args``, and only ``bundle.fn``
    under the counter."""
    args = rank0_args(bundle.abstract_args if values is None else values,
                      bundle.in_shardings, device_mesh)
    with StepCounter() as counter:
        outputs = bundle.fn(*args)
    return outputs, counter.analysis()


def count_step(cfg, shape, mesh: str, rules: str):
    """(bundle, outputs, rank 0's ``HloAnalysis``, count seconds) of one
    step on ``mesh`` (a name in ``MESHES``): with no process group on one
    card; else ``rank0_count`` on a fake world of the mesh's size."""
    dims, names = MESHES[mesh]
    if math.prod(dims) == 1:
        bundle = make_bundle(cfg, shape, abstract_mesh(dims, names),
                             RULE_SETS[rules])
        t0 = time.time()
        with StepCounter() as counter:
            outputs = bundle.fn(*bundle.abstract_args)
        return bundle, outputs, counter.analysis(), time.time() - t0
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(math.prod(dims)):
        dm = init_device_mesh("cpu", dims, mesh_dim_names=names)
        bundle = make_bundle(cfg, shape, dm, RULE_SETS[rules])
        t0 = time.time()
        outputs, hlo = rank0_count(bundle, dm)
        return bundle, outputs, hlo, time.time() - t0


def dryrun_one(arch: str, shape_name: str, *, mesh: str = "16x16",
               rules: str = "default", verbose: bool = True,
               overrides: Optional[dict] = None, tag: str = "") -> dict:
    """One combination's record: rank 0's count (``count_step``)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
           "rules": rules, "status": "ok",
           "overrides": overrides or {}, "tag": tag, "counted_on": "meta"}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    t0 = time.time()
    bundle, outputs, hlo, t_count = count_step(cfg, shape, mesh, rules)
    t_build = time.time() - t0 - t_count
    chips = math.prod(MESHES[mesh][0])

    mem = resident_bytes(bundle, outputs)
    hbm_resident = (mem["argument_size_in_bytes"]
                    + mem["output_size_in_bytes"]
                    - mem["alias_size_in_bytes"])
    rl = derive_roofline(
        cfg, shape, chips=chips,
        hlo_flops_per_device=hlo.flops,
        hlo_bytes_per_device=hlo.hbm_bytes,
        collective_bytes_per_device=hlo.collective_bytes)

    rec.update({
        "chips": chips,
        "build_s": round(t_build, 1),
        "count_s": round(t_count, 1),
        "per_device": "rank0",
        "hlo_flops_per_device": hlo.flops,
        "hlo_bytes_per_device": hlo.hbm_bytes,
        "collective_bytes_per_device": hlo.collective_bytes,
        "collectives": hlo.as_dict()["per_collective"],
        "memory_analysis": mem,
        "hbm_resident_bytes": hbm_resident,
        "fits_hbm": bool(hbm_resident <= HW["hbm_bytes"]),
        "roofline": rl.as_dict(),
    })
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh} ({rules}), "
              f"reckoned on meta: count {t_count:.1f}s, rank 0 of "
              f"{chips}: flops {hlo.flops:.3e}, bytes {hlo.hbm_bytes:.3e}, "
              f"collective bytes {hlo.collective_bytes:.3e}, "
              f"dominant={rl.dominant}, "
              f"resident={hbm_resident / 1e9:.2f}GB", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Count each step on meta tensors and reckon its "
                    "per-device residency and roofline terms (no device).")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    meshes = ap.add_mutually_exclusive_group()
    meshes.add_argument("--multi-pod", action="store_true")
    meshes.add_argument("--both-meshes", action="store_true")
    meshes.add_argument("--one-card", action="store_true")
    ap.add_argument("--rules", default="default", choices=sorted(RULE_SETS))
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    mesh_names = (["16x16", "2x16x16"] if args.both_meshes
                  else ["2x16x16"] if args.multi_pod
                  else ["1x1"] if args.one_card else ["16x16"])

    results = []
    for arch in archs:
        for shape_name in shapes:
            for mesh in mesh_names:
                tag = f"{arch}__{shape_name}__{mesh}__{args.rules}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] skip existing {tag}")
                    continue
                try:
                    rec = dryrun_one(arch, shape_name, mesh=mesh,
                                     rules=args.rules)
                except Exception as e:  # noqa: BLE001  (one record each)
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
                           "rules": args.rules, "status": "error",
                           "counted_on": "meta",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-3000:]}
                    print(f"[dryrun] ERROR {tag}: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                results.append(rec)

    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    er = sum(1 for r in results if r["status"] == "error")
    print(f"[dryrun] done: {ok} ok, {sk} skipped, {er} errors")
    return results


if __name__ == "__main__":
    main()
