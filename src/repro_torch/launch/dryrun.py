"""Dry run: count every (arch x input-shape x mesh) combination's step on
``meta`` tensors (no allocation, no card), reckon each device's resident
bytes from the sharding rules, and emit the roofline terms.  The port of
``repro.launch.dryrun``, which lowers and compiles each step for 512
forced host devices.

What a record holds, and how it differs from JAX's:
  * per-device resident bytes are exact: the step's arguments plus its
    outputs minus what ``donate_argnums`` lets the outputs reuse, each
    leaf at its ``NamedSharding.shard_shape`` (JAX's ``hbm_resident``
    without the temporaries, which a trace on ``meta`` cannot see:
    ``temp_size_in_bytes`` is null);
  * FLOPs and bytes are counted over the whole step
    (``launch/hlo.analyze_step``) and split evenly over the chips
    (``"per_device": "even_split"``): the port runs no partitioner, so a
    partitioned count waits for execution on a mesh (ROADMAP queue 1,
    item 6.8).  ``collective_bytes_per_device`` is null on a mesh larger
    than one card, 0 on ``1x1``;
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
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch.hlo import StepCounter
from repro_torch.launch.mesh import HW, abstract_mesh
from repro_torch.launch.roofline import derive_roofline
from repro_torch.launch.steps import make_bundle
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


def dryrun_one(arch: str, shape_name: str, *, mesh: str = "16x16",
               rules: str = "default", verbose: bool = True,
               overrides: Optional[dict] = None, tag: str = "",
               memo: Optional[dict] = None) -> dict:
    """One combination's record.  ``memo`` (a dict the caller keeps)
    carries a step's count to the next mesh: the step, and so its count,
    does not depend on the mesh."""
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
    m = abstract_mesh(*MESHES[mesh])
    chips = m.size
    bundle = make_bundle(cfg, shape, m, RULE_SETS[rules])
    t_build = time.time() - t0
    key = (arch, shape_name, repr(sorted((overrides or {}).items())))
    if memo is not None and key in memo:
        hlo, outputs, t_count = memo[key]
    else:
        with StepCounter() as counter:
            outputs = bundle.fn(*bundle.abstract_args)
        t_count = time.time() - t0 - t_build
        hlo = counter.analysis()
        if memo is not None:
            memo[key] = hlo, outputs, t_count

    mem = resident_bytes(bundle, outputs)
    hbm_resident = (mem["argument_size_in_bytes"]
                    + mem["output_size_in_bytes"]
                    - mem["alias_size_in_bytes"])
    coll = 0.0 if chips == 1 else None
    rl = derive_roofline(
        cfg, shape, chips=chips,
        hlo_flops_per_device=hlo.flops / chips,
        hlo_bytes_per_device=hlo.hbm_bytes / chips,
        collective_bytes_per_device=coll)

    rec.update({
        "chips": chips,
        "build_s": round(t_build, 1),
        "count_s": round(t_count, 1),
        "flops_total": hlo.flops,
        "hbm_bytes_total": hlo.hbm_bytes,
        "per_device": "even_split",
        "hlo_flops_per_device": hlo.flops / chips,
        "hlo_bytes_per_device": hlo.hbm_bytes / chips,
        "collective_bytes_per_device": coll,
        "memory_analysis": mem,
        "hbm_resident_bytes": hbm_resident,
        "fits_hbm": bool(hbm_resident <= HW["hbm_bytes"]),
        "roofline": rl.as_dict(),
    })
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh} ({rules}), "
              f"reckoned on meta: count {t_count:.1f}s, flops/dev "
              f"{rec['hlo_flops_per_device']:.3e}, bytes/dev "
              f"{rec['hlo_bytes_per_device']:.3e} (even split), "
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

    results, memo = [], {}
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
                                     rules=args.rules, memo=memo)
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
