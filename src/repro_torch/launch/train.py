"""End-to-end training entry point: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m \\
        --steps 300 --batch 8 --seq 512 [--ckpt-dir ckpts/100m] \\
        [--devices N --model-axis M] [--device cpu]

It runs on the GPU unless ``--device cpu`` is given.  ``--devices`` and
``--model-axis`` are JAX's (``src/repro/launch/train.py:55-82``): the
step runs on a ('data', 'model') mesh of ``--devices`` devices (default:
every card the host has; one on the CPU) with ``--model-axis`` of them
on the model axis (default 1), the devices past a multiple of it
dropped as JAX drops them.  More than one device starts one rank a
device (``launch.mesh.launch``: ``gloo`` ranks on the CPU, one card a
rank under ``nccl``), and the step runs on DTensor parameters laid out
by the default rules (``launch.steps.make_train_bundle`` and
``on_mesh``); rank 0 prints the ``[train]`` lines, checkpoints hold
full tensors, and a restore distributes them.  On a CPU mesh the
weights equal a one-device run's; on the cards each rank draws its own
shards (``LMBase.init``).  As in JAX:
``remat`` is off when ``seq * batch <= 8192``; the step is
``launch.steps.make_train_step``'s at the constant ``--lr`` with fp32
moments, and the ``linear_warmup_cosine`` optimizer built beside it only
makes the initial state; a restore brings back the parameters only
(Adam's moments restart at zero); batch ``i`` is
``LMStream(...).sample(batch, seq, seed=i + 1)``, the tokens JAX sees
(where JAX runs: its stream needs a vocabulary of 2048 or more).
Weights are drawn from seed 0 on a generator on the run's device (JAX's
``PRNGKey(0)`` draws cannot be reproduced in torch).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import LMStream, LMStreamConfig
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import (make_train_bundle, make_train_step,
                                      on_mesh)
from repro_torch.models.api import build_model
from repro_torch.nn import param as P
from repro_torch.nn import sharding as shd
from repro_torch.optim import adamw, linear_warmup_cosine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train an LM of the port on the synthetic LMStream, on "
                    "one device or on JAX's ('data', 'model') mesh of "
                    "--devices devices (one rank a device).")
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--devices", type=int, default=None,
                    help="devices in the mesh (default: every card; 1 on "
                         "the CPU)")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config of the arch family")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap


def main(argv=None) -> Dict[str, Any]:
    """Train, printing JAX's ``[train]`` lines.  Returns what the run
    measured: the logged losses by step, the first step's seconds and the
    later steps' (host clock between synchronizes, checkpoint writes
    left out), and ``restored``, the parameters as a restore brought them
    back (None without one).  On a mesh it is rank 0's, with full
    tensors on the CPU."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    n = args.devices if args.devices is not None else \
        (torch.cuda.device_count() if dev.type == "cuda" else 1)
    shape = mesh_lib.mesh_shape(n, args.model_axis)
    if shape == (1, 1):
        return _train(args, dev, None)
    return mesh_lib.launch(_rank_main, shape[0] * shape[1],
                           device_type=dev.type, args=(argv,),
                           timeout=None)[0]


def _rank_main(argv) -> Optional[Dict[str, Any]]:
    """One rank of a mesh run: the same run on its shards; rank 0 returns
    the measurements, the parameters and the state as full CPU
    tensors."""
    args = _parser().parse_args(argv)
    dev = torch.device("cpu") if resolve_device(args.device).type == "cpu" \
        else torch.device("cuda", torch.cuda.current_device())
    dm = mesh_lib.make_device_mesh(args.model_axis, device_type=dev.type)
    out = _train(args, dev, dm)
    full = {k: P.tree_map(lambda t: t.cpu(), shd.full(out[k]))
            if out[k] is not None else None
            for k in ("params", "opt_state", "restored")}
    return {**out, **full} if dm.get_rank() == 0 else None


def _train(args, dev: torch.device, dm) -> Dict[str, Any]:
    """The training loop, on ``dev`` alone (``dm`` None) or as one rank of
    the ``DeviceMesh`` ``dm``."""
    lead = dm is None or dm.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, remat=False) \
        if args.seq * args.batch <= 8192 else cfg

    model = build_model(cfg)
    opt = adamw(linear_warmup_cosine(args.lr, 20, args.steps),
                weight_decay=0.1)
    gen = torch.Generator(device=dev).manual_seed(0)
    if dm is None:
        step_fn = make_train_step(cfg, lr=args.lr,
                                  opt_state_dtype=torch.float32)
        params = model.init(gen, device=dev)
        where = f"device {dev}"
    else:
        rules = shd.DEFAULT_RULES
        bundle = make_train_bundle(
            cfg, InputShape("local", args.seq, args.batch, "train"), dm,
            rules, lr=args.lr, opt_state_dtype=torch.float32)
        step_fn = on_mesh(bundle, dm)
        params = model.init(gen, dev, mesh=dm, rules=rules)
        where = (f"mesh {dict(zip(dm.mesh_dim_names, dm.shape))}, "
                 f"{dev.type}")
    opt_state = opt.init(params)
    start, restored = 0, None
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        restored = restore_checkpoint(args.ckpt_dir, shd.full(params),
                                      step=start)
        params = restored if dm is None else shd.distribute(
            restored, bundle.in_shardings[0], dm)
        say(f"[train] restored step {start} from {args.ckpt_dir}")

    # JAX's stream draws 2048 distinct tokens a topic, which a vocabulary
    # under 2048 (every --smoke config's 1024) cannot give: JAX's --smoke
    # raises there; the port draws a topic from the whole vocabulary
    stream = LMStream(LMStreamConfig(
        vocab_size=cfg.vocab_size,
        topic_vocab=min(LMStreamConfig.topic_vocab, cfg.vocab_size)))
    n_params = P.count_params(params)
    say(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, {where}, "
        f"batch {args.batch} x seq {args.seq}")
    losses: Dict[int, float] = {}
    first_s: Optional[float] = None
    ckpt_s = 0.0
    _sync(dev)
    t0 = t_first = time.perf_counter()
    for step in range(start, args.steps):
        toks, labs = stream.sample(args.batch, args.seq, seed=step + 1)
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 "labels": torch.as_tensor(labs, device=dev)}
        params, opt_state, loss, metrics = step_fn(params, opt_state, batch)
        if step == start:
            _sync(dev)
            t_first = time.perf_counter()
            first_s = t_first - t0
        if (step + 1) % args.log_every == 0 or step == start:
            loss_v = float(shd.full(loss))
            dt = time.perf_counter() - t0
            tok_s = args.batch * args.seq * (step + 1 - start) / dt
            say(f"[train] step {step+1}: loss {loss_v:.4f} "
                f"ce {float(shd.full(metrics['ce'])):.4f} "
                f"({tok_s:.0f} tok/s)")
            if not math.isfinite(loss_v):
                raise FloatingPointError(f"[train] step {step + 1}: loss "
                                         f"diverged ({loss_v})")
            losses[step + 1] = loss_v
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            t_ck = time.perf_counter()
            whole, loss_v = shd.full(params), float(shd.full(loss))
            if lead:
                save_checkpoint(args.ckpt_dir, step + 1, whole,
                                metadata={"loss": loss_v})
            ckpt_s += time.perf_counter() - t_ck
    _sync(dev)
    t_end = time.perf_counter()
    later = args.steps - start - 1
    step_s = (t_end - t_first - ckpt_s) / later if later > 0 else None
    say(f"[train] done in {t_end - t0:.1f}s")
    if step_s is not None:
        say(f"[train] first step {first_s * 1e3:.1f} ms; steps "
            f"{start + 2}-{args.steps}: {step_s * 1e3:.2f} ms a step, "
            f"{args.batch * args.seq / step_s:.0f} tokens/s (host clock "
            f"between synchronizes, checkpoint writes {ckpt_s:.2f} s "
            f"left out)")
    return {"cfg": cfg, "start": start, "steps": args.steps,
            "losses": losses, "first_step_s": first_s, "step_s": step_s,
            "ckpt_s": ckpt_s, "wall_s": t_end - t0, "n_params": n_params,
            "params": params, "opt_state": opt_state, "restored": restored}


if __name__ == "__main__":
    main()
