"""Batched-decode serving driver: feed a prompt batch through the KV-cache
decode step token by token, then decode greedily (or by sampling).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        [--smoke] --batch 4 --prompt-len 64 --gen 32 [--devices N] \
        [--device cpu]

The port of ``repro.launch.serve``.  It runs on the GPU unless
``--device cpu`` is given.  Weights are drawn from seed 0 on a generator
on the run's device; prompts come from ``np.random.default_rng(0)``, as
in the JAX driver.  As JAX's ``make_local_mesh()``
(``src/repro/launch/serve.py:71-76``) it serves on a data mesh over
every device the host has (``--devices``, default every card, one on
the CPU): with more than one, one rank a device
(``launch.mesh.launch``), each decoding its rows of the batch through
the decode bundle on DTensor (``generate``'s ``ctx``); rank 0 prints.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import make_decode_bundle, on_mesh
from repro_torch.models.api import build_model
from repro_torch.nn import sharding as shd
from repro_torch.nn.layers import NO_SHARD, ShardCtx


@torch.no_grad()
def generate(model, params, prompts: torch.Tensor, gen_len: int,
             cache_len: int, ctx: ShardCtx = NO_SHARD,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompts: (B, S) int.  Greedy (or sampled) decode; returns (B,
    gen_len) generated tokens.

    The prompt goes through ``decode_step`` token by token, as in JAX:
    ``prefill`` gives last-token logits but no cache.  Sampling at
    ``temperature > 0`` draws from ``generator`` (its own stream, not
    JAX's).  With ``ctx`` on a ``DeviceMesh`` each step is the decode
    bundle's on the mesh (``on_mesh``): the parameters and the cache
    laid out by its shardings, the cache updated in place on each rank;
    the next token is picked from the gathered logits, the same on every
    rank."""
    b, s = prompts.shape
    dev = prompts.device
    cache = model.init_cache(b, cache_len, device=dev)
    if ctx.mesh is None:
        def decode(p, c, batch):
            return model.decode_step(p, c, batch)
    else:
        bundle = make_decode_bundle(
            model.cfg, InputShape("serve", cache_len, b, "decode"),
            ctx.mesh, ctx.rules)
        run = on_mesh(bundle, ctx.mesh)
        params = shd.distribute(params, bundle.in_shardings[0], ctx.mesh)
        cache = shd.distribute(cache, bundle.in_shardings[1], ctx.mesh)

        def decode(p, c, batch):
            logits, c = run(p, c, batch)
            return shd.full(logits), c

    def step(tok, pos):
        return decode(params, cache, {
            "token": tok, "pos": torch.full((b,), pos, device=dev)})[0]

    logits = None
    for i in range(s):
        logits = step(prompts[:, i:i + 1], i)
    out = []
    for j in range(gen_len):
        lg = logits[:, -1]
        if temperature > 0:
            nxt = torch.multinomial(torch.softmax(lg / temperature, -1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = torch.argmax(lg, dim=-1)
        out.append(nxt)
        logits = step(nxt[:, None], s + j)
    return torch.stack(out, dim=1)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--devices", type=int, default=None,
                    help="devices in the data mesh (default: every card; "
                         "1 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap


def main(argv=None) -> np.ndarray:
    """Serve, printing JAX's ``[serve]`` lines; returns the generated
    tokens (B, gen) (rank 0's on a mesh: every rank picks the same)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    n = args.devices if args.devices is not None else \
        (torch.cuda.device_count() if dev.type == "cuda" else 1)
    if n == 1:
        return _serve(args, dev, NO_SHARD)
    return mesh_lib.launch(_rank_main, n, device_type=dev.type,
                           args=(argv,), timeout=None)[0]


def _rank_main(argv) -> np.ndarray:
    """One rank of a served data mesh."""
    args = _parser().parse_args(argv)
    dev = torch.device("cpu") if resolve_device(args.device).type == "cpu" \
        else torch.device("cuda", torch.cuda.current_device())
    dm = mesh_lib.make_device_mesh(device_type=dev.type)
    return _serve(args, dev, ShardCtx(dm, shd.DEFAULT_RULES))


def _serve(args, dev: torch.device, ctx: ShardCtx) -> np.ndarray:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, device=dev) if ctx.mesh is None else \
        model.init(gen, dev, mesh=ctx.mesh, rules=ctx.rules)
    lead = ctx.mesh is None or ctx.mesh.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len)),
        device=dev)
    t0 = time.perf_counter()
    toks = generate(model, params, prompts, args.gen,
                    args.prompt_len + args.gen, ctx,
                    temperature=args.temperature,
                    generator=torch.Generator(device=dev).manual_seed(0))
    toks = toks.cpu().numpy()
    dt = time.perf_counter() - t0
    where = dev if ctx.mesh is None else \
        f"mesh {dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.shape))}"
    say(f"[serve] {cfg.name} on {where}: generated {args.batch}x{args.gen} "
        f"tokens in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    say("[serve] sample token ids:", toks[0][:16])
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise RuntimeError("generated token ids out of range")
    return toks


if __name__ == "__main__":
    main()
