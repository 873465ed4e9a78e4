"""Batched-decode serving driver: feed a prompt batch through the KV-cache
decode step token by token, then decode greedily (or by sampling).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        [--smoke] --batch 4 --prompt-len 64 --gen 32 [--device cpu]

The port of ``repro.launch.serve``.  It runs on the GPU unless
``--device cpu`` is given.  Weights are drawn from seed 0 on a generator
on the run's device; prompts come from ``np.random.default_rng(0)``, as
in the JAX driver.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model


@torch.no_grad()
def generate(model, params, prompts: torch.Tensor, gen_len: int,
             cache_len: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompts: (B, S) int.  Greedy (or sampled) decode; returns (B,
    gen_len) generated tokens.

    The prompt goes through ``decode_step`` token by token, as in JAX:
    ``prefill`` gives last-token logits but no cache.  Sampling at
    ``temperature > 0`` draws from ``generator`` (its own stream, not
    JAX's)."""
    b, s = prompts.shape
    dev = prompts.device
    cache = model.init_cache(b, cache_len, device=dev)

    def step(tok, pos):
        return model.decode_step(params, cache, {
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len)),
        device=dev)
    t0 = time.perf_counter()
    toks = generate(model, params, prompts, args.gen,
                    args.prompt_len + args.gen, temperature=args.temperature,
                    generator=torch.Generator(device=dev).manual_seed(0))
    toks = toks.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name} on {dev}: generated {args.batch}x{args.gen} "
          f"tokens in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    print("[serve] sample token ids:", toks[0][:16])
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise RuntimeError("generated token ids out of range")


if __name__ == "__main__":
    main()
