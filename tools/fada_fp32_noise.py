#!/usr/bin/env python3
"""How far float32 rounding alone moves FADA's discriminators, and how
far the card moves them from the CPU port, on the ST-LF main path's
full-size state.

    python3 tools/fada_fp32_noise.py [--device cuda] [--states 3] [--perturb 6]

FADA's domain gap (``repro_torch.fl.baselines._domain_gap``) trains one
logistic discriminator a (source, target) pair: 40 SGD steps at lr 0.05
on a CNN's frozen features, then counts the rows it gets wrong.  This
builds the state ``chip_smoke.py``'s main path builds (``M//MM``, 10
devices x 250 samples, 300 local steps) ``--states`` times on
``--device`` (on a card each build differs in cuDNN's rounding), and for
the 21 pairs of psi [1 1 1 1 1 1 0 0 1 0] (the psi ST-LF decided in
every recorded run) and for all 90 ordered pairs, on the same draws,
prints two distances between two runs: the largest gap move in rows of
its pair (one row of a pair is 4 / (n_s + n_t) of its gap), and
max |w - w_ref| / max |w_ref|.  The runs are the device in float32 and
float64, the CPU port in float32 and float64 (the same code on float64
parameters and data), and the CPU port in float32 with its parameters
scaled by (1 + 6e-7 N(0, 1)) ``--perturb`` times (about the features'
card-against-CPU difference), and the CPU port in float64 with its
parameters scaled by (1 + 1e-15 N(0, 1)) once (how far a float64 run
moves).  The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

PSI = np.array([1, 1, 1, 1, 1, 1, 0, 0, 1, 0], dtype=float)
FADA_KW = dict(iters=40, batch=16, lr=0.05)
PERTURB = 6e-7
PERTURB64 = 1e-15


def _on(clients, params, device, dtype):
    """Clients and parameters on ``device``, floating point in ``dtype``."""
    def mv(t):
        return t.to(device=device, dtype=dtype if t.is_floating_point()
                    else t.dtype)
    return (type(clients)(**{f.name: mv(getattr(clients, f.name))
                             for f in dataclasses.fields(clients)}),
            {k: mv(v) for k, v in params.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--states", type=int, default=3)
    ap.add_argument("--perturb", type=int, default=6)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.data import build_network
    from repro_torch.device import resolve_device
    from repro_torch.fl import baselines as bl
    from repro_torch.fl import prepare_round
    from repro_torch.fl.divergence import pair_draws
    from repro_torch.rng import split_seed

    dev = resolve_device(args.device)          # TF32 off on a card
    devices = build_network("M//MM", num_devices=10, samples_per_device=250,
                            seed=0)
    n = len(PSI)
    srcs, tgts = np.flatnonzero(PSI == 0), np.flatnonzero(PSI == 1)
    sets = {"psi": tuple(a.ravel() for a in np.meshgrid(
                srcs, tgts, indexing="ij")),
            "all": tuple(np.array(a) for a in zip(*[
                (s, t) for s in range(n) for t in range(n) if s != t]))}
    gen = torch.Generator().manual_seed(0)
    out = []
    for k in range(args.states):
        t0 = time.perf_counter()
        state = prepare_round(devices, 0, train_iters=300, div_tau=4,
                              div_T=25, device=dev)
        counts = state.clients.counts.cpu().numpy()
        rec = {"state": k}
        for name, (si, ti) in sets.items():
            draws = pair_draws(split_seed(3, len(si)), counts[si],
                               counts[ti], steps=FADA_KW["iters"],
                               batch=FADA_KW["batch"])
            row = 4.0 / (counts[si] + counts[ti])

            def gap(c, p):
                g, w, _ = bl._domain_gap(p, c, si, ti, draws=draws,
                                         **FADA_KW)
                return g.double().cpu().numpy(), w.double().cpu()

            runs = {}
            for tag, d, dt in (("dev32", dev, torch.float32),
                               ("dev64", dev, torch.float64),
                               ("cpu32", "cpu", torch.float32),
                               ("cpu64", "cpu", torch.float64)):
                runs[tag] = gap(*_on(state.clients, state.params, d, dt))
            c32, p32 = _on(state.clients, state.params, "cpu", torch.float32)
            for j in range(args.perturb):
                runs[f"pert{j}"] = gap(c32, {
                    key: v * (1 + PERTURB * torch.randn(v.shape,
                                                        generator=gen))
                    for key, v in p32.items()})
            c64, p64 = _on(state.clients, state.params, "cpu", torch.float64)
            runs["pert64"] = gap(c64, {
                key: v * (1 + PERTURB64 * torch.randn(
                    v.shape, generator=gen, dtype=torch.float64))
                for key, v in p64.items()})

            def apart(a, b):
                (ga, wa), (gb, wb) = runs[a], runs[b]
                return [float((np.abs(ga - gb) / row).max()),
                        float((wa - wb).abs().max() / wb.abs().max())]

            rec[name] = {
                "dev32_vs_cpu32": apart("dev32", "cpu32"),
                "cpu32_vs_cpu64": apart("cpu32", "cpu64"),
                "dev32_vs_cpu64": apart("dev32", "cpu64"),
                "dev64_vs_cpu64": apart("dev64", "cpu64"),
                "pert_vs_cpu32": [apart(f"pert{j}", "cpu32")
                                  for j in range(args.perturb)],
                "pert_vs_cpu64": [apart(f"pert{j}", "cpu64")
                                  for j in range(args.perturb)],
                "pert64_vs_cpu64": apart("pert64", "cpu64")}
        rec["s"] = time.perf_counter() - t0
        out.append(rec)
        for name in sets:
            r = rec[name]
            print(f"[fada-noise] state {k} {name} ({len(sets[name][0])} "
                  f"pairs), [gap rows, w rel]: {args.device} f32 vs cpu f32 "
                  f"{r['dev32_vs_cpu32']}; cpu f32 vs cpu f64 "
                  f"{r['cpu32_vs_cpu64']}; {args.device} f32 vs cpu f64 "
                  f"{r['dev32_vs_cpu64']}; {args.device} f64 vs cpu f64 "
                  f"{r['dev64_vs_cpu64']}; perturbed f32 vs cpu f32, worst "
                  f"{np.max(r['pert_vs_cpu32'], 0).tolist()}; nudged f64 vs "
                  f"cpu f64 {r['pert64_vs_cpu64']}", flush=True)
    print(json.dumps({"device": str(dev), "perturb": PERTURB,
                      "perturb64": PERTURB64, "states": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
