"""CLI: python -m repro_torch.sim.run --scenario channel-drift --devices 8
--rounds 5 [--trace] [--device cpu]

The port's ``python -m repro.sim.run``: the reference's flags and
defaults for the ported features, plus ``--device`` (the GPU unless
``--device cpu``).  Runs a scenario under the sync executor and writes
the per-round JSONL metrics log (schema: ``repro_torch.sim.metrics``,
the reference's), then prints a short end-of-run summary.  The
reference's flags of features not ported yet are refused with an error
naming their ROADMAP.md item, never ignored.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Tuple

import numpy as np

from repro_torch.sim.engine import SimConfig, SimulationEngine
from repro_torch.sim.executors import EXECUTORS
from repro_torch.sim.executors import NOT_PORTED as EXEC_NOT_PORTED
from repro_torch.sim.scenarios import NOT_PORTED as SCEN_NOT_PORTED
from repro_torch.sim.scenarios import SCENARIOS

ITEM3 = "queue 1 item 3 (async and drift)"
ITEM4 = "queue 1 item 4 (robustness and trace)"
#: the reference's flags of features not ported yet -> the ROADMAP.md
#: item that brings them.  The parser does not declare them: each is
#: added with its feature, and until then asking for one is refused.
NOT_PORTED_FLAGS = {
    "--mesh": "queue 1 item 5 (sharded pool)",
    **dict.fromkeys((
        "--div-key-mode", "--drift-frac", "--drift-p", "--drift-step",
        "--tick-periods", "--gossip-pairs", "--gossip-topology",
        "--gossip-degree", "--no-train-gather", "--gossip-mix",
        "--resolve-patience", "--div-prior", "--gather-floor"), ITEM3),
    **dict.fromkeys((
        "--checkpoint-every", "--ckpt-dir", "--ckpt-keep", "--resume",
        "--kill-after", "--fault-seed", "--fault-crash-p",
        "--fault-rejoin-after", "--fault-shard-p", "--fault-op-p",
        "--fault-gossip-drop-p", "--fault-retries", "--autotune",
        "--autotune-model"), ITEM4),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.run",
        description="Time-evolving decentralized ST-LF network simulator")
    p.add_argument("--scenario", default="channel-drift",
                   choices=sorted(set(SCENARIOS) | set(SCEN_NOT_PORTED)))
    p.add_argument("--engine", default="sync",
                   choices=sorted(set(EXECUTORS) | set(EXEC_NOT_PORTED)),
                   help="execution mode (see repro_torch.sim.executors)")
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--rounds", type=int, default=5, help="global rounds")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--setting", default="M//MM",
                   help="dataset manipulation (see data.build_network)")
    p.add_argument("--samples", type=int, default=100,
                   help="samples per device")
    p.add_argument("--train-iters", type=int, default=30,
                   help="local SGD iterations per round")
    p.add_argument("--div-tau", type=int, default=1,
                   help="Algorithm-1 exchange rounds per estimate")
    p.add_argument("--div-T", type=int, default=8,
                   help="Algorithm-1 local iterations per exchange")
    p.add_argument("--div-refresh", default="dirty",
                   choices=("dirty", "all"),
                   help="drift re-estimation policy: budgeted dirty-pair "
                        "tracking (default) or the naive all-active-pairs "
                        "refresh every round")
    p.add_argument("--div-budget", type=int, default=-1,
                   help="max dirty pairs re-estimated per tick; "
                        "-1: n_active, 0: unbounded")
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--threshold", type=float, default=0.05,
                   help="drift threshold that triggers a re-solve")
    p.add_argument("--link-thresh", type=float, default=1e-3,
                   help="alpha weight above which a link counts active")
    p.add_argument("--no-reseed", action="store_true",
                   help="disable churn-robust re-seeding of (re)joining "
                        "devices from the current best source mixture")
    p.add_argument("--solver-max-outer", type=int, default=8)
    p.add_argument("--solver-inner-steps", type=int, default=600)
    p.add_argument("--trace", action="store_true",
                   help="record per-phase wall-clock events (fills the "
                        "*_wall_s metrics fields; no effect on the draws)")
    p.add_argument("--trace-out", default=None,
                   help="also stream raw trace events to this JSONL "
                        "file (implies --trace)")
    p.add_argument("--out", default=None,
                   help="JSONL metrics path (default: results/sim/"
                        "<scenario>-n<devices>-r<rounds>.jsonl)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; no silent CPU run)")
    return p


def parse_args(p: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse ``argv``; exit through ``p.error`` when a scenario, engine
    or flag of a feature not ported yet was asked for."""
    args, extra = p.parse_known_args(argv)
    for tok in extra:
        flag = tok.split("=", 1)[0]
        if flag in NOT_PORTED_FLAGS:
            p.error(f"{flag} is not ported to repro_torch yet "
                    f"(ROADMAP.md {NOT_PORTED_FLAGS[flag]})")
    if extra:
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.scenario in SCEN_NOT_PORTED:
        p.error(f"scenario {args.scenario!r} is not ported to repro_torch "
                f"yet (ROADMAP.md {SCEN_NOT_PORTED[args.scenario]})")
    if args.engine in EXEC_NOT_PORTED:
        p.error(f"engine {args.engine!r} is not ported to repro_torch yet "
                f"(ROADMAP.md {EXEC_NOT_PORTED[args.engine]})")
    return args


def simulate(argv=None) -> Tuple[SimulationEngine, List[dict]]:
    """The CLI's run: parse ``argv``, run the scenario, write the JSONL
    log, print the summary; returns the engine (its final state) and the
    rows."""
    p = build_parser()
    args = parse_args(p, argv)
    out = args.out or os.path.join(
        "results", "sim",
        f"{args.scenario}-n{args.devices}-r{args.rounds}.jsonl")
    cfg = SimConfig(
        scenario=args.scenario, engine=args.engine, devices=args.devices,
        rounds=args.rounds, seed=args.seed, setting=args.setting,
        samples_per_device=args.samples, train_iters=args.train_iters,
        div_tau=args.div_tau, div_T=args.div_T,
        div_refresh=args.div_refresh, div_budget=args.div_budget,
        batch=args.batch, lr=args.lr, resolve_threshold=args.threshold,
        link_thresh=args.link_thresh,
        reseed_on_rejoin=not args.no_reseed,
        solver_max_outer=args.solver_max_outer,
        solver_inner_steps=args.solver_inner_steps,
        trace=bool(args.trace or args.trace_out),
        trace_path=args.trace_out,
        log_path=out, verbose=not args.quiet)
    engine = SimulationEngine(cfg, device=args.device)
    rows = engine.run()

    resolves = [r for r in rows if r["resolved"]]
    warm_iters = [r["solver_iters"] for r in resolves if r["warm"]]
    cold_iters = [r["solver_iters"] for r in resolves if not r["warm"]]
    tgt = [r["mean_target_acc"] for r in rows
           if np.isfinite(r["mean_target_acc"])]
    print(f"\n[sim] {args.scenario} ({args.engine}, "
          f"pool={engine.pool.name}, device={engine.device}): "
          f"{len(rows)} rounds, {len(resolves)} re-solves "
          f"({len(warm_iters)} warm, mean "
          f"{np.mean(warm_iters) if warm_iters else 0:.1f} outer iters; "
          f"{len(cold_iters)} cold, mean "
          f"{np.mean(cold_iters) if cold_iters else 0:.1f})")
    if tgt:
        print(f"[sim] target accuracy: first={tgt[0]:.3f} "
              f"last={tgt[-1]:.3f}; total energy "
              f"{rows[-1]['energy_cum']:.3f}")
    print(f"[sim] metrics log: {out}")
    return engine, rows


def main(argv=None) -> int:
    simulate(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
