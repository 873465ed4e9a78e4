"""CLI: python -m repro_torch.sim.run --scenario channel-drift --devices 8
--rounds 5 [--engine sync|async-gossip] [--trace] [--device cpu]

The port's ``python -m repro.sim.run``: the reference's flags and
defaults, plus ``--device`` (the GPU unless ``--device cpu``).  Runs a
scenario under the chosen execution mode and writes the per-round JSONL
metrics log (schema: ``repro_torch.sim.metrics``, the reference's), then
prints the reference's end-of-run summary.  ``--mesh k`` shards the
pool over k local devices of ``--device``'s type (more shards than the
host has is an error; emulating k shards on one device is the Python
API's ``SimulationEngine(cfg, emulate=True)``); ``--autotune`` needs
``--autotune-model`` (the port ships no fitted cost model).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Tuple

import numpy as np

from repro_torch.sim.engine import SimConfig, SimulationEngine
from repro_torch.sim.executors import EXECUTORS
from repro_torch.sim.scenarios import SCENARIOS

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.run",
        description="Time-evolving decentralized ST-LF network simulator")
    p.add_argument("--scenario", default="channel-drift",
                   choices=sorted(SCENARIOS))
    p.add_argument("--engine", default="sync", choices=sorted(EXECUTORS),
                   help="execution mode (see repro_torch.sim.executors)")
    p.add_argument("--mesh", type=int, default=0,
                   help="device-pool backend: 0 = single device "
                        "(default); k >= 1 = pool axis sharded over a "
                        "k-shard 'devices' mesh (k > 1 needs that many "
                        "local devices of --device's type; the Python "
                        "API emulates k shards on one device with "
                        "SimulationEngine(cfg, emulate=True))")
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--rounds", type=int, default=5,
                   help="global rounds (sync) / ticks (async-gossip)")
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
                        "refresh every round (the benchmark reference)")
    p.add_argument("--div-budget", type=int, default=-1,
                   help="max dirty pairs re-estimated per tick; "
                        "-1: n_active, 0: unbounded")
    p.add_argument("--div-key-mode", default="positional",
                   choices=("positional", "content"),
                   help="Algorithm-1 PRNG addressing: positional "
                        "(historical) or content — estimates become a "
                        "deterministic function of (pair, data)")
    p.add_argument("--drift-frac", type=float, default=0.5,
                   help="feature-drift: fraction of devices designated "
                        "as drifters")
    p.add_argument("--drift-p", type=float, default=0.3,
                   help="feature-drift: per-drifter per-tick drift "
                        "probability")
    p.add_argument("--drift-step", type=float, default=0.15,
                   help="feature-drift: domain-mix increment per drift "
                        "step")
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
    # async-gossip knobs
    p.add_argument("--tick-periods", default="1,2,4",
                   help="comma-separated local clock periods devices "
                        "sample from (async-gossip)")
    p.add_argument("--gossip-pairs", type=int, default=-1,
                   help="gossip meetings per tick; -1: n_active//4")
    p.add_argument("--gossip-topology", default="uniform",
                   choices=("uniform", "ring", "k-regular"),
                   help="meeting graph the gossip pairs are drawn from")
    p.add_argument("--gossip-degree", type=int, default=4,
                   help="neighbor degree of the k-regular topology")
    p.add_argument("--no-train-gather", action="store_true",
                   help="async: keep the masked full-pool training step "
                        "instead of gathering eligible lanes compactly")
    p.add_argument("--gossip-mix", type=float, default=0.5,
                   help="blend step of a gossip model exchange")
    p.add_argument("--resolve-patience", type=int, default=10,
                   help="staleness bound in ticks that forces a warm "
                        "re-solve (async-gossip; <=0 disables)")
    p.add_argument("--div-prior", type=float, default=1.0,
                   help="solver-input divergence for never-estimated "
                        "pairs (async measures lazily; <=0 disables)")
    # checkpoint / resume
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="crash-consistent run snapshot every k rounds "
                        "(default: off)")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default: <out>.ckpt "
                        "when checkpointing or resuming)")
    p.add_argument("--ckpt-keep", type=int, default=3,
                   help="retention: keep the newest k checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest readable checkpoint "
                        "in --ckpt-dir; the resumed run reproduces the "
                        "uninterrupted trajectory bit-for-bit")
    p.add_argument("--kill-after", type=int, default=-1,
                   help="crash-injection test hook: SIGKILL this "
                        "process after completing (and checkpointing) "
                        "round k (-1: off)")
    # fault injection (active under --scenario faulty)
    p.add_argument("--fault-seed", type=int, default=-1,
                   help="fault-schedule PRNG seed (-1: seed+5)")
    p.add_argument("--fault-crash-p", type=float, default=0.15,
                   help="per-tick device-crash probability")
    p.add_argument("--fault-rejoin-after", type=int, default=2,
                   help="outage length of a crashed device, in ticks")
    p.add_argument("--fault-shard-p", type=float, default=0.1,
                   help="per-tick shard-loss probability (mesh runs)")
    p.add_argument("--fault-op-p", type=float, default=0.2,
                   help="per-tick transient pool-op failure probability")
    p.add_argument("--fault-gossip-drop-p", type=float, default=0.15,
                   help="per-exchange gossip model-drop probability "
                        "(async-gossip)")
    p.add_argument("--fault-retries", type=int, default=3,
                   help="bounded-retry budget for transient pool-op "
                        "failures")
    # trace / autotune (repro_torch.sim.trace)
    p.add_argument("--trace", action="store_true",
                   help="record per-phase wall-clock events (fills the "
                        "*_wall_s metrics fields; no effect on the draws)")
    p.add_argument("--trace-out", default=None,
                   help="also stream raw trace events to this JSONL "
                        "file (implies --trace)")
    p.add_argument("--gather-floor", type=int, default=4,
                   help="async subset-gather bucket floor (power-of-two "
                        "widths start here; an autotuner knob)")
    p.add_argument("--autotune", action="store_true",
                   help="before running, search mesh/div-budget/gather-"
                        "floor/resolve-patience against the fitted cost "
                        "model and apply the cheapest predicted config "
                        "(needs --autotune-model)")
    p.add_argument("--autotune-model", default=None,
                   help="cost model source for --autotune (required: "
                        "the port ships none): a model JSON or a raw "
                        "trace .jsonl recorded on this machine "
                        "(--trace-out)")
    p.add_argument("--out", default=None,
                   help="JSONL metrics path (default: results/sim/"
                        "<scenario>[-<engine>]-n<devices>-r<rounds>"
                        ".jsonl)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; no silent CPU run)")
    return p


def parse_args(p: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse ``argv``; exit through ``p.error`` for ``--autotune``
    without a model."""
    args = p.parse_args(argv)
    if args.autotune and not args.autotune_model:
        p.error("--autotune needs --autotune-model: the port ships no "
                "cost model (the reference's BENCH_trace.json was fitted "
                "on another machine); record a trace with --trace-out "
                "and pass it")
    return args


def config_from_args(args: argparse.Namespace) -> SimConfig:
    """The SimConfig the reference's CLI builds from the same flags."""
    tag = "" if args.engine == "sync" else f"-{args.engine}"
    out = args.out or os.path.join(
        "results", "sim",
        f"{args.scenario}{tag}-n{args.devices}-r{args.rounds}.jsonl")
    return SimConfig(
        scenario=args.scenario, engine=args.engine, devices=args.devices,
        rounds=args.rounds, seed=args.seed, setting=args.setting,
        samples_per_device=args.samples, train_iters=args.train_iters,
        div_tau=args.div_tau, div_T=args.div_T,
        div_refresh=args.div_refresh, div_budget=args.div_budget,
        div_key_mode=args.div_key_mode,
        feature_drift_frac=args.drift_frac, feature_drift_p=args.drift_p,
        feature_drift_step=args.drift_step, batch=args.batch,
        lr=args.lr, resolve_threshold=args.threshold,
        link_thresh=args.link_thresh,
        reseed_on_rejoin=not args.no_reseed,
        solver_max_outer=args.solver_max_outer,
        solver_inner_steps=args.solver_inner_steps,
        tick_periods=tuple(int(x) for x in
                           args.tick_periods.split(",") if x.strip()),
        gossip_pairs=args.gossip_pairs, gossip_mix=args.gossip_mix,
        gossip_topology=args.gossip_topology,
        gossip_degree=args.gossip_degree,
        resolve_patience=args.resolve_patience,
        div_prior=args.div_prior,
        mesh=args.mesh, train_gather=not args.no_train_gather,
        checkpoint_every=args.checkpoint_every,
        ckpt_dir=args.ckpt_dir or (
            f"{out}.ckpt" if args.checkpoint_every or args.resume
            else None),
        ckpt_keep=args.ckpt_keep, resume=args.resume,
        kill_after=args.kill_after,
        fault_seed=args.fault_seed, fault_crash_p=args.fault_crash_p,
        fault_rejoin_after=args.fault_rejoin_after,
        fault_shard_p=args.fault_shard_p, fault_op_p=args.fault_op_p,
        fault_gossip_drop_p=args.fault_gossip_drop_p,
        fault_retries=args.fault_retries,
        trace=bool(args.trace or args.trace_out),
        trace_path=args.trace_out,
        train_gather_floor=args.gather_floor,
        log_path=out, verbose=not args.quiet)


def autotuned(cfg: SimConfig, model_path: str) -> SimConfig:
    """``--autotune``: the cheapest configuration the cost model fitted
    from ``model_path`` predicts (``trace.tune.autotune``)."""
    from repro_torch.sim.trace.model import CostModel
    from repro_torch.sim.trace.tune import autotune
    tuned = autotune(cfg, CostModel.from_bench(model_path))
    if tuned["knobs"]:
        print(f"[sim] autotune ({os.path.basename(model_path)}): "
              f"{tuned['knobs']} — predicted "
              f"{tuned['predicted_s']:.1f}s vs "
              f"{tuned['baseline_s']:.1f}s default "
              f"({tuned['n_candidates']} candidates)")
        return dataclasses.replace(cfg, **tuned["knobs"])
    print(f"[sim] autotune: default config already cheapest "
          f"(predicted {tuned['baseline_s']:.1f}s, "
          f"{tuned['n_candidates']} candidates)")
    return cfg


def summarize(args: argparse.Namespace, engine: SimulationEngine,
              rows: List[dict]):
    """The reference's end-of-run summary (plus the device)."""
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
    if args.engine == "async-gossip":
        trained = sum(r["n_trained"] for r in rows)
        meetings = sum(len(r["gossip"] or []) for r in rows)
        stale_resolves = sum(r["resolve_reason"] == "staleness"
                             for r in rows)
        stale_mean = np.mean([r["mean_staleness"] for r in rows]) \
            if rows else 0.0
        print(f"[sim] async: {trained} device-steps over {len(rows)} "
              f"ticks ({trained / max(len(rows), 1):.1f}/tick), "
              f"{meetings} gossip meetings, "
              f"{stale_resolves} staleness-triggered re-solves, "
              f"mean staleness {stale_mean:.2f}")
    drifted = sum(r["n_drifted"] for r in rows)
    if drifted:
        reest = sum(r["n_reestimated"] for r in rows)
        drift_resolves = sum(r["resolve_reason"] == "drift" for r in rows)
        print(f"[sim] drift: {drifted} feature-drift events, "
              f"{reest} pair re-estimates "
              f"({reest / max(len(rows), 1):.1f}/tick), "
              f"{drift_resolves} drift-triggered re-solves, "
              f"{rows[-1]['n_dirty_pairs']} dirty pairs at last tick")
    n_faults = sum(r["n_faults"] for r in rows)
    n_recovered = sum(r["n_recovered"] for r in rows)
    if n_faults or n_recovered or (rows and rows[-1]["resume_count"]):
        print(f"[sim] faults: {n_faults} injected, {n_recovered} "
              f"devices recovered; resumed "
              f"{rows[-1]['resume_count'] if rows else 0}x")
    if tgt:
        print(f"[sim] target accuracy: first={tgt[0]:.3f} "
              f"last={tgt[-1]:.3f}; total energy "
              f"{rows[-1]['energy_cum']:.3f}")
    print(f"[sim] metrics log: {engine.cfg.log_path}")


def simulate(argv=None) -> Tuple[SimulationEngine, List[dict]]:
    """The CLI's run: parse ``argv``, run the scenario, write the JSONL
    log, print the summary; returns the engine (its final state) and the
    rows."""
    p = build_parser()
    args = parse_args(p, argv)
    cfg = config_from_args(args)
    if args.autotune:
        cfg = autotuned(cfg, args.autotune_model)
    engine = SimulationEngine(cfg, device=args.device)
    rows = engine.run()
    summarize(args, engine, rows)
    return engine, rows


def main(argv=None) -> int:
    simulate(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
