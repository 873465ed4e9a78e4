"""Numpy copy of ``repro.sim.trace.replay`` (its CLI needs ``--model``:
the port has no default cost model, see ``trace.model``).

What-if replay: walk a scenario's control flow with the cost model.

``predict_run`` steps through the rounds/ticks a SimConfig WOULD
execute — the all-pairs Algorithm-1 bootstrap and cold solve of tick 0,
per-tick training (clock-eligibility-scaled under async), gossip
meetings, the budgeted dirty-pair refresh backlog of the drift
scenarios, churn-driven membership re-solves, staleness-gated async
re-solves, transfer, evaluation and checkpoints — charging each phase
its fitted cost (repro_torch.sim.trace.model) instead of running it.  Event
counts are deterministic EXPECTATIONS of the scenario's seeded
randomness (expected drifters per tick, expected joins, fractional
re-solves), so the prediction is a smooth function of the knobs and
consumes no PRNG.

Structural approximations, stated rather than hidden:

  - membership is held at ``cfg.devices`` (churn is modeled as expected
    re-solve + re-measurement load, not as a varying active count);
  - drift-gated re-solves are charged pessimistically: every tick whose
    refresh re-measured pairs is assumed to trip the gate (an upper
    bound on solver load — sustained drift does re-solve near-every
    tick at the default threshold);
  - one fitted ``solve`` cost covers warm and cold solves.

CLI (also reachable as ``python -m repro_torch.sim.replay``):

    python -m repro_torch.sim.replay --scenario feature-drift --n 64 \
        --model run.trace.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import List, Optional

from repro_torch.sim.trace.model import CostModel, read_trace

#: scenarios whose steady ticks re-solve (expected fraction per tick is
#: computed in _resolve_frac); everything else solves only on tick 0
DRIFT_SCENARIOS = ("feature-drift", "feature-drift-async")

PHASE_ORDER = ("train", "divergence", "solve", "transfer", "eval",
               "checkpoint")


def _bucket(n: int, cap: int, floor: int = 4) -> int:
    """Smallest power-of-two >= n with the configured floor, capped at
    the pool size — mirrors repro_torch.sim.shard.pool's subset-gather widths
    without importing the torch pool module."""
    w = max(1, int(floor))
    while w < n:
        w *= 2
    return max(1, min(w, cap))


def _mean_elig_frac(tick_periods) -> float:
    periods = list(tick_periods) or [1]
    return sum(1.0 / p for p in periods) / len(periods)


def _resolve_frac(cfg, t: int, refreshed: float) -> float:
    """Expected re-solves on steady tick ``t`` (tick 0 is always the
    cold solve and handled by the caller)."""
    frac = 0.0
    if cfg.scenario == "channel-drift":
        frac = 1.0 if cfg.drift_sigma > 0 else 0.0
    elif cfg.scenario == "device-churn":
        frac = min(1.0, cfg.churn_p_leave + cfg.churn_p_join)
    elif cfg.scenario == "faulty":
        frac = min(1.0, cfg.fault_crash_p + cfg.fault_shard_p)
    elif cfg.scenario in DRIFT_SCENARIOS and refreshed > 0:
        frac = 1.0
    if cfg.engine == "async-gossip" and cfg.resolve_patience > 0:
        frac = max(frac, 1.0 / cfg.resolve_patience)
    return frac


def predict_run(cfg, model: CostModel) -> dict:
    """Predicted per-round and end-to-end wall time for ``cfg`` (a
    SimConfig) under ``model``.  Returns per-round phase seconds, phase
    totals, ``round0_s`` / ``steady_mean_s`` and ``total_s``."""
    n = cfg.devices
    total_pairs = n * (n - 1) // 2
    is_async = cfg.engine == "async-gossip"
    ctx = {"n_devices": n, "mesh": cfg.mesh}

    train_ctx = dict(ctx)
    if is_async:
        elig = _mean_elig_frac(cfg.tick_periods) * n
        if cfg.mesh == 0 and cfg.train_gather:
            train_ctx["lanes"] = _bucket(int(round(elig)), n,
                                         cfg.train_gather_floor)
        # sharded async keeps the masked full-pool step: default lanes

    # drift-backlog expectations (feature-drift scenarios)
    drifting = cfg.scenario in DRIFT_SCENARIOS
    if drifting:
        k_drifters = max(1, round(cfg.feature_drift_frac * n))
        steps_to_sat = math.ceil(1.0 / max(cfg.feature_drift_step, 1e-9))
        t_sat = math.ceil(steps_to_sat / max(cfg.feature_drift_p, 1e-9))
        dirty_rate = k_drifters * cfg.feature_drift_p * (n - 1)
    backlog = 0.0
    budget = n if cfg.div_budget == -1 else \
        (float("inf") if cfg.div_budget == 0 else cfg.div_budget)

    gossip_pairs = 0
    if is_async:
        gossip_pairs = cfg.gossip_pairs if cfg.gossip_pairs > 0 \
            else max(n // 4, 1)
        gossip_pairs = min(gossip_pairs, n // 2)

    seen: set = set()

    def charge(phases: dict, phase: str, **extra):
        c = dict(ctx, **extra)
        first = phase not in seen
        seen.add(phase)
        phases[phase] = phases.get(phase, 0.0) \
            + model.predict(phase, c, first=first)

    per_round: List[dict] = []
    for t in range(cfg.rounds):
        phases: dict = {}
        charge(phases, "train", **{k: v for k, v in train_ctx.items()
                                   if k != "n_devices"})

        # ---- divergence load of the tick
        pairs = 0.0
        if t == 0 and not is_async:
            pairs += total_pairs          # sync all-pairs bootstrap
        if is_async and gossip_pairs:
            pairs += gossip_pairs         # lazy pairwise measurement
        if cfg.scenario == "device-churn" and t > 0 and not is_async:
            pairs += cfg.churn_p_join * (n - 1)   # joiner bootstraps
        refreshed = 0.0
        if drifting:
            new_dirty = min(dirty_rate if t < t_sat else 0.0,
                            total_pairs - backlog)
            refreshed = min(budget, backlog + new_dirty)
            backlog = backlog + new_dirty - refreshed
            pairs += refreshed
        if pairs > 0:
            charge(phases, "divergence", n_pairs=pairs)

        # ---- re-solve gate
        frac = 1.0 if t == 0 else _resolve_frac(cfg, t, refreshed)
        if frac > 0:
            first = "solve" not in seen
            seen.add("solve")
            phases["solve"] = frac * model.predict("solve", ctx,
                                                   first=first)

        charge(phases, "transfer")
        charge(phases, "eval")
        if cfg.checkpoint_every and (t + 1) % cfg.checkpoint_every == 0:
            charge(phases, "checkpoint")

        per_round.append({"round": t, "phase_s": phases,
                          "total_s": sum(phases.values())})

    totals = {p: sum(r["phase_s"].get(p, 0.0) for r in per_round)
              for p in PHASE_ORDER
              if any(p in r["phase_s"] for r in per_round)}
    steady = [r["total_s"] for r in per_round[1:]]
    return {
        "scenario": cfg.scenario, "engine": cfg.engine, "n": n,
        "mesh": cfg.mesh, "rounds": cfg.rounds,
        "per_round": per_round, "phase_totals_s": totals,
        "round0_s": per_round[0]["total_s"] if per_round else 0.0,
        "steady_mean_s": (sum(steady) / len(steady)) if steady else 0.0,
        "total_s": sum(r["total_s"] for r in per_round),
    }


# ---------------------------------------------------------------- CLI
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.replay",
        description="Predict a simulation's per-phase wall time from "
                    "the fitted cost model instead of running it")
    p.add_argument("--scenario", default="static")
    p.add_argument("--engine", default="sync",
                   choices=("sync", "async-gossip"))
    p.add_argument("--n", "--devices", dest="n", type=int, default=64)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--mesh", type=int, default=0)
    p.add_argument("--div-budget", type=int, default=-1)
    p.add_argument("--resolve-patience", type=int, default=10)
    p.add_argument("--gossip-pairs", type=int, default=-1)
    p.add_argument("--gather-floor", type=int, default=4)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--model", default=None,
                   help="cost model source (required): a model JSON, a "
                        "bench file with a 'model' key, or a .jsonl "
                        "trace to fit, recorded on the machine to "
                        "predict for")
    p.add_argument("--json", default=None,
                   help="also write the full prediction as JSON here")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if not args.model:
        p.error("--model is required: the port ships no cost model "
                "(fit one from a trace of this machine, e.g. "
                "python -m repro_torch.sim.run --trace-out run.trace.jsonl)")
    from repro_torch.sim.engine import SimConfig
    cfg = SimConfig(
        scenario=args.scenario, engine=args.engine, devices=args.n,
        rounds=args.rounds, mesh=args.mesh, div_budget=args.div_budget,
        resolve_patience=args.resolve_patience,
        gossip_pairs=args.gossip_pairs,
        train_gather_floor=args.gather_floor,
        checkpoint_every=args.checkpoint_every,
        ckpt_dir="unused" if args.checkpoint_every else None)
    model = CostModel.from_bench(args.model) \
        if not args.model.endswith(".jsonl") \
        else CostModel.fit(read_trace(args.model))
    missing = [p for p in ("train", "divergence", "solve", "transfer",
                           "eval") if p not in model.phases]
    if missing:
        print(f"[replay] WARNING: model has no fit for {missing} — "
              f"those phases predict 0s")
    pred = predict_run(cfg, model)
    print(f"[replay] {cfg.scenario} ({cfg.engine}) n={cfg.devices} "
          f"mesh={cfg.mesh} rounds={cfg.rounds} — model: {args.model}")
    for phase, s in pred["phase_totals_s"].items():
        print(f"[replay]   {phase:<11s} {s:10.1f}s total")
    print(f"[replay] round 0 {pred['round0_s']:.1f}s, steady "
          f"{pred['steady_mean_s']:.2f}s/round, end-to-end "
          f"{pred['total_s']:.1f}s "
          f"(~{pred['total_s'] / 3600:.2f}h)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(pred, f, indent=2, default=float)
        print(f"[replay] wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
