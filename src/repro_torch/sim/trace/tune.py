"""Numpy copy of ``repro.sim.trace.tune``: the same search, mesh sizes
included, against a cost model fitted on the machine it predicts for.

Knob autotuner: search SimConfig knobs against the fitted cost model.

``autotune`` grid-searches the four cost-relevant knobs the trace PR
exposes — ``mesh``, ``div_budget``, the train gather bucket floor
(``train_gather_floor``) and ``resolve_patience`` — scoring each
candidate with the replay walker's predicted end-to-end wall time, and
returns the cheapest configuration that respects the guardrails:

  - **mesh**: only mesh sizes the model was actually fitted on (plus
    the caller's own) are searched by default — the per-shard lane
    feature would happily extrapolate a speedup an emulated mesh cannot
    deliver; ``allow_mesh_extrapolation`` opts in to powers of two up
    to ``max_mesh``.
  - **div_budget**: cost-only minimization would starve the refresh
    (budget 0 is always cheapest), so a candidate budget must cover the
    scenario's expected per-tick dirty-pair rate — capped at
    ``n_active``, the default's own coverage, when drift outpaces even
    that.
  - **resolve_patience**: bounded to [PATIENCE_MIN, PATIENCE_MAX]
    ticks — unbounded patience is free and useless (the staleness gate
    exists to bound assignment age, see executors.py).

The tuner never claims a MEASURED win: it reports predicted seconds for
the tuned and default configs side by side, and ``run.py --autotune``
prints both before applying the knobs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from repro_torch.sim.trace.model import CostModel
from repro_torch.sim.trace.replay import DRIFT_SCENARIOS, predict_run

PATIENCE_MIN, PATIENCE_MAX = 5, 30
TUNED_KNOBS = ("mesh", "div_budget", "train_gather_floor",
               "resolve_patience")


def expected_dirty_rate(cfg) -> float:
    """Expected newly-dirtied active pairs per tick (the replay
    walker's drift expectation; 0 for non-drift scenarios)."""
    if cfg.scenario not in DRIFT_SCENARIOS:
        return 0.0
    n = cfg.devices
    k = max(1, round(cfg.feature_drift_frac * n))
    return k * cfg.feature_drift_p * (n - 1)


def min_budget(cfg) -> int:
    """Guardrail floor for ``div_budget``: cover the expected dirty
    rate, capped at n_active (the default's own per-tick coverage)."""
    rate = expected_dirty_rate(cfg)
    return min(int(math.ceil(rate)), cfg.devices) if rate > 0 else 0


def _budget_candidates(cfg) -> List[int]:
    n = cfg.devices
    floor = min_budget(cfg)
    cands = {cfg.div_budget, -1, max(n // 4, 1), max(n // 2, 1), n}
    ok = []
    for b in cands:
        eff = n if b == -1 else (n * (n - 1) // 2 if b == 0 else b)
        if eff >= floor:
            ok.append(b)
    return sorted(ok)


def _mesh_candidates(cfg, model: CostModel, max_mesh: Optional[int],
                     allow_extrapolation: bool) -> List[int]:
    cands = {cfg.mesh} | {m for m in model.known_meshes()}
    if allow_extrapolation and max_mesh:
        m = 1
        while m <= max_mesh:
            cands.add(m)
            m *= 2
    if max_mesh is not None:
        cands = {m for m in cands if m <= max_mesh}
    return sorted(cands)


def autotune(cfg, model: CostModel, *, max_mesh: Optional[int] = None,
             allow_mesh_extrapolation: bool = False) -> dict:
    """Returns ``{"knobs": {changed knob: value}, "predicted_s",
    "baseline_s", "n_candidates"}`` — the cheapest guardrail-respecting
    configuration under the model.  ``cfg`` itself is never mutated;
    apply the knobs with ``dataclasses.replace``."""
    baseline = predict_run(cfg, model)["total_s"]
    meshes = _mesh_candidates(cfg, model, max_mesh,
                              allow_mesh_extrapolation)
    budgets = _budget_candidates(cfg)
    floors = sorted({cfg.train_gather_floor, 4, 8, 16})
    if cfg.engine == "async-gossip" and cfg.resolve_patience > 0:
        patiences = sorted({max(PATIENCE_MIN,
                                min(cfg.resolve_patience, PATIENCE_MAX)),
                            PATIENCE_MIN, 10, 20, PATIENCE_MAX})
    else:
        patiences = [cfg.resolve_patience]

    best, best_knobs, tried = baseline, {}, 0
    for mesh in meshes:
        for budget in budgets:
            for floor in floors:
                for patience in patiences:
                    knobs = dict(mesh=mesh, div_budget=budget,
                                 train_gather_floor=floor,
                                 resolve_patience=patience)
                    changed = {k: v for k, v in knobs.items()
                               if v != getattr(cfg, k)}
                    tried += 1
                    if not changed:
                        continue
                    cand = dataclasses.replace(cfg, **changed)
                    cost = predict_run(cand, model)["total_s"]
                    if cost < best:
                        best, best_knobs = cost, changed
    return {"knobs": best_knobs, "predicted_s": best,
            "baseline_s": baseline, "n_candidates": tried,
            "min_div_budget": min_budget(cfg)}
