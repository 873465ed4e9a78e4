"""Crash-consistent run snapshots: full-fidelity checkpoint/resume (the
port of ``repro.sim.snapshot``).

``save_run`` captures EVERYTHING mutable about an in-flight simulation —
NetworkState (device data, params, measurements, dirty-pair tracking,
clocks, the embedded assignment), the solver's warm state (relaxed
iterates + the full SCA iterate ``x_relaxed``), every host numpy stream
(engine, scenario, async executor, fault injector), the feature-drift
base caches, and the engine's bookkeeping — through
``repro_torch.checkpoint.store``'s atomic two-file protocol (arrays in
``step_<k>.npz``, JSON metadata committed first in ``step_<k>.json``).

The archive's member names are the reference's (``_key``, ``_slot``),
wherever the state is the same, so a port archive and a reference
archive of the same round can be compared array by array.  The one
difference is ``['key']``: it holds the engine's seed (an int64 scalar),
which takes the place of the reference's saved JAX key array — per-round
seeds are ``fold_in(key, t)``, so there is no stream position to track.

``restore_run`` rebuilds a freshly-constructed engine to that state, so
the resumed run is the uninterrupted one: every metrics row it writes
from the restored round onward matches the uninterrupted run
field-for-field (modulo ``metrics.NONDETERMINISTIC_FIELDS``) on the CPU.
Derived state is rebuilt, not stored: ``clients`` restacks from the
pool, the gossip ring and the refresh classifier init re-derive from the
seed, and the feature-drift alt-domain renders re-derive from
(true_labels, domain, seed) — only the pristine drift BASES are stored.

A checkpoint at step k means "rounds < k are complete and logged"; the
resumed engine re-enters the loop at round k.  Resume validates the
checkpoint's SimConfig against the current one (trajectory-defining
fields must match; output paths, verbosity, checkpoint cadence and
``rounds`` itself may differ — resuming with a larger ``rounds`` is how
an interrupted run continues past its crash point).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointCorruptError, leaf_name,
                                    load_arrays, load_metadata,
                                    save_checkpoint)
from repro_torch.core.energy import EnergyModel
from repro_torch.core.solver import SolverResult
from repro_torch.data.digits import render_images
from repro_torch.data.partition import DeviceData
from repro_torch.fl.client import stack_clients
from repro_torch.sim.clock import DeviceClocks

if TYPE_CHECKING:                                   # no import cycle
    from repro_torch.sim.engine import SimulationEngine

SNAPSHOT_VERSION = 1

#: SimConfig fields a resume may legitimately change: run-control and
#: output knobs that do not define the trajectory.  ``rounds`` is
#: exempt because continuing an interrupted run past its crash point IS
#: the point of resume; wall-clock-only knobs (backoff) and the trace
#: instrumentation are exempt too; ``train_gather_floor`` is not (the
#: reference's rule).
RESUME_EXEMPT_CFG = frozenset({
    "rounds", "log_path", "verbose", "resume", "kill_after",
    "checkpoint_every", "ckpt_dir", "ckpt_keep", "fault_backoff_s",
    "trace", "trace_path",
})

_key = leaf_name


def _slot(j: int) -> str:
    return f"{int(j):05d}"


def _device_arrays(dev: DeviceData) -> Dict[str, np.ndarray]:
    return {"images": np.asarray(dev.images),
            "labels": np.asarray(dev.labels),
            "labeled_mask": np.asarray(dev.labeled_mask),
            "domain_ids": np.asarray(dev.domain_ids),
            "true_labels": np.asarray(dev.true_labels)}


def _device_from(arrs: Dict[str, np.ndarray], *prefix) -> DeviceData:
    g = lambda f: arrs[_key(*prefix, f)]                  # noqa: E731
    return DeviceData(images=g("images"), labels=g("labels"),
                      labeled_mask=g("labeled_mask"),
                      domain_ids=g("domain_ids"),
                      true_labels=g("true_labels"))


def _cfg_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["tick_periods"] = [int(p) for p in cfg.tick_periods]
    return d


# --------------------------------------------------------------------- save
def save_run(engine: "SimulationEngine", step: int) -> str:
    """Snapshot the full run state as checkpoint ``step`` (meaning:
    rounds < step are complete).  Returns the written npz path."""
    st, cfg = engine.state, engine.cfg

    tree: dict = {
        "key": np.asarray(engine.key, np.int64),
        "active": np.asarray(st.active),
        "eps_hat": np.asarray(st.eps_hat),
        "own_acc": np.asarray(st.own_acc),
        "div_hat": np.asarray(st.div_hat),
        "div_known": np.asarray(st.div_known),
        "div_dirty": np.asarray(st.div_dirty),
        "div_tick": np.asarray(st.div_tick),
        "energy_K": np.asarray(st.energy.K),
        "psi": np.asarray(st.psi),
        "alpha": np.asarray(st.alpha),
        "params": st.params,
        "pool": {_slot(j): _device_arrays(d)
                 for j, d in enumerate(st.pool)},
    }
    if st.solver is not None:
        sol = {"psi": np.asarray(st.solver.psi),
               "alpha": np.asarray(st.solver.alpha),
               "psi_relaxed": np.asarray(st.solver.psi_relaxed),
               "alpha_relaxed": np.asarray(st.solver.alpha_relaxed)}
        if st.solver.x_relaxed is not None:
            sol["x"] = np.asarray(st.solver.x_relaxed)
        tree["solver"] = sol
    if st.solve_active is not None:
        tree["solve_active"] = np.asarray(st.solve_active)
    if st.clocks is not None:
        tree["clocks"] = {"period": np.asarray(st.clocks.period),
                          "phase": np.asarray(st.clocks.phase),
                          "last_train": np.asarray(st.clocks.last_train)}
    if st.ref_K is not None:
        tree["refs"] = {"K": np.asarray(st.ref_K),
                        "eps": np.asarray(st.ref_eps),
                        "div": np.asarray(st.ref_div)}
    if engine._drift_base:
        tree["drift"] = {_slot(j): _device_arrays(b)
                         for j, b in engine._drift_base.items()}

    meta = {
        "version": SNAPSHOT_VERSION,
        "round": int(step),
        "cfg": _cfg_dict(cfg),
        "resume_count": int(engine._resume_count),
        "engine_rng": engine.rng.bit_generator.state,
        "membership_dirty": bool(engine._membership_dirty),
        "prev_links": sorted([int(i), int(j)]
                             for i, j in engine._prev_links),
        "energy_cum": float(engine._energy_cum),
        "solve_tick": int(engine._solve_tick),
        "eps_e": float(st.energy.eps_e),
        "scenario": engine.scenario.state_dict(),
        "executor": engine.executor.state_dict(),
        "faults": (engine.faults.state_dict()
                   if engine.faults is not None else None),
        "solver": {
            "present": st.solver is not None,
            "converged": bool(st.solver.converged)
            if st.solver is not None else False,
            "outer_iters": int(st.solver.outer_iters)
            if st.solver is not None else 0,
            "has_x": st.solver is not None
            and st.solver.x_relaxed is not None,
        },
        "solve_active_present": st.solve_active is not None,
        "clocks_present": st.clocks is not None,
        "refs_present": st.ref_K is not None,
        "drift_domains": {str(int(j)): engine._drift_domain[j]
                          for j in engine._drift_base},
    }
    return save_checkpoint(cfg.ckpt_dir, step, tree, metadata=meta)


# ------------------------------------------------------------------ restore
def _check_cfg(cfg, saved_cfg: dict):
    """Trajectory-defining SimConfig fields must match the checkpoint's;
    anything in RESUME_EXEMPT_CFG may differ.  Fields the saved config
    does not know (written by an older version) are skipped — absence
    means the field did not influence the saved trajectory."""
    diffs = []
    for k, v in _cfg_dict(cfg).items():
        if k in RESUME_EXEMPT_CFG or k not in saved_cfg:
            continue
        if v != saved_cfg[k]:
            diffs.append(f"  {k}: checkpoint={saved_cfg[k]!r} "
                         f"current={v!r}")
    if diffs:
        raise ValueError(
            "cannot resume: the checkpoint was written under a "
            "different configuration (a resumed run must replay the "
            "same trajectory).  Mismatched fields:\n"
            + "\n".join(diffs)
            + "\nRe-run with matching settings, or start fresh "
            "without --resume.")


def restore_run(engine: "SimulationEngine") -> int:
    """Rebuild ``engine`` to the latest readable checkpoint in
    ``cfg.ckpt_dir`` (corrupt latest -> previous step, with a warning —
    see checkpoint.load_arrays).  The engine must be freshly
    constructed (its params supply the leaf names, dtypes and device).
    Returns the restored step."""
    cfg = engine.cfg
    step, arrs = load_arrays(cfg.ckpt_dir)
    meta = load_metadata(cfg.ckpt_dir, step)
    if meta is None:
        raise CheckpointCorruptError(
            f"checkpoint step {step} in {cfg.ckpt_dir} has no metadata "
            f"sidecar — it was not written by snapshot.save_run")
    _check_cfg(cfg, meta["cfg"])
    st = engine.state

    engine.key = int(arrs[_key("key")])
    st.active = np.asarray(arrs[_key("active")], bool)
    st.eps_hat = np.asarray(arrs[_key("eps_hat")], float)
    st.own_acc = np.asarray(arrs[_key("own_acc")], float)
    st.div_hat = np.asarray(arrs[_key("div_hat")], float)
    st.div_known = np.asarray(arrs[_key("div_known")], bool)
    st.div_dirty = np.asarray(arrs[_key("div_dirty")], bool)
    st.div_tick = np.asarray(arrs[_key("div_tick")], int)
    st.energy = EnergyModel(K=np.asarray(arrs[_key("energy_K")], float),
                            eps_e=float(meta["eps_e"]))
    st.psi = np.asarray(arrs[_key("psi")], float)
    st.alpha = np.asarray(arrs[_key("alpha")], float)
    st.params = {k: torch.as_tensor(arrs[_key("params", k)]).to(
        dtype=v.dtype, device=v.device) for k, v in st.params.items()}

    for j in range(st.pool_size):
        st.pool[j] = _device_from(arrs, "pool", _slot(j))
    st.clients = stack_clients(st.pool, device=engine.device)

    sol_meta = meta["solver"]
    if sol_meta["present"]:
        st.solver = SolverResult(
            psi=arrs[_key("solver", "psi")],
            alpha=arrs[_key("solver", "alpha")],
            psi_relaxed=arrs[_key("solver", "psi_relaxed")],
            alpha_relaxed=arrs[_key("solver", "alpha_relaxed")],
            objective_trace=[], objective_parts={},
            converged=bool(sol_meta["converged"]),
            outer_iters=int(sol_meta["outer_iters"]),
            x_relaxed=(arrs[_key("solver", "x")]
                       if sol_meta["has_x"] else None))
    else:
        st.solver = None
    st.solve_active = (np.asarray(arrs[_key("solve_active")], int)
                       if meta["solve_active_present"] else None)
    if meta["clocks_present"]:
        st.clocks = DeviceClocks(
            period=np.asarray(arrs[_key("clocks", "period")], int),
            phase=np.asarray(arrs[_key("clocks", "phase")], int),
            last_train=np.asarray(arrs[_key("clocks", "last_train")],
                                  int))
    if meta["refs_present"]:
        st.ref_K = np.asarray(arrs[_key("refs", "K")], float)
        st.ref_eps = np.asarray(arrs[_key("refs", "eps")], float)
        st.ref_div = np.asarray(arrs[_key("refs", "div")], float)
    else:
        st.ref_K = st.ref_eps = st.ref_div = None

    # feature-drift caches: pristine bases from the archive, alt-domain
    # renders re-derived (deterministic in (labels, domain, seed))
    engine._drift_base.clear()
    engine._drift_alt.clear()
    engine._drift_domain.clear()
    for sj, domain in meta["drift_domains"].items():
        j = int(sj)
        base = _device_from(arrs, "drift", _slot(j))
        engine._drift_base[j] = base
        engine._drift_domain[j] = domain
        engine._drift_alt[j] = render_images(
            base.true_labels, domain, cfg.seed + 7000 + j)

    # host numpy streams + bookkeeping
    engine.rng.bit_generator.state = meta["engine_rng"]
    engine.scenario.load_state_dict(meta["scenario"])
    engine.executor.load_state_dict(meta["executor"])
    if meta["faults"] is not None:
        if engine.faults is None:
            raise ValueError(
                "checkpoint carries fault-injector state but the "
                "current scenario installs no FaultInjector — resume "
                "under the same scenario")
        engine.faults.load_state_dict(meta["faults"])
    engine._membership_dirty = bool(meta["membership_dirty"])
    engine._prev_links = {(int(i), int(j))
                          for i, j in meta["prev_links"]}
    engine._energy_cum = float(meta["energy_cum"])
    engine._solve_tick = int(meta["solve_tick"])
    engine._resume_count = int(meta["resume_count"]) + 1
    st.round = int(step)
    return int(step)
