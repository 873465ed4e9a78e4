"""Execution layer: HOW the network advances one global tick (the port
of ``repro.sim.executors``).

The engine owns state, scenarios, solver plumbing and metrics; an
Executor owns the per-tick control flow.  ``sync`` (SyncExecutor) is the
synchronous round pipeline: every active device trains each round,
never-estimated active pairs run Algorithm 1, the drift gate decides a
warm re-solve, and the full alpha-mixture transfer is applied globally.
The reference's ``async-gossip`` executor is not ported yet
(``get_executor`` refuses it).

The drift-aware re-estimation phase (``_refresh_dirty``) comes along:
pairs dirtied by feature drift are re-measured budgeted and stalest
first through the pool's refresh path.  No sync scenario drifts
features, so under them its dirty set stays empty and it does nothing
(unless ``div_refresh='all'``).

Seeds take the place of the reference's keys: a round's training seed
is ``rng.fold_in(engine.key, t)`` and its divergence seed
``fold_in`` of that with 1, where the reference folds its PRNG key.  An
engine given a draws provider (``SimulationEngine(draws=...)``) takes
each round's training rows and divergence (h0, rows), and the
refresh's (h0, rows), from it instead.

The heavy phases go through ``engine.pool`` (``repro_torch.sim.shard``).
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, Type

import numpy as np

from repro_torch.fl import cnn
from repro_torch.fl.client import stack_clients
from repro_torch.fl.divergence import budget_pairs
from repro_torch.rng import fold_in, generator
from repro_torch.sim.metrics import RoundRecord

if TYPE_CHECKING:                                   # no import cycle
    from repro_torch.sim.engine import SimulationEngine

EXECUTORS: Dict[str, Type["Executor"]] = {}

#: the reference's executors this port does not run yet
NOT_PORTED = {"async-gossip": "queue 1 item 3 (async and drift)"}


def register(name: str):
    def deco(cls):
        cls.name = name
        EXECUTORS[name] = cls
        return cls
    return deco


def get_executor(name: str) -> Type["Executor"]:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported to repro_torch yet "
            f"(ROADMAP.md {NOT_PORTED[name]}); ported: {sorted(EXECUTORS)}")
    if name not in EXECUTORS:
        raise KeyError(f"unknown engine {name!r}; "
                       f"available: {sorted(EXECUTORS)}")
    return EXECUTORS[name]


class Executor:
    """Per-tick control flow over a SimulationEngine's state.  The
    helpers below are the reference's blocks shared by its executors;
    step() wires them around the mode's training/measurement phases."""

    name = "base"
    #: lazily-measuring executors set this so the engine's divergence
    #: view (solver input, drift metric, re-solve snapshot) substitutes
    #: cfg.div_prior for never-estimated pairs
    divergence_prior_view = False

    def __init__(self, engine: "SimulationEngine"):
        self.engine = engine
        self._refresh_h0_cache = None

    def step(self, t: int) -> dict:
        raise NotImplementedError

    # --------------------------------------------------- shared phases
    def _begin(self, t: int):
        """Phase 1: scenario mutation (+ restack after label reveals).
        Returns (tick start time, scenario events)."""
        eng = self.engine
        t0 = time.time()
        eng.trace.begin_tick(t)
        events = eng.scenario.step(eng, t)
        if eng._restack:
            eng.state.clients = stack_clients(eng.state.pool,
                                              device=eng.device)
            eng._restack = False
        return t0, events

    def _gate(self, a: np.ndarray, t: int, drift: float):
        """The re-solve decision ladder (the reference's async executor
        adds a staleness rung).  Returns (reason, solve_age); reason None
        means no re-solve."""
        eng, st, cfg = self.engine, self.engine.state, self.engine.cfg
        solve_age = t - eng._solve_tick if st.solver is not None else -1
        membership_changed = eng._membership_dirty or st.solver is None \
            or not np.array_equal(a, st.solve_active)
        if st.solver is None:
            reason = "cold"
        elif membership_changed:
            reason = "membership"
        elif drift > cfg.resolve_threshold:
            reason = "drift"
        else:
            reason = None
        return reason, solve_age

    def _refresh_dirty(self, t: int):
        """Drift-aware divergence re-estimation (runs after the mode's
        own measurement phase, before the re-solve gate).  Under
        ``div_refresh='dirty'`` (default): re-measure a budgeted top-K of
        the active pairs whose estimates feature drift invalidated,
        stalest first (``fl.divergence.budget_pairs``); under ``'all'``:
        the naive reference — every active pair not already measured
        this tick.  Re-estimates flow through the pool's refresh path
        and the ``update_divergences`` EMA merge: dirty/never-known
        pairs replace outright (their old value measured a distribution
        that no longer exists), clean pairs caught by 'all' mode
        EMA-merge with ``div_ema``.  Returns (dirty count entering the
        tick, pairs re-estimated).  No dirty pairs -> no work and no
        seed consumption, which leaves the sync scenarios' trajectories
        untouched by this phase.

        Refresh measurements use CONTENT-ADDRESSED seeds — each pair's
        seed derives from its device ids (plus a per-run stream and
        classifier init), not from its position in this tick's batch —
        so an estimate is a deterministic function of (pair identity,
        pair data).  The seeds are the port's own (``rng.fold_in``); an
        engine given a draws provider takes the pairs' (h0, rows) from
        its ``refresh`` instead."""
        eng, st, cfg = self.engine, self.engine.state, self.engine.cfg
        dirty = st.dirty_active_pairs()
        if cfg.div_refresh == "all":
            a = st.active_idx
            ii, jj = np.triu_indices(len(a), k=1)
            pairs = np.stack([a[ii], a[jj]], axis=1).astype(np.int32)
            if len(pairs):                   # already measured this tick
                pairs = pairs[st.div_tick[pairs[:, 0], pairs[:, 1]] < t]
        else:
            budget = len(st.active_idx) if cfg.div_budget < 0 \
                else cfg.div_budget
            pairs = budget_pairs(dirty, st.div_tick, budget)
        if len(pairs) == 0:
            return len(dirty), 0
        pi, pj = pairs[:, 0], pairs[:, 1]
        ema = np.where(
            np.logical_and(st.div_known[pi, pj], ~st.div_dirty[pi, pj]),
            cfg.div_ema, 0.0)
        # annotate the pool's divergence event with the dirty backlog —
        # only the executor knows it (a no-op when tracing is off)
        eng.trace.with_ctx(n_dirty=len(dirty))
        if eng.draws is None:
            kw = dict(keys=self._pair_content_keys(pairs),
                      h0=self._refresh_h0())
        else:
            h0, rows = eng.draws.refresh(pairs, st.clients)
            kw = dict(h0=h0, draws=rows)
        st.div_hat = eng.pool.refresh_divergences(
            st.div_hat, st.clients, None, pairs, ema=ema, **kw)
        st.mark_pairs_estimated(pairs, t)
        return len(dirty), len(pairs)

    def _pair_content_keys(self, pairs: np.ndarray) -> np.ndarray:
        """(K,) content-addressed seeds:
        ``fold_in(fold_in(refresh_stream, min(i, j)), max(i, j))`` —
        symmetric in the pair, independent of batch composition."""
        base = fold_in(self.engine.cfg.seed, 2 ** 20)
        lo = np.minimum(pairs[:, 0], pairs[:, 1])
        hi = np.maximum(pairs[:, 0], pairs[:, 1])
        return np.array([fold_in(fold_in(base, int(i)), int(j))
                         for i, j in zip(lo, hi)], np.int64)

    def _refresh_h0(self):
        """The per-run shared classifier init of the refresh stream
        (fixed so refresh measurements are content-addressed; cached —
        it is the same dict every tick)."""
        if self._refresh_h0_cache is None:
            self._refresh_h0_cache = cnn.cnn_init(
                generator(fold_in(self.engine.cfg.seed, 2 ** 21)),
                num_classes=2, device=self.engine.device)
        return self._refresh_h0_cache

    def _run_solve(self, a: np.ndarray, t: int):
        """Warm-started re-solve + installation.  Returns
        (warm, outer_iters, solve wall seconds)."""
        eng = self.engine
        warm = eng.state.solver is not None
        res = eng._solve(a)
        eng._install_solution(a, res, t)
        # the solver measures itself; feed the trace stream directly
        # (solve keeps its own solver_wall_s field, no WALL_FIELDS entry)
        eng.trace.add("solve", res.solve_time_s, n_devices=len(a),
                      inner_steps=res.inner_steps)
        return warm, res.outer_iters, res.solve_time_s

    def _link_churn(self) -> float:
        """Jaccard distance of the active-link set vs. the previous
        tick (links = solved alpha above link_thresh)."""
        eng, st, cfg = self.engine, self.engine.state, self.engine.cfg
        links = {(int(i), int(j)) for i, j in zip(
            *np.nonzero(st.alpha > cfg.link_thresh))}
        union = links | eng._prev_links
        churn = len(links ^ eng._prev_links) / max(len(union), 1)
        eng._prev_links = links
        return churn

    def _emit(self, *, t, t0, a, acc, events, resolved, warm,
              solver_iters, solver_wall, drift, energy, transmissions,
              churn, solve_age, reason, n_dirty_pairs=0,
              n_reestimated=0, **extras):
        """Build + log the tick's RoundRecord from the shared fields;
        mode-specific fields come in through ``extras``.  Returns
        (logged row, record)."""
        eng, st, cfg = self.engine, self.engine.state, self.engine.cfg
        src = a[st.psi[a] == 0.0]
        tgt = a[st.psi[a] == 1.0]
        eng._energy_cum += energy
        n_drifted = sum(1 for e in events
                        if e.get("event") == "feature_drift")
        n_faults = eng.faults.n_faults if eng.faults is not None else 0
        n_recov = eng.faults.n_recovered if eng.faults is not None else 0
        record = RoundRecord(
            round=t, scenario=cfg.scenario, n_active=len(a),
            n_sources=len(src), n_targets=len(tgt),
            resolved=bool(resolved), warm=bool(warm),
            solver_iters=int(solver_iters),
            solver_wall_s=float(solver_wall),
            drift=float(drift if np.isfinite(drift) else -1.0),
            mean_target_acc=float(acc[tgt].mean()) if len(tgt)
            else float("nan"),
            mean_source_acc=float(acc[src].mean()) if len(src)
            else float("nan"),
            energy=float(energy),
            energy_cum=float(eng._energy_cum),
            transmissions=int(transmissions),
            link_churn=float(churn), events=events,
            wall_time_s=time.time() - t0,
            engine=self.name, solve_age=int(solve_age),
            resolve_reason=reason, n_drifted=int(n_drifted),
            n_dirty_pairs=int(n_dirty_pairs),
            n_reestimated=int(n_reestimated),
            n_faults=int(n_faults), n_recovered=int(n_recov),
            resume_count=int(eng._resume_count),
            # per-phase wall totals popped from the trace accumulators
            # ({} when tracing is off -> the fields keep their 0.0
            # defaults and golden rows are byte-identical)
            **eng.trace.tick_wall_fields(), **extras)
        row = eng.logger.log(record)
        st.round = t + 1
        return row, record


@register("sync")
class SyncExecutor(Executor):
    """The synchronous round pipeline (see module docstring)."""

    def step(self, t: int) -> dict:
        eng = self.engine
        st, cfg = eng.state, eng.cfg
        t0, events = self._begin(t)

        # 2. batched train + measure (one stacked loop over the pool)
        k_round = fold_in(eng.key, t)
        if eng.draws is None:
            gen, rows = generator(k_round), None
        else:
            gen, rows = None, eng.draws.train(t, st.clients)
        st.params, st.eps_hat, st.own_acc = eng.pool.train(
            st.params, st.clients, gen, st.active, draws=rows)

        # 3. incremental divergence refresh: never-estimated pairs run
        # the full-pool path (a bootstrap spans everyone) ...
        pairs = st.unknown_active_pairs()
        if len(pairs):
            if eng.draws is None:
                kw = dict(seed=fold_in(k_round, 1))
            else:
                h0, rows = eng.draws.divergence(t, pairs, st.clients)
                kw = dict(seed=None, h0=h0, draws=rows)
            st.div_hat = eng.pool.update_divergences(
                st.div_hat, st.clients, pairs=pairs, **kw)
            st.mark_pairs_estimated(pairs, t)
        # ... then the budgeted drift-aware re-estimation of dirtied
        # pairs through the row-targeted refresh path
        n_dirty, n_reest = self._refresh_dirty(t)

        # 4. drift-gated warm re-solve
        a = st.active_idx
        drift = eng._drift_metric()
        reason, solve_age = self._gate(a, t, drift)
        resolved = reason is not None
        warm, solver_iters, solver_wall = False, 0, 0.0
        if resolved:
            warm, solver_iters, solver_wall = self._run_solve(a, t)

        # 5. transfer + evaluation
        mixed = eng.pool.transfer(st.params, st.alpha, st.psi)
        st.params = mixed                        # targets adopt mixtures
        acc_mixed = np.asarray(eng.pool.accuracies(mixed, st.clients),
                               float)

        churn = self._link_churn()
        row, record = self._emit(
            t=t, t0=t0, a=a, acc=acc_mixed, events=events,
            resolved=resolved, warm=warm, solver_iters=solver_iters,
            solver_wall=solver_wall, drift=drift,
            energy=st.energy.energy(st.alpha),
            transmissions=st.energy.transmissions(
                st.alpha, thresh=cfg.link_thresh),
            churn=churn, solve_age=solve_age, reason=reason,
            n_dirty_pairs=n_dirty, n_reestimated=n_reest,
            n_trained=int(np.sum(st.labeled_devices[a])))
        if cfg.verbose:
            print(f"[sim] round {t}: active={len(a)} "
                  f"src={record.n_sources} tgt={record.n_targets} "
                  f"resolve={resolved} ({solver_iters} it, warm={warm}) "
                  f"tgt_acc={record.mean_target_acc:.3f} "
                  f"energy={record.energy:.3f}")
        return row


