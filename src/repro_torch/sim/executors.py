"""Execution layer: HOW the network advances one global tick (the port
of ``repro.sim.executors``).

The engine owns state, scenarios, solver plumbing and metrics; an
Executor owns the per-tick control flow.  Two implementations:

``sync`` (SyncExecutor)
    The synchronous round pipeline: every active device trains each
    round, never-estimated active pairs run Algorithm 1, the drift gate
    decides a warm re-solve, and the full alpha-mixture transfer is
    applied globally (on the GPU, the ``alpha_combine`` kernel).

``async-gossip`` (AsyncGossipExecutor)
    Devices progress on heterogeneous local clocks (``sim.clock``): only
    clock-eligible devices train on a given global tick (the pool
    gathers their lanes into one compact step, or masks the others out),
    and instead of a global transfer phase, gossip pairs meet each tick
    (uniform random, ring or k-regular topology): a meeting pair
    refreshes its Algorithm-1 divergence (EMA-merged into the running
    estimate) and exchanges models along the currently solved alpha
    links — indexed row writes, not the ``alpha_combine`` mixture.  The
    re-solve gate adds a staleness rung: once the installed assignment
    has outlived ``resolve_patience`` ticks it is warm re-solved even if
    the sparsely refreshed measurements keep the drift metric under
    threshold.

Both executors share the drift-aware re-estimation phase
(``_refresh_dirty``): pairs dirtied by feature drift
(``engine.drift_features``) are re-measured budgeted and stalest first
through the pool's row-targeted refresh path.  Scenarios that never
drift features keep an empty dirty set and it does nothing (unless
``div_refresh='all'``).

Seeds take the place of the reference's keys: a tick's training seed is
``rng.fold_in(engine.key, t)`` and its divergence seed (bootstrap or
gossip) ``fold_in`` of that with 1, where the reference folds its PRNG
key; under ``div_key_mode='content'`` every measurement is
content-addressed (``_pair_content_keys``).  An engine given a draws
provider (``SimulationEngine(draws=...)``) takes each tick's training
rows (the full pool's, for both executors), its positional
Algorithm-1 (h0, rows) and the content-addressed (h0, rows) from it
instead.  The numpy streams (clocks ``seed + 2``, gossip ``seed + 3``,
the ring ``seed + 4``) are the reference's own.

The heavy phases go through ``engine.pool`` (``repro_torch.sim.shard``).
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, List, Tuple, Type

import numpy as np
import torch

from repro_torch.fl import cnn
from repro_torch.fl.client import stack_clients
from repro_torch.fl.divergence import budget_pairs
from repro_torch.rng import fold_in, generator
from repro_torch.sim.clock import DeviceClocks
from repro_torch.sim.metrics import RoundRecord

if TYPE_CHECKING:                                   # no import cycle
    from repro_torch.sim.engine import SimulationEngine

EXECUTORS: Dict[str, Type["Executor"]] = {}

#: the reference's executors this port does not run (none since the
#: async slice)
NOT_PORTED: Dict[str, str] = {}


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
    helpers below are the blocks both executors share; step() wires
    them around the mode-specific training/measurement phases."""

    name = "base"
    #: lazily-measuring executors set this so the engine's divergence
    #: view (solver input, drift metric, re-solve snapshot) substitutes
    #: cfg.div_prior for never-estimated pairs
    divergence_prior_view = False

    def __init__(self, engine: "SimulationEngine"):
        self.engine = engine
        self._refresh_h0_cache = None

    def setup(self):
        """Called once at engine init, before the scenario's setup."""

    def step(self, t: int) -> dict:
        raise NotImplementedError

    # ---------------------------------------------- checkpoint support
    def state_dict(self) -> dict:
        """Executor-owned mutable state for run checkpoints (sync: none
        — its control flow is a pure function of engine state + tick)."""
        return {}

    def load_state_dict(self, state: dict):
        pass

    # --------------------------------------------------- shared phases
    def _begin(self, t: int):
        """Phase 1: scenario mutation (+ restack after label reveals or
        feature drift).  Returns (tick start time, scenario events)."""
        eng = self.engine
        t0 = time.time()
        eng.trace.begin_tick(t)
        events = eng.scenario.step(eng, t)
        if eng._restack:
            eng.state.clients = stack_clients(eng.state.pool,
                                              device=eng.device)
            eng._restack = False
        return t0, events

    def _train_draws(self, t: int):
        """(generator, rows) of tick ``t``'s training: the engine's seed
        stream, or the draws provider's full-pool rows."""
        eng = self.engine
        if eng.draws is None:
            return generator(fold_in(eng.key, t)), None
        return None, eng.draws.train(t, eng.state.clients)

    def _gate(self, a: np.ndarray, t: int, drift: float,
              patience: int = 0):
        """The re-solve decision ladder.  ``patience`` > 0 adds the
        bounded-staleness rule (async): re-solve once the installed
        assignment is that many ticks old.  Returns (reason, solve_age);
        reason None means no re-solve."""
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
        elif patience > 0 and solve_age >= patience:
            reason = "staleness"
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
        this tick.  Re-estimates flow through the pool's ROW-TARGETED
        refresh path and the ``update_divergences`` EMA merge:
        dirty/never-known pairs replace outright (their old value
        measured a distribution that no longer exists), clean pairs
        caught by 'all' mode EMA-merge with ``div_ema``.  Returns (dirty
        count entering the tick, pairs re-estimated).  No dirty pairs ->
        no work and no seed consumption.

        Refresh measurements are CONTENT-ADDRESSED — each pair's seed
        derives from its device ids (plus a per-run stream and
        classifier init), not from its position in this tick's batch —
        so an estimate is a deterministic function of (pair identity,
        pair data) (``_content_kwargs``)."""
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
        st.div_hat = eng.pool.refresh_divergences(
            st.div_hat, st.clients, None, pairs, ema=ema,
            **self._content_kwargs(pairs))
        st.mark_pairs_estimated(pairs, t)
        return len(dirty), len(pairs)

    def _measure_kwargs(self, t: int, pairs: np.ndarray) -> dict:
        """The seed / (h0, rows) of the mode's own Algorithm-1
        measurements of tick ``t`` (bootstrap, gossip): positional —
        ``fold_in(fold_in(key, t), 1)``, or the draws provider's
        ``divergence`` — under the historical addressing, the
        content-addressed stream under ``div_key_mode='content'`` — so
        flipping the mode re-keys EVERY measurement consistently and
        re-measuring unchanged data becomes an exact no-op across
        bootstrap/gossip/refresh alike."""
        eng = self.engine
        if eng.cfg.div_key_mode == "content":
            return dict(seed=None, **self._content_kwargs(pairs))
        if eng.draws is None:
            return dict(seed=fold_in(fold_in(eng.key, t), 1))
        h0, rows = eng.draws.divergence(t, pairs, eng.state.clients)
        return dict(seed=None, h0=h0, draws=rows)

    def _content_kwargs(self, pairs: np.ndarray) -> dict:
        """keys/h0 of the content-addressed stream, or the draws
        provider's ``refresh`` (h0, rows) for the same pairs."""
        eng = self.engine
        if eng.draws is None:
            return dict(keys=self._pair_content_keys(pairs),
                        h0=self._refresh_h0())
        h0, rows = eng.draws.refresh(pairs, eng.state.clients)
        return dict(h0=h0, draws=rows)

    def _pair_content_keys(self, pairs: np.ndarray) -> np.ndarray:
        """(K,) content-addressed seeds:
        ``fold_in(fold_in(refresh_stream, min(i, j)), max(i, j))`` —
        symmetric in the pair, independent of batch composition."""
        base = fold_in(self.engine.cfg.seed, 2 ** 20)
        pairs = np.asarray(pairs)
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
            # defaults)
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
        gen, rows = self._train_draws(t)
        st.params, st.eps_hat, st.own_acc = eng.pool.train(
            st.params, st.clients, gen, st.active, draws=rows)

        # 3. incremental divergence refresh: never-estimated pairs run
        # the full-pool path (a bootstrap spans everyone) ...
        pairs = st.unknown_active_pairs()
        if len(pairs):
            st.div_hat = eng.pool.update_divergences(
                st.div_hat, st.clients, pairs=pairs,
                **self._measure_kwargs(t, pairs))
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


@register("async-gossip")
class AsyncGossipExecutor(Executor):
    """Event-driven ticks: local clocks + pairwise gossip (see module
    docstring)."""

    divergence_prior_view = True

    def setup(self):
        eng, cfg = self.engine, self.engine.cfg
        # separate streams so the sync path's draws are untouched
        self.clock_rng = np.random.default_rng(cfg.seed + 2)
        self.gossip_rng = np.random.default_rng(cfg.seed + 3)
        eng.state.clocks = DeviceClocks.sample(
            eng.state.pool_size, cfg.tick_periods, self.clock_rng)
        # structured topologies live on a seeded ring over POOL slots, so
        # the neighborhood structure is stable under churn; the ring is
        # drawn from a dedicated stream so 'uniform' runs keep the
        # gossip_rng trajectory untouched
        self._ring = np.random.default_rng(cfg.seed + 4).permutation(
            eng.state.pool_size)

    def state_dict(self) -> dict:
        """The two async numpy streams are the executor's only mutable
        state (clocks live on NetworkState, the ring is seed-derived)."""
        return {"clock_rng": self.clock_rng.bit_generator.state,
                "gossip_rng": self.gossip_rng.bit_generator.state}

    def load_state_dict(self, state: dict):
        self.clock_rng.bit_generator.state = state["clock_rng"]
        self.gossip_rng.bit_generator.state = state["gossip_rng"]

    # ------------------------------------------------------------- gossip
    def _select_pairs(self, active_idx: np.ndarray) -> List[Tuple[int, int]]:
        """Disjoint gossip meetings among the active devices, drawn from
        ``cfg.gossip_topology``:

        ``uniform``    random disjoint pairs
        ``ring``       a block of adjacent edges of the seeded ring,
                       restricted to active devices, starting at a
                       random offset each tick
        ``k-regular``  random disjoint edges of the seeded circulant
                       graph (ring neighbors at hops 1..degree/2)

        The pair count is held constant across ticks (``gossip_pairs``,
        default n_active // 4); when the active set is too small it
        shrinks to n_active // 2."""
        cfg = self.engine.cfg
        g = cfg.gossip_pairs if cfg.gossip_pairs > 0 \
            else max(len(active_idx) // 4, 1)
        g = min(g, len(active_idx) // 2)
        if g < 1:
            return []
        if cfg.gossip_topology == "uniform":
            perm = self.gossip_rng.permutation(active_idx)
            return [(int(perm[2 * k]), int(perm[2 * k + 1]))
                    for k in range(g)]
        act = set(int(i) for i in active_idx)
        ring = [int(d) for d in self._ring if int(d) in act]
        n = len(ring)
        if cfg.gossip_topology == "ring":
            # g consecutive disjoint edges from a random starting offset
            o = int(self.gossip_rng.integers(n))
            return [(ring[(o + 2 * k) % n], ring[(o + 2 * k + 1) % n])
                    for k in range(g)]
        # k-regular: circulant edge set over the active ring
        half = max(1, cfg.gossip_degree // 2)
        edges = [(ring[i], ring[(i + d) % n])
                 for d in range(1, half + 1) for i in range(n)
                 if ring[i] != ring[(i + d) % n]]
        pairs: List[Tuple[int, int]] = []
        used: set = set()
        for e in self.gossip_rng.permutation(len(edges)):
            i, j = edges[int(e)]
            if i not in used and j not in used:
                pairs.append((i, j))
                used.update((i, j))
                if len(pairs) == g:
                    break
        return pairs

    def _gossip_divergences(self, pairs, t: int):
        """Pair-incremental Algorithm-1 refresh for this tick's meetings.
        Known CLEAN pairs EMA-merge the fresh estimate (cfg.div_ema on
        the old value — two measurements of the same distributions);
        never-estimated pairs, and pairs feature drift dirtied, take it
        outright (their old value has nothing left to say)."""
        st, cfg = self.engine.state, self.engine.cfg
        parr = np.asarray(pairs, np.int32)
        pi, pj = parr[:, 0], parr[:, 1]
        ema = np.where(
            np.logical_and(st.div_known[pi, pj], ~st.div_dirty[pi, pj]),
            cfg.div_ema, 0.0)
        st.div_hat = self.engine.pool.update_divergences(
            st.div_hat, st.clients, pairs=parr, ema=ema,
            **self._measure_kwargs(t, parr))
        st.mark_pairs_estimated(parr, t)

    def _gossip_models(self, pairs) -> Tuple[np.ndarray, int]:
        """Model exchange along solved links: inside each meeting pair,
        a target pulls its partner's model with the solved alpha weight
        (scaled by ``gossip_mix``) — the link-local, incremental
        realization of the sync engine's one-shot alpha-mixture.
        Returns (B, n_exchanges): B[s, d] holds this tick's transfer
        weights, for energy accounting.

        The update is one indexed row write a leaf, every blend built
        from the pre-tick rows: sources of solved links have psi=0 and
        are never blend destinations, and disjoint pairs touch each
        destination at most once, so that is the reference's sequence of
        writes exactly.  A tick touches at most 2*gossip_pairs rows, so
        mixing through the full (P, P) blend matrix would be O(P^2) work
        for O(pairs) change."""
        eng = self.engine
        st, cfg = eng.state, eng.cfg
        t0 = eng.trace.start()
        used = np.zeros((st.pool_size, st.pool_size))
        blends = []
        for i, j in pairs:
            for s, d in ((i, j), (j, i)):
                w = st.alpha[s, d]
                if st.psi[d] == 1.0 and w > cfg.link_thresh:
                    used[s, d] = cfg.gossip_mix * float(w)
                    if eng.faults is not None \
                            and eng.faults.drop_exchange():
                        # payload lost in flight: the sender's energy is
                        # spent (``used`` keeps the link), the receiver
                        # never applies the blend — and transmissions
                        # counts completed exchanges only
                        continue
                    blends.append((s, d, used[s, d]))
        if blends:
            dev = eng.device
            src = torch.as_tensor([b[0] for b in blends], device=dev)
            dst = torch.as_tensor([b[1] for b in blends], device=dev)
            mix = torch.as_tensor([b[2] for b in blends],
                                  dtype=torch.float32, device=dev)
            params = {}
            for k, leaf in st.params.items():
                m = mix.to(leaf.dtype).reshape((-1,) + (1,) * (leaf.dim()
                                                               - 1))
                out = leaf.clone()
                out[dst] = (1 - m) * leaf[dst] + m * leaf[src]
                params[k] = out
            st.params = params
        # async has no global mixture phase; the gossip exchange IS its
        # transfer, so it lands in the same trace phase/wall field
        eng.trace.stop("transfer", t0, block=st.params,
                       n_devices=st.pool_size)
        return used, len(blends)

    # --------------------------------------------------------------- tick
    def step(self, t: int) -> dict:
        eng = self.engine
        st, cfg = eng.state, eng.cfg
        t0, events = self._begin(t)

        # 2. local training on the clock-eligible subset (the pool
        # decides HOW: LocalPool gathers the eligible lanes into a
        # compact batch, or masks the others under train_gather=False)
        elig = np.logical_and(st.active, st.clocks.eligible(t))
        gen, rows = self._train_draws(t)
        # measurements refresh only where a device actually ticked —
        # everyone else's view stays stale, as it would in deployment
        st.params, st.eps_hat, st.own_acc = eng.pool.train_async(
            st.params, st.clients, gen, st.active, elig, st.eps_hat,
            st.own_acc, draws=rows)
        # but only devices with labeled data actually TRAIN on a tick
        # (the step's update mask); unlabeled devices progress through
        # gossip alone and must read as stale until they do
        t_idx = np.flatnonzero(np.logical_and(elig, st.labeled_devices))
        st.clocks.mark_trained(t_idx, t)

        # 3. gossip: pairwise divergence refresh + model exchange, then
        # the budgeted drift-aware re-estimation (row-targeted path)
        a = st.active_idx
        pairs = self._select_pairs(a)
        if pairs:
            self._gossip_divergences(pairs, t)
        used, n_exchanges = self._gossip_models(pairs)
        n_dirty, n_reest = self._refresh_dirty(t)

        # 4. drift + staleness gated warm re-solve
        drift = eng._drift_metric()
        reason, solve_age = self._gate(a, t, drift,
                                       patience=cfg.resolve_patience)
        resolved = reason is not None
        warm, solver_iters, solver_wall = False, 0, 0.0
        if resolved:
            warm, solver_iters, solver_wall = self._run_solve(a, t)

        # 5. evaluation + metrics (no global transfer phase: targets
        # converge to their mixtures through the gossip exchanges above)
        acc_now = np.asarray(eng.pool.accuracies(st.params, st.clients),
                             float)
        churn = self._link_churn()
        stale_dev = st.clocks.staleness(t)[a] if len(a) \
            else np.zeros(1, int)
        row, record = self._emit(
            t=t, t0=t0, a=a, acc=acc_now, events=events,
            resolved=resolved, warm=warm, solver_iters=solver_iters,
            solver_wall=solver_wall, drift=drift,
            energy=st.energy.energy(used),
            transmissions=n_exchanges, churn=churn,
            solve_age=solve_age, reason=reason,
            n_dirty_pairs=n_dirty, n_reestimated=n_reest,
            n_trained=len(t_idx), trained=[int(i) for i in t_idx],
            gossip=[[int(i), int(j)] for i, j in pairs],
            gossip_topology=cfg.gossip_topology,
            mean_staleness=float(stale_dev.mean()),
            max_staleness=float(stale_dev.max()))
        if cfg.verbose:
            print(f"[sim] tick {t}: active={len(a)} "
                  f"trained={len(t_idx)} gossip={len(pairs)} "
                  f"resolve={resolved} ({reason}) "
                  f"stale={record.mean_staleness:.1f} "
                  f"tgt_acc={record.mean_target_acc:.3f}")
        return row
