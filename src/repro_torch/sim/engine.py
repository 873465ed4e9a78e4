"""Simulation engine: state + solver plumbing; the executor drives the
ticks (the port of ``repro.sim.engine``).

The per-tick control flow lives in the execution layer
(``repro_torch.sim.executors``): ``SyncExecutor`` runs the five-phase
round pipeline (scenario mutation -> batched training -> divergence
refresh -> drift-gated re-solve -> transfer/eval/metrics).  WHERE the
heavy array phases run is the device pool (``repro_torch.sim.shard``).
The engine owns what they share:

  - NetworkState construction (fixed-size pool, spares for churn)
  - the scenario mutation API (drift_channels / set_active /
    reveal_labels / set_tick_period; drift_features comes with the
    feature-drift scenarios)
  - the drift metric against the last-solve snapshot
  - warm-started (P) re-solves (previous SolverResult remapped over
    churn) and installation of the solved assignment
  - churn-robust re-seeding: a (re)joining device adopts the current
    best source mixture instead of keeping stale (or fresh-init) params
  - the JSONL metrics logger

``SimConfig`` keeps every field and default of the reference's, so a
reference config maps over one to one; fields of features not ported
yet raise ``NotImplementedError`` naming their ROADMAP.md item.  The
engine runs on ``device`` (the GPU unless the caller passes "cpu").
Its seeds take the place of the reference's PRNG keys; ``params0``
(numpy, e.g. the reference engine's initial parameters) and ``draws``
(a draws provider, see ``executors``) inject the reference's
initialization and row draws instead.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import params_from_jax
from repro_torch.core.bounds import BoundTerms
from repro_torch.core.energy import EnergyModel
from repro_torch.core.problem import STLFProblem
from repro_torch.core.solver import SolverResult, solve_stlf
from repro_torch.data.partition import build_network, make_device, \
    reveal_labels
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.client import (StackedClients, init_client_params,
                                   stack_clients)
from repro_torch.fl.transfer import column_normalize
from repro_torch.rng import generator, split_seed
from repro_torch.sim.executors import get_executor
from repro_torch.sim.metrics import MetricsLogger
from repro_torch.sim.scenarios import get_scenario
from repro_torch.sim.shard.pool import make_pool
from repro_torch.sim.state import NetworkState
from repro_torch.sim.trace.events import TraceRecorder

if TYPE_CHECKING:
    from typing import Protocol

    class DrawsProvider(Protocol):
        """Supplies a round's random draws in place of the engine's
        seeds (the parity tests pass the reference's)."""

        def train(self, t: int, clients: StackedClients) -> torch.Tensor:
            """(P, train_iters, batch) training rows of round ``t``."""

        def divergence(self, t: int, pairs: np.ndarray,
                       clients: StackedClients
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
            """(h0, (len(pairs), div_tau * div_T, 2, batch) rows) of
            round ``t``'s Algorithm-1 bootstrap of ``pairs``."""

        def refresh(self, pairs: np.ndarray, clients: StackedClients
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
            """(h0, rows) of the content-addressed re-estimation of
            ``pairs`` (``Executor._refresh_dirty``): a function of the
            pairs' device ids, not of the round."""

#: SimConfig's fault-injection knobs (the 'faulty' scenario's)
FAULT_KNOBS = ("fault_seed", "fault_crash_p", "fault_rejoin_after",
               "fault_shard_p", "fault_op_p", "fault_gossip_drop_p",
               "fault_retries", "fault_backoff_s")


@dataclasses.dataclass
class SimConfig:
    """The reference's SimConfig, field for field (its comments describe
    the reference's features; ``_refuse_not_ported`` lists the ones the
    port does not run yet)."""
    scenario: str = "static"
    devices: int = 8
    rounds: int = 5
    seed: int = 0
    setting: str = "M//MM"
    samples_per_device: int = 100
    spares: int = -1             # -1: let the scenario choose
    # execution layer (repro_torch.sim.executors)
    engine: str = "sync"
    # device-pool backend (repro.sim.shard.pool): 0 = single-host
    # LocalPool (the bit-for-bit historical path); k >= 1 = ShardedPool
    # with the pool axis over a k-shard 'devices' mesh (k=1 runs the full
    # sharded pipeline on one device — parity-testable anywhere; k>1
    # needs that many local/emulated jax devices)
    mesh: int = 0
    #: async subset-gather training (LocalPool): gather the eligible
    #: lanes into a compact batch instead of masked no-op SGD over the
    #: whole pool; False keeps the masked path (the parity reference)
    train_gather: bool = True
    #: alpha weight above which a link counts as active (transmissions,
    #: link_churn, and the async gossip exchanges all use this)
    link_thresh: float = 1e-3
    #: churn-robust transfer: re-seed a (re)joining device's params from
    #: the current best source mixture of the last solved assignment
    reseed_on_rejoin: bool = True
    # per-round local training
    train_iters: int = 30
    batch: int = 10
    lr: float = 0.01
    # Algorithm-1 settings (sim-scale: cheaper than one-shot reproduction)
    div_tau: int = 1
    div_T: int = 8
    #: drift-aware re-estimation policy: 'dirty' (default) re-measures
    #: only pairs whose estimates were invalidated by feature drift,
    #: budgeted + stalest-first; 'all' re-measures EVERY active pair
    #: every tick after the bootstrap — the naive reference the
    #: sim_drift benchmark compares against
    div_refresh: str = "dirty"
    #: max dirty pairs re-estimated per tick under div_refresh='dirty';
    #: -1: n_active (a vanishing fraction of the N(N-1)/2 total as the
    #: network grows), 0: unbounded (all dirty pairs)
    div_budget: int = -1
    #: PRNG addressing of Algorithm-1 measurements: 'positional'
    #: (historical, golden-pinned — keys follow the pair's position in
    #: the measurement batch) or 'content' — every measurement's key
    #: derives from the pair's device ids and the classifier init is
    #: per-run, so an estimate is a deterministic function of (pair,
    #: data): re-measuring an unchanged pair reproduces its value
    #: exactly, and refresh POLICIES can be compared free of sampling
    #: noise (benchmarks/sim_drift.py).  The budgeted drift refresh
    #: itself is always content-addressed.
    div_key_mode: str = "positional"
    # objective weights + solver
    phi_s: float = 1.0
    phi_t: float = 5.0
    phi_e: float = 1.0
    solver_max_outer: int = 8
    solver_inner_steps: int = 600
    # Warm-started re-solves seed near the optimum, so each linearized
    # inner problem needs a fraction of the cold budget (the penalty ramp
    # is schedule-preserving: it scales with the step count).  Measured at
    # N=256: identical decisions at 4x fewer steps (benchmarks/
    # solver_scaling.py).
    solver_inner_steps_warm: int = 150
    # inner-loop early-stop safety valve (see solve_stlf inner_tol)
    solver_inner_tol: float = 1e-4
    resolve_threshold: float = 0.05
    # async-gossip executor knobs
    #: per-device tick periods are sampled uniformly from this set
    tick_periods: Tuple[int, ...] = (1, 2, 4)
    #: gossip meetings per tick; -1: n_active // 4 (at least 1)
    gossip_pairs: int = -1
    #: who meets whom (async-gossip executor): 'uniform' random disjoint
    #: pairs (historical), 'ring' — adjacent edges of a seeded ring over
    #: the pool, or 'k-regular' — random disjoint edges of a seeded
    #: circulant graph of degree ``gossip_degree``
    gossip_topology: str = "uniform"
    #: neighbor degree of the 'k-regular' topology (rounded down to even)
    gossip_degree: int = 4
    #: blend step size of a gossip model exchange (scales the solved
    #: alpha weight of the link)
    gossip_mix: float = 0.5
    #: staleness bound: warm re-solve once the installed assignment is
    #: this many ticks old, even if measured drift stays under threshold
    #: (async executor only; <= 0 disables)
    resolve_patience: int = 10
    #: EMA weight on the OLD estimate when a gossip pair re-runs
    #: Algorithm 1 on an already-estimated link
    div_ema: float = 0.5
    #: solver-input divergence for never-estimated pairs (async measures
    #: lazily; an unmeasured link must not look BETTER than a measured
    #: one, so unknowns carry a pessimistic prior; <= 0 disables).
    #: d_H ranges over [0, 2]; 1.0 is the midpoint.
    div_prior: float = 1.0
    # scenario knobs (read by scenarios.py via getattr)
    drift_sigma: float = 0.15
    #: feature-drift scenario: fraction of the initially-active devices
    #: designated as drifters at setup
    feature_drift_frac: float = 0.5
    #: per-drifter per-tick probability of a drift step
    feature_drift_p: float = 0.3
    #: domain-mix increment of one drift step (mix is clipped at 1.0)
    feature_drift_step: float = 0.15
    churn_p_leave: float = 0.35
    churn_p_join: float = 0.35
    label_frac: float = 0.25
    label_p_device: float = 0.5
    retick_p: float = 0.1
    straggler_frac: float = 0.25
    straggler_period: int = 8
    straggler_p_swap: float = 0.1
    # ---- checkpoint / resume (repro.sim.snapshot over repro.checkpoint)
    #: crash-consistent snapshot cadence in rounds (None disables; when
    #: set it must be >= 1 and ``ckpt_dir`` must be set too)
    checkpoint_every: Optional[int] = None
    #: directory the run checkpoints live in
    ckpt_dir: Optional[str] = None
    #: retention: keep the newest k checkpoints, gc the rest
    ckpt_keep: int = 3
    #: continue from the latest readable checkpoint in ``ckpt_dir``
    #: instead of starting at round 0 (bit-for-bit: the resumed
    #: trajectory reproduces the uninterrupted one field-for-field,
    #: modulo the documented provenance/wall-clock fields)
    resume: bool = False
    #: crash-injection test hook: SIGKILL our own process immediately
    #: after completing (and checkpointing) this round — a REAL hard
    #: kill, no cleanup handlers run (-1 disables; used by the CI
    #: kill-and-resume gate and tests/test_sim_resume.py)
    kill_after: int = -1
    # ---- fault injection (repro.sim.faults; active under the 'faulty'
    # ---- scenario, which installs a FaultInjector on the engine)
    #: seed of the fault schedule's own PRNG stream (-1: seed + 5)
    fault_seed: int = -1
    #: per-tick probability one active device crashes (rejoining
    #: ``fault_rejoin_after`` ticks later through the churn/reseed path)
    fault_crash_p: float = 0.15
    #: outage length of a crashed device, in ticks
    fault_rejoin_after: int = 2
    #: per-tick probability one pool shard is lost (ShardedPool runs;
    #: the pool detects it and recovers the shard's devices)
    fault_shard_p: float = 0.1
    #: per-tick probability the next pool op suffers 1..fault_retries
    #: transient failures before succeeding
    fault_op_p: float = 0.2
    #: per-exchange probability an async gossip model transfer is lost
    fault_gossip_drop_p: float = 0.15
    #: bounded-retry budget for transient pool-op failures
    fault_retries: int = 3
    #: base of the exponential retry backoff, seconds (0: no sleeping)
    fault_backoff_s: float = 0.0
    # ---- trace subsystem (repro.sim.trace)
    #: record per-phase wall-clock events (train / divergence /
    #: transfer / solve / eval / checkpoint) into the RoundRecord
    #: ``*_wall_s`` fields; off by default — tracing-off runs are
    #: the same trajectory (no seed use, no extra device
    #: synchronization)
    trace: bool = False
    #: optional standalone JSONL trace file for the recorded events
    #: (the cost-model fit input; requires ``trace=True``)
    trace_path: Optional[str] = None
    #: floor of the power-of-two bucket widths the async subset-gather
    #: training step compiles for (LocalPool; the autotuner's "gather
    #: bucket size" knob).  Width choice never changes per-lane values,
    #: only batch padding, so this is trajectory-preserving
    train_gather_floor: int = 4
    log_path: Optional[str] = None
    verbose: bool = False

    def __post_init__(self):
        """Reject impossible configurations at CONSTRUCTION, with
        actionable messages — not ticks later inside a jitted phase."""
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.rounds < 0:
            raise ValueError(f"rounds must be >= 0, got {self.rounds}")
        if self.div_budget < -1:
            raise ValueError(
                f"div_budget must be -1 (n_active), 0 (unbounded) or "
                f"positive, got {self.div_budget}")
        if self.div_refresh not in ("dirty", "all"):
            raise ValueError(
                f"unknown div_refresh {self.div_refresh!r}; "
                "available: dirty, all")
        if self.div_key_mode not in ("positional", "content"):
            raise ValueError(
                f"unknown div_key_mode {self.div_key_mode!r}; "
                "available: positional, content")
        if self.gossip_topology not in ("uniform", "ring", "k-regular"):
            raise ValueError(
                f"unknown gossip_topology {self.gossip_topology!r}; "
                "available: uniform, ring, k-regular")
        if self.checkpoint_every is not None:
            if self.checkpoint_every <= 0:
                raise ValueError(
                    f"checkpoint_every must be >= 1 round, got "
                    f"{self.checkpoint_every} (omit it to disable "
                    f"checkpointing)")
            if not self.ckpt_dir:
                raise ValueError(
                    "checkpoint_every is set but ckpt_dir is not — "
                    "checkpoints need a directory to live in")
        if self.resume and not self.ckpt_dir:
            raise ValueError(
                "resume=True needs ckpt_dir pointing at the "
                "interrupted run's checkpoint directory")
        if self.ckpt_keep < 1:
            raise ValueError(f"ckpt_keep must be >= 1, got "
                             f"{self.ckpt_keep}")
        for knob in ("fault_crash_p", "fault_shard_p", "fault_op_p",
                     "fault_gossip_drop_p"):
            p = getattr(self, knob)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{knob} is a probability, got {p}")
        if self.fault_retries < 0:
            raise ValueError(f"fault_retries must be >= 0, got "
                             f"{self.fault_retries}")
        if self.trace_path and not self.trace:
            raise ValueError(
                "trace_path is set but trace=False — enable tracing "
                "or drop the path")
        if self.train_gather_floor < 1:
            raise ValueError(f"train_gather_floor must be >= 1, got "
                             f"{self.train_gather_floor}")
        self._refuse_not_ported()

    def _refuse_not_ported(self):
        """Fields of the reference's features this port does not run
        yet raise here, each naming the ROADMAP.md item that brings it
        (defaults pass, so a reference config maps over one to one)."""
        item3 = "queue 1 item 3 (async and drift)"
        item4 = "queue 1 item 4 (robustness and trace)"
        refused = []
        if self.engine != "sync":
            refused.append((f"engine={self.engine!r}", item3))
        if self.div_key_mode != "positional":
            refused.append((f"div_key_mode={self.div_key_mode!r}", item3))
        if self.mesh:
            refused.append((f"mesh={self.mesh}",
                            "queue 1 item 5 (sharded pool)"))
        for knob in ("checkpoint_every", "ckpt_dir"):
            if getattr(self, knob) is not None:
                refused.append((f"{knob}={getattr(self, knob)!r}", item4))
        if self.resume:
            refused.append(("resume=True", item4))
        if self.kill_after >= 0:
            refused.append((f"kill_after={self.kill_after}", item4))
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for knob in FAULT_KNOBS:
            if getattr(self, knob) != defaults[knob]:
                refused.append((f"{knob}={getattr(self, knob)!r}", item4))
        if refused:
            raise NotImplementedError(
                "not ported to repro_torch yet: " + "; ".join(
                    f"{what} (ROADMAP.md {where})"
                    for what, where in refused))


class SimulationEngine:
    def __init__(self, cfg: SimConfig, *, device: DeviceLike = None,
                 params0: Optional[Mapping[str, np.ndarray]] = None,
                 draws: Optional["DrawsProvider"] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.draws = draws
        scen_cls = get_scenario(cfg.scenario)
        self.rng = np.random.default_rng(cfg.seed)
        self.scenario = scen_cls(cfg, np.random.default_rng(cfg.seed + 1))

        spares = cfg.spares if cfg.spares >= 0 else scen_cls.wants_spares
        pool = build_network(cfg.setting, num_devices=cfg.devices,
                             samples_per_device=cfg.samples_per_device,
                             seed=cfg.seed)
        for k in range(spares):
            ratio = 0.0 if self.rng.random() < 0.5 \
                else float(self.rng.uniform(0.3, 0.9))
            pool.append(make_device(cfg.setting, cfg.samples_per_device,
                                    cfg.seed + 9000 + k, ratio,
                                    rng=self.rng))
        p = len(pool)
        active = np.zeros(p, bool)
        active[:cfg.devices] = True

        s_init, self.key = (int(s) for s in split_seed(cfg.seed, 2))
        params = params_from_jax(params0, self.device) \
            if params0 is not None \
            else init_client_params(p, generator(s_init), device=self.device)
        self.state = NetworkState(
            round=0, pool=pool, active=active,
            clients=stack_clients(pool, device=self.device),
            params=params,
            eps_hat=np.ones(p), own_acc=np.zeros(p),
            div_hat=np.zeros((p, p)), div_known=np.eye(p, dtype=bool),
            div_dirty=np.zeros((p, p), bool),
            div_tick=np.full((p, p), -1, int),
            energy=EnergyModel.sample(p, np.random.default_rng(cfg.seed)),
            psi=np.zeros(p), alpha=np.zeros((p, p)))
        self._restack = False
        self._membership_dirty = False
        self._prev_links: set = set()
        self._energy_cum = 0.0
        self._solve_tick = -1
        #: fault injection comes with the 'faulty' scenario (not ported);
        #: the executor reads it
        self.faults = None
        self._resume_count = 0
        #: per-phase wall-clock recorder — a no-op unless cfg.trace;
        #: constructed before the pool/executor so both can reference it
        #: unconditionally
        self.trace = TraceRecorder(cfg, self.device)
        self.pool = make_pool(self)
        self.executor = get_executor(cfg.engine)(self)
        self.logger = MetricsLogger(cfg.log_path)

    # ------------------------------------------------- scenario mutation API
    def drift_channels(self, rng: np.random.Generator, sigma: float):
        self.state.energy = self.state.energy.drift(rng, sigma)

    def set_active(self, device: int, flag: bool):
        was = bool(self.state.active[device])
        self.state.active[device] = flag
        self._membership_dirty = True
        if flag and not was and self.cfg.reseed_on_rejoin \
                and self.state.solver is not None:
            self._reseed_device(device)

    def reveal_labels(self, device: int, frac: float,
                      rng: np.random.Generator):
        self.state.pool[device] = reveal_labels(self.state.pool[device],
                                                frac, rng)
        self._restack = True

    def set_tick_period(self, device: int, period: int):
        """Re-rate one device's local clock (no-op under executors that
        keep no clocks, i.e. sync)."""
        if self.state.clocks is not None:
            self.state.clocks.set_period(device, period)

    def drift_features(self, device: int, mix: float,
                       domain: Optional[str] = None) -> str:
        """Feature drift (the feature-drift scenarios' mutation)."""
        raise NotImplementedError(
            "drift_features: feature drift is not ported to repro_torch "
            "yet (ROADMAP.md queue 1 item 3 (async and drift))")

    # ------------------------------------------------------------ internals
    def _reseed_device(self, j: int):
        """Churn-robust transfer: a (re)joining device adopts the
        consensus source mixture of the last solved assignment (the mean
        of the column-normalized alpha over its target columns — exactly
        the embedded ``state.alpha``) applied to the sources' CURRENT
        params, instead of keeping whatever it held when it left (or its
        fresh initialization, for first-time joiners from the spare
        pool)."""
        st = self.state
        sa = np.asarray(st.solve_active)
        psi_sv = st.psi[sa]
        srcs = sa[psi_sv == 0.0]
        tgts = sa[psi_sv == 1.0]
        if len(srcs) == 0:
            return
        if len(tgts):
            w = st.alpha[:, tgts].mean(axis=1)
        else:
            w = np.zeros(st.pool_size)
        if w.sum() <= 1e-12:
            w = np.zeros(st.pool_size)
            w[srcs[int(np.argmin(st.eps_hat[srcs]))]] = 1.0
        w = w / w.sum()
        wj = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        params = {}
        for k, v in st.params.items():
            v = v.clone()
            v[j] = torch.tensordot(wj.to(v.dtype), v, dims=1)
            params[k] = v
        st.params = params

    def _drift_metric(self) -> float:
        st = self.state
        if st.solver is None or st.ref_K is None:
            return float("inf")
        a = st.active_idx
        sub = np.ix_(a, a)
        off = ~np.eye(len(a), dtype=bool)
        ref_k, cur_k = st.ref_K[sub][off], st.energy.K[sub][off]
        dk = float(np.abs(cur_k - ref_k).mean()
                   / max(float(ref_k.mean()), 1e-12))
        de = float(np.abs(st.eps_hat[a] - st.ref_eps[a]).mean())
        dd = float(np.abs(self._divergence_view()[sub]
                          - st.ref_div[sub]).mean())
        return dk + de + dd

    def _warm_for(self, a: np.ndarray) -> Optional[SolverResult]:
        """Previous solve, remapped onto the current active set (numpy
        fancy indexing over the churn — both index sets are sorted, so
        surviving devices are located with one searchsorted)."""
        st = self.state
        if st.solver is None:
            return None
        if np.array_equal(a, st.solve_active):
            return st.solver
        n = len(a)
        psi0 = np.full(n, 0.5)                  # new joiners: undecided
        alpha0 = np.full((n, n), 1e-3)
        np.fill_diagonal(alpha0, 0.0)
        sa = np.asarray(st.solve_active)
        if len(sa):
            loc = np.minimum(np.searchsorted(sa, a), len(sa) - 1)
            kept = sa[loc] == a                 # device also in last solve
            new_pos = np.flatnonzero(kept)
            old_pos = loc[kept]
            psi0[new_pos] = st.solver.psi_relaxed[old_pos]
            alpha0[np.ix_(new_pos, new_pos)] = \
                st.solver.alpha_relaxed[np.ix_(old_pos, old_pos)]
        return SolverResult(
            psi=(psi0 >= 0.5).astype(float), alpha=alpha0,
            psi_relaxed=psi0, alpha_relaxed=alpha0, objective_trace=[],
            objective_parts={}, converged=False, outer_iters=0,
            x_relaxed=None)

    def _divergence_view(self) -> np.ndarray:
        """Full-pool divergences as the SOLVER sees them.  Executors
        that measure pairs lazily (async gossip) substitute
        ``div_prior`` for never-estimated pairs: the div_hat init of 0
        is the most OPTIMISTIC possible value, and feeding it to the
        solver would concentrate alpha on exactly the links nobody
        measured.  The drift metric and the re-solve reference snapshot
        use the same view, so a gossip measurement registers drift only
        to the extent it DIFFERS from the prior the solver assumed —
        not by merely arriving.  Under sync every active pair is
        estimated before any solve and this is the raw measured
        matrix."""
        st, cfg = self.state, self.cfg
        if not self.executor.divergence_prior_view or cfg.div_prior <= 0:
            return st.div_hat
        div = np.array(st.div_hat, float, copy=True)
        unknown = ~st.div_known
        np.fill_diagonal(unknown, False)
        div[unknown] = cfg.div_prior
        return div

    def _solve(self, a: np.ndarray) -> SolverResult:
        st, cfg = self.state, self.cfg
        sub = np.ix_(a, a)
        counts = st.clients.counts.cpu().numpy()
        bounds = BoundTerms(eps_hat=st.eps_hat[a], n_data=counts[a],
                            div_hat=self._divergence_view()[sub])
        prob = STLFProblem(bounds,
                           EnergyModel(K=st.energy.K[sub],
                                       eps_e=st.energy.eps_e),
                           phi_s=cfg.phi_s, phi_t=cfg.phi_t,
                           phi_e=cfg.phi_e)
        warm = self._warm_for(a)
        # The reduced warm budget is earned only by a true continuation
        # seed (same membership, drifted data).  Churn re-solves are
        # warm-started too, but their joiners are seeded near-cold
        # (psi=0.5), so they keep the full inner budget.
        continuation = warm is not None \
            and np.array_equal(a, st.solve_active)
        steps = cfg.solver_inner_steps_warm if continuation \
            else cfg.solver_inner_steps
        return solve_stlf(prob, max_outer=cfg.solver_max_outer,
                          inner_steps=steps,
                          inner_tol=cfg.solver_inner_tol,
                          warm_start=warm, verbose=cfg.verbose,
                          device=self.device)

    def _install_solution(self, a: np.ndarray, res: SolverResult, t: int):
        """Adopt a fresh SolverResult: embed psi/alpha at pool indices,
        snapshot the drift references, stamp the solve tick."""
        st = self.state
        st.solver = res
        st.solve_active = a.copy()
        st.ref_K = st.energy.K.copy()
        st.ref_eps = st.eps_hat.copy()
        st.ref_div = self._divergence_view().copy()
        st.psi = np.zeros(st.pool_size)
        st.alpha = np.zeros((st.pool_size, st.pool_size))
        st.psi[a] = res.psi
        st.alpha[np.ix_(a, a)] = column_normalize(
            res.alpha, res.psi, energy_K=st.energy.K[np.ix_(a, a)],
            eps_hat=st.eps_hat[a])
        self._membership_dirty = False
        self._solve_tick = t

    # ---------------------------------------------------------------- round
    def step(self, t: int) -> dict:
        return self.executor.step(t)

    def run(self) -> List[dict]:
        """Execute rounds ``state.round .. rounds-1``."""
        try:
            for t in range(self.state.round, self.cfg.rounds):
                self.step(t)
                self.state.round = t + 1
        finally:
            self.logger.close()
            self.trace.close()
        return self.logger.records
