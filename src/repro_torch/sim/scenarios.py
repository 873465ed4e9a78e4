"""Scenario registry: named time-evolution processes for the network
(the port of ``repro.sim.scenarios``: every scenario, drawing from the
same numpy streams, so one seed gives the same events in both
packages).

A scenario mutates the engine's NetworkState once per round through the
engine's mutation API (drift_channels / set_active / reveal_labels /
set_tick_period / drift_features) and returns a list of event dicts
that land in the round's metrics record.

Registered scenarios:
  static        nothing changes — the multi-round control
  channel-drift EnergyModel.K drifts log-normally every round
  device-churn  devices leave and (spare-slot) devices join; psi must be
                re-decided whenever membership changes
  label-arrival unlabeled devices gradually gain labels, flipping targets
                into sources as their empirical error drops
  async-gossip  clock-drift control for the async executor: device tick
                periods are occasionally re-drawn; no data/channel change
  stragglers    a fixed fraction of devices runs on a much slower clock;
                the straggler set slowly rotates
  feature-drift a designated subset of devices' FEATURE distributions
                slide toward a foreign domain over time (domain
                interpolation), dirtying their Algorithm-1 pairs for the
                executors' budgeted re-estimation
  feature-drift-async
                feature-drift + occasional clock re-draws — the domain
                shift regime under the async executor
  faulty        fault-injection workload (repro_torch.sim.faults): device
                crashes with later rejoin, shard losses, transient
                pool-op failures and dropped gossip exchanges on a
                seeded schedule; the fault_* SimConfig knobs tune it

The clock scenarios mutate device tick rates through
``engine.set_tick_period`` and are only meaningful under
``--engine async-gossip`` (under sync there are no clocks and they
degenerate to ``static``).  Scenarios that need to see the initial state
(e.g. to designate stragglers) override ``setup``, called once after the
engine and its executor are constructed.
"""
from __future__ import annotations

from typing import Dict, List, Type

import numpy as np

SCENARIOS: Dict[str, Type["Scenario"]] = {}


def register(name: str):
    def deco(cls):
        cls.name = name
        SCENARIOS[name] = cls
        return cls
    return deco


#: the reference's scenarios this port does not run (none since the async,
#: drift and fault slice)
NOT_PORTED: Dict[str, str] = {}


def get_scenario(name: str) -> Type["Scenario"]:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"scenario {name!r} is not ported to repro_torch yet "
            f"(ROADMAP.md {NOT_PORTED[name]}); ported: {sorted(SCENARIOS)}")
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"available: {sorted(SCENARIOS)}")
    return SCENARIOS[name]


class Scenario:
    """Base: holds the scenario RNG; subclasses override step()."""

    name = "base"
    #: extra spare pool slots the engine should allocate for this scenario
    wants_spares = 0

    def __init__(self, cfg, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng

    def setup(self, engine):
        """One-time hook after engine/executor construction."""

    def step(self, engine, t: int) -> List[dict]:
        return []

    # ---------------------------------------------- checkpoint support
    def state_dict(self) -> dict:
        """Scenario-owned mutable state for run checkpoints (base: the
        RNG stream; subclasses append their own fields).  Must be
        JSON-serializable — it rides in the checkpoint metadata."""
        return {"rng": self.rng.bit_generator.state}

    def load_state_dict(self, state: dict):
        self.rng.bit_generator.state = state["rng"]


@register("static")
class Static(Scenario):
    """Control: the network never changes; the engine should solve once
    and skip every subsequent re-solve."""


@register("channel-drift")
class ChannelDrift(Scenario):
    """Per-round multiplicative log-normal drift of the channel gains
    (time-varying rates/powers -> time-varying K)."""

    def __init__(self, cfg, rng):
        super().__init__(cfg, rng)
        self.sigma = getattr(cfg, "drift_sigma", 0.15)

    def step(self, engine, t):
        engine.drift_channels(self.rng, self.sigma)
        return [{"event": "channel_drift", "sigma": self.sigma}]


@register("device-churn")
class DeviceChurn(Scenario):
    """Random departures and joins.  Joins pull devices from the spare
    pool (fresh data, divergences unknown -> estimated incrementally);
    departures deactivate.  Membership changes always force a re-solve."""

    wants_spares = 4

    def __init__(self, cfg, rng):
        super().__init__(cfg, rng)
        self.p_leave = getattr(cfg, "churn_p_leave", 0.35)
        self.p_join = getattr(cfg, "churn_p_join", 0.35)
        self.min_active = max(3, cfg.devices // 2)

    def step(self, engine, t):
        st = engine.state
        events: List[dict] = []
        active = st.active_idx
        inactive = np.flatnonzero(~st.active)
        if len(active) > self.min_active \
                and self.rng.random() < self.p_leave:
            gone = int(active[self.rng.integers(len(active))])
            engine.set_active(gone, False)
            events.append({"event": "leave", "device": gone})
        if len(inactive) > 0 and self.rng.random() < self.p_join:
            join = int(inactive[self.rng.integers(len(inactive))])
            engine.set_active(join, True)
            events.append({"event": "join", "device": join})
        return events


def _maybe_retick(scenario: "Scenario", engine, p: float) -> List[dict]:
    """Shared clock-redraw block (async-gossip + feature-drift-async):
    with probability ``p``, re-draw one active device's clock period
    from the configured set.  The leading ``random()`` is drawn
    UNCONDITIONALLY so the scenario's rng stream is engine-agnostic
    (under sync there are no clocks and the draw is simply discarded)."""
    st = engine.state
    r = scenario.rng.random()
    if st.clocks is None or r >= p:
        return []
    a = st.active_idx
    dev = int(a[scenario.rng.integers(len(a))])
    period = int(scenario.rng.choice(
        np.asarray(list(scenario.cfg.tick_periods), int)))
    engine.set_tick_period(dev, period)
    return [{"event": "retick", "device": dev, "period": period}]


@register("async-gossip")
class AsyncGossip(Scenario):
    """Clock-drift control for the async-gossip executor: no exogenous
    data or channel mutation, but with probability ``retick_p`` per tick
    one active device's clock period is re-drawn from the configured
    period set — devices speed up and slow down over the run."""

    def __init__(self, cfg, rng):
        super().__init__(cfg, rng)
        self.p = getattr(cfg, "retick_p", 0.1)

    def step(self, engine, t):
        return _maybe_retick(self, engine, self.p)


@register("stragglers")
class Stragglers(Scenario):
    """A fixed fraction of devices runs on a much slower clock (the
    straggler/participation regime of async FL); occasionally one
    straggler recovers and a previously-fast device starts straggling,
    so the slow set rotates without changing its size."""

    def __init__(self, cfg, rng):
        super().__init__(cfg, rng)
        self.frac = getattr(cfg, "straggler_frac", 0.25)
        self.period = getattr(cfg, "straggler_period", 8)
        self.p_swap = getattr(cfg, "straggler_p_swap", 0.1)
        self.stragglers: set = set()
        self._orig_period: dict = {}     # sampled period, restored on recovery

    def _straggle(self, engine, device: int):
        self.stragglers.add(device)
        self._orig_period[device] = int(engine.state.clocks.period[device])
        engine.set_tick_period(device, self.period)

    def setup(self, engine):
        st = engine.state
        if st.clocks is None:
            return
        a = st.active_idx
        k = max(1, int(round(self.frac * len(a))))
        for i in sorted(int(i) for i in
                        self.rng.choice(a, size=k, replace=False)):
            self._straggle(engine, i)

    def state_dict(self):
        d = super().state_dict()
        d["stragglers"] = sorted(self.stragglers)
        d["orig_period"] = {str(k): int(v)
                            for k, v in self._orig_period.items()}
        return d

    def load_state_dict(self, state):
        super().load_state_dict(state)
        self.stragglers = set(int(i) for i in state["stragglers"])
        self._orig_period = {int(k): int(v)
                             for k, v in state["orig_period"].items()}

    def step(self, engine, t):
        st = engine.state
        events: List[dict] = []
        if st.clocks is None:
            return events
        if self.rng.random() < self.p_swap and self.stragglers:
            back = int(self.rng.choice(sorted(self.stragglers)))
            self.stragglers.remove(back)
            restored = self._orig_period.pop(back, 1)
            engine.set_tick_period(back, restored)
            events.append({"event": "recover", "device": back,
                           "period": restored})
            fast = [int(i) for i in st.active_idx
                    if int(i) not in self.stragglers and int(i) != back]
            if fast:
                slow = fast[self.rng.integers(len(fast))]
                self._straggle(engine, slow)
                events.append({"event": "straggle", "device": slow,
                               "period": self.period})
        return events


@register("feature-drift")
class FeatureDrift(Scenario):
    """Domain shift over time (the regime of Yao et al. 2021 / FACT): a
    ``feature_drift_frac`` subset of the initially-active devices is
    designated as drifters at setup, and each tick each drifter's
    domain mix advances by ``feature_drift_step`` with probability
    ``feature_drift_p`` (absolute mix, clipped at 1.0 — a device ends
    fully re-rendered in its alt domain).  Every drift step re-blends
    the device's features through ``engine.drift_features``, which
    dirties its Algorithm-1 pairs; the executors re-measure a budgeted
    stalest-first subset each tick and the moved estimates drive
    ``resolve_reason='drift'`` warm re-solves."""

    def __init__(self, cfg, rng):
        super().__init__(cfg, rng)
        self.frac = getattr(cfg, "feature_drift_frac", 0.5)
        self.p = getattr(cfg, "feature_drift_p", 0.3)
        self.step_size = getattr(cfg, "feature_drift_step", 0.15)
        self.mix: dict = {}              # drifter -> current absolute mix

    def setup(self, engine):
        a = engine.state.active_idx
        k = max(1, int(round(self.frac * len(a))))
        self.mix = {int(d): 0.0 for d in sorted(
            int(i) for i in self.rng.choice(a, size=k, replace=False))}

    def state_dict(self):
        d = super().state_dict()
        d["mix"] = {str(k): float(v) for k, v in self.mix.items()}
        return d

    def load_state_dict(self, state):
        super().load_state_dict(state)
        # dict order is part of the trajectory (step() iterates it);
        # JSON preserves insertion order, so rebuild in the saved order
        self.mix = {int(k): float(v) for k, v in state["mix"].items()}

    def step(self, engine, t):
        events: List[dict] = []
        for d in self.mix:
            # draw unconditionally so the event stream of the OTHER
            # drifters is unaffected by one device leaving/saturating
            r = self.rng.random()
            if not engine.state.active[d] or self.mix[d] >= 1.0 \
                    or r >= self.p:
                continue
            self.mix[d] = min(1.0, self.mix[d] + self.step_size)
            domain = engine.drift_features(d, self.mix[d])
            events.append({"event": "feature_drift", "device": d,
                           "mix": round(self.mix[d], 6),
                           "domain": domain})
        return events


@register("feature-drift-async")
class FeatureDriftAsync(FeatureDrift):
    """Feature drift under the async executor's world: the same domain
    interpolation schedule, plus the ``async-gossip`` scenario's
    occasional clock re-draws (``retick_p``) — so budgeted dirty-pair
    re-estimation, gossip measurement, and heterogeneous clocks all
    interact.  Degenerates to plain feature-drift under ``sync`` (no
    clocks to mutate)."""

    def __init__(self, cfg, rng):
        super().__init__(cfg, rng)
        self.retick_p = getattr(cfg, "retick_p", 0.1)

    def step(self, engine, t):
        events = super().step(engine, t)
        events.extend(_maybe_retick(self, engine, self.retick_p))
        return events


@register("faulty")
class Faulty(Scenario):
    """Fault-injection workload (repro_torch.sim.faults): installs a
    FaultInjector on the engine at setup and advances its seeded
    schedule every tick — device crashes with later rejoin through the
    churn/reseed path, shard losses the ShardedPool detects and
    recovers, transient pool-op failures ridden out with bounded retry,
    and (async executor) dropped gossip exchanges.  The schedule runs
    on its own PRNG stream (``fault_seed``, default ``seed + 5``) so
    the fault pattern is independent of every other scenario draw, and
    the injector's state is part of the run checkpoint — a resumed
    faulty run replays the exact same failures."""

    def setup(self, engine):
        from repro_torch.sim.faults import FaultInjector
        cfg = self.cfg
        seed = cfg.fault_seed if cfg.fault_seed >= 0 else cfg.seed + 5
        engine.faults = FaultInjector(cfg, np.random.default_rng(seed))

    def step(self, engine, t):
        return engine.faults.begin_tick(engine, t)


@register("label-arrival")
class LabelArrival(Scenario):
    """Each round, each partially/fully-unlabeled active device receives
    labels for a fraction of its hidden samples with some probability —
    the streaming-annotation regime: targets become sources over time."""

    def __init__(self, cfg, rng):
        super().__init__(cfg, rng)
        self.frac = getattr(cfg, "label_frac", 0.25)
        self.p_device = getattr(cfg, "label_p_device", 0.5)

    def step(self, engine, t):
        st = engine.state
        events: List[dict] = []
        for i in st.active_idx:
            dev = st.pool[i]
            if dev.n_labeled == dev.n:
                continue
            if self.rng.random() < self.p_device:
                n_before = dev.n_labeled
                engine.reveal_labels(int(i), self.frac, self.rng)
                events.append({"event": "labels", "device": int(i),
                               "labeled_before": int(n_before),
                               "labeled_after":
                                   int(st.pool[i].n_labeled)})
        return events
