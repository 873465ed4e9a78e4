"""Scenario registry: named time-evolution processes for the network
(the sync scenarios of ``repro.sim.scenarios``, drawing from the same
numpy streams, so one seed gives the same events in both packages).

A scenario mutates the engine's NetworkState once per round through the
engine's mutation API (drift_channels / set_active / reveal_labels) and
returns a list of event dicts that land in the round's metrics record.

Registered scenarios:
  static        nothing changes — the multi-round control
  channel-drift EnergyModel.K drifts log-normally every round
  device-churn  devices leave and (spare-slot) devices join; psi must be
                re-decided whenever membership changes
  label-arrival unlabeled devices gradually gain labels, flipping targets
                into sources as their empirical error drops

The reference's other scenarios are not ported yet (``NOT_PORTED``):
``get_scenario`` refuses them, naming the ROADMAP.md item that brings
them.
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


#: the reference's scenarios this port does not run yet -> where they
#: come (ROADMAP.md, queue 1)
NOT_PORTED = {
    "async-gossip": "queue 1 item 3 (async and drift)",
    "stragglers": "queue 1 item 3 (async and drift)",
    "feature-drift": "queue 1 item 3 (async and drift)",
    "feature-drift-async": "queue 1 item 3 (async and drift)",
    "faulty": "queue 1 item 4 (robustness and trace)",
}


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

    def step(self, engine, t: int) -> List[dict]:
        return []


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
