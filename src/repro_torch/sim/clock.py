"""Numpy copy of ``repro.sim.clock``: the port imports nothing of the JAX
package.

Heterogeneous device clocks for the async-gossip execution layer.

Each device advances on its own local clock: device i performs a local
training step only on global ticks t with ``(t - phase[i]) % period[i]
== 0``.  Periods are sampled per device (and may be mutated by scenarios
— see ``stragglers``), phases desynchronize devices with equal periods so
the network never degenerates back into lockstep rounds.

``last_train`` tracks the tick of each device's most recent local step;
``staleness(t)`` is the tick-age of every device's contribution to the
global picture, the signal the async executor feeds into the re-solve
gate alongside the measured drift.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class DeviceClocks:
    period: np.ndarray       # (P,) int >= 1: global ticks per local step
    phase: np.ndarray        # (P,) int in [0, period): tick offset
    last_train: np.ndarray   # (P,) int: tick of last local step; -1 never

    @classmethod
    def sample(cls, n: int, periods: Sequence[int],
               rng: np.random.Generator) -> "DeviceClocks":
        """Draw each device's period uniformly from ``periods`` and a
        uniform phase inside it."""
        choices = np.asarray(list(periods), int)
        if len(choices) == 0 or np.any(choices < 1):
            raise ValueError(f"tick periods must be >= 1, got {periods!r}")
        period = choices[rng.integers(0, len(choices), size=n)]
        phase = rng.integers(0, period)
        return cls(period=period, phase=phase,
                   last_train=np.full(n, -1, int))

    @property
    def n_devices(self) -> int:
        return len(self.period)

    def eligible(self, t: int) -> np.ndarray:
        """(P,) bool: devices whose local clock fires at global tick t."""
        return (t - self.phase) % self.period == 0

    def mark_trained(self, idx: np.ndarray, t: int):
        self.last_train[idx] = t

    def staleness(self, t: int) -> np.ndarray:
        """(P,) ticks since each device last trained (never: t + 1)."""
        return t - self.last_train

    def set_period(self, device: int, period: int):
        """Re-rate one device's clock (scenario mutation: clock drift /
        straggling).  The phase is folded into the new period so the
        device keeps a valid offset."""
        period = int(period)
        if period < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        self.period[device] = period
        self.phase[device] = int(self.phase[device]) % period
