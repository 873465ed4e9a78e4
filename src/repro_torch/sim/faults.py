"""Numpy copy of ``repro.sim.faults``: the port imports nothing of the JAX
package.

Fault injection for the simulator: seeded, resumable failure schedules.

The paper's setting is a decentralized network of unreliable edge
devices, so failure is a WORKLOAD, not an exception path.  This module
injects four fault classes on a seeded schedule (its RNG state is part
of the run checkpoint, so an interrupted-and-resumed faulty run replays
the exact same failures):

  device crash    an active device drops out mid-run and rejoins
                  ``fault_rejoin_after`` ticks later through the
                  engine's churn path (``set_active`` — a rejoin
                  re-seeds its params from the solved source mixture
                  when ``reseed_on_rejoin`` is on)
  shard loss      one shard of a ``ShardedPool`` dies; the pool detects
                  it at its next op and recovers by routing the lost
                  shard's devices through the same churn/reseed path
                  instead of killing the run (the host-side
                  ``NetworkState`` survives; what is "lost" is the
                  devices' training state, which re-seeding replaces)
  transient op    a pool operation fails ``k <= fault_retries`` times
                  before succeeding; the pool rides it out with bounded
                  retry + exponential backoff (``with_retry``)
  gossip drop     a model exchange of an async-gossip meeting is lost
                  in flight (the divergence measurement of the meeting
                  still lands — chatter is cheap, model payloads are
                  what links lose)

The ``faulty`` scenario (repro_torch.sim.scenarios) owns the schedule: it
installs a ``FaultInjector`` on the engine and advances it every tick.
Executors and pools only consult ``engine.faults`` (None on fault-free
runs — zero overhead and zero PRNG consumption, so existing goldens are
untouched).  Per-tick counters land in the metrics as ``n_faults`` /
``n_recovered`` (docs/metrics-schema.md).
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

import numpy as np

if TYPE_CHECKING:                                   # no import cycle
    from repro_torch.sim.engine import SimulationEngine

__all__ = ["PoolFaultError", "FaultInjector", "with_retry"]


class PoolFaultError(RuntimeError):
    """A transient device-pool operation failure (injected or real).
    Retryable: pools wrap ops in ``with_retry`` and only let it
    propagate once the retry budget is exhausted."""


def with_retry(fn: Callable, *, retries: int, backoff_s: float = 0.0):
    """Run ``fn``, retrying up to ``retries`` times on PoolFaultError
    with exponential backoff (``backoff_s * 2**attempt`` seconds; 0
    skips sleeping, which is what tests and CI use).  Re-raises once the
    budget is spent — an op that fails ``retries + 1`` times is not
    transient."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except PoolFaultError:
            if attempt >= retries:
                raise
            if backoff_s > 0:
                time.sleep(backoff_s * (2 ** attempt))


class FaultInjector:
    """Seeded per-tick fault schedule (see module docstring).

    Determinism contract: ``begin_tick`` draws a FIXED number of
    uniforms per tick (one per fault class) regardless of whether the
    fault fires, so the schedule of tick t is independent of what
    happened on ticks < t — and checkpoint/resume only has to restore
    the RNG state + the down-device map to replay it exactly."""

    def __init__(self, cfg, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng
        #: device -> tick at which it rejoins
        self.down: Dict[int, int] = {}
        #: shard scheduled to be lost, consumed by the pool's fault gate
        self.pending_shard: Optional[int] = None
        #: injected consecutive failures the next pool op must ride out
        self.pending_op_failures = 0
        # per-tick counters, surfaced in the metrics record
        self.n_faults = 0
        self.n_recovered = 0

    # ------------------------------------------------------------ schedule
    def begin_tick(self, engine: "SimulationEngine", t: int) -> List[dict]:
        """Advance the schedule one tick: rejoin due devices, then draw
        this tick's crash / shard-loss / transient-op faults.  Returns
        the event dicts for the metrics record."""
        cfg = self.cfg
        self.n_faults = 0
        self.n_recovered = 0
        events: List[dict] = []

        # crashed devices whose outage has elapsed rejoin (sorted for a
        # deterministic order) through the engine's churn/reseed path
        for dev in sorted(self.down):
            if self.down[dev] <= t:
                del self.down[dev]
                engine.set_active(dev, True)
                self.n_recovered += 1
                events.append({"event": "rejoin", "device": dev})

        # device crash — all draws are unconditional so the stream is
        # independent of network state (cf. scenarios._maybe_retick)
        r_crash = self.rng.random()
        active = engine.state.active_idx
        floor = max(3, cfg.devices // 2)
        if cfg.fault_crash_p > 0 and r_crash < cfg.fault_crash_p \
                and len(active) > floor:
            dev = int(active[self.rng.integers(len(active))])
            engine.set_active(dev, False)
            rejoin = t + max(1, cfg.fault_rejoin_after)
            self.down[dev] = rejoin
            self.n_faults += 1
            events.append({"event": "crash", "device": dev,
                           "rejoin_tick": rejoin})

        # shard loss: schedule one shard to die; the pool's fault gate
        # detects and recovers it at this tick's first heavy op
        r_shard = self.rng.random()
        n_shards = int(getattr(engine.pool, "n_shards", 0))
        if cfg.fault_shard_p > 0 and r_shard < cfg.fault_shard_p:
            shard = int(self.rng.integers(max(n_shards, 1)))
            if n_shards >= 1:
                self.pending_shard = shard
                self.n_faults += 1
                events.append({"event": "shard_lost", "shard": shard})

        # transient pool-op failures: always recoverable within the
        # retry budget (1 <= k <= fault_retries consecutive failures)
        r_op = self.rng.random()
        if cfg.fault_op_p > 0 and r_op < cfg.fault_op_p \
                and cfg.fault_retries > 0:
            self.pending_op_failures = \
                1 + int(self.rng.integers(cfg.fault_retries))
            self.n_faults += 1
            events.append({"event": "pool_fault",
                           "failures": self.pending_op_failures})
        return events

    # ----------------------------------------------------- pool-side hooks
    def take_lost_shard(self) -> Optional[int]:
        """Consume the pending shard loss (None if no shard died)."""
        shard, self.pending_shard = self.pending_shard, None
        return shard

    def op_attempt_fails(self) -> bool:
        """One pool-op ATTEMPT: True while injected failures remain."""
        if self.pending_op_failures > 0:
            self.pending_op_failures -= 1
            return True
        return False

    def drop_exchange(self) -> bool:
        """Whether one gossip model exchange is lost in flight."""
        if self.cfg.fault_gossip_drop_p <= 0:
            return False
        if self.rng.random() < self.cfg.fault_gossip_drop_p:
            self.n_faults += 1
            return True
        return False

    # -------------------------------------------------- checkpoint support
    def state_dict(self) -> dict:
        return {"rng": self.rng.bit_generator.state,
                "down": {str(k): int(v) for k, v in self.down.items()},
                "pending_shard": self.pending_shard,
                "pending_op_failures": int(self.pending_op_failures)}

    def load_state_dict(self, state: dict):
        self.rng.bit_generator.state = state["rng"]
        self.down = {int(k): int(v) for k, v in state["down"].items()}
        self.pending_shard = state["pending_shard"]
        self.pending_op_failures = int(state["pending_op_failures"])
        self.n_faults = 0
        self.n_recovered = 0
