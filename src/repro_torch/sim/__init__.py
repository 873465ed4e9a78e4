"""repro_torch.sim — the time-evolving decentralized-network simulator
on the port (``repro.sim``'s sync path).

A network of devices advances round by round under a named scenario
(static, channel drift, device churn, label arrival): local training
continues in one stacked call per round, divergence estimates refresh
incrementally, and the (P) solver re-runs — warm-started from the
previous solution — only when the measured drift exceeds a threshold.
Every round's transfer is the ``alpha_combine`` kernel on the GPU.

Entry points:
  python -m repro_torch.sim.run --scenario channel-drift --devices 8
  SimulationEngine(SimConfig(...), device="cpu").run()

Not ported yet (each refused with a message naming its ROADMAP.md
item): the async-gossip executor and the feature-drift scenarios, the
sharded pool, checkpoint/resume, fault injection and the trace cost
model.
"""
from repro_torch.sim.clock import DeviceClocks  # noqa: F401
from repro_torch.sim.engine import SimConfig, SimulationEngine  # noqa: F401
from repro_torch.sim.executors import EXECUTORS, get_executor  # noqa: F401
from repro_torch.sim.metrics import MetricsLogger, read_jsonl  # noqa: F401
from repro_torch.sim.scenarios import SCENARIOS, get_scenario  # noqa: F401
from repro_torch.sim.shard import DevicePool, make_pool  # noqa: F401
from repro_torch.sim.state import NetworkState  # noqa: F401
