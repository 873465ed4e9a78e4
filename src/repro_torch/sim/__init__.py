"""repro_torch.sim — the time-evolving decentralized-network simulator
on the port (``repro.sim``).

A network of devices advances tick by tick under a named scenario
(static, channel drift, device churn, label arrival, clock drift,
stragglers, feature drift, injected faults), under the sync executor
(every device trains each round, the alpha-mixture transfer — the
``alpha_combine`` kernel on the GPU — applies globally) or the
async-gossip one (local clocks, pairwise gossip exchanges): divergence
estimates refresh incrementally, and the (P) solver re-runs —
warm-started from the previous solution — only when the measured drift
(or, async, the assignment's age) calls for it.  Runs checkpoint and
resume crash-consistently (``snapshot``).

Entry points:
  python -m repro_torch.sim.run --scenario channel-drift --devices 8
  python -m repro_torch.sim.replay --model run.trace.jsonl
  python -m repro_torch.sim.run --mesh 1 ...   (the sharded pool)
  SimulationEngine(SimConfig(...), device="cpu").run()
  SimulationEngine(SimConfig(mesh=4, ...), device="cpu", emulate=True)

The pool axis runs on one device (``LocalPool``) or sharded over a
``mesh`` of local devices (``ShardedPool``), k shards emulated on one
device when the engine is built with ``emulate=True``.
"""
from repro_torch.sim.clock import DeviceClocks  # noqa: F401
from repro_torch.sim.engine import SimConfig, SimulationEngine  # noqa: F401
from repro_torch.sim.executors import EXECUTORS, get_executor  # noqa: F401
from repro_torch.sim.metrics import MetricsLogger, read_jsonl  # noqa: F401
from repro_torch.sim.scenarios import SCENARIOS, get_scenario  # noqa: F401
from repro_torch.sim.shard import DevicePool, make_pool  # noqa: F401
from repro_torch.sim.state import NetworkState  # noqa: F401
