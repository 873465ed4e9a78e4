"""Trace subsystem of the port (``repro.sim.trace``): per-phase timing
events (``events.TraceRecorder``), the cost model fitted from them
(``model.CostModel``), the what-if replay walker (``replay``,
``python -m repro_torch.sim.replay``) and the knob autotuner (``tune``,
``python -m repro_torch.sim.run --autotune``).  The port ships no fitted
model: the model is fitted from a trace the caller recorded."""
from repro_torch.sim.trace.events import WALL_FIELDS, TraceRecorder
from repro_torch.sim.trace.model import CostModel, phase_features

__all__ = ["TraceRecorder", "WALL_FIELDS", "CostModel", "phase_features"]
