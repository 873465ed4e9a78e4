"""Trace subsystem of the port: per-phase timing events
(``events.TraceRecorder``).  ``repro.sim.trace``'s cost model, what-if
replay and autotuner are not ported yet."""
from repro_torch.sim.trace.events import WALL_FIELDS, TraceRecorder

__all__ = ["TraceRecorder", "WALL_FIELDS"]
