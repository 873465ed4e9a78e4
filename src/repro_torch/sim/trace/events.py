"""TraceRecorder: per-phase wall-clock events for the simulator (the
port of ``repro.sim.trace.events``).

Both executors and the pool bracket their heavy phases with
``start()`` / ``stop()`` (or report an externally-measured duration via
``add()``), and each completed phase becomes one structured event::

    {"phase": "train", "tick": 3, "n_devices": 64, "mesh": 0,
     "n_pairs": null, "seconds": 1.98, ...}

Per-tick accumulators surface into the JSONL metrics log as the
``*_wall_s`` RoundRecord fields (``tick_wall_fields``, popped by the
executors' ``_emit``) — nondeterministic fields, stripped from every
determinism comparison; the raw events are kept in ``events`` and
optionally streamed to a JSONL file (``SimConfig.trace_path``), the
input of the cost-model fit (``trace.model``).

Disabled (``SimConfig.trace=False``, the default) every method is an
early-returning no-op: no device synchronization is issued, and no
random stream is touched.  Enabled, ``stop(..., block=out)`` calls
``torch.cuda.synchronize()`` on a CUDA run (where JAX calls
``jax.block_until_ready``) so the interval covers the phase's device
work instead of its enqueue.
"""
from __future__ import annotations

import json
import os
import time
from typing import IO, List, Optional

import torch

#: trace phase -> the RoundRecord wall field its per-tick total lands in
#: (``solve`` is traced too but keeps its pre-existing ``solver_wall_s``
#: field, filled by the executors from SolverResult.solve_time_s)
WALL_FIELDS = {
    "train": "train_wall_s",
    "divergence": "div_wall_s",
    "transfer": "transfer_wall_s",
    "eval": "eval_wall_s",
    "checkpoint": "ckpt_wall_s",
}

PHASES = ("train", "divergence", "transfer", "solve", "eval",
          "checkpoint")


class TraceRecorder:
    """Per-phase wall-clock recording; a no-op unless ``cfg.trace``."""

    def __init__(self, cfg, device: Optional[torch.device] = None):
        self.enabled = bool(getattr(cfg, "trace", False))
        self._cuda = device is not None and device.type == "cuda"
        self.mesh = int(getattr(cfg, "mesh", 0) or 0)
        self.events: List[dict] = []
        self.tick = 0
        self._acc = {}                   # phase -> seconds this tick
        self._pending_ctx = {}           # merged into the next event
        self._fh: Optional[IO[str]] = None
        path = getattr(cfg, "trace_path", None)
        if self.enabled and path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "w")

    # ------------------------------------------------------------ timing
    def start(self) -> Optional[float]:
        """Phase entry: a perf_counter stamp, or None when disabled (the
        disabled fast path is this one attribute read)."""
        return time.perf_counter() if self.enabled else None

    def stop(self, phase: str, t0: Optional[float], *, block=None,
             **ctx):
        """Phase exit: ``t0`` is ``start()``'s return — None means the
        recorder is disabled and this returns immediately.  ``block``
        (the phase's outputs) set on a CUDA run synchronizes the device
        first, so the measured interval covers the phase's device work."""
        if t0 is None:
            return
        if block is not None and self._cuda:
            torch.cuda.synchronize()
        self.add(phase, time.perf_counter() - t0, **ctx)

    def add(self, phase: str, seconds: float, **ctx):
        """Record one completed phase (externally-measured durations —
        e.g. the solver's own solve_time_s — enter here directly)."""
        if not self.enabled:
            return
        self._acc[phase] = self._acc.get(phase, 0.0) + float(seconds)
        event = {"phase": phase, "tick": int(self.tick),
                 "mesh": self.mesh, "seconds": float(seconds)}
        if self._pending_ctx:
            event.update(self._pending_ctx)
            self._pending_ctx = {}
        event.update(ctx)
        self.events.append(event)
        if self._fh is not None:
            self._fh.write(json.dumps(event, default=float) + "\n")
            self._fh.flush()

    def with_ctx(self, **ctx):
        """Attach context the caller knows but the timed layer does not
        (e.g. the executor's dirty-pair count for the pool's refresh
        event); merged into the NEXT recorded event only."""
        if self.enabled:
            self._pending_ctx.update(ctx)

    # ------------------------------------------------- per-tick surface
    def begin_tick(self, t: int):
        self.tick = int(t)

    def tick_wall_fields(self) -> dict:
        """Pop this tick's per-phase totals as RoundRecord field values
        ({} when disabled, so the fields keep their 0.0 defaults)."""
        if not self.enabled:
            return {}
        out = {field: self._acc.pop(phase, 0.0)
               for phase, field in WALL_FIELDS.items()}
        self._acc.clear()
        return out

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
