"""Copy of ``repro.sim.metrics``: the port writes the JAX package's row
schema field for field (a port row and a JAX row of the same record have
the same keys, in the same order).

Per-round event/metrics log for the simulator (JSONL).

Schema (one JSON object per line, one line per round):
  round            int    0-based round index
  scenario         str    scenario name
  n_active         int    devices currently in the network
  n_sources        int    active devices with psi == 0
  n_targets        int    active devices with psi == 1
  resolved         bool   whether solve_stlf ran this round
  warm             bool   whether that solve was warm-started
  solver_iters     int    outer SCA iterations of that solve (0 if skipped)
  solver_wall_s    float  wall-clock seconds inside solve_stlf this round
                          (0.0 if the solve was skipped; nondeterministic)
  drift            float  drift metric vs. the last-solve snapshot
                          (-1.0 on rounds before any snapshot exists)
  mean_target_acc  float  ground-truth accuracy at targets (post-transfer)
  mean_source_acc  float  ground-truth accuracy at sources
  energy           float  network energy of this round's alpha (eq. 14)
  energy_cum       float  running total energy spent
  transmissions    int    active links
  link_churn       float  |L_t symdiff L_{t-1}| / |L_t union L_{t-1}|
  events           list   scenario events applied this round
  wall_time_s      float  wall-clock seconds for the round (excluded from
                          determinism comparisons)

Execution-layer fields (added with the executor refactor; the sync
executor fills the first two and the gate fields, async-only fields keep
their defaults under sync):
  engine           str    executor that produced the tick (sync |
                          async-gossip)
  n_trained        int    devices whose local SGD actually applied this
                          tick — active AND labeled, further restricted
                          to the clock-eligible subset under async
                          (unlabeled devices never train; they progress
                          through transfer/gossip alone)
  trained          list?  async: device ids that trained this tick
                          (null under sync)
  gossip           list?  async: [i, j] gossip meetings of this tick
                          (null under sync)
  gossip_topology  str?   async: the meeting graph the pairs were drawn
                          from — uniform | ring | k-regular (null under
                          sync)
  mean_staleness   float  async: mean ticks since each active device
                          last trained (-1.0 under sync)
  max_staleness    float  async: max of the same (-1.0 under sync)
  solve_age        int    ticks since the installed assignment was
                          solved, measured entering the tick (-1 before
                          the first solve)
  resolve_reason   str?   why the gate fired: cold | membership | drift
                          | staleness (async staleness bound); null when
                          no re-solve ran

Feature-drift / dirty-pair fields (added with the drift-aware budgeted
re-estimation; all 0 on ticks where nothing drifts, so pre-drift
scenarios read exactly as before):
  n_drifted        int    devices whose features drifted this tick
                          (feature_drift scenario events)
  n_dirty_pairs    int    active pairs flagged dirty entering the
                          refresh phase (estimates invalidated by drift,
                          not yet re-measured)
  n_reestimated    int    pairs the budgeted refresh re-measured this
                          tick (<= div_budget under div_refresh='dirty')

Fault-tolerance fields (added with the checkpoint/resume + fault
injection layer; all 0 on fault-free, never-resumed runs):
  n_faults         int    faults injected this tick (device crashes,
                          shard losses, transient pool-op failures,
                          dropped gossip exchanges)
  n_recovered      int    devices recovered this tick (crash rejoins +
                          lost-shard devices re-entered through the
                          churn/reseed path)
  resume_count     int    how many times this run has been resumed from
                          a checkpoint (0 on an uninterrupted run;
                          constant within one process lifetime)

Per-phase wall clocks (trace subsystem, repro_torch.sim.trace; all 0.0 unless
``SimConfig.trace`` is on, and all nondeterministic):
  train_wall_s     float  wall seconds in the pool's training phase
  div_wall_s       float  wall seconds in Algorithm-1 estimation
                          (bootstrap + gossip + budgeted refresh)
  transfer_wall_s  float  wall seconds in transfer (sync alpha-mixture /
                          async gossip model exchanges)
  eval_wall_s      float  wall seconds in the accuracy sweep
  ckpt_wall_s      float  wall seconds checkpointing — the PREVIOUS
                          round's snapshot (the engine checkpoints after
                          a round's record is emitted)

The authoritative field-by-field reference, including which fields are
nondeterministic, lives in docs/metrics-schema.md (CI checks every
RoundRecord field is documented there).
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import IO, List, Optional

# fields excluded when comparing runs: wall clocks (environment-
# dependent, including the per-phase walls the trace subsystem fills
# when SimConfig.trace is on) and resume_count (run PROVENANCE — a
# resumed run must reproduce the uninterrupted trajectory
# field-for-field except for the counter that says it was resumed)
NONDETERMINISTIC_FIELDS = ("wall_time_s", "solver_wall_s",
                           "train_wall_s", "div_wall_s",
                           "transfer_wall_s", "eval_wall_s",
                           "ckpt_wall_s", "resume_count")


@dataclasses.dataclass
class RoundRecord:
    round: int
    scenario: str
    n_active: int
    n_sources: int
    n_targets: int
    resolved: bool
    warm: bool
    solver_iters: int
    solver_wall_s: float
    drift: float
    mean_target_acc: float
    mean_source_acc: float
    energy: float
    energy_cum: float
    transmissions: int
    link_churn: float
    events: List[dict]
    wall_time_s: float
    # execution-layer fields (defaults = the sync engine's view)
    engine: str = "sync"
    n_trained: int = -1
    trained: Optional[List[int]] = None
    gossip: Optional[List[List[int]]] = None
    gossip_topology: Optional[str] = None
    mean_staleness: float = -1.0
    max_staleness: float = -1.0
    solve_age: int = -1
    resolve_reason: Optional[str] = None
    # feature-drift / dirty-pair fields (0 when nothing drifts)
    n_drifted: int = 0
    n_dirty_pairs: int = 0
    n_reestimated: int = 0
    # fault-tolerance fields (0 when no faults are injected / no resume)
    n_faults: int = 0
    n_recovered: int = 0
    resume_count: int = 0
    # per-phase wall clocks (trace subsystem; 0.0 unless SimConfig.trace
    # is on — all nondeterministic.  ckpt_wall_s carries the PREVIOUS
    # round's checkpoint: the engine snapshots after a round's record is
    # already emitted)
    train_wall_s: float = 0.0
    div_wall_s: float = 0.0
    transfer_wall_s: float = 0.0
    eval_wall_s: float = 0.0
    ckpt_wall_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class MetricsLogger:
    """Appends one JSON line per round; ``path=None`` collects in memory
    only (both modes keep ``records`` for programmatic access).

    Crash consistency: every row is flushed AND fsynced, so after a hard
    kill (SIGKILL, power loss) the log holds every completed round plus
    at most one truncated final line — which ``read_jsonl`` tolerates.
    That makes the log tail trustworthy for ``--resume``.

    ``resume_round``: continue an interrupted run's log in place — the
    existing file is read back (tolerating a truncated tail), rows from
    rounds the resumed engine will re-execute (``round >=
    resume_round``) are dropped, the file is rewritten to exactly the
    kept prefix, and subsequent ``log`` calls append.  ``records`` is
    seeded with the kept prefix so a resumed run still returns the FULL
    stitched history."""

    def __init__(self, path: Optional[str] = None,
                 resume_round: Optional[int] = None):
        self.path = path
        self.records: List[dict] = []
        self._fh: Optional[IO[str]] = None
        if not path:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if resume_round is not None and os.path.exists(path):
            kept = [r for r in read_jsonl(path)
                    if r.get("round", resume_round) < resume_round]
            with open(path, "w") as f:
                for row in kept:
                    f.write(json.dumps(row, default=float) + "\n")
            self.records = kept
            self._fh = open(path, "a")
        else:
            self._fh = open(path, "w")

    def log(self, record: RoundRecord) -> dict:
        row = record.to_dict()
        self.records.append(row)
        if self._fh:
            self._fh.write(json.dumps(row, default=float) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
        return row

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def read_jsonl(path: str) -> List[dict]:
    """Read a metrics log back.  A truncated FINAL line (the signature
    of a crash mid-write) is dropped with a warning — the complete
    prefix is still trustworthy; a malformed line anywhere else is real
    corruption and raises."""
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    rows = []
    for i, ln in enumerate(lines):
        try:
            rows.append(json.loads(ln))
        except json.JSONDecodeError as e:
            if i == len(lines) - 1:
                warnings.warn(
                    f"{path}: dropping truncated final line "
                    f"({len(ln)} chars) — interrupted write")
                break
            raise ValueError(
                f"{path}: malformed JSONL at line {i + 1}: {e}") from e
    return rows


def strip_nondeterministic(rows: List[dict]) -> List[dict]:
    """Rows minus wall-clock fields — the determinism-comparison view."""
    return [{k: v for k, v in r.items() if k not in NONDETERMINISTIC_FIELDS}
            for r in rows]
