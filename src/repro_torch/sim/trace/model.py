"""Numpy copy of ``repro.sim.trace.model``, without its default model.

The reference loads ``BENCH_trace.json`` when no model is named; its
coefficients were fitted on the reference's own machine, so here every
caller names its model (``CostModel.from_bench(path)`` has no default,
and ``python -m repro_torch.sim.run --autotune`` and
``python -m repro_torch.sim.replay`` refuse to run without one).

Per-phase cost model fitted from trace events and BENCH fixtures.

Each simulator phase gets a small linear model over structural features
the replay walker can compute without running anything:

  train / eval   a * ceil(N / mesh) + b      (per-shard lane count)
  transfer       a * N*ceil(N / mesh) + b    (mixture rows x lanes)
  divergence     a * n_pairs + b             (Algorithm-1 pair batch)
  solve          a * N + b                   (solver incl. jit compile)
  checkpoint     a * N + b                   (snapshot volume)

Costs are wall seconds; coefficients are fitted by least squares with
slopes clamped non-negative (a negative slope means the feature carried
no signal at the fitted sizes — the intercept then absorbs the mean).
First-call overhead (jit compile, tick-0 events) is kept OUT of the
steady fit where the data allows: phases with steady (tick >= 1) events
fit on those, and ``first_extra`` records the mean tick-0 residual the
replay adds back the first time a phase runs.  Phases that only ever
run on tick 0 (the bootstrap divergence, the cold solve under static)
fit on everything and carry their compile cost inside the fit.

The model is JSON-serializable (``to_dict`` / ``from_dict``) so
BENCH_trace.json commits the fitted coefficients alongside the raw
events they came from, and ``from_bench`` loads either a bench file
(new stamped schema or old) or a bare model dict.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional

import numpy as np

#: phase -> feature names (the last is always the intercept)
PHASE_FEATURES: Dict[str, List[str]] = {
    "train": ["lanes", "const"],
    "eval": ["lanes", "const"],
    "transfer": ["rows_x_lanes", "const"],
    "divergence": ["n_pairs", "const"],
    "solve": ["n_devices", "const"],
    "checkpoint": ["n_devices", "const"],
}


def _lanes(n: int, mesh: int) -> int:
    return math.ceil(n / max(int(mesh), 1))


def phase_features(phase: str, ctx: dict) -> np.ndarray:
    """Feature vector for one event/prediction context.  ``ctx`` needs
    ``n_devices`` and ``mesh`` (``n_pairs`` too for divergence).  An
    explicit ``lanes`` overrides the mesh-derived lane count — the
    async subset-gather path's bucketed batch width."""
    n = int(ctx.get("n_devices", 0))
    lanes = int(ctx["lanes"]) if ctx.get("lanes") is not None \
        else _lanes(n, ctx.get("mesh", 0))
    vals = {
        "lanes": lanes,
        "rows_x_lanes": n * lanes,
        "n_pairs": int(ctx.get("n_pairs", 0)),
        "n_devices": n,
        "const": 1.0,
    }
    return np.array([vals[f] for f in PHASE_FEATURES[phase]], float)


def _nn_lstsq(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with non-negative slopes: fit, then zero any
    negative slope column (iteratively, most negative first) and refit
    the remainder; finally clamp a negative intercept to 0."""
    keep = list(range(X.shape[1]))
    coef = np.zeros(X.shape[1])
    while keep:
        w = np.linalg.lstsq(X[:, keep], y, rcond=None)[0]
        slopes = [(c, i) for c, i in zip(w, keep) if i < X.shape[1] - 1]
        neg = [(c, i) for c, i in slopes if c < 0]
        if not neg:
            coef[:] = 0.0
            for c, i in zip(w, keep):
                coef[i] = c
            break
        keep.remove(min(neg)[1])
    if coef[-1] < 0:
        coef[-1] = 0.0
    return coef


class CostModel:
    """phase -> {features, coef, first_extra, n_events}."""

    def __init__(self, phases: Optional[Dict[str, dict]] = None):
        self.phases: Dict[str, dict] = phases or {}

    # ------------------------------------------------------------- fit
    @classmethod
    def fit(cls, events: Iterable[dict]) -> "CostModel":
        """Fit every phase present in ``events`` (trace-event dicts with
        ``phase``, ``tick``, ``seconds`` + structural context)."""
        by_phase: Dict[str, List[dict]] = {}
        for e in events:
            p = e.get("phase")
            if p in PHASE_FEATURES and "seconds" in e:
                by_phase.setdefault(p, []).append(e)
        model = cls()
        for phase, evs in by_phase.items():
            steady = [e for e in evs if e.get("tick", 0) >= 1]
            first = [e for e in evs if e.get("tick", 0) == 0]
            fit_on = steady if steady else evs
            X = np.stack([phase_features(phase, e) for e in fit_on])
            y = np.array([e["seconds"] for e in fit_on], float)
            coef = _nn_lstsq(X, y)
            first_extra = 0.0
            if steady and first:
                resid = [e["seconds"]
                         - float(phase_features(phase, e) @ coef)
                         for e in first]
                first_extra = max(0.0, float(np.mean(resid)))
            pred = X @ coef
            model.phases[phase] = {
                "features": list(PHASE_FEATURES[phase]),
                "coef": [float(c) for c in coef],
                "first_extra": float(first_extra),
                "n_events": len(evs),
                "mean_abs_err_s": float(np.mean(np.abs(pred - y))),
                "fit_meshes": sorted({int(e.get("mesh", 0)) for e in evs}),
            }
        return model

    # --------------------------------------------------------- predict
    def predict(self, phase: str, ctx: dict, *,
                first: bool = False) -> float:
        """Predicted wall seconds for one phase execution; 0.0 for a
        phase the model never saw (logged by callers, not hidden)."""
        spec = self.phases.get(phase)
        if spec is None:
            return 0.0
        sec = float(phase_features(phase, ctx) @ np.asarray(spec["coef"]))
        sec = max(0.0, sec)
        if first:
            sec += spec.get("first_extra", 0.0)
        return sec

    def known_meshes(self) -> set:
        out = set()
        for spec in self.phases.values():
            out.update(spec.get("fit_meshes", []))
        return out

    # --------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {"phases": self.phases}

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        return cls(dict(d.get("phases", d)))

    @classmethod
    def from_bench(cls, path: str) -> "CostModel":
        """Load from a BENCH_trace.json (stamped bench schema with a
        ``model`` key), an old-style bare model dict, or a raw trace
        JSONL file (falls back to fitting the events)."""
        if path.endswith(".jsonl"):
            return cls.fit(read_trace(path))
        with open(path) as f:
            obj = json.load(f)
        if "model" in obj:
            return cls.from_dict(obj["model"])
        if "phases" in obj:
            return cls.from_dict(obj)
        if "events" in obj:
            return cls.fit(obj["events"])
        raise ValueError(f"{path}: no cost model or trace events found")


def read_trace(path: str) -> List[dict]:
    """Read a standalone JSONL trace file back (tolerates a truncated
    final line, like the metrics reader)."""
    events = []
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    for i, ln in enumerate(lines):
        try:
            events.append(json.loads(ln))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break
            raise
    return events
