"""NetworkState: everything the simulator tracks about the device pool
(``repro.sim.state`` with ``params`` a dict of stacked tensors).

The pool is FIXED-SIZE (initial devices + spare slots for churn joins) so
every stacked computation keeps one shape; membership changes flip the
``active`` mask instead of reshaping arrays.  Inactive devices keep their
parameters (psi is forced to 0 / alpha rows+cols to 0 for them, so
apply_transfer leaves them untouched while they are away).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.energy import EnergyModel
from repro_torch.core.solver import SolverResult
from repro_torch.data.partition import DeviceData
from repro_torch.fl.client import StackedClients
from repro_torch.sim.clock import DeviceClocks


@dataclasses.dataclass
class NetworkState:
    round: int
    pool: List[DeviceData]          # size P (devices + spares)
    active: np.ndarray              # (P,) bool
    clients: StackedClients         # stacked FULL pool
    params: Dict[str, torch.Tensor]  # stacked per-device params, pool-major
    eps_hat: np.ndarray             # (P,)
    own_acc: np.ndarray             # (P,) accuracy of own params
    div_hat: np.ndarray             # (P, P) Algorithm-1 estimates
    div_known: np.ndarray           # (P, P) bool: pair ever estimated
    energy: EnergyModel             # K is (P, P)
    # current assignment, embedded at pool indices (inactive: psi=0, alpha=0)
    psi: np.ndarray                 # (P,)
    alpha: np.ndarray               # (P, P)
    solver: Optional[SolverResult] = None
    solve_active: Optional[np.ndarray] = None   # active idx at last solve
    # drift-aware staleness tracking over div_hat (both arrays symmetric,
    # maintained by the executors' refresh phases + engine.drift_features)
    #: (P, P) bool: pair's estimate invalidated by feature drift and not
    #: yet re-measured — candidates of the budgeted top-K refresh
    div_dirty: Optional[np.ndarray] = None
    #: (P, P) int: tick the pair was last estimated (-1: never) — the
    #: staleness rank the budgeted refresh orders dirty pairs by
    div_tick: Optional[np.ndarray] = None
    #: heterogeneous local clocks (async-gossip executor; None under sync)
    clocks: Optional[DeviceClocks] = None
    # measurement snapshot at the last solve (drift reference)
    ref_K: Optional[np.ndarray] = None
    ref_eps: Optional[np.ndarray] = None
    ref_div: Optional[np.ndarray] = None

    @property
    def pool_size(self) -> int:
        return len(self.pool)

    @property
    def active_idx(self) -> np.ndarray:
        return np.flatnonzero(self.active)

    @property
    def labeled_devices(self) -> np.ndarray:
        """(P,) bool, host-side: devices holding ANY labeled sample —
        the only ones whose local SGD ever applies (unlabeled devices
        progress through transfer/gossip alone)."""
        return self.clients.labeled.any(dim=1).cpu().numpy()

    def unknown_active_pairs(self) -> np.ndarray:
        """(M, 2) active pairs whose divergence was never estimated."""
        a = self.active_idx
        out = [(i, j) for ii, i in enumerate(a) for j in a[ii + 1:]
               if not self.div_known[i, j]]
        return np.asarray(out, np.int32).reshape(-1, 2)

    # ------------------------------------------- dirty-pair bookkeeping
    def mark_pairs_dirty(self, device: int):
        """Feature drift on ``device`` invalidates every Algorithm-1
        estimate involving it: flag the device's full row+column (not
        just currently-active partners — an inactive partner's stale
        estimate must still read as dirty when it rejoins)."""
        self.div_dirty[device, :] = True
        self.div_dirty[:, device] = True
        self.div_dirty[device, device] = False

    def dirty_active_pairs(self) -> np.ndarray:
        """(M, 2) upper-triangle ACTIVE pairs currently flagged dirty —
        the candidate set the budgeted refresh ranks by staleness."""
        a = self.active_idx
        sub = self.div_dirty[np.ix_(a, a)]
        ii, jj = np.nonzero(np.triu(sub, k=1))
        return np.stack([a[ii], a[jj]], axis=1).astype(np.int32) \
            if len(ii) else np.zeros((0, 2), np.int32)

    def mark_pairs_estimated(self, pairs: np.ndarray, t: int):
        """Record that ``pairs`` were (re-)measured on tick ``t``:
        known, clean, and freshly stamped (symmetric)."""
        pairs = np.atleast_2d(np.asarray(pairs, np.int32))
        if pairs.size == 0:
            return
        pi, pj = pairs[:, 0], pairs[:, 1]
        self.div_known[pi, pj] = self.div_known[pj, pi] = True
        self.div_dirty[pi, pj] = self.div_dirty[pj, pi] = False
        self.div_tick[pi, pj] = self.div_tick[pj, pi] = t
