"""The numpy comparison baselines of ``repro.fl.baselines`` (Sec. V-B)
that the quickstart uses.

alpha-baselines (take psi as given, usually ST-LF's):
  rnd_alpha       — Dirichlet-random link weights
  fedavg_alpha    — weights ∝ source labeled-dataset size   [3]
  avg_degree      — ST-LF's average per-source degree, random links/weights

psi-baselines (also choose psi):
  random_psi      — random source/target split
  heuristic_psi   — labeled => source
  single_matching — one-to-one min-divergence matching      [34]-style

The FADA-style baseline (``fada_alpha``) is not ported.
"""
from __future__ import annotations

import numpy as np

from repro_torch.fl.client import StackedClients
from repro_torch.fl.transfer import column_normalize


def heuristic_psi(clients: StackedClients) -> np.ndarray:
    """Literature heuristic: any labeled data -> source (psi=0)."""
    has_lab = clients.labeled.any(dim=1).cpu().numpy()
    return np.where(has_lab, 0.0, 1.0)


def random_psi(n: int, rng: np.random.Generator) -> np.ndarray:
    psi = (rng.random(n) < 0.5).astype(float)
    if psi.all():
        psi[rng.integers(n)] = 0.0
    if not psi.any():
        psi[rng.integers(n)] = 1.0
    return psi


def rnd_alpha(psi: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    n = len(psi)
    a = np.zeros((n, n))
    srcs = np.flatnonzero(psi == 0.0)
    for j in np.flatnonzero(psi == 1.0):
        if len(srcs):
            a[srcs, j] = rng.dirichlet(np.ones(len(srcs)))
    return a


def fedavg_alpha(psi: np.ndarray, clients: StackedClients) -> np.ndarray:
    """FedAvg's data-size weighting, applied to labeled counts."""
    n = len(psi)
    sizes = clients.labeled.sum(dim=1).cpu().numpy().astype(float)
    a = np.zeros((n, n))
    srcs = np.flatnonzero(psi == 0.0)
    w = sizes[srcs]
    w = w / max(w.sum(), 1e-9) if w.sum() > 0 \
        else np.ones(len(srcs)) / max(len(srcs), 1)
    for j in np.flatnonzero(psi == 1.0):
        a[srcs, j] = w
    return a


def avg_degree_alpha(psi: np.ndarray, stlf_alpha: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
    """Each source gets ST-LF's average number of links; destinations and
    weights random."""
    n = len(psi)
    srcs = np.flatnonzero(psi == 0.0)
    tgts = np.flatnonzero(psi == 1.0)
    links = int((stlf_alpha > 1e-6).sum())
    deg = max(1, int(round(links / max(len(srcs), 1))))
    a = np.zeros((n, n))
    for s in srcs:
        dst = rng.permutation(tgts)[:min(deg, len(tgts))]
        a[s, dst] = rng.random(len(dst)) + 0.1
    return column_normalize(a, psi)


def single_matching_alpha(psi: np.ndarray, div: np.ndarray) -> np.ndarray:
    """SM: each target receives exactly one source — its min-divergence
    match (greedy one-to-one until sources run out, then reuse)."""
    n = len(psi)
    a = np.zeros((n, n))
    srcs = list(np.flatnonzero(psi == 0.0))
    free = list(srcs)
    for j in np.flatnonzero(psi == 1.0):
        pool = free if free else srcs
        best = pool[int(np.argmin([div[s, j] for s in pool]))]
        a[best, j] = 1.0
        if best in free:
            free.remove(best)
    return a
