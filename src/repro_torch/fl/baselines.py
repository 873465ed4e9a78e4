"""The paper's comparison baselines (Sec. V-B), as ``repro.fl.baselines``.

alpha-baselines (take psi as given, usually ST-LF's):
  rnd_alpha       — Dirichlet-random link weights
  fedavg_alpha    — weights ∝ source labeled-dataset size   [3]
  fada_alpha      — adversarial alignability weighting      [8]-style
  avg_degree      — ST-LF's average per-source degree, random links/weights

psi-baselines (also choose psi):
  random_psi      — random source/target split
  heuristic_psi   — labeled => source
  single_matching — one-to-one min-divergence matching      [34]-style

``fada_alpha`` trains one logistic discriminator per (source, target)
pair on the source model's frozen features.  The reference draws each
step's rows with ``jax.random.randint`` inside a scan; here they come
from a seed (``divergence.pair_draws``) or from an explicit
(pairs, iters, 2, batch) index tensor, so tests can pass in the
reference's draws.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.fl import cnn
from repro_torch.fl.client import StackedClients
from repro_torch.fl.divergence import pair_draws
from repro_torch.fl.transfer import column_normalize
from repro_torch.rng import split_seed


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


# ------------------------------------------------------------- FADA-style
def _domain_gap(feat_params_stack, clients: StackedClients, src_ids,
                tgt_ids, seed: Optional[int] = None, *, iters: int,
                batch: int, lr: float,
                draws: Optional[torch.Tensor] = None):
    """For each (source s, target t) pair: train a logistic discriminator
    on the SOURCE model's frozen features to separate s-data from t-data;
    the gap statistic 2(1-2 err) measures alignability (lower = more
    alignable).  Returns ((P,) gaps, (P, 128, 2) weights, (P, 2) biases).

    All pairs train together: each pair's source parameters are gathered
    into one stacked model, every step's features are computed up front
    (they are frozen, so only (w, b) carry a gradient) and the SGD steps
    are batched over pairs.  ``draws``: (P, iters, 2, batch) rows of s
    ([..., 0, :]) and t ([..., 1, :]); without it they come from
    ``seed``.  (w, b) take the dtype of the parameters and data (float32
    on the paths; float64 holds the card against the CPU in
    ``chip_smoke.py``)."""
    dev = clients.device
    si = torch.as_tensor(np.asarray(src_ids), dtype=torch.int64, device=dev)
    ti = torch.as_tensor(np.asarray(tgt_ids), dtype=torch.int64, device=dev)
    npairs = len(si)
    n_max = clients.x.shape[1]
    if draws is None:
        counts = clients.counts.cpu().numpy()
        draws = pair_draws(split_seed(seed, npairs),
                           counts[np.asarray(src_ids)],
                           counts[np.asarray(tgt_ids)], steps=iters,
                           batch=batch)
    if tuple(draws.shape) != (npairs, iters, 2, batch):
        raise ValueError(f"draws {tuple(draws.shape)} != "
                         f"{(npairs, iters, 2, batch)}")
    draws = draws.to(device=dev, dtype=torch.int64)
    fp = {k: v[si] for k, v in feat_params_stack.items()}
    ends = torch.stack([si, ti], 1)[:, None, :, None]       # (P, 1, 2, 1)
    rows = (ends * n_max + draws).reshape(npairs, -1)
    flat_x = clients.x.reshape(-1, *clients.x.shape[2:])
    with torch.no_grad():
        f = cnn._features_stacked(fp, flat_x[rows]) \
            .reshape(npairs, iters, 2 * batch, cnn.FC_HIDDEN)
    y = torch.cat([torch.zeros(batch, dtype=torch.int64),
                   torch.ones(batch, dtype=torch.int64)]).to(dev)
    onehot = torch.nn.functional.one_hot(y, 2).to(f.dtype)
    w = torch.zeros((npairs, cnn.FC_HIDDEN, 2), dtype=f.dtype, device=dev)
    b = torch.zeros((npairs, 2), dtype=f.dtype, device=dev)
    for step in range(iters):
        fs = f[:, step]                                     # (P, 2B, 128)
        logits = torch.bmm(fs, w) + b[:, None, :]
        # d/dlogits of the mean cross-entropy over the 2B rows
        g = (torch.softmax(logits, -1) - onehot) / (2 * batch)
        w = w - lr * torch.bmm(fs.transpose(1, 2), g)
        b = b - lr * g.sum(1)

    row = torch.arange(n_max, device=dev)
    with torch.no_grad():
        xs = torch.cat([flat_x[si[:, None] * n_max + row],
                        flat_x[ti[:, None] * n_max + row]], dim=1)
        fe = cnn._features_stacked(fp, xs)
        pred = torch.argmax(torch.bmm(fe, w) + b[:, None, :], dim=-1)
    vs = row < clients.counts[si][:, None]
    vt = row < clients.counts[ti][:, None]
    wrong = (vs & (pred[:, :n_max] != 0)).sum(1) \
        + (vt & (pred[:, n_max:] != 1)).sum(1)
    eps = wrong / torch.clamp(vs.sum(1) + vt.sum(1), min=1)
    return torch.clamp(2.0 * (1.0 - 2.0 * eps), 0.0, 2.0), w, b


def fada_alpha(psi: np.ndarray, params_stack, clients: StackedClients,
               seed: Optional[int] = None, *, iters: int = 40,
               batch: int = 16, lr: float = 0.05,
               draws: Optional[torch.Tensor] = None) -> np.ndarray:
    """Dynamic attention: at each target, a softmax over sources of
    -2 * gap.  Pairs run source-major (``meshgrid(srcs, tgts, "ij")``),
    the order ``draws`` follows."""
    n = len(psi)
    srcs = np.flatnonzero(psi == 0.0)
    tgts = np.flatnonzero(psi == 1.0)
    if len(srcs) == 0 or len(tgts) == 0:
        return np.zeros((n, n))
    ss, tt = np.meshgrid(srcs, tgts, indexing="ij")
    gaps, _, _ = _domain_gap(params_stack, clients, ss.ravel(), tt.ravel(),
                             seed, iters=iters, batch=batch, lr=lr,
                             draws=draws)
    gaps = gaps.cpu().numpy().reshape(len(srcs), len(tgts))
    a = np.zeros((n, n))
    w = np.exp(-2.0 * gaps)
    w = w / w.sum(axis=0, keepdims=True)
    for bi, j in enumerate(tgts):
        a[srcs, j] = w[:, bi]
    return a
