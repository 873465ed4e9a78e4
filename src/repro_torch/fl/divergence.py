"""Algorithm 1 — decentralized federated estimation of the empirical
H-divergence for every device pair.

Per pair (i, j): relabel device-i data as class 0 and device-j data as
class 1; both devices train a shared-initialization binary domain
classifier locally for T^d iterations; exchange parameters and average;
repeat tau^d times; the averaged classifier's domain-classification error
eps on the union maps to the empirical divergence

    d_H(D_i, D_j) = 2 (1 - 2 eps)        (separability; clipped at 0)

All requested pairs train together: the 2P pair-member classifiers are
one stacked model (see ``fl.cnn``), stepped by a Python loop over the
tau^d T^d local iterations, and each pair's two members are replaced by
their mean after every T^d-th step.

The invariant of ``repro.fl.divergence`` holds here too: a pair's value
depends only on its own lane — its (i, j), its key, and the row draws
made from that key — so the pair axis can be chunked at any width
(``chunked_pair_lanes``) without changing which rows a pair trains on.
The key schedule (``pair_keys``) and the canonical (min, max) pair
order are fixed in ``estimate_divergences``, before any chunking.
``draws`` overrides the keys with explicit row indices, so tests can
pass in the reference's ``jax.random.randint`` draws.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.fl import cnn
from repro_torch.fl.client import StackedClients, sgd_steps
from repro_torch.rng import fold_in, generator, split_seed

Params = Dict[str, torch.Tensor]


def pair_draws(keys: np.ndarray, count_i: np.ndarray, count_j: np.ndarray,
               *, steps: int, batch: int) -> torch.Tensor:
    """(P, steps, 2, batch) int64 row draws, lane p from ``keys[p]``
    alone: uniform over device i's rows ([..., 0, :]) and device j's
    ([..., 1, :]), as ``jax.random.randint(k, (batch,), 0, count)``."""
    out = torch.empty((len(keys), steps, 2, batch), dtype=torch.int64)
    for p, k in enumerate(keys):
        u = torch.rand((steps, 2, batch), generator=generator(int(k)),
                       dtype=torch.float64)
        hi = torch.tensor([count_i[p], count_j[p]],
                          dtype=torch.float64)[None, :, None]
        out[p] = torch.minimum((u * hi).long(), hi.long() - 1)
    return out


def pairwise_divergence_values(h0: Params, clients: StackedClients,
                               pair_i, pair_j, keys=None, *, tau: int,
                               T: int, batch: int, lr: float,
                               draws: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """h0: single init params (shared h').  pair_i/j: (P,) ints;
    ``keys``: per-pair seeds (see ``pair_keys``), or ``draws``: explicit
    (P, tau*T, 2, batch) row indices.  Returns (P,) float32 estimates."""
    dev = clients.device
    pi = torch.as_tensor(np.asarray(pair_i), dtype=torch.int64, device=dev)
    pj = torch.as_tensor(np.asarray(pair_j), dtype=torch.int64, device=dev)
    npairs, steps = len(pi), tau * T
    n_dev, n_max = clients.x.shape[:2]
    if draws is None:
        counts = clients.counts.cpu().numpy()
        draws = pair_draws(np.asarray(keys), counts[pi.cpu().numpy()],
                           counts[pj.cpu().numpy()], steps=steps,
                           batch=batch)
    if tuple(draws.shape) != (npairs, steps, 2, batch):
        raise ValueError(f"draws {tuple(draws.shape)} != "
                         f"{(npairs, steps, 2, batch)}")
    draws = draws.to(device=dev, dtype=torch.int64)
    flat_x = clients.x.reshape(n_dev * n_max, *clients.x.shape[2:])
    base = torch.cat([pi, pj])[:, None] * n_max                  # (2P, 1)
    lab = torch.cat([torch.zeros(npairs, batch, dtype=torch.int64),
                     torch.ones(npairs, batch, dtype=torch.int64)]).to(dev)

    # members [0, P) are the h_i, [P, 2P) the h_j of each pair
    h = {k: v[None].repeat(2 * npairs, *([1] * v.dim()))
         for k, v in h0.items()}
    for t in range(steps):
        rows = base + torch.cat([draws[:, t, 0], draws[:, t, 1]])
        h = sgd_steps(h, [(flat_x[rows], lab)], lr)
        if (t + 1) % T == 0:      # parameter exchange + average
            h = {k: torch.cat([0.5 * (v[:npairs] + v[npairs:])] * 2)
                 for k, v in h.items()}
    hbar = {k: 0.5 * (v[:npairs] + v[npairs:]) for k, v in h.items()}

    # error of hbar on the union (device i -> 0, device j -> 1)
    row = torch.arange(n_max, device=dev)
    with torch.no_grad():
        xs = torch.cat([flat_x[pi[:, None] * n_max + row],
                        flat_x[pj[:, None] * n_max + row]], dim=1)
        pred = torch.argmax(cnn.forward_stacked(hbar, xs), dim=-1)
    vi = row < clients.counts[pi][:, None]
    vj = row < clients.counts[pj][:, None]
    wi = (vi & (pred[:, :n_max] != 0)).float().sum(1)
    wj = (vj & (pred[:, n_max:] != 1)).float().sum(1)
    ni, nj = vi.float().sum(1), vj.float().sum(1)
    eps = (wi + wj) / torch.clamp(ni + nj, min=1.0)
    return torch.clamp(2.0 * (1.0 - 2.0 * eps), 0.0, 2.0)


def pair_keys(seed: int, npairs: int, pair_chunk: int = 256) -> np.ndarray:
    """The per-pair seeds of the chunked estimator, (npairs,) int64.

    Key schedule, as ``repro.fl.divergence.pair_keys``: when everything
    fits in one chunk the keys are ``split_seed(seed, npairs)``; beyond
    that, chunk c (pairs [c0, c0 + pair_chunk)) draws
    ``split_seed(fold_in(seed, c0), pair_chunk)``.  Computed once by
    ``estimate_divergences``, so any chunking of the lanes afterwards
    keeps every pair's draws."""
    if npairs <= pair_chunk:
        return split_seed(seed, npairs)
    out = [split_seed(fold_in(seed, c0), pair_chunk)
           for c0 in range(0, npairs, pair_chunk)]
    return np.concatenate(out)[:npairs]


def _pad_rows(a, pad: int):
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[:1].expand(pad, *a.shape[1:])])
    return np.concatenate([a, np.repeat(a[:1], pad, axis=0)])


def chunked_pair_lanes(pi, pj, lanes, width: int, call, *,
                       pad_partial: bool = False) -> np.ndarray:
    """Drive ``call(ci, cj, clanes) -> (width or fewer,) values`` over
    fixed-width chunks of the pair axis.  When there is more than one
    chunk, a short last chunk is padded with repeats of its first lane
    (outputs discarded), so every call has one shape; a single chunk runs
    at its natural size unless ``pad_partial`` (the sharded pool, whose
    lanes must divide the mesh) pads it too.  ``lanes`` is any per-pair
    array (keys or draws) aligned with ``pi``/``pj``."""
    npairs = len(pi)
    out = np.zeros(npairs)
    for c0 in range(0, npairs, width):
        ci = pi[c0:c0 + width]
        cj = pj[c0:c0 + width]
        cl = lanes[c0:c0 + width]
        pad = (width - len(ci)) if (pad_partial or npairs > width) else 0
        if pad:
            ci, cj, cl = (_pad_rows(a, pad) for a in (ci, cj, cl))
        vals = call(ci, cj, cl)
        vals = vals.cpu().numpy() if isinstance(vals, torch.Tensor) \
            else np.asarray(vals)
        out[c0:c0 + width - pad] = vals[:width - pad]
    return out


def estimate_divergences(clients: StackedClients, seed: Optional[int], *,
                         tau: int = 4, T: int = 25, batch: int = 10,
                         lr: float = 0.01, pairs=None, pair_chunk: int = 256,
                         keys=None, h0: Optional[Params] = None,
                         draws: Optional[torch.Tensor] = None,
                         values_fn=None) -> np.ndarray:
    """Algorithm 1: returns the symmetric (N, N) matrix of empirical
    d_H estimates (diagonal 0).

    ``pairs``: optional (P, 2) int array of device pairs to estimate; the
    default is every upper-triangle pair (entries of unrequested pairs
    are left at 0; merge with ``update_divergences``).

    ``pair_chunk``: pairs run in padded chunks of this width, bounding
    the stacked classifiers' working set.

    ``keys`` / ``h0``: explicit per-pair seeds ((npairs,), aligned with
    the given ``pairs`` order) and classifier init, overriding the
    positional ``pair_keys`` schedule and the init drawn from ``seed``.
    ``draws``: explicit (npairs, tau*T, 2, batch) row indices, overriding
    the keys.  When the overrides cover everything ``seed`` may be None.

    ``values_fn``: optional executor for the per-pair values,
    ``fn(h0, clients, pi, pj, keys, tau=, T=, batch=, lr=, draws=) ->
    (npairs,)`` with exactly one of ``keys`` / ``draws`` given — the
    placement hook (the sharded pool's).  The contract: treat (pi, pj,
    keys or draws) as opaque aligned lanes, return one value per lane in
    order.  The key schedule, ``h0`` and the canonical (min, max) pair
    order are fixed HERE, so a values_fn that keeps lanes intact
    reproduces the local values."""
    n = clients.n_devices
    if pairs is None:
        pi, pj = np.triu_indices(n, k=1)
    else:
        pairs = np.atleast_2d(np.asarray(pairs, np.int64))
        if pairs.size == 0:
            return np.zeros((n, n))
        pi, pj = np.minimum(pairs[:, 0], pairs[:, 1]), \
            np.maximum(pairs[:, 0], pairs[:, 1])
    for name, lanes in (("keys", keys), ("draws", draws)):
        if lanes is not None and len(lanes) != len(pi):
            raise ValueError(f"explicit {name}: {len(lanes)} lanes for "
                             f"{len(pi)} pairs")
    if (keys is None and draws is None) or h0 is None:
        seed_pairs, seed_init = split_seed(seed, 2)
        if h0 is None:
            h0 = cnn.cnn_init(generator(seed_init), num_classes=2,
                              device=clients.device)
        if keys is None and draws is None:
            keys = pair_keys(seed_pairs, len(pi), pair_chunk)

    if values_fn is not None:
        d = np.asarray(values_fn(h0, clients, pi, pj,
                                 keys if draws is None else None, tau=tau,
                                 T=T, batch=batch, lr=lr, draws=draws))
    else:
        def call(ci, cj, cl):
            if draws is None:
                return pairwise_divergence_values(
                    h0, clients, ci, cj, cl, tau=tau, T=T, batch=batch,
                    lr=lr)
            return pairwise_divergence_values(
                h0, clients, ci, cj, tau=tau, T=T, batch=batch, lr=lr,
                draws=cl)

        d = chunked_pair_lanes(pi, pj, keys if draws is None else draws,
                               pair_chunk, call)
    out = np.zeros((n, n))
    out[pi, pj] = d
    out[pj, pi] = d
    return out


def update_divergences(div: np.ndarray, clients: StackedClients,
                       seed: Optional[int], pairs, *, tau: int = 4,
                       T: int = 25, batch: int = 10, lr: float = 0.01,
                       ema=0.0, keys=None, h0: Optional[Params] = None,
                       draws: Optional[torch.Tensor] = None,
                       values_fn=None) -> np.ndarray:
    """Refresh ``div`` on the given (P, 2) pairs only and return the
    merged copy (Algorithm 1 run just for those links).

    ``ema``: weight given to the OLD value when merging — scalar or
    per-pair (P,) array, applied in the symmetric scatter
    ``out[i, j] = ema * out[i, j] + (1 - ema) * fresh[i, j]``; 0
    replaces outright.  ``keys``, ``h0``, ``draws`` and ``values_fn``
    are forwarded to ``estimate_divergences``."""
    pairs = np.atleast_2d(np.asarray(pairs, np.int64))
    out = np.array(div, float, copy=True)
    if pairs.size == 0:
        return out
    fresh = estimate_divergences(clients, seed, tau=tau, T=T, batch=batch,
                                 lr=lr, pairs=pairs, keys=keys, h0=h0,
                                 draws=draws, values_fn=values_fn)
    pi, pj = pairs[:, 0], pairs[:, 1]        # vectorized symmetric scatter
    w = np.broadcast_to(np.asarray(ema, float), pi.shape)
    out[pi, pj] = w * out[pi, pj] + (1.0 - w) * fresh[pi, pj]
    out[pj, pi] = w * out[pj, pi] + (1.0 - w) * fresh[pj, pi]
    return out


def budget_pairs(pairs: np.ndarray, div_tick: np.ndarray,
                 budget: int) -> np.ndarray:
    """Rank candidate ``pairs`` stalest-first and truncate to ``budget``
    — the drift-aware re-estimation schedule.

    ``pairs``: (M, 2) candidate pairs.  ``div_tick``: (N, N) tick each
    pair was last estimated (-1: never).  ``budget``: max pairs to
    return; <= 0 means unbounded (every candidate, still in rank order).
    Ordering is (last-estimate tick ascending, i, j): fully
    deterministic, no RNG."""
    pairs = np.atleast_2d(np.asarray(pairs, np.int32))
    if pairs.size == 0:
        return np.zeros((0, 2), np.int32)
    pi, pj = pairs[:, 0], pairs[:, 1]
    order = np.lexsort((pj, pi, div_tick[pi, pj]))
    if budget > 0:
        order = order[:budget]
    return pairs[order]
