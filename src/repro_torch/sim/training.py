"""Batched per-round client training: the whole device axis in one
stacked loop (the port of ``repro.sim.training``).

Local training, the empirical-error refresh and the ground-truth
accuracy sweep run over the stacked pool (``repro_torch.fl.client``).
Unlike the one-shot prepare_round (where untrained unlabeled devices are
simply overwritten by the transfer), the simulator CONTINUES from mixed
parameters round after round — so devices with no labeled data must keep
their received parameters instead of drifting under the dummy y=0 SGD
that train_sources runs for them; ``network_step`` masks their update
out.

Every lane is independent: lane i trains on its own rows of ``draws``
(or of the draws made from ``gen`` for the whole pool), so the async
executor's compact subset step (``network_step`` on gathered lanes and
their rows of the full pool's draws; the reference's
``subset_network_step``) and the masked full-pool step
(``network_step(train_mask=...)``) give each device the same result.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.fl.client import (StackedClients, empirical_errors,
                                   train_sources, true_accuracies)

Params = Dict[str, torch.Tensor]


def network_step(params: Params, clients: StackedClients,
                 gen: Optional[torch.Generator], active: torch.Tensor,
                 train_mask: Optional[torch.Tensor] = None, *,
                 iters: int, batch: int, lr: float,
                 draws: Optional[torch.Tensor] = None
                 ) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """One simulator round of local training for every device at once.

    ``active``: (N,) bool — devices currently in the network.  Departed
    devices must NOT keep training while away: their params stay frozen
    until they rejoin.  (The SGD itself still runs for every pool slot —
    shapes stay fixed across churn — only its result is discarded.)

    ``train_mask``: optional (N,) bool — the async-gossip executor's
    clock-eligibility subset.  Devices outside it keep their params this
    tick (their lanes still run and are discarded).  ``None`` (the sync
    engine) trains every active device.

    ``draws``: optional (N, iters, batch) row indices used instead of
    drawing from ``gen``.

    Returns (params', eps_hat, own_acc):
      params'  — updated stacked params; inactive devices, devices
                 without labeled data, and devices outside train_mask
                 are left untouched
      eps_hat  — empirical errors (unlabeled counted as 1), shape (N,)
      own_acc  — ground-truth accuracy of each device's own params, (N,)
    """
    trained = train_sources(params, clients, gen, iters=iters, batch=batch,
                            lr=lr, draws=draws)
    update = clients.labeled.any(dim=1) & active.to(clients.device)
    if train_mask is not None:
        update = update & train_mask.to(clients.device)

    def keep(new, old):
        return torch.where(update.reshape((-1,) + (1,) * (new.dim() - 1)),
                           new, old)

    params = {k: keep(trained[k], params[k]) for k in params}
    return (params, empirical_errors(params, clients),
            true_accuracies(params, clients))


def mixed_accuracies(params: Params, clients: StackedClients
                     ) -> torch.Tensor:
    """Ground-truth accuracy of (post-transfer) stacked params."""
    return true_accuracies(params, clients)
