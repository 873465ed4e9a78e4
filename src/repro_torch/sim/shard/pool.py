"""Device-pool backends: WHERE the per-tick array work runs (the port of
``repro.sim.shard.pool``).

The engine owns state and solver plumbing, the executor owns per-tick
control flow, and a DevicePool owns the placement of the heavy array
phases — local training, Algorithm-1 pair estimation, the alpha-mixture
transfer, and the accuracy sweep.  ``LocalPool`` runs them on the
engine's one device; the transfer goes through
``fl.transfer.apply_transfer``, so on the GPU every round's mixture is
the ``alpha_combine`` kernel.  The sharded pool over
``torch.distributed`` (``SimConfig.mesh > 0``) and the async executor's
training path are not ported yet (``make_pool`` refuses a mesh).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.fl.client import StackedClients
from repro_torch.fl.divergence import \
    update_divergences as _update_divergences
from repro_torch.fl.transfer import apply_transfer
from repro_torch.sim.training import mixed_accuracies, network_step

if TYPE_CHECKING:                                   # no import cycle
    from repro_torch.sim.engine import SimulationEngine

Params = Dict[str, torch.Tensor]


def make_pool(engine: "SimulationEngine") -> "DevicePool":
    n = int(getattr(engine.cfg, "mesh", 0) or 0)
    if n > 0:
        raise NotImplementedError(
            f"mesh={n}: the sharded device pool is not ported to "
            f"repro_torch yet (ROADMAP.md queue 1 item 5)")
    return LocalPool(engine)


class DevicePool:
    """Backend API.  All methods take/return POOL-sized arrays.

    The public phase methods are TEMPLATE METHODS: they bracket the
    backend implementation (``_train`` / ``_transfer`` /
    ``_accuracies``) with the engine's TraceRecorder — start/stop
    collapse to attribute reads when tracing is off, and
    ``stop(..., block=out)`` synchronizes the card when it is on, so
    asynchronous launches cannot attribute one phase's device time to
    the next.  Backends override ONLY the underscored hooks."""

    name = "base"

    def __init__(self, engine: "SimulationEngine"):
        self.engine = engine

    def train(self, params: Params, clients: StackedClients,
              gen: Optional[torch.Generator], active: np.ndarray, *,
              draws: Optional[torch.Tensor] = None
              ) -> Tuple[Params, np.ndarray, np.ndarray]:
        """One round's training: (params', eps_hat, own_acc), the last
        two as float64 numpy on the host."""
        t0 = self.engine.trace.start()
        out = self._train(params, clients, gen, active, draws)
        self.engine.trace.stop("train", t0, block=out,
                               n_devices=clients.n_devices)
        return out

    def update_divergences(self, div, clients, seed, pairs, *, ema=0.0,
                           keys=None, h0=None, draws=None) -> np.ndarray:
        cfg = self.engine.cfg
        t0 = self.engine.trace.start()
        out = _update_divergences(
            div, clients, seed, pairs, tau=cfg.div_tau, T=cfg.div_T,
            batch=cfg.batch, lr=cfg.lr, ema=ema, keys=keys, h0=h0,
            draws=draws)
        self.engine.trace.stop("divergence", t0, block=out,
                               n_devices=clients.n_devices,
                               n_pairs=len(pairs))
        return out

    def refresh_divergences(self, div, clients, seed, pairs, *, ema=0.0,
                            keys=None, h0=None, draws=None) -> np.ndarray:
        """Budgeted drift refresh: the contract of ``update_divergences``
        (the reference stages only the touched devices' rows here, which
        changes no value; the port's estimator indexes rows per pair
        either way)."""
        return self.update_divergences(div, clients, seed, pairs, ema=ema,
                                       keys=keys, h0=h0, draws=draws)

    def transfer(self, params: Params, alpha: np.ndarray,
                 psi: np.ndarray) -> Params:
        t0 = self.engine.trace.start()
        out = self._transfer(params, alpha, psi)
        self.engine.trace.stop("transfer", t0, block=out,
                               n_devices=len(psi))
        return out

    def accuracies(self, params: Params,
                   clients: StackedClients) -> np.ndarray:
        t0 = self.engine.trace.start()
        out = self._accuracies(params, clients)
        self.engine.trace.stop("eval", t0, block=out,
                               n_devices=clients.n_devices)
        return out

    # -------------------------------------------------- backend hooks
    def _train(self, params, clients, gen, active, draws):
        raise NotImplementedError

    def _transfer(self, params, alpha, psi):
        raise NotImplementedError

    def _accuracies(self, params, clients):
        raise NotImplementedError


class LocalPool(DevicePool):
    """One device: the reference's single-host pool."""

    name = "local"

    def _train(self, params, clients, gen, active, draws):
        cfg = self.engine.cfg
        params, eps, acc = network_step(
            params, clients, gen,
            torch.as_tensor(np.asarray(active), device=clients.device),
            iters=cfg.train_iters, batch=cfg.batch, lr=cfg.lr, draws=draws)
        return (params, eps.cpu().numpy().astype(float),
                acc.cpu().numpy().astype(float))

    def _transfer(self, params, alpha, psi):
        return apply_transfer(params, alpha, psi)

    def _accuracies(self, params, clients):
        return mixed_accuracies(params, clients).cpu().numpy().astype(float)
