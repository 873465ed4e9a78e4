"""Device-pool backends: WHERE the per-tick array work runs (the port of
``repro.sim.shard.pool``).

The engine owns state and solver plumbing, the executors own per-tick
control flow, and a DevicePool owns the placement of the heavy array
phases — local training, Algorithm-1 pair estimation, the alpha-mixture
transfer, and the accuracy sweep.  ``LocalPool`` runs them on the
engine's one device; the transfer goes through
``fl.transfer.apply_transfer``, so on the GPU every sync round's mixture
is the ``alpha_combine`` kernel.  Its async path implements SUBSET-GATHER
training (``SimConfig.train_gather``, default on): the clock-eligible
lanes are gathered into a compact bucket-padded batch for
``network_step`` instead of running masked no-op SGD for the
ineligible majority — per-lane results are identical (lanes keep their
rows of the full pool's draws), and the bucketed widths (powers of two)
are the ones the reference compiles for, which the trace's ``lanes``
(the cost model's train feature) records.

The sharded pool over ``torch.distributed`` (``SimConfig.mesh > 0``) is
not ported yet (ROADMAP.md queue 1 item 5; ``make_pool`` refuses a
mesh).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.fl.client import StackedClients, sample_train_indices
from repro_torch.fl.divergence import \
    update_divergences as _update_divergences
from repro_torch.fl.transfer import apply_transfer
from repro_torch.sim.faults import PoolFaultError, with_retry
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


def _bucket(n: int, cap: int, floor: int = 4) -> int:
    """Smallest power-of-two >= n (configurable floor, default 4),
    capped at the pool size — the reference's compiled widths of the
    compact subset step.  The floor is the ``SimConfig.train_gather_floor``
    autotuner knob on the training path."""
    w = max(1, int(floor))
    while w < n:
        w *= 2
    return max(1, min(w, cap))


def take_clients(clients: StackedClients,
                 idx: torch.Tensor) -> StackedClients:
    """The rows ``idx`` of every stacked client array."""
    return StackedClients(x=clients.x[idx], y=clients.y[idx],
                          labeled=clients.labeled[idx],
                          valid=clients.valid[idx],
                          true_y=clients.true_y[idx],
                          counts=clients.counts[idx])


def _gather_pair_rows(clients: StackedClients, pi, pj,
                      width_for: Callable[[int], int]):
    """Row-targeted gather for a small pair subset: compact the client
    arrays down to the UNIQUE device rows the pairs touch (padded to
    ``width_for(n_rows)`` by repeating the first row) and remap the pair
    indices into the compact array.

    Lanes are untouched — each pair still reads exactly its own two
    devices' rows — so per-pair values equal those of staging the full
    pool; only the data entering the computation shrinks from P rows to
    the handful a budgeted refresh names.  Returns (compact_clients, ri,
    rj) with ri/rj int32 indices into the compact row axis."""
    pi, pj = np.asarray(pi), np.asarray(pj)
    rows, inv = np.unique(np.concatenate([pi, pj]), return_inverse=True)
    ri = inv[:len(pi)].astype(np.int32)
    rj = inv[len(pi):].astype(np.int32)
    width = width_for(len(rows))
    if width < len(rows):
        raise ValueError(f"width {width} < {len(rows)} gathered rows")
    pad = width - len(rows)
    if pad:
        rows = np.concatenate([rows, np.full(pad, rows[0], rows.dtype)])
    gather = torch.as_tensor(rows, dtype=torch.int64, device=clients.device)
    return take_clients(clients, gather), ri, rj


class DevicePool:
    """Backend API.  All methods take/return POOL-sized arrays.

    The public phase methods are TEMPLATE METHODS: they bracket the
    backend implementation (``_train`` / ``_train_async`` /
    ``_transfer`` / ``_accuracies``) with the engine's
    TraceRecorder — start/stop collapse to attribute reads when tracing
    is off, and ``stop(..., block=out)`` synchronizes the card when it
    is on, so asynchronous launches cannot attribute one phase's device
    time to the next.  Backends override ONLY the underscored hooks."""

    name = "base"

    def __init__(self, engine: "SimulationEngine"):
        self.engine = engine

    def train(self, params: Params, clients: StackedClients,
              gen: Optional[torch.Generator], active: np.ndarray,
              train_mask: Optional[np.ndarray] = None, *,
              draws: Optional[torch.Tensor] = None
              ) -> Tuple[Params, np.ndarray, np.ndarray]:
        """One round's training: (params', eps_hat, own_acc), the last
        two as float64 numpy on the host."""
        t0 = self.engine.trace.start()
        out = self._train(params, clients, gen, active, train_mask, draws)
        self.engine.trace.stop("train", t0, block=out,
                               n_devices=clients.n_devices)
        return out

    def train_async(self, params: Params, clients: StackedClients,
                    gen: Optional[torch.Generator], active: np.ndarray,
                    elig: np.ndarray, eps_prev: np.ndarray,
                    acc_prev: np.ndarray, *,
                    draws: Optional[torch.Tensor] = None
                    ) -> Tuple[Params, np.ndarray, np.ndarray]:
        """An async tick: refresh params/eps/acc for the eligible lanes
        only (the others keep ``eps_prev`` / ``acc_prev``).  ``draws``:
        the FULL pool's (P, iters, batch) rows, else drawn from ``gen``
        for the whole pool."""
        t0 = self.engine.trace.start()
        out = self._train_async(params, clients, gen, active, elig,
                                eps_prev, acc_prev, draws)
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
        either way, so ``_gather_pair_rows`` is kept for the sharded
        pool of queue 1 item 5)."""
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
    def _train(self, params, clients, gen, active, train_mask, draws):
        raise NotImplementedError

    def _train_async(self, params, clients, gen, active, elig, eps_prev,
                     acc_prev, draws):
        raise NotImplementedError

    def _transfer(self, params, alpha, psi):
        raise NotImplementedError

    def _accuracies(self, params, clients):
        raise NotImplementedError

    # ------------------------------------------------------ fault gate
    def _fault_gate(self, params: Params) -> Params:
        """Consume this tick's injected pool faults before a heavy op
        (called entering the training phase — the tick's first pool
        op).  A lost shard is detected and recovered (backend-specific
        ``_recover_shard``); transient op failures are ridden out with
        bounded retry + exponential backoff.  No injector installed ->
        nothing to consume.

        Takes and returns the params: shard recovery re-seeds the lost
        devices through ``engine.state.params``, and the caller's
        already-captured argument must not shadow that update."""
        eng = self.engine
        inj = eng.faults
        if inj is None:
            return params
        shard = inj.take_lost_shard()
        if shard is not None:
            eng.state.params = params
            self._recover_shard(shard)
            params = eng.state.params
        if inj.pending_op_failures > 0:
            def attempt():
                if inj.op_attempt_fails():
                    raise PoolFaultError(
                        "injected transient pool-op failure")
            with_retry(attempt, retries=eng.cfg.fault_retries,
                       backoff_s=eng.cfg.fault_backoff_s)
        return params

    def _recover_shard(self, shard: int):
        """Backend hook: bring a lost shard's devices back.  LocalPool
        is one device with no shards, so the injector never schedules a
        shard loss against it (``n_shards`` reads 0) and this is never
        reached; the sharded pool (queue 1 item 5) overrides it."""

    # shared async merge: measurements refresh ONLY where a device ticked
    @staticmethod
    def _merge_measured(g, eps_g, acc_g, eps_prev, acc_prev):
        """``eps_g``/``acc_g``: the fresh values FOR the lanes in ``g``
        (same order, length len(g))."""
        eps_out = np.array(eps_prev, float, copy=True)
        acc_out = np.array(acc_prev, float, copy=True)
        eps_out[g] = np.asarray(eps_g, float)
        acc_out[g] = np.asarray(acc_g, float)
        return eps_out, acc_out


def _host(v: torch.Tensor) -> np.ndarray:
    return v.cpu().numpy().astype(float)


class LocalPool(DevicePool):
    """One device: the reference's single-host pool."""

    name = "local"

    def _train(self, params, clients, gen, active, train_mask, draws):
        cfg = self.engine.cfg
        params = self._fault_gate(params)
        dev = clients.device
        mask = None if train_mask is None else \
            torch.as_tensor(np.asarray(train_mask), device=dev)
        params, eps, acc = network_step(
            params, clients, gen, torch.as_tensor(np.asarray(active),
                                                  device=dev),
            mask, iters=cfg.train_iters, batch=cfg.batch, lr=cfg.lr,
            draws=draws)
        return params, _host(eps), _host(acc)

    def _train_async(self, params, clients, gen, active, elig, eps_prev,
                     acc_prev, draws):
        cfg = self.engine.cfg
        params = self._fault_gate(params)
        g = np.flatnonzero(np.logical_and(active, elig))
        if not cfg.train_gather:
            # masked full-pool path: every lane computes, ineligible
            # results are discarded (kept as the parity reference;
            # _train, not train — the template wrapper already times
            # this call)
            params, eps, acc = self._train(params, clients, gen, active,
                                           elig, draws)
            return (params,) + self._merge_measured(
                g, eps[g], acc[g], eps_prev, acc_prev)
        if len(g) == 0:                 # nobody's clock fired
            return params, np.array(eps_prev, float, copy=True), \
                np.array(acc_prev, float, copy=True)
        # compact gather: lane i trains on the rows it would have had in
        # the masked step (the full pool's draws), so per-device results
        # are the same — only the no-op lanes disappear
        if draws is None:
            draws = sample_train_indices(clients, gen, iters=cfg.train_iters,
                                         batch=cfg.batch)
        w = _bucket(len(g), clients.n_devices, cfg.train_gather_floor)
        # the trace's train event carries the COMPACT batch width — the
        # cost model keys on it
        self.engine.trace.with_ctx(lanes=w)
        gpad = np.concatenate([g, np.full(w - len(g), g[0], g.dtype)])
        dev = clients.device
        gj = torch.as_tensor(gpad, dtype=torch.int64, device=dev)
        trained, eps_s, acc_s = network_step(
            {k: v[gj] for k, v in params.items()}, take_clients(clients, gj),
            None, torch.as_tensor(np.asarray(active), device=dev)[gj],
            iters=cfg.train_iters, batch=cfg.batch, lr=cfg.lr,
            draws=draws.to(dev)[gj])
        k = len(g)
        gi = gj[:k]
        out = {}
        for name, v in params.items():          # padded lanes discarded
            v = v.clone()
            v[gi] = trained[name][:k]
            out[name] = v
        return (out,) + self._merge_measured(
            g, _host(eps_s)[:k], _host(acc_s)[:k], eps_prev, acc_prev)

    def _transfer(self, params, alpha, psi):
        return apply_transfer(params, alpha, psi)

    def _accuracies(self, params, clients):
        return _host(mixed_accuracies(params, clients))
