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

``ShardedPool`` (``SimConfig.mesh = k``) partitions the pool axis over a
k-shard 'devices' mesh (``shard.mesh`` / ``shard.ops``): per-shard
training, pair estimation with a cross-shard client gather, and the
transfer as one ``alpha_combine_slab`` per shard on its own target
columns.  Padding to a shard multiple happens HERE at the pool boundary
— NetworkState stays exactly pool-sized, so the engine, scenarios and
executors do not know the mesh.  Array payloads (and the per-lane
training draws) are edge-replicated; masks, alpha and psi are padded
with zeros, so padded lanes never train, transfer or add energy.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.fl.client import StackedClients, sample_train_indices
from repro_torch.fl.divergence import chunked_pair_lanes
from repro_torch.fl.divergence import \
    update_divergences as _update_divergences
from repro_torch.fl.transfer import apply_transfer
from repro_torch.sim.faults import PoolFaultError, with_retry
from repro_torch.sim.shard import ops
from repro_torch.sim.shard.mesh import DEVICE_AXIS, make_pool_mesh
from repro_torch.sim.training import mixed_accuracies, network_step

if TYPE_CHECKING:                                   # no import cycle
    from repro_torch.sim.engine import SimulationEngine

Params = Dict[str, torch.Tensor]


def make_pool(engine: "SimulationEngine", *,
              emulate: bool = False) -> "DevicePool":
    """``LocalPool`` for ``cfg.mesh == 0``, else a ``ShardedPool`` of
    ``cfg.mesh`` shards (``emulate``: all on the engine's device)."""
    n = int(getattr(engine.cfg, "mesh", 0) or 0)
    if n > 0:
        return ShardedPool(engine, n, emulate=emulate)
    if emulate:
        raise ValueError("emulate=True asks for an emulated mesh, but "
                         "cfg.mesh is 0 (the single-device pool)")
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
    return ops.map_clients(clients, lambda a: a[idx])


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
        return self._divergences(div, clients, seed, pairs, ema, keys, h0,
                                 draws, self._values_fn())

    def refresh_divergences(self, div, clients, seed, pairs, *, ema=0.0,
                            keys=None, h0=None, draws=None) -> np.ndarray:
        """Budgeted drift refresh: the contract of ``update_divergences``
        through the ROW-TARGETED values path (``_targeted_values_fn``):
        the sharded pool gathers only the rows of the devices the pairs
        touch.  Values are the same either way."""
        return self._divergences(div, clients, seed, pairs, ema, keys, h0,
                                 draws, self._targeted_values_fn())

    def _divergences(self, div, clients, seed, pairs, ema, keys, h0, draws,
                     values_fn) -> np.ndarray:
        cfg = self.engine.cfg
        t0 = self.engine.trace.start()
        out = _update_divergences(
            div, clients, seed, pairs, tau=cfg.div_tau, T=cfg.div_T,
            batch=cfg.batch, lr=cfg.lr, ema=ema, keys=keys, h0=h0,
            draws=draws, values_fn=values_fn)
        self.engine.trace.stop("divergence", t0, block=out,
                               n_devices=clients.n_devices,
                               n_pairs=len(pairs))
        return out

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
        reached; ShardedPool overrides it."""

    def _values_fn(self):
        """Hook into fl.divergence.estimate_divergences; None = local."""
        return None

    def _targeted_values_fn(self):
        """Row-targeted variant of ``_values_fn`` (budgeted refreshes);
        None = local (the single-device estimator indexes each pair's
        rows, so staging fewer rows changes nothing there)."""
        return None

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


#: per-shard cap on the stacked pair-classifier batch (the local
#: estimator's pair_chunk, so working-set bounds carry over per shard)
PAIR_CHUNK = 256


def _pad_rows(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge replication along the pool axis (the last row, repeated)."""
    return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]) if pad else a


class ShardedPool(DevicePool):
    """Pool axis over a 'devices' mesh; see the module docstring.
    ``emulate=True`` puts every shard on the engine's device."""

    def __init__(self, engine: "SimulationEngine", n_shards: int, *,
                 emulate: bool = False):
        super().__init__(engine)
        self.mesh = make_pool_mesh(n_shards, engine.device,
                                   emulate=emulate)
        self.n_shards = self.mesh.shape[DEVICE_AXIS]
        self.name = f"sharded-{self.n_shards}"
        cfg = engine.cfg
        self._train_fn = ops.build_train_step(
            self.mesh, iters=cfg.train_iters, batch=cfg.batch, lr=cfg.lr)
        self._pair_fn = ops.build_pair_values(
            self.mesh, tau=cfg.div_tau, T=cfg.div_T, batch=cfg.batch,
            lr=cfg.lr)
        self._transfer_fn = ops.build_transfer(self.mesh)
        self._acc_fn = ops.build_accuracies(self.mesh)

    # ------------------------------------------------------ pool padding
    def _pad(self, n: int) -> int:
        return -n % self.n_shards

    @staticmethod
    def _pad_tree(tree: Params, pad: int) -> Params:
        return {k: _pad_rows(v, pad) for k, v in tree.items()}

    @staticmethod
    def _pad_clients(clients: StackedClients, pad: int) -> StackedClients:
        return ops.map_clients(clients, lambda a: _pad_rows(a, pad)) \
            if pad else clients

    @staticmethod
    def _pad_mask(m, pad: int, device) -> torch.Tensor:
        m = np.asarray(m, bool)
        return torch.as_tensor(np.concatenate([m, np.zeros(pad, bool)]),
                               device=device)

    # ------------------------------------------------- shard membership
    def shard_devices(self, s: int):
        """Pool indices shard ``s`` owns (the pool axis is
        block-partitioned over the padded pool; padded lanes excluded)."""
        n = self.engine.state.pool_size
        blk = (n + self._pad(n)) // self.n_shards
        return list(range(s * blk, min((s + 1) * blk, n)))

    def _recover_shard(self, s: int):
        """A shard died: its devices' on-device training state is gone,
        but the host-side NetworkState survives — so instead of killing
        the run, the shard's ACTIVE devices re-enter through the
        engine's churn/reseed path (params re-seeded from the solved
        source mixture, assignment marked dirty for a membership
        re-solve).  See engine._recover_devices."""
        devs = [d for d in self.shard_devices(s)
                if bool(self.engine.state.active[d])]
        if devs:
            self.engine._recover_devices(devs, shard=s)

    # ------------------------------------------------------------ phases
    def _train(self, params, clients, gen, active, train_mask, draws):
        cfg = self.engine.cfg
        params = self._fault_gate(params)
        n = clients.n_devices
        pad = self._pad(n)
        if draws is None:                    # the single-device stream
            draws = sample_train_indices(clients, gen, iters=cfg.train_iters,
                                         batch=cfg.batch)
        mask = np.ones(n, bool) if train_mask is None else train_mask
        dev = clients.device
        out, eps, acc = self._train_fn(
            self._pad_tree(params, pad), self._pad_clients(clients, pad),
            _pad_rows(draws.to(dev), pad), self._pad_mask(active, pad, dev),
            self._pad_mask(mask, pad, dev))
        return ({k: v[:n] for k, v in out.items()}, _host(eps)[:n],
                _host(acc)[:n])

    def _train_async(self, params, clients, gen, active, elig, eps_prev,
                     acc_prev, draws):
        # the masked lanes run on the shards that own them either way, so
        # the sharded pool keeps the one-call masked step (as the
        # reference does) rather than a per-tick gather
        g = np.flatnonzero(np.logical_and(active, elig))
        params, eps, acc = self._train(params, clients, gen, active, elig,
                                       draws)
        return (params,) + self._merge_measured(g, eps[g], acc[g],
                                                eps_prev, acc_prev)

    def _lanes_fn(self, prepare):
        """A values_fn: ``prepare(clients, pi, pj) -> (clients', ri,
        rj)`` stages the rows, which are copied once onto each shard's
        device; then the pair lanes run in chunks of ``w * n_shards``
        (w <= PAIR_CHUNK lanes a shard; a lone short chunk padded too, so
        the lanes divide the mesh)."""
        def values(h0, clients, pi, pj, keys, *, tau, T, batch, lr,
                   draws=None):
            del tau, T, batch, lr           # fixed in _pair_fn at init
            rows, ri, rj = prepare(clients, pi, pj)
            sub = ops.replicate_clients(self.mesh, rows)
            w = min(PAIR_CHUNK, -(-len(ri) // self.n_shards))

            def call(ci, cj, cl):
                if draws is None:
                    return self._pair_fn(h0, sub, ci, cj, keys=cl)
                return self._pair_fn(h0, sub, ci, cj, draws=cl)

            return chunked_pair_lanes(
                ri, rj, keys if draws is None else draws,
                w * self.n_shards, call, pad_partial=True)
        return values

    def _values_fn(self):
        """The full pool's rows are what each shard gathers (gathered,
        not partitioned: they need no padding)."""
        return self._lanes_fn(lambda c, pi, pj: (c, np.asarray(pi),
                                                 np.asarray(pj)))

    def _targeted_values_fn(self):
        """Sharded row targeting: the compact row set (bucketed, padded
        to a shard multiple) is what each shard gathers — the cross-shard
        gather shrinks from the whole padded pool to the rows this
        refresh touches."""
        k = self.n_shards
        return self._lanes_fn(lambda c, pi, pj: _gather_pair_rows(
            c, pi, pj, lambda r: -(-_bucket(r, c.n_devices) // k) * k))

    def _transfer(self, params, alpha, psi):
        n = len(psi)
        pad = self._pad(n)
        a = np.pad(np.asarray(alpha, np.float32), ((0, pad), (0, pad)))
        s = np.pad(np.asarray(psi, np.float32), (0, pad))
        dev = next(iter(params.values())).device
        out = self._transfer_fn(self._pad_tree(params, pad),
                                torch.as_tensor(a, device=dev),
                                torch.as_tensor(s, device=dev))
        return {k: v[:n] for k, v in out.items()}

    def _accuracies(self, params, clients):
        n = clients.n_devices
        pad = self._pad(n)
        return _host(self._acc_fn(self._pad_tree(params, pad),
                                  self._pad_clients(clients, pad)))[:n]
