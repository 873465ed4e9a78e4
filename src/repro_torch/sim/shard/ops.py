"""Building blocks of the sharded device pool (the port of
``repro.sim.shard.ops``).

Each ``build_*`` function closes over a pool mesh (``shard.mesh``) and
returns ONE callable.  All four follow the same contract: the pool axis of
every array argument is partitioned over the mesh's shards in
contiguous blocks (the caller pads it to a multiple of the shard
count), per-lane computation is the single-device code verbatim
(``network_step``, ``pairwise_divergence_values``, ``true_accuracies``,
the ``alpha_combine`` kernel), and anything a shard needs beyond its own
block arrives through an explicit copy onto the shard's device:

  train     — none: each shard runs its block's lanes.
  pair divergence — the Algorithm-1 pair lanes are partitioned over
              shards, and each shard gathers every shard's client rows
              (the all-gather) so it can stage any (i, j) pair.
  transfer  — the stacked parameters are flattened once, the (S, P)
              source matrix is gathered onto each shard's device, and
              each shard mixes ONLY its own target columns of alpha
              through ``alpha_combine_slab``: every source crosses to a
              device once, however many of its targets that device owns.
  accuracies — per-lane eval, no collective.

One process drives every shard (the reference's ``shard_map`` programs
are single-controller too).  The arrays live on the pool's home device
between calls; a shard's block is copied to its device, and its results
copied back and concatenated in shard order.  On an emulated mesh every
shard shares the home device, so those copies are no-ops and the shards
run one after another.

Lanes are independent, so a sharded run computes what the single-device
pool computes; the transfer's sums may take another order (k launches of
T/k targets against one of T), which the parity tests bound.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.fl.client import StackedClients, true_accuracies
from repro_torch.fl.divergence import pairwise_divergence_values
from repro_torch.kernels.alpha_combine.ops import alpha_combine_slab
from repro_torch.launch.mesh import LocalMesh
from repro_torch.nn.param import flatten_to_vector, unflatten_from_vector
from repro_torch.sim.training import network_step

Params = Dict[str, torch.Tensor]


def map_clients(clients: StackedClients,
                fn: Callable[[torch.Tensor], torch.Tensor]
                ) -> StackedClients:
    """``fn`` applied to every stacked client array."""
    return StackedClients(**{f.name: fn(getattr(clients, f.name))
                             for f in dataclasses.fields(clients)})


def shard_blocks(mesh: LocalMesh, n: int
                 ) -> Iterator[Tuple[slice, torch.device]]:
    """(block of the pool axis, device) of each shard, in shard order;
    ``n`` must be a multiple of the shard count."""
    k = len(mesh.devices)
    if n % k:
        raise ValueError(f"pool axis {n} is not padded to a multiple of "
                         f"{k} shards")
    blk = n // k
    for s, dev in enumerate(mesh.devices):
        yield slice(s * blk, (s + 1) * blk), dev


def _gather(parts, home: torch.device) -> torch.Tensor:
    return torch.cat([p.to(home) for p in parts])


def replicate_clients(mesh: LocalMesh, clients: StackedClients
                      ) -> Tuple[StackedClients, ...]:
    """Every shard's copy of ``clients`` on its device (the all-gather),
    copied once a device: shards that share a device share the copy."""
    copies: Dict[torch.device, StackedClients] = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = map_clients(clients, lambda a: a.to(dev))
    return tuple(copies[dev] for dev in mesh.devices)


def build_train_step(mesh: LocalMesh, *, iters: int, batch: int,
                     lr: float) -> Callable:
    """(params, clients, draws, active, train_mask) -> (params', eps,
    acc), every argument padded to a multiple of the shard count; the
    per-lane ``draws`` (P, iters, batch) come from the caller (the full
    pool's rows, exactly the single-device stream)."""
    def step(params: Params, clients: StackedClients, draws: torch.Tensor,
             active: torch.Tensor, mask: torch.Tensor):
        home = clients.device
        outs = []
        for blk, dev in shard_blocks(mesh, clients.n_devices):
            outs.append(network_step(
                {k: v[blk].to(dev) for k, v in params.items()},
                map_clients(clients, lambda a: a[blk].to(dev)), None,
                active[blk].to(dev), mask[blk].to(dev), iters=iters,
                batch=batch, lr=lr, draws=draws[blk].to(dev)))
        return ({k: _gather([o[0][k] for o in outs], home) for k in params},
                _gather([o[1] for o in outs], home),
                _gather([o[2] for o in outs], home))
    return step


def build_pair_values(mesh: LocalMesh, *, tau: int, T: int, batch: int,
                      lr: float) -> Callable:
    """(h0, replicas, pi, pj, keys=, draws=) -> (npairs,) d_H values;
    the PAIR axis is partitioned over the shards (padded by the caller to
    a multiple of the shard count), and shard s stages its pairs from
    ``replicas[s]``, every client row on its device
    (``replicate_clients``: the cross-shard gather that lets any shard
    estimate any pair, made once by the caller for all its chunks).
    Exactly one of ``keys`` / ``draws`` holds the lanes."""
    def values(h0: Params, replicas: Tuple[StackedClients, ...], pi, pj,
               keys=None, draws=None) -> torch.Tensor:
        home = next(iter(h0.values())).device
        lanes = keys if draws is None else draws
        outs = []
        for (blk, dev), full in zip(shard_blocks(mesh, len(pi)), replicas):
            lane = lanes[blk]
            outs.append(pairwise_divergence_values(
                {k: v.to(dev) for k, v in h0.items()}, full,
                np.asarray(pi)[blk], np.asarray(pj)[blk],
                None if draws is not None else lane, tau=tau, T=T,
                batch=batch, lr=lr,
                draws=None if draws is None else lane.to(dev)))
        return _gather(outs, home)
    return values


def build_transfer(mesh: LocalMesh) -> Callable:
    """(params, alpha, psi) -> params' with targets (psi=1) holding their
    alpha-mixtures — ``fl.transfer.apply_transfer`` with the mixture
    computed per shard by ``alpha_combine_slab`` on the shard's COLUMN
    block of alpha, matching its row block of the parameter stack."""
    def transfer(params: Params, alpha: torch.Tensor,
                 psi: torch.Tensor) -> Params:
        home = next(iter(params.values())).device
        flat = flatten_to_vector(params, lead=1)            # (S_pad, P)
        outs = []
        for blk, dev in shard_blocks(mesh, flat.shape[0]):
            theta = flat.to(dev)                            # the gather
            mixed = unflatten_from_vector(
                alpha_combine_slab(theta, alpha[:, blk].to(dev)),
                params, lead=1)                             # (T_loc, ...)
            m = psi[blk].to(dev)

            def sel(own, mix):
                w = m.reshape((-1,) + (1,) * (own.dim() - 1)).to(own.dtype)
                return own * (1 - w) + mix * w

            outs.append({k: sel(v[blk].to(dev), mixed[k])
                         for k, v in params.items()})
        return {k: _gather([o[k] for o in outs], home) for k in params}
    return transfer


def build_accuracies(mesh: LocalMesh) -> Callable:
    """(params, clients) -> (P',) ground-truth accuracies, per shard."""
    def accuracies(params: Params, clients: StackedClients) -> torch.Tensor:
        home = clients.device
        return _gather([
            true_accuracies({k: v[blk].to(dev) for k, v in params.items()},
                            map_clients(clients, lambda a: a[blk].to(dev)))
            for blk, dev in shard_blocks(mesh, clients.n_devices)], home)
    return accuracies
