"""End-to-end ST-LF round orchestration (Fig. 2 pipeline) + evaluation of
any (psi, alpha) assignment.

``prepare_round`` and the functions it calls run on ``device`` (the GPU
unless the caller passes "cpu"); ``run_stlf`` and ``evaluate_assignment``
run where the RoundState lives.  Seeds replace the reference's PRNG keys;
``prepare_round``'s ``params0`` / ``train_draws`` / ``div_h0`` /
``div_draws`` and ``run_all_baselines``' ``fada_draws`` inject an
initialization and row draws instead (the parity tests pass the
reference's).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.bounds import BoundTerms
from repro_torch.core.energy import EnergyModel
from repro_torch.core.problem import STLFProblem
from repro_torch.core.solver import SolverResult, solve_stlf
from repro_torch.data.partition import DeviceData
from repro_torch.device import DeviceLike
from repro_torch.fl import baselines as bl
from repro_torch.fl.client import (StackedClients, empirical_errors,
                                   init_client_params, stack_clients,
                                   train_sources, true_accuracies)
from repro_torch.fl.divergence import estimate_divergences
from repro_torch.fl.transfer import apply_transfer, column_normalize
from repro_torch.rng import generator, split_seed

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class RoundState:
    """Everything measured once per network, reused across methods."""
    clients: StackedClients
    params: Params               # locally-trained per-device params
    eps_hat: np.ndarray          # (N,)
    div_hat: np.ndarray          # (N, N) Algorithm-1 estimates
    energy: EnergyModel
    bounds: BoundTerms
    # wall seconds of prepare_round's phases ("train" includes scoring
    # eps_hat; each phase ends with its result on the host)
    wall_s: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MethodResult:
    name: str
    psi: np.ndarray
    alpha: np.ndarray
    target_acc: float            # mean ground-truth accuracy at targets
    per_device_acc: np.ndarray
    energy: float
    transmissions: int
    solver: Optional[SolverResult] = None


def train_local(params: Params, clients: StackedClients, seed: int, *,
                iters: int = 100, batch: int = 10, lr: float = 0.01,
                draws: Optional[torch.Tensor] = None) -> Params:
    """Continue every device's local SGD, all devices in one stacked
    loop; ``draws`` (N, iters, batch) overrides the seeded row draws."""
    return train_sources(params, clients, generator(seed), iters=iters,
                         batch=batch, lr=lr, draws=draws)


def make_bounds(clients: StackedClients, eps: np.ndarray, div: np.ndarray,
                delta: float = 0.05) -> BoundTerms:
    """BoundTerms from the current measurements of a network."""
    return BoundTerms(eps_hat=np.asarray(eps),
                      n_data=clients.counts.cpu().numpy(),
                      div_hat=np.asarray(div), delta=delta)


def prepare_round(devices: List[DeviceData], seed: int = 0, *,
                  train_iters: int = 100, train_batch: int = 10,
                  train_lr: float = 0.01, div_tau: int = 4, div_T: int = 25,
                  energy: Optional[EnergyModel] = None,
                  energy_seed: int = 0, delta: float = 0.05,
                  device: DeviceLike = None,
                  params0: Optional[Params] = None,
                  train_draws: Optional[torch.Tensor] = None,
                  div_h0: Optional[Params] = None,
                  div_draws: Optional[torch.Tensor] = None) -> RoundState:
    clients = stack_clients(devices, device=device)
    n = clients.n_devices
    s_init, s_train, s_div = split_seed(seed, 3)
    params = params0 if params0 is not None else init_client_params(
        n, generator(s_init), device=clients.device)
    t0 = time.perf_counter()
    params = train_local(params, clients, s_train, iters=train_iters,
                         batch=train_batch, lr=train_lr, draws=train_draws)
    eps = empirical_errors(params, clients).cpu().numpy()
    t1 = time.perf_counter()
    div = estimate_divergences(clients, s_div, tau=div_tau, T=div_T,
                               batch=train_batch, lr=train_lr, h0=div_h0,
                               draws=div_draws)
    t2 = time.perf_counter()
    if energy is None:
        energy = EnergyModel.sample(n, np.random.default_rng(energy_seed))
    bounds = make_bounds(clients, eps, div, delta)
    return RoundState(clients, params, eps, div, energy, bounds,
                      wall_s={"train": t1 - t0, "divergence": t2 - t1})


def evaluate_assignment(state: RoundState, name: str, psi: np.ndarray,
                        alpha: np.ndarray,
                        solver: Optional[SolverResult] = None
                        ) -> MethodResult:
    alpha = column_normalize(alpha, psi, energy_K=state.energy.K,
                             eps_hat=state.eps_hat)
    mixed = apply_transfer(state.params, alpha, psi)
    acc = true_accuracies(mixed, state.clients).cpu().numpy()
    tgts = np.flatnonzero(psi == 1.0)
    t_acc = float(acc[tgts].mean()) if len(tgts) else float("nan")
    return MethodResult(
        name=name, psi=np.asarray(psi, float), alpha=alpha,
        target_acc=t_acc, per_device_acc=acc,
        energy=state.energy.energy(alpha),
        transmissions=state.energy.transmissions(alpha),
        solver=solver)


def run_stlf(state: RoundState, *, phi_s: float = 1.0, phi_t: float = 5.0,
             phi_e: float = 1.0, **solver_kw) -> MethodResult:
    prob = STLFProblem(state.bounds, state.energy,
                       phi_s=phi_s, phi_t=phi_t, phi_e=phi_e)
    res = solve_stlf(prob, device=state.clients.device, **solver_kw)
    return evaluate_assignment(state, "ST-LF", res.psi, res.alpha, res)


def run_all_baselines(state: RoundState, stlf: MethodResult, key: int,
                      seed: int = 0, *,
                      fada_draws: Optional[Sequence[torch.Tensor]] = None
                      ) -> Dict[str, MethodResult]:
    """Evaluate the four alpha-baselines (on ST-LF's psi) and the four
    psi-baselines, exactly the paper's comparison matrix.  ``key`` is
    split into the two FADA calls' seeds, where the reference splits its
    PRNG key; ``fada_draws`` (FADA's, then psi-FADA's row draws) replaces
    them."""
    rng = np.random.default_rng(seed)
    psi = stlf.psi
    out: Dict[str, MethodResult] = {}

    k1, k2 = split_seed(key, 2)
    d1, d2 = fada_draws if fada_draws is not None else (None, None)
    # ---- alpha-baselines (ST-LF's psi)
    out["Rnd-alpha"] = evaluate_assignment(
        state, "Rnd-alpha", psi, bl.rnd_alpha(psi, rng))
    out["FedAvg"] = evaluate_assignment(
        state, "FedAvg", psi, bl.fedavg_alpha(psi, state.clients))
    out["FADA"] = evaluate_assignment(
        state, "FADA", psi,
        bl.fada_alpha(psi, state.params, state.clients, k1, draws=d1))
    out["AvgD"] = evaluate_assignment(
        state, "AvgD", psi, bl.avg_degree_alpha(psi, stlf.alpha, rng))

    # ---- psi-baselines
    rpsi = bl.random_psi(len(psi), rng)
    out["Rnd-psi"] = evaluate_assignment(
        state, "Rnd-psi", rpsi, bl.rnd_alpha(rpsi, rng))
    hpsi = bl.heuristic_psi(state.clients)
    out["psi-FedAvg"] = evaluate_assignment(
        state, "psi-FedAvg", hpsi, bl.fedavg_alpha(hpsi, state.clients))
    out["psi-FADA"] = evaluate_assignment(
        state, "psi-FADA", hpsi,
        bl.fada_alpha(hpsi, state.params, state.clients, k2, draws=d2))
    out["SM"] = evaluate_assignment(
        state, "SM", psi, bl.single_matching_alpha(psi, state.div_hat))
    return out
