"""Numpy copy of ``repro.core.problem``: the port imports nothing of the JAX
package.

Problem (P) assembly (Sec. IV-B, eqs. 11-16).

Variables (all strictly positive GP variables, log-parametrized):
  psi_i   in [eps_psi, 1]   (0 -> source, 1 -> target; relaxed integer)
  a_ij    in [eps_a, 1]     link/combination weights (i source, j target)
  chiS_i  > 0               auxiliary for term (c): (1-psi_i) S_i <= chiS_i
  chiT_ij > 0               auxiliary for term (d): psi_j(1-psi_i)a_ij T_ij <= chiT_ij
  chiC_j  > 0               auxiliary squeezing the equality sum_i a_ij = psi_j

Objective (eq. 83):  phiS sum chiS + phiT sum chiT + phiE sum E_ij + sum chiC.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.bounds import BoundTerms
from repro_torch.core.energy import EnergyModel


@dataclasses.dataclass
class VarIndex:
    n: int

    def __post_init__(self):
        n = self.n
        self.psi = np.arange(n)
        self.alpha = n + np.arange(n * n).reshape(n, n)
        self.chiS = n + n * n + np.arange(n)
        self.chiT = 2 * n + n * n + np.arange(n * n).reshape(n, n)
        self.chiC = 2 * n + 2 * n * n + np.arange(n)
        self.nvars = 3 * n + 2 * n * n


@dataclasses.dataclass
class STLFProblem:
    bounds: BoundTerms
    energy: EnergyModel
    phi_s: float = 1.0
    phi_t: float = 5.0
    phi_e: float = 1.0
    eps_psi: float = 1e-3
    eps_alpha: float = 1e-4
    eps_c: float = 1e-2

    def __post_init__(self):
        self.S = self.bounds.S()                 # (N,)
        self.T = self.bounds.T()                 # (N,N)  T[i,j], i->j
        self.idx = VarIndex(self.bounds.n)

    @property
    def n(self) -> int:
        return self.bounds.n

    # ---------------------------------------------------------------- eval
    def objective(self, psi: np.ndarray, alpha: np.ndarray) -> Dict[str, float]:
        """True (un-relaxed) objective of (P) at a 0/1-psi, simplex-alpha
        point — used for reporting and for baseline comparisons."""
        psi = np.asarray(psi, float)
        alpha = np.asarray(alpha, float)
        src_term = float(self.phi_s * np.sum((1.0 - psi) * self.S))
        # term (d): sum_ij psi_j (1-psi_i) alpha_ij T_ij, vectorized so the
        # polish loop stays cheap at N=64+ (it calls this O(N) times/round)
        tgt = float(np.einsum("j,i,ij,ij->", psi, 1.0 - psi,
                              alpha, self.T))
        e = self.energy.energy(alpha)
        # Equality-constraint absorption: (83) carries sum_j chi^C_j with
        # unit weight, and chi^C_j >= |sum_i alpha_ij - psi_j|; at a
        # discrete point this is the exact cost of leaving a target
        # link-less (the paper's phi_E -> inf "all devices become targets"
        # regime lives here).
        eq_pen = float(np.sum(np.abs(alpha.sum(axis=0) - psi)))
        return {"source": src_term, "target": float(self.phi_t * tgt),
                "energy": float(self.phi_e * e), "equality": eq_pen,
                "total": src_term + self.phi_t * tgt + self.phi_e * e
                + eq_pen}

    def feasible_start(self) -> np.ndarray:
        """A feasible interior point x0 (Algorithm 2 line 2).

        alpha columns start proportional to softmax(-phi_t * T[:, j] / tau)
        rather than uniform: with uniform alpha every prospective target
        initially pays the MEAN source bound (bad sources included), which
        biases the relaxed psi toward all-sources; the softmax start prices
        targets at roughly their best-source bound, which is what the
        rounded optimum actually pays.
        """
        n = self.n
        x = np.zeros(self.idx.nvars)
        psi0 = 0.5
        tau = max(0.25 * float(np.std(self.T)), 1e-3)
        w = np.exp(-(self.T - self.T.min(axis=0, keepdims=True)) / tau)
        np.fill_diagonal(w, 0.0)
        w = w / np.maximum(w.sum(axis=0, keepdims=True), 1e-12)
        a0 = np.maximum(psi0 * w, self.eps_alpha)
        x[self.idx.psi] = psi0
        x[self.idx.alpha.ravel()] = a0.ravel()
        x[self.idx.chiS] = (1.0 - psi0) * self.S * 1.05 + 1e-3
        chiT0 = psi0 * (1.0 - psi0) * a0 * self.T * 1.05 + 1e-4
        x[self.idx.chiT.ravel()] = chiT0.ravel()
        x[self.idx.chiC] = self.eps_c / 2.0
        return x

    def start_from(self, psi: np.ndarray, alpha: np.ndarray) -> np.ndarray:
        """Warm-start iterate x0 from a previous (relaxed) solution.

        psi/alpha are clipped into this problem's box and the auxiliary
        chi variables are re-derived at their tight feasible values for the
        CURRENT problem data (S, T may have drifted since the previous
        solve) — exactly the feasible_start construction, evaluated at the
        supplied point instead of the default interior point.
        """
        n = self.n
        psi = np.clip(np.asarray(psi, float), self.eps_psi, 1.0)
        alpha = np.clip(np.asarray(alpha, float), self.eps_alpha, 1.0)
        x = np.zeros(self.idx.nvars)
        x[self.idx.psi] = psi
        x[self.idx.alpha.ravel()] = alpha.ravel()
        x[self.idx.chiS] = (1.0 - psi) * self.S * 1.05 + 1e-3
        chiT0 = psi[None, :] * (1.0 - psi[:, None]) * alpha * self.T \
            * 1.05 + 1e-4
        x[self.idx.chiT.ravel()] = chiT0.ravel()
        d = alpha.sum(axis=0) - psi
        x[self.idx.chiC] = np.maximum(np.abs(d), self.eps_c / 2.0)
        return x
