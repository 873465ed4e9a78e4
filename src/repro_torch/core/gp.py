"""Monomial / posynomial machinery + the arithmetic-geometric-mean (AGM)
monomial lower bound of Lemma 2 — the engine of Algorithm 2.

A monomial  u(y) = c * prod_k y_k^{b_k}  (c > 0) is, in log variables
z = log y, the affine function  log u = log c + b . z.  A posynomial is a
sum of monomials -> log g = logsumexp of affines (convex).  Lemma 2 bounds a
posynomial below by the monomial

    g_hat(y) = prod_i (u_i(y) / a_i)^{a_i},   a_i = u_i(y0) / g(y0),

whose log is again affine:  sum_i a_i (log u_i(z) - log a_i).  We represent
everything as (coeff-log, exponent-row) pairs over a flat variable vector so
the inner convex solve is a handful of array ops.

A numpy copy of ``repro.core.gp`` (the port imports nothing of the JAX
package); ``core.solver.build_program_reference`` packs (P) through it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Monomial:
    log_c: float
    exps: Dict[int, float]          # var index -> power

    def log_value(self, z: np.ndarray) -> float:
        return self.log_c + sum(p * z[k] for k, p in self.exps.items())


@dataclasses.dataclass
class Posynomial:
    terms: List[Monomial]

    @classmethod
    def const(cls, c: float) -> "Posynomial":
        return cls([Monomial(float(np.log(c)), {})])

    @classmethod
    def var(cls, idx: int, power: float = 1.0, coeff: float = 1.0
            ) -> "Posynomial":
        return cls([Monomial(float(np.log(coeff)), {idx: power})])

    def __add__(self, other: "Posynomial") -> "Posynomial":
        return Posynomial(self.terms + other.terms)

    def scale(self, c: float) -> "Posynomial":
        lc = float(np.log(c))
        return Posynomial([Monomial(m.log_c + lc, dict(m.exps))
                           for m in self.terms])

    def value(self, z: np.ndarray) -> float:
        return float(sum(np.exp(m.log_value(z)) for m in self.terms))

    def agm_monomial(self, z0: np.ndarray) -> Monomial:
        """Lemma 2 around the point y0 = exp(z0)."""
        logs = np.array([m.log_value(z0) for m in self.terms])
        mx = logs.max()
        w = np.exp(logs - mx)
        a = w / w.sum()                                   # a_i = u_i/g at y0
        log_c = 0.0
        exps: Dict[int, float] = {}
        for ai, m in zip(a, self.terms):
            if ai <= 1e-300:
                continue
            log_c += ai * (m.log_c - np.log(ai))
            for k, p in m.exps.items():
                exps[k] = exps.get(k, 0.0) + ai * p
        return Monomial(float(log_c), exps)


def pack_posynomial(p: Posynomial, nvars: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (log-coeffs (T,), exponent matrix (T, nvars)); log g(z) =
    logsumexp(logc + E @ z)."""
    logc = np.array([m.log_c for m in p.terms])
    e = np.zeros((len(p.terms), nvars))
    for t, m in enumerate(p.terms):
        for k, pw in m.exps.items():
            e[t, k] = pw
    return logc, e


def pack_monomial(m: Monomial, nvars: int) -> Tuple[float, np.ndarray]:
    e = np.zeros(nvars)
    for k, pw in m.exps.items():
        e[k] = pw
    return float(m.log_c), e
