"""Algorithm 2: successive-convex-approximation solver for (P), the
structured path of ``repro.core.solver``.

Each outer iteration linearizes every GP-violating posynomial denominator
with the AGM monomial bound (Lemma 2) around the previous iterate, giving
a convex program in log variables z (x = e^z), minimized by a penalty +
Adam inner loop:

  G1 (each i):      1 <= F_hat_i(z),  F_i = psi_i + chiS_i / S_i
  G2 (each i!=j):   T_ij <= H_hat_ij(z),
                    H_ij = psi_i T_ij + chiT_ij psi_j^-1 a_ij^-1
  G3 (each j):      sum_i a_ij <= M+_hat_j(z), M+_j = chiC_j+eps_C+psi_j
  G4 (each j):      chiC_j + psi_j <= M-_hat_j(z) + eps_C, M-_j = sum a
Objective (83): phiS sum chiS + phiT sum chiT + phiE sum K a / J_hat + sum chiC.

The program is evaluated through its family structure as dense (n,) and
(n, n) expressions over the psi/alpha/chi views of z
(``StructuredProgram``).  The inner loop is a Python loop of
``torch.autograd.grad`` steps where the reference scans under a
``lax.while_loop``; it keeps the reference's schedule exactly: z in
float32, the penalty ramp r = rho (1 + 99 t / steps) and the bias
corrections with float t, and the ``inner_tol`` early stop checked once
per equal-size chunk of steps.  On a GPU each step is a few hundred tiny
launches, so the inner loop is launch-bound.

The generic packed evaluator of the reference (``build_program``,
``inner_impl="packed"``) is not ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.problem import STLFProblem
from repro_torch.device import DeviceLike, resolve_device

_NEG = -1e30                       # pad log-coeff: exp() == 0, softmax w == 0


@dataclasses.dataclass
class SolverResult:
    psi: np.ndarray              # rounded {0,1}; 0 = source, 1 = target
    alpha: np.ndarray            # masked + renormalized link weights
    psi_relaxed: np.ndarray
    alpha_relaxed: np.ndarray
    objective_trace: List[float]
    objective_parts: Dict[str, float]
    converged: bool
    outer_iters: int
    # Full relaxed iterate x = e^z (chi auxiliaries included).  Passed back
    # via solve_stlf(warm_start=...) it resumes the SCA exactly where the
    # previous solve stopped; None on results not produced by solve_stlf.
    x_relaxed: Optional[np.ndarray] = None
    # Wall-clock breakdown of the producing solve_stlf call (0.0 on
    # externally-built results): program packing vs the whole solve.
    pack_time_s: float = 0.0
    solve_time_s: float = 0.0
    # Adam steps the inner loops ran, over every outer iteration (fewer
    # than outer_iters * inner_steps when inner_tol stops a loop early)
    inner_steps: int = 0


# ------------------------------------------------------- structured form
class StructuredProgram(NamedTuple):
    """(P) specialized to its fixed family structure: dense (n,)/(n,n)
    float32 coefficient tensors consumed by broadcast expressions over
    the psi/alpha/chiS/chiT/chiC views of z."""
    off: torch.Tensor        # (n,n) off-diagonal mask
    logS_inv: torch.Tensor   # (n,)   log(1/S_i)
    logT_den: torch.Tensor   # (n,n)  log T_ij (0 on the diagonal)
    logT_num: torch.Tensor   # (n,n)  log max(T_ij, 1e-9)
    log_eps_c: torch.Tensor  # scalar log eps_C
    e_mask: torch.Tensor     # (n,n)  energy-objective block mask
    log_phiK: torch.Tensor   # (n,n)  log(phi_E K_ij) on e_mask (0 elsewhere)
    log_eps_e: torch.Tensor  # scalar log eps_E
    phi_s: torch.Tensor      # scalar
    phi_t: torch.Tensor      # scalar


def build_structured(prob: STLFProblem, *,
                     device: DeviceLike = None) -> StructuredProgram:
    """Structured-form packing of (P), computed in float32 on the host as
    the reference does (its T-floor is the smallest normal float32)."""
    dev = resolve_device(device)
    n = prob.n
    f32 = np.float32
    off = ~np.eye(n, dtype=bool)
    e_mask = off & (prob.energy.K > 0) if prob.phi_e > 0 \
        else np.zeros_like(off)
    T = np.asarray(prob.T, f32)
    t_floor = np.finfo(f32).tiny
    arrays = dict(
        off=off,
        logS_inv=np.log(f32(1.0) / np.asarray(prob.S, f32)),
        logT_den=np.where(off, np.log(np.maximum(T, t_floor)), f32(0.0)),
        logT_num=np.log(np.maximum(T, f32(1e-9))),
        log_eps_c=np.log(f32(prob.eps_c)),
        e_mask=e_mask,
        log_phiK=np.where(
            e_mask,
            np.log(np.where(e_mask,
                            f32(prob.phi_e) * np.asarray(prob.energy.K, f32),
                            f32(1.0))), f32(0.0)),
        log_eps_e=np.log(f32(prob.energy.eps_e)),
        phi_s=f32(prob.phi_s),
        phi_t=f32(prob.phi_t))
    return StructuredProgram(**{k: torch.as_tensor(np.asarray(v),
                                                   device=dev)
                                for k, v in arrays.items()})


def _views(z, n):
    """psi (n,), alpha (n,n), chiS (n,), chiT (n,n), chiC (n,) of z —
    the VarIndex layout as zero-copy reshapes."""
    return (z[:n], z[n:n + n * n].reshape(n, n),
            z[n + n * n:2 * n + n * n],
            z[2 * n + n * n:2 * n + 2 * n * n].reshape(n, n),
            z[2 * n + 2 * n * n:])


def _entropy(w, dim):
    """Zero-safe AGM weights and sum w log w along ``dim``."""
    safe = w > 1e-12
    ws = torch.where(safe, w, 0.0)
    return ws, torch.sum(ws * torch.log(torch.where(safe, w, 1.0)), dim=dim)


def _softmax_entropy(t):
    """AGM weights over the last axis + sum w log w (zero-safe)."""
    return _entropy(torch.softmax(t, dim=-1), -1)


def _structured_affine(sp: StructuredProgram, z0):
    """All families' AGM weights (Lemma 2) at z0 — computed once per
    inner solve."""
    n = sp.off.shape[0]
    zp0, za0, zS0, zT0, zC0 = _views(z0, n)
    w1, h1 = _softmax_entropy(torch.stack(
        [zp0, sp.logS_inv + zS0], dim=-1))                        # G1 (n,2)
    w2, h2 = _softmax_entropy(torch.stack(
        [sp.logT_den + zp0[:, None],
         zT0 - zp0[None, :] - za0], dim=-1))                    # G2 (n,n,2)
    w3, h3 = _softmax_entropy(torch.stack(
        [zC0, sp.log_eps_c.expand(n), zp0], dim=-1))              # G3 (n,3)
    wcs, hc = _entropy(torch.softmax(torch.where(sp.off, za0, _NEG), dim=0),
                       0)                                         # G4 columns
    wj, hj = _softmax_entropy(torch.stack(
        [za0, sp.log_eps_e.expand(n, n)], dim=-1))           # energy (n,n,2)
    return (w1, h1, w2, h2, w3, h3, wcs, hc, wj, hj)


def _structured_violations(sp: StructuredProgram, aff, z):
    """relu(log num - log den) per family, den AGM-linearized via aff."""
    n = sp.off.shape[0]
    w1, h1, w2, h2, w3, h3, wcs, hc, _, _ = aff
    zp, za, zS, zT, zC = _views(z, n)
    d1 = w1[:, 0] * zp + w1[:, 1] * (sp.logS_inv + zS) - h1
    v1 = torch.relu(-d1)                                    # num = log 1 = 0
    d2 = w2[..., 0] * (sp.logT_den + zp[:, None]) \
        + w2[..., 1] * (zT - zp[None, :] - za) - h2
    v2 = torch.where(sp.off, torch.relu(sp.logT_num - d2), 0.0)
    colnum = torch.logsumexp(torch.where(sp.off, za, _NEG), dim=0)
    d3 = w3[:, 0] * zC + w3[:, 1] * sp.log_eps_c + w3[:, 2] * zp - h3
    v3 = torch.relu(colnum - d3)
    dcol = torch.sum(wcs * za, dim=0) - hc
    v4 = torch.relu(torch.logaddexp(zC, zp)
                    - torch.logaddexp(dcol, sp.log_eps_c))
    return v1, v2, v3, v4


def _structured_objective(sp: StructuredProgram, aff, z):
    n = sp.off.shape[0]
    wj, hj = aff[8], aff[9]
    zp, za, zS, zT, zC = _views(z, n)
    jden = wj[..., 0] * za + wj[..., 1] * sp.log_eps_e - hj
    return sp.phi_s * torch.sum(torch.exp(zS)) \
        + sp.phi_t * torch.sum(torch.where(sp.off, torch.exp(zT), 0.0)) \
        + torch.sum(torch.exp(zC)) \
        + torch.sum(torch.where(sp.e_mask,
                                torch.exp(sp.log_phiK + za - jden), 0.0))


def _structured_loss(sp: StructuredProgram, aff, z, r):
    """Objective + r-weighted penalty (squared and linear) on every
    family's violations."""
    pen = sum(r * torch.sum(torch.square(v)) + 10.0 * r * torch.sum(v)
              for v in _structured_violations(sp, aff, z))
    return _structured_objective(sp, aff, z) + pen


# ---------------------------------------------------------------- inner
def _chunk_for(steps: int, cap: int = 64) -> int:
    """Largest divisor of ``steps`` <= cap: the inner loop runs in equal
    chunks so early stopping never changes the Adam/penalty schedule."""
    for d in range(min(cap, steps), 0, -1):
        if steps % d == 0:
            return d
    return 1


def _adam_loop(loss, z0, steps, lo, hi, rho, inner_tol, chunk):
    """Penalty + Adam minimization of the z0-linearized convex program.

    Runs ``chunk``-step segments; stops once a whole chunk moves z by
    less than ``inner_tol`` (inf-norm, log space) — inner_tol <= 0
    always runs the full ``steps`` budget.  ``loss(z, r)`` supplies the
    objective + r-weighted penalty.  The step's scalars (penalty weight
    r, bias corrections) are computed in float32 as in the reference.
    Returns (z, Adam steps run)."""
    f32 = np.float32
    lr = 0.02
    b1, b2, eps = 0.9, 0.999, 1e-8
    z = z0.detach()
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    t = 0
    while True:
        z_chunk = z
        for _ in range(chunk):
            tf = f32(t)
            r = f32(rho) * (f32(1.0) + f32(99.0) * tf / f32(steps))
            zg = z.requires_grad_()
            g, = torch.autograd.grad(loss(zg, float(r)), zg)
            with torch.no_grad():
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                mh = m / float(f32(1.0) - f32(b1) ** (tf + f32(1.0)))
                vh = v / float(f32(1.0) - f32(b2) ** (tf + f32(1.0)))
                z = torch.clamp(z - lr * mh / (torch.sqrt(vh) + eps),
                                lo, hi)
            t += 1
        if t >= steps:
            return z, t
        if inner_tol > 0.0:
            with torch.no_grad():
                if float(torch.max(torch.abs(z - z_chunk))) <= inner_tol:
                    return z, t


def _inner_solve_structured(sp: StructuredProgram, z0, steps, lo, hi, rho,
                            inner_tol, chunk):
    """One convexified inner solve: (z, objective, max violation, Adam
    steps run)."""
    with torch.no_grad():
        aff = _structured_affine(sp, z0)
    z, ran = _adam_loop(lambda zz, r: _structured_loss(sp, aff, zz, r),
                   z0, steps, lo, hi, rho, inner_tol, chunk)
    with torch.no_grad():
        max_viol = torch.max(torch.stack(
            [torch.max(v) for v in _structured_violations(sp, aff, z)]))
        return z, _structured_objective(sp, aff, z), max_viol, ran


# ------------------------------------------------------------- polish
def _batch_columns(prob: STLFProblem, srcs: np.ndarray, tgts: np.ndarray,
                   alpha_relaxed: Optional[np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """All targets' best candidate columns at once: one-hot at the
    cheapest source, a softmax spread over near-best sources, and the
    relaxed solver column.  Returns (cols embedded in (n, t), costs
    (t,)); a zero column of cost 1 (the chi^C equality penalty of a
    link-less target) when there are no sources."""
    n = prob.n
    t = len(tgts)
    if t == 0:
        return np.zeros((n, 0)), np.zeros(0)
    if len(srcs) == 0:
        return np.zeros((n, t)), np.ones(t)
    Ts = prob.T[np.ix_(srcs, tgts)]                      # (s, t)
    Ks = prob.energy.K[np.ix_(srcs, tgts)]
    eps_e = prob.energy.eps_e
    ar = np.arange(t)

    def cost_of(cols):                                   # cols (s, t)
        d = prob.phi_t * np.einsum("st,st->t", cols, Ts)
        e = prob.phi_e * np.sum(Ks * cols / (cols + eps_e), axis=0)
        return d + e + np.abs(cols.sum(axis=0) - 1.0)

    # candidate 0: one-hot at the cheapest source
    sel = prob.phi_t * Ts + prob.phi_e * Ks
    b = np.argmin(sel, axis=0)
    onehot = np.zeros((len(srcs), t))
    onehot[b, ar] = 1.0
    # candidate 1: softmax spread over near-best sources
    tau = np.maximum(0.25 * np.std(Ts, axis=0), 1e-3)
    w = np.exp(-(Ts - Ts.min(axis=0, keepdims=True)) / tau)
    w[w < 0.05 * w.max(axis=0, keepdims=True)] = 0.0
    sm = w / w.sum(axis=0, keepdims=True)
    cand_cols = [onehot, sm]
    cand_cost = [cost_of(onehot), cost_of(sm)]
    # candidate 2: the relaxed solver column, renormalized over sources
    if alpha_relaxed is not None:
        R = alpha_relaxed[np.ix_(srcs, tgts)]
        rs = R.sum(axis=0)
        ok = rs > 1e-9
        rc = R / np.where(ok, rs, 1.0)
        rc[:, ~ok] = 0.0
        c2 = cost_of(rc)
        c2[~ok] = np.inf
        cand_cols.append(rc)
        cand_cost.append(c2)

    costs = np.stack(cand_cost)                          # (C, t)
    pick = np.argmin(costs, axis=0)      # first-min tie-break, like min()
    stacked = np.stack(cand_cols)                        # (C, s, t)
    chosen = stacked[pick, :, ar].T                      # (s, t)
    cols = np.zeros((n, t))
    cols[srcs] = chosen
    return cols, costs[pick, ar]


def polish_assignment(prob: STLFProblem, psi: np.ndarray,
                      alpha_relaxed: Optional[np.ndarray] = None,
                      max_rounds: int = 4
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy coordinate descent on the TRUE (un-relaxed) objective of (P):
    rebuild every target's alpha column from candidates, then try flipping
    each psi_i while all other coordinates stay at their conditional
    optima, each flip priced column-separably —
    objective(cand) = phi_S sum_src S + sum_j best-column cost."""
    n = prob.n
    psi = np.asarray(psi, float).copy()

    def evaluate(psi_vec):
        srcs = np.flatnonzero(psi_vec == 0.0)
        tgts = np.flatnonzero(psi_vec == 1.0)
        cols, costs = _batch_columns(prob, srcs, tgts, alpha_relaxed)
        obj = prob.phi_s * float(prob.S[srcs].sum()) + float(costs.sum())
        return tgts, cols, obj

    def materialize(tgts, cols):
        a = np.zeros((n, n))
        a[:, tgts] = cols
        return a

    tgts, cols, best = evaluate(psi)
    alpha = materialize(tgts, cols)
    for _ in range(max_rounds):
        improved = False
        for i in range(n):
            cand = psi.copy()
            cand[i] = 1.0 - cand[i]
            if not np.any(cand == 0.0):      # need >= 1 source
                continue
            t2, c2, obj = evaluate(cand)
            if obj < best - 1e-9:
                psi, best = cand, obj
                alpha = materialize(t2, c2)
                improved = True
        if not improved:
            break
    return psi, alpha


# ---------------------------------------------------------------- outer
def solve_stlf(prob: STLFProblem, *, max_outer: int = 12,
               inner_steps: int = 1500, tol: float = 1e-3,
               step_tol: float = 0.02, rho: float = 50.0,
               link_threshold: float = 0.02, polish: bool = True,
               inner_tol: float = 0.0, verbose: bool = False,
               warm_start: Optional[SolverResult] = None,
               device: DeviceLike = None) -> SolverResult:
    """Algorithm 2, with the inner solves on ``device`` (the GPU unless
    the caller passes "cpu").

    Outer convergence fires on either (a) an objective-trace plateau
    (relative ``tol``) or (b) decision stability: the relaxed psi/alpha
    moved less than ``step_tol`` in one outer iteration.

    ``inner_tol``: early-stop threshold for the inner Adam loop (inf-norm
    z movement per chunk; 0 disables).

    ``warm_start``: a previous SolverResult whose relaxed iterate seeds
    the SCA."""
    t_solve = time.perf_counter()
    dev = resolve_device(device)
    n, idx = prob.n, prob.idx
    if warm_start is not None:
        if warm_start.x_relaxed is not None \
                and len(warm_start.x_relaxed) == idx.nvars:
            x0 = np.asarray(warm_start.x_relaxed, float)
        else:
            # different network size (churn) or externally-built result:
            # re-derive the chi auxiliaries from (psi, alpha)
            x0 = prob.start_from(warm_start.psi_relaxed,
                                 warm_start.alpha_relaxed)
    else:
        x0 = prob.feasible_start()
    z = np.log(np.maximum(x0, 1e-12))

    lo = np.full(idx.nvars, np.log(1e-8))
    hi = np.full(idx.nvars, np.log(1e4))
    lo[idx.psi] = np.log(prob.eps_psi)
    hi[idx.psi] = 0.0
    lo[idx.alpha.ravel()] = np.log(prob.eps_alpha)
    hi[idx.alpha.ravel()] = 0.0
    z = np.clip(z, lo, hi)

    t_pack = time.perf_counter()
    prog = build_structured(prob, device=dev)
    pack_time = time.perf_counter() - t_pack
    f32 = dict(dtype=torch.float32, device=dev)
    lo_t, hi_t = torch.as_tensor(lo, **f32), torch.as_tensor(hi, **f32)
    chunk = _chunk_for(int(inner_steps))

    trace: List[float] = []
    converged = False
    it = 0
    dec = np.concatenate([idx.psi, idx.alpha.ravel()])
    steps_run = 0
    for it in range(max_outer):
        z_new, obj, max_viol, ran = _inner_solve_structured(
            prog, torch.as_tensor(z, **f32), int(inner_steps), lo_t, hi_t,
            rho, float(inner_tol), chunk)
        steps_run += ran
        z_new = z_new.cpu().numpy()
        trace.append(float(obj))
        step = float(np.max(np.abs(np.exp(z_new[dec]) - np.exp(z[dec]))))
        if verbose:
            print(f"[stlf] outer {it}: obj={float(obj):.4f} "
                  f"viol={float(max_viol):.2e} step={step:.4f}")
        plateau = it > 0 and abs(trace[-1] - trace[-2]) \
            < tol * max(1.0, abs(trace[-2]))
        z = z_new
        if plateau or step < step_tol:
            converged = True
            break

    x = np.exp(z)
    psi_rel = x[idx.psi]
    alpha_rel = x[idx.alpha.ravel()].reshape(n, n)

    # ---- rounding (documented deviation: paper is silent on its rounding)
    psi = (psi_rel >= 0.5).astype(float)           # 1 = target
    if np.all(psi == 1.0):                         # degenerate: no sources
        if prob.phi_e * np.mean(prob.energy.K) < 1e3:   # keep best device
            psi[int(np.argmin(prob.S))] = 0.0
    if np.all(psi == 0.0):                         # degenerate: no targets
        psi[int(np.argmax(prob.S))] = 1.0

    alpha = alpha_rel.copy()
    alpha[psi == 1.0, :] = 0.0                     # targets don't transmit
    alpha[:, psi == 0.0] = 0.0                     # sources don't receive
    np.fill_diagonal(alpha, 0.0)
    alpha[alpha < link_threshold] = 0.0            # link deactivation
    tgt = psi == 1.0
    csum = alpha.sum(axis=0)
    live = tgt & (csum > 1e-9)
    alpha[:, live] /= csum[live]
    dead = np.flatnonzero(tgt & ~live)             # fall back: best source
    srcs = np.flatnonzero(psi == 0.0)
    if len(dead) and len(srcs):
        alpha[srcs[np.argmin(prob.T[np.ix_(srcs, dead)], axis=0)],
              dead] = 1.0

    if polish:
        psi, alpha = polish_assignment(prob, psi, alpha_rel)

    return SolverResult(
        psi=psi, alpha=alpha, psi_relaxed=psi_rel, alpha_relaxed=alpha_rel,
        objective_trace=trace,
        objective_parts=prob.objective(psi, alpha),
        converged=converged, outer_iters=it + 1, x_relaxed=x,
        pack_time_s=pack_time,
        solve_time_s=time.perf_counter() - t_solve, inner_steps=steps_run)
