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

Two inner evaluators, as in the reference.  The default
(``inner_impl="structured"``) evaluates the program through its family
structure as dense (n,) and (n, n) expressions over the psi/alpha/chi
views of z (``StructuredProgram``).  The generic packed path
(``inner_impl="packed"``) evaluates the sparse (log-coeff, var-index,
exponent) blocks of a ``PackedProgram`` with ``z[vidx]`` gathers, whose
backward pass is scatter-adds.  The packing is numpy: ``build_program``
fills the blocks by vectorized index arithmetic, and
``build_program_reference`` builds the same arrays through
``gp.Posynomial`` objects.  The inner loop is a Python loop of
``torch.autograd.grad`` steps where the reference scans under a
``lax.while_loop``; it keeps the reference's schedule exactly: z in
float32, the penalty ramp r = rho (1 + 99 t / steps) and the bias
corrections with float t, and the ``inner_tol`` early stop checked once
per equal-size chunk of steps.  On a GPU each step is a few hundred tiny
launches, so the inner loop is launch-bound.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.gp import Monomial, Posynomial
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


# ---------------------------------------------------------------- packing
class PackedTerms(NamedTuple):
    """Sparse monomial-term block: logc (G,T), vidx/vexp (G,T,K); numpy
    float32 / int32 / float32 as packed (the dtypes of the reference's
    device arrays), torch tensors on the solve's device inside it."""
    logc: np.ndarray
    vidx: np.ndarray
    vexp: np.ndarray


class Family(NamedTuple):
    """One constraint family num <= AGM(den) + extras, packed at the
    family's NATURAL term/variable width (padding G3's 63-term columns
    onto G2's 1-term groups is a ~30x waste at N=64)."""
    num: PackedTerms
    den: PackedTerms
    ex: PackedTerms


class PackedProgram(NamedTuple):
    """Structure of (P) at fixed coefficients; AGM points are supplied at
    solve time, so this packs once per solve (not once per outer iter)."""
    families: Tuple[Family, ...]
    o_num: PackedTerms
    o_den: PackedTerms


def _terms_from_arrays(logc: np.ndarray, vidx: np.ndarray,
                       vexp: np.ndarray) -> PackedTerms:
    return PackedTerms(np.asarray(logc, np.float32),
                       np.asarray(vidx, np.int32),
                       np.asarray(vexp, np.float32))


def _const_terms(logc: np.ndarray) -> PackedTerms:
    """(G, T) groups of pure constants — zero-width variable arrays."""
    g, t = logc.shape
    return _terms_from_arrays(logc, np.zeros((g, t, 0), np.int32),
                              np.zeros((g, t, 0)))


def _pad_terms(g: int) -> PackedTerms:
    """G empty groups (all-padding), as _pack_terms produces for them."""
    return _const_terms(np.full((g, 1), _NEG))


def _pack_terms(groups: Sequence[Sequence[Monomial]]) -> PackedTerms:
    """Ragged term groups -> (logc (G,T), vidx (G,T,K), vexp (G,T,K)) at
    the groups' natural widths (reference path; the vectorized packer
    below builds the same arrays directly)."""
    g = len(groups)
    t = max((len(terms) for terms in groups), default=1) or 1
    k = max((len(m.exps) for terms in groups for m in terms), default=0)
    logc = np.full((g, t), _NEG)
    vidx = np.zeros((g, t, k), np.int32)
    vexp = np.zeros((g, t, k), np.float64)
    for gi, terms in enumerate(groups):
        for ti, m in enumerate(terms):
            logc[gi, ti] = max(m.log_c, _NEG)
            for ki, (v, p) in enumerate(m.exps.items()):
                vidx[gi, ti, ki] = v
                vexp[gi, ti, ki] = p
    return _terms_from_arrays(logc, vidx, vexp)


def build_program(prob: STLFProblem) -> PackedProgram:
    """Pack (P)'s constraint/objective structure to sparse arrays with
    vectorized index arithmetic — no per-term Python objects.  Produces
    bit-identical arrays to ``build_program_reference`` (asserted by
    ``tests/test_torch_solver_packing.py``)."""
    n, idx = prob.n, prob.idx
    off = ~np.eye(n, dtype=bool)
    pi, pj = np.nonzero(off)               # row-major (i, j), i != j
    m = len(pi)
    # row j of src_of: the source indices i != j in ascending order
    src_of = np.broadcast_to(np.arange(n), (n, n))[off].reshape(n, n - 1)
    cols = np.arange(n)[:, None]

    # G1: 1 <= F_hat_i,  F_i = psi_i + chiS_i / S_i
    g1_den_logc = np.zeros((n, 2))
    g1_den_logc[:, 1] = np.log(1.0 / prob.S)
    g1_den_vidx = np.zeros((n, 2, 1), np.int64)
    g1_den_vidx[:, 0, 0] = idx.psi
    g1_den_vidx[:, 1, 0] = idx.chiS
    g1 = Family(_const_terms(np.zeros((n, 1))),
                _terms_from_arrays(g1_den_logc, g1_den_vidx,
                                   np.ones((n, 2, 1))),
                _pad_terms(n))

    # G2: T_ij <= H_hat_ij,  H_ij = psi_i T_ij + chiT_ij psi_j^-1 a_ij^-1
    t_off = prob.T[pi, pj]
    with np.errstate(divide="ignore"):
        g2_den_logc = np.stack(
            [np.maximum(np.log(t_off), _NEG), np.zeros(m)], axis=1)
    g2_den_vidx = np.zeros((m, 2, 3), np.int64)
    g2_den_vidx[:, 0, 0] = idx.psi[pi]
    g2_den_vidx[:, 1, 0] = idx.chiT[pi, pj]
    g2_den_vidx[:, 1, 1] = idx.psi[pj]
    g2_den_vidx[:, 1, 2] = idx.alpha[pi, pj]
    g2_den_vexp = np.zeros((m, 2, 3))
    g2_den_vexp[:, 0, 0] = 1.0
    g2_den_vexp[:, 1] = (1.0, -1.0, -1.0)
    g2 = Family(_const_terms(np.log(np.maximum(t_off, 1e-9))[:, None]),
                _terms_from_arrays(g2_den_logc, g2_den_vidx, g2_den_vexp),
                _pad_terms(m))

    # G3: sum_{i != j} a_ij <= M+_hat_j,  M+_j = chiC_j + eps_C + psi_j
    col_vidx = idx.alpha[src_of, cols][:, :, None]       # (n, n-1, 1)
    col_terms = _terms_from_arrays(np.zeros((n, n - 1)), col_vidx,
                                   np.ones((n, n - 1, 1)))
    g3_den_logc = np.zeros((n, 3))
    g3_den_logc[:, 1] = np.log(prob.eps_c)
    g3_den_vidx = np.zeros((n, 3, 1), np.int64)
    g3_den_vidx[:, 0, 0] = idx.chiC
    g3_den_vidx[:, 2, 0] = idx.psi
    g3_den_vexp = np.zeros((n, 3, 1))
    g3_den_vexp[:, 0, 0] = 1.0
    g3_den_vexp[:, 2, 0] = 1.0
    g3 = Family(col_terms,
                _terms_from_arrays(g3_den_logc, g3_den_vidx, g3_den_vexp),
                _pad_terms(n))

    # G4: chiC_j + psi_j <= M-_hat_j + eps_C,  M-_j = sum_{i != j} a_ij
    g4_num_vidx = np.zeros((n, 2, 1), np.int64)
    g4_num_vidx[:, 0, 0] = idx.chiC
    g4_num_vidx[:, 1, 0] = idx.psi
    g4 = Family(_terms_from_arrays(np.zeros((n, 2)), g4_num_vidx,
                                   np.ones((n, 2, 1))),
                col_terms,
                _const_terms(np.full((n, 1), np.log(prob.eps_c))))

    # Objective (83): each group is num_monomial / AGM(den posynomial);
    # chi blocks carry the trivial denominator 1 (AGM of a constant is
    # itself), energy blocks carry J_ij = a_ij + eps_E.
    on_logc: List[np.ndarray] = []
    on_vidx: List[np.ndarray] = []
    if prob.phi_s > 0:
        on_logc.append(np.full(n, np.log(prob.phi_s)))
        on_vidx.append(idx.chiS)
    if prob.phi_t > 0:
        on_logc.append(np.full(m, np.log(prob.phi_t)))
        on_vidx.append(idx.chiT[pi, pj])
    on_logc.append(np.zeros(n))
    on_vidx.append(idx.chiC)
    if prob.phi_e > 0:
        e_mask = off & (prob.energy.K > 0)
        ei, ej = np.nonzero(e_mask)
        on_logc.append(np.log(prob.phi_e * prob.energy.K[ei, ej]))
        on_vidx.append(idx.alpha[ei, ej])
        ne = len(ei)
    else:
        ne = 0
    num_logc = np.concatenate(on_logc)[:, None]          # (Go, 1)
    num_vidx = np.concatenate(on_vidx)[:, None, None]    # (Go, 1, 1)
    go = len(num_logc)
    o_num = _terms_from_arrays(num_logc, num_vidx, np.ones((go, 1, 1)))

    td, kd = (2, 1) if ne else (1, 0)
    od_logc = np.full((go, td), _NEG)
    od_logc[:, 0] = 0.0
    od_vidx = np.zeros((go, td, kd), np.int64)
    od_vexp = np.zeros((go, td, kd))
    if ne:
        od_logc[go - ne:, 1] = np.log(prob.energy.eps_e)
        od_vidx[go - ne:, 0, 0] = idx.alpha[ei, ej]
        od_vexp[go - ne:, 0, 0] = 1.0
    o_den = _terms_from_arrays(od_logc, od_vidx, od_vexp)

    return PackedProgram(families=(g1, g2, g3, g4), o_num=o_num,
                         o_den=o_den)


def build_program_reference(prob: STLFProblem) -> PackedProgram:
    """Object-graph packing of (P) via gp.Posynomial — the readable
    reference implementation ``build_program`` vectorizes (kept for the
    parity tests; ~quadratically slower, do not use on hot paths)."""
    n, idx = prob.n, prob.idx

    def pack_family(rows) -> Family:
        nums, dens, exs = zip(*rows)
        return Family(_pack_terms(nums), _pack_terms(dens),
                      _pack_terms(exs))

    none: List[Monomial] = []

    # G1: 1 <= F_hat_i
    g1 = []
    for i in range(n):
        F = Posynomial.var(idx.psi[i]) + \
            Posynomial.var(idx.chiS[i], coeff=1.0 / prob.S[i])
        g1.append((Posynomial.const(1.0).terms, F.terms, none))

    # G2: T_ij <= H_hat_ij
    g2 = []
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            H = Posynomial.var(idx.psi[i], coeff=prob.T[i, j]) + \
                Posynomial([Monomial(0.0, {idx.chiT[i, j]: 1.0,
                                           idx.psi[j]: -1.0,
                                           idx.alpha[i, j]: -1.0})])
            g2.append((Posynomial.const(max(prob.T[i, j], 1e-9)).terms,
                       H.terms, none))

    # G3: sum_i a_ij <= M+_hat_j
    g3 = []
    for j in range(n):
        col = Posynomial([Monomial(0.0, {idx.alpha[i, j]: 1.0})
                          for i in range(n) if i != j])
        Mp = Posynomial.var(idx.chiC[j]) + Posynomial.const(prob.eps_c) + \
            Posynomial.var(idx.psi[j])
        g3.append((col.terms, Mp.terms, none))

    # G4: chiC_j + psi_j <= M-_hat_j + eps_C
    g4 = []
    for j in range(n):
        num = Posynomial.var(idx.chiC[j]) + Posynomial.var(idx.psi[j])
        Mm = Posynomial([Monomial(0.0, {idx.alpha[i, j]: 1.0})
                         for i in range(n) if i != j])
        g4.append((num.terms, Mm.terms,
                   Posynomial.const(prob.eps_c).terms))

    # Objective (83)
    o_num: List[List[Monomial]] = []
    o_den: List[List[Monomial]] = []
    one = Posynomial.const(1.0)

    def add_obj(num: Monomial, den: Posynomial):
        o_num.append([num])
        o_den.append(den.terms)

    for i in range(n):
        if prob.phi_s > 0:
            add_obj(Monomial(float(np.log(prob.phi_s)), {idx.chiS[i]: 1.0}),
                    one)
    for i in range(n):
        for j in range(n):
            if i != j and prob.phi_t > 0:
                add_obj(Monomial(float(np.log(prob.phi_t)),
                                 {idx.chiT[i, j]: 1.0}), one)
    for j in range(n):
        add_obj(Monomial(0.0, {idx.chiC[j]: 1.0}), one)
    for i in range(n):
        for j in range(n):
            if i == j or prob.energy.K[i, j] <= 0 or prob.phi_e <= 0:
                continue
            J = Posynomial.var(idx.alpha[i, j]) + \
                Posynomial.const(prob.energy.eps_e)
            add_obj(Monomial(float(np.log(prob.phi_e * prob.energy.K[i, j])),
                             {idx.alpha[i, j]: 1.0}), J)

    return PackedProgram(
        families=(pack_family(g1), pack_family(g2), pack_family(g3),
                  pack_family(g4)),
        o_num=_pack_terms(o_num),
        o_den=_pack_terms(o_den))


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


# ------------------------------------------------------ packed evaluator
def _packed_on(prog: PackedProgram, device: torch.device) -> PackedProgram:
    """The packed numpy arrays as tensors on ``device`` (vidx as int64
    gather indices)."""
    def terms(t: PackedTerms) -> PackedTerms:
        return PackedTerms(torch.as_tensor(t.logc, device=device),
                           torch.as_tensor(t.vidx, dtype=torch.int64,
                                           device=device),
                           torch.as_tensor(t.vexp, device=device))
    return PackedProgram(
        families=tuple(Family(terms(f.num), terms(f.den), terms(f.ex))
                       for f in prog.families),
        o_num=terms(prog.o_num), o_den=terms(prog.o_den))


def _termlog(packed: PackedTerms, z):
    """(G, T) log-values of every packed monomial term at z."""
    logc, vidx, vexp = packed
    return logc + torch.sum(vexp * z[vidx], dim=-1)


def _agm_affine(packed: PackedTerms, z0):
    """Lemma 2 around z0 as an affine form of z: returns (c (G,), wexp
    (G,T,K)) with  log AGM(z) = c + sum_{t,k} wexp * z[vidx].  The
    softmax weights depend only on z0, so this is computed once per
    inner solve."""
    w = torch.softmax(_termlog(packed, z0), dim=-1)
    safe = w > 1e-12
    ws = torch.where(safe, w, 0.0)
    logw = torch.log(torch.where(safe, w, 1.0))
    c = torch.sum(ws * (packed.logc - logw), dim=-1)
    return c, ws[..., None] * packed.vexp


def _agm_eval(packed: PackedTerms, aff, z):
    c, wexp = aff
    return c + torch.sum(wexp * z[packed.vidx], dim=(-2, -1))


def _objective(prog: PackedProgram, aff_o, z):
    onum = torch.squeeze(_termlog(prog.o_num, z), dim=-1)    # (Go,)
    oden = _agm_eval(prog.o_den, aff_o, z)
    return torch.sum(torch.exp(onum - oden))


def _violations(prog: PackedProgram, affs, z):
    """Per-family relu(log num - log den) vectors (a list — families have
    different group counts and term widths)."""
    out = []
    for fam, aff in zip(prog.families, affs):
        num = torch.logsumexp(_termlog(fam.num, z), dim=-1)
        den_agm = _agm_eval(fam.den, aff, z)                 # (G,)
        ex = _termlog(fam.ex, z)                             # (G, Te)
        den = torch.logsumexp(torch.cat([den_agm[:, None], ex], dim=-1),
                              dim=-1)
        out.append(torch.relu(num - den))
    return out


def _packed_loss(prog: PackedProgram, affs, aff_o, z, r):
    """Objective + r-weighted penalty (squared and linear) on every
    family's violations: the packed counterpart of
    ``_structured_loss``."""
    pen = sum(r * torch.sum(torch.square(v)) + 10.0 * r * torch.sum(v)
              for v in _violations(prog, affs, z))
    return _objective(prog, aff_o, z) + pen


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


def _inner_solve_packed(prog: PackedProgram, z0, steps, lo, hi, rho,
                        inner_tol, chunk):
    """Generic packed-program inner solve (gather / scatter-add; the
    reference path): (z, objective, max violation, Adam steps run)."""
    with torch.no_grad():
        affs = tuple(_agm_affine(fam.den, z0) for fam in prog.families)
        aff_o = _agm_affine(prog.o_den, z0)
    z, ran = _adam_loop(
        lambda zz, r: _packed_loss(prog, affs, aff_o, zz, r),
        z0, steps, lo, hi, rho, inner_tol, chunk)
    with torch.no_grad():
        max_viol = torch.max(torch.stack(
            [torch.max(v) for v in _violations(prog, affs, z)]))
        return z, _objective(prog, aff_o, z), max_viol, ran


# ------------------------------------------------------------- polish
def _column_cost(prob: STLFProblem, j: int, col: np.ndarray) -> float:
    """Objective contribution of target j's alpha column (terms d + e,
    plus the unit chi^C equality-absorption penalty |sum(col) - 1|)."""
    t = prob.phi_t * float(col @ prob.T[:, j])
    e = prob.phi_e * float(np.sum(
        prob.energy.K[:, j] * col / (col + prob.energy.eps_e)))
    return t + e + abs(float(col.sum()) - 1.0)


def _best_column(prob: STLFProblem, j: int, psi: np.ndarray,
                 relaxed_col: Optional[np.ndarray] = None) -> np.ndarray:
    """Best alpha column for target j among: one-hot best source, a
    softmax spread over near-best sources, and the relaxed solver column.
    Column-wise the objective separates, so this is exact over the
    candidate set.  (Reference path for _batch_columns.)"""
    n = prob.n
    srcs = np.flatnonzero(psi == 0.0)
    cands: List[np.ndarray] = []
    # (Link-less targets are infeasible in (P): constraints (75)+(76)
    # squeeze |sum_i alpha_ij - psi_j| <= eps_C with chi^C >= 0, so every
    # target must receive ~unit total weight.)
    if len(srcs) == 0:
        return np.zeros(n)
    cost = prob.phi_t * prob.T[srcs, j] + prob.phi_e * prob.energy.K[srcs, j]
    one = np.zeros(n)
    one[srcs[int(np.argmin(cost))]] = 1.0
    cands.append(one)
    tau = max(0.25 * float(np.std(prob.T[srcs, j])), 1e-3)
    w = np.exp(-(prob.T[srcs, j] - prob.T[srcs, j].min()) / tau)
    w[w < 0.05 * w.max()] = 0.0
    sm = np.zeros(n)
    sm[srcs] = w / w.sum()
    cands.append(sm)
    if relaxed_col is not None and relaxed_col[srcs].sum() > 1e-9:
        rc = np.zeros(n)
        rc[srcs] = relaxed_col[srcs] / relaxed_col[srcs].sum()
        cands.append(rc)
    return min(cands, key=lambda c: _column_cost(prob, j, c))


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


def polish_assignment_reference(prob: STLFProblem, psi: np.ndarray,
                                alpha_relaxed: Optional[np.ndarray] = None,
                                max_rounds: int = 4
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column greedy reference for polish_assignment (O(N^3) Python
    loops; kept for the equivalence tests)."""
    n = prob.n
    psi = np.asarray(psi, float).copy()

    def alpha_for(psi_vec):
        a = np.zeros((n, n))
        for j in np.flatnonzero(psi_vec == 1.0):
            rc = alpha_relaxed[:, j] if alpha_relaxed is not None else None
            a[:, j] = _best_column(prob, j, psi_vec, rc)
        return a

    alpha = alpha_for(psi)
    best = prob.objective(psi, alpha)["total"]
    for _ in range(max_rounds):
        improved = False
        for i in range(n):
            cand = psi.copy()
            cand[i] = 1.0 - cand[i]
            if not np.any(cand == 0.0):      # need >= 1 source
                continue
            a2 = alpha_for(cand)
            obj = prob.objective(cand, a2)["total"]
            if obj < best - 1e-9:
                psi, alpha, best = cand, a2, obj
                improved = True
        if not improved:
            break
    return psi, alpha


# ---------------------------------------------------------------- outer
def solve_stlf(prob: STLFProblem, *, max_outer: int = 12,
               inner_steps: int = 1500, tol: float = 1e-3,
               step_tol: float = 0.02, rho: float = 50.0,
               link_threshold: float = 0.02, polish: bool = True,
               inner_tol: float = 0.0, inner_impl: str = "structured",
               verbose: bool = False,
               warm_start: Optional[SolverResult] = None,
               device: DeviceLike = None) -> SolverResult:
    """Algorithm 2, with the inner solves on ``device`` (the GPU unless
    the caller passes "cpu").

    Outer convergence fires on either (a) an objective-trace plateau
    (relative ``tol``) or (b) decision stability: the relaxed psi/alpha
    moved less than ``step_tol`` in one outer iteration.

    ``inner_tol``: early-stop threshold for the inner Adam loop (inf-norm
    z movement per chunk; 0 disables).

    ``inner_impl``: "structured" (default — the dense family-structure
    evaluator) or "packed" (the generic PackedProgram evaluator; the
    reference path); anything else raises ``ValueError``.

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
    if inner_impl == "structured":
        prog = build_structured(prob, device=dev)
        inner = _inner_solve_structured
    elif inner_impl == "packed":
        prog = _packed_on(build_program(prob), dev)
        inner = _inner_solve_packed
    else:
        raise ValueError(f"unknown inner_impl {inner_impl!r}")
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
        z_new, obj, max_viol, ran = inner(
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
