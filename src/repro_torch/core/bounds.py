"""Numpy copy of ``repro.core.bounds``: the port imports nothing of the JAX
package.

Measurable generalization-bound terms (Sec. IV-A).

Implements, with delta the confidence parameter:

  Massart (Lemma 3):  Rad_Q(H) <= sqrt(2 log 2) for binary H
  eq (17):  S_i  = eps^_i(h_i) + 2 sqrt(2 log 2) + 3 sqrt(log(2/d)/(2 D_i))
  eq (18):  T_ij = eps^_i(h_i) + 10 sqrt(2 log 2) + [label-fn diff, omitted]
                   + 1/2 d^_HdH(D_j, D_i) + [eps^_j(h_j,h_i), omitted per
                   paper's App. H-2 note] + 6 (sqrt(log(2/d)/(2 D_i))
                   + sqrt(log(2/d)/(2 D_j)))

Empirical errors follow Sec. III-A: on an unlabeled datum x,
|h(x) - f(x)| is counted as 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

SQRT_2LOG2 = math.sqrt(2.0 * math.log(2.0))


def massart_rad_bound() -> float:
    """Worst-case empirical Rademacher complexity of a binary H (eq. 47)."""
    return SQRT_2LOG2


def confidence_term(n: int, delta: float) -> float:
    """3 sqrt(log(2/delta) / (2 n)) — Bartlett-Mendelson deviation term."""
    return 3.0 * math.sqrt(math.log(2.0 / delta) / (2.0 * max(n, 1)))


def empirical_error(correct: np.ndarray, labeled_mask: np.ndarray) -> float:
    """eq (3) with the unlabeled-counted-as-1 convention.

    correct: bool array, prediction == label (meaningless where unlabeled).
    labeled_mask: bool array, True where the datum is labeled.
    """
    correct = np.asarray(correct, bool)
    labeled_mask = np.asarray(labeled_mask, bool)
    n = correct.shape[0]
    if n == 0:
        return 1.0
    wrong_labeled = np.sum(labeled_mask & ~correct)
    unlabeled = np.sum(~labeled_mask)
    return float(wrong_labeled + unlabeled) / n


def hypothesis_disagreement(pred_a: np.ndarray, pred_b: np.ndarray) -> float:
    """eq (4): empirical hypothesis-difference error on shared data."""
    pred_a, pred_b = np.asarray(pred_a), np.asarray(pred_b)
    if pred_a.size == 0:
        return 0.0
    return float(np.mean(pred_a != pred_b))


def source_term(eps_hat: float, n: int, delta: float = 0.05,
                include_constants: bool = False) -> float:
    """S_i of eq (17).

    ``include_constants`` controls the data-independent Massart offset
    2*sqrt(2 log 2).  Reproduction finding: with the raw constants included,
    T_ij - S_i >= 8*sqrt(2 log 2) ~ 9.4 for every (i, j), so under the
    paper's phi_S=1, phi_T=5 the optimization (P) degenerates to
    all-devices-are-sources — Fig. 4/5 of the paper (5/5 source/target
    splits) can only emerge when the constant offsets are dropped from the
    optimization surface (they never affect the optimal alpha at fixed psi,
    only the psi balance).  We therefore exclude them from S_i/T_ij by
    default while keeping them in the Corollary-1 bound evaluations
    (Table II).  See EXPERIMENTS.md §Paper-validation.
    """
    c = 2.0 * SQRT_2LOG2 if include_constants else 0.0
    return eps_hat + c + confidence_term(n, delta)


def source_term_opt(eps_hat: float, n: int, delta: float = 0.05,
                    include_constants: bool = True,
                    include_confidence: bool = True) -> float:
    """S_i as used on the optimization surface of (P).

    Calibration finding (see EXPERIMENTS.md §Paper-validation): with BOTH
    Massart offsets included verbatim (2√(2log2) in S_i, 10√(2log2) in
    T_ij), T_ij − S_i ≥ 8√(2log2) ≈ 9.4 for every pair, so under the
    paper's φS=1, φT=5 no device can ever prefer to be a target — yet the
    paper's own Fig. 4/5 show 5/5 source/target splits.  The unique
    flag setting that reproduces ALL of the paper's reported behaviors
    (Fig 4B high-ε flip, Fig 5A/B regime structure, Fig 6/7 φE thresholds
    with all-targets saturation at φE≈1e3) keeps the Massart offset in S_i
    but drops it from T_ij; the per-device confidence terms stay.  That is
    our default; the verbatim eq. (17)/(18) surface is one flag away and
    is always used for the Corollary-1 bound evaluation (Table II).
    """
    out = eps_hat
    if include_constants:
        out += 2.0 * SQRT_2LOG2
    if include_confidence:
        out += confidence_term(n, delta)
    return out


def target_term(eps_hat_src: float, div_hat: float, n_src: int, n_tgt: int,
                delta: float = 0.05, label_fn_diff: float = 0.0,
                hyp_comb_noise: float = 0.0,
                include_constants: bool = False) -> float:
    """T_ij of eq (18).

    ``label_fn_diff`` (term eps_j(f_j, f_i)) is unmeasurable and omitted (=0)
    exactly as the paper argues; ``hyp_comb_noise`` defaults to 0 matching
    the paper's App. H-2 simulation note, but can be supplied.
    ``include_constants``: see source_term.
    """
    c = 10.0 * SQRT_2LOG2 if include_constants else 0.0
    return (eps_hat_src + c + label_fn_diff
            + 0.5 * div_hat + hyp_comb_noise
            + 2.0 * (confidence_term(n_src, delta)
                     + confidence_term(n_tgt, delta)))


def target_term_opt(eps_hat_src: float, div_hat: float, n_src: int,
                    n_tgt: int, delta: float = 0.05,
                    label_fn_diff: float = 0.0, hyp_comb_noise: float = 0.0,
                    include_constants: bool = False,
                    include_confidence: bool = True) -> float:
    """T_ij on the optimization surface of (P); see source_term_opt
    (default keeps the Massart offset OUT of T_ij — the calibrated
    reproduction surface)."""
    out = eps_hat_src + label_fn_diff + 0.5 * div_hat + hyp_comb_noise
    if include_constants:
        out += 10.0 * SQRT_2LOG2
    if include_confidence:
        out += 2.0 * (confidence_term(n_src, delta)
                      + confidence_term(n_tgt, delta))
    return out


def corollary1_rhs(alpha: np.ndarray, eps_src: np.ndarray, div: np.ndarray,
                   n_src: np.ndarray, n_tgt: int, delta: float = 0.05,
                   hyp_noise: Optional[np.ndarray] = None) -> float:
    """Full RHS of Corollary 1 (eq. 10) for one target: alpha (S,),
    eps_src (S,), div (S,), n_src (S,)."""
    s = len(alpha)
    total = 0.0
    for k in range(s):
        hn = 0.0 if hyp_noise is None else float(hyp_noise[k])
        total += alpha[k] * (
            eps_src[k] + 0.5 * div[k] + hn + 10.0 * SQRT_2LOG2
            + 2.0 * (confidence_term(int(n_src[k]), delta)
                     + confidence_term(n_tgt, delta)))
    return float(total)


def theorem2_rhs(alpha: np.ndarray, eps_src_true: np.ndarray,
                 div_true: np.ndarray, hyp_noise: np.ndarray,
                 label_fn_diff: Optional[np.ndarray] = None) -> float:
    """RHS of Theorem 2 (eq. 6), with empirical stand-ins for true terms
    (the Table II protocol)."""
    s = len(alpha)
    total = 0.0
    for k in range(s):
        lf = 0.0 if label_fn_diff is None else float(label_fn_diff[k])
        total += alpha[k] * (eps_src_true[k] + lf + 0.5 * div_true[k]
                             + hyp_noise[k])
    return float(total)


@dataclasses.dataclass
class BoundTerms:
    """Everything (P) needs, computed from the network (Sec. IV-B)."""
    eps_hat: np.ndarray        # (N,) empirical errors (unlabeled counted 1)
    n_data: np.ndarray         # (N,) local dataset sizes
    div_hat: np.ndarray        # (N, N) empirical H-divergences (Alg. 1)
    delta: float = 0.05
    # Calibrated optimization surface (see source_term_opt and
    # EXPERIMENTS.md §Paper-validation): S_i keeps ALL of eq. (17) — the
    # Massart offset and the data-quantity confidence term are exactly the
    # paper's "quality and quantity of data" source-selection signal.  T_ij
    # keeps only the SIGNAL terms of eq. (18) (source error + divergence):
    # its Massart/confidence additions are (near-)uniform additive shifts
    # across (i, j) that get multiplied by phi_T=5 and wipe out the psi
    # balance the paper's own figures exhibit; they never change argmin
    # alpha at fixed psi.
    massart_in_S: bool = True      # 2√(2log2) offset in S_i (eq. 17)
    massart_in_T: bool = False     # 10√(2log2) offset in T_ij (eq. 18)
    confidence_in_S: bool = True   # 3√(log(2/δ)/2n) in S_i
    confidence_in_T: bool = False  # 6(√.. + √..) in T_ij

    @property
    def n(self) -> int:
        return len(self.eps_hat)

    def S(self) -> np.ndarray:
        return np.array([source_term_opt(
            self.eps_hat[i], int(self.n_data[i]), self.delta,
            self.massart_in_S, self.confidence_in_S)
            for i in range(self.n)])

    def T(self) -> np.ndarray:
        n = self.n
        out = np.zeros((n, n))
        for i in range(n):
            for j in range(n):
                out[i, j] = target_term_opt(
                    self.eps_hat[i], self.div_hat[i, j],
                    int(self.n_data[i]), int(self.n_data[j]), self.delta,
                    include_constants=self.massart_in_T,
                    include_confidence=self.confidence_in_T)
        return out
