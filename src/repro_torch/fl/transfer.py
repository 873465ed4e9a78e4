"""Source -> target model transfer: h_t = sum_s alpha[s, t] h_s.

The stacked parameters are mixed as one flat (S, P) matrix by the
``alpha_combine`` kernel on the GPU (its plain version for CPU tensors),
the counterpart of ``repro.fl.transfer.combine_models(impl="pallas")``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels.alpha_combine.ops import alpha_combine_tree
from repro_torch.nn.param import tree_leaves

Params = Dict[str, Any]         # a (nested) dict of tensors


def _on(params: Params, a) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.as_tensor(a, dtype=torch.float32, device=dev)


def combine_models(params_stack: Params, alpha) -> Params:
    """params_stack: (nested) dict with leading device axis N; alpha: (N, N)
    column-stochastic over targets (alpha[s, t]).  Returns the same dict
    where entry t = sum_s alpha[s, t] * params[s]."""
    return alpha_combine_tree(params_stack, _on(params_stack, alpha))


def apply_transfer(params_stack: Params, alpha, psi) -> Params:
    """Targets (psi=1) receive their alpha-mixture; sources keep their own
    locally-trained parameters."""
    mixed = combine_models(params_stack, alpha)
    psi = _on(params_stack, psi)

    def sel(own, mix):
        if isinstance(own, dict):
            return {k: sel(own[k], mix[k]) for k in own}
        m = psi.reshape((-1,) + (1,) * (own.dim() - 1)).to(own.dtype)
        return own * (1 - m) + mix * m

    return sel(params_stack, mixed)


def column_normalize(alpha: np.ndarray, psi: np.ndarray,
                     energy_K: np.ndarray = None,
                     eps_hat: np.ndarray = None) -> np.ndarray:
    """Project raw link weights onto (P)'s feasible set: zero rows for
    targets / columns for sources, unit column sums at targets.

    A target whose column sums to ~0 (every candidate link deactivated)
    still must receive unit weight — constraints (75)+(76) squeeze
    |sum_i alpha_ij - psi_j| <= eps_C.  The rescue source is chosen by the
    cheapest criterion available rather than arbitrarily: minimum link
    energy ``energy_K[:, j]`` when given, else the lowest-error source
    (``eps_hat``), else the first source (the historical tie-break, kept
    as the final fallback so callers without measurements stay valid).
    """
    a = np.array(alpha, float)
    a[psi == 1.0, :] = 0.0
    a[:, psi == 0.0] = 0.0
    np.fill_diagonal(a, 0.0)
    for j in np.flatnonzero(psi == 1.0):
        c = a[:, j].sum()
        if c > 1e-12:
            a[:, j] /= c
        else:
            srcs = np.flatnonzero(psi == 0.0)
            if len(srcs) == 0:
                continue
            if energy_K is not None:
                pick = srcs[int(np.argmin(np.asarray(energy_K)[srcs, j]))]
            elif eps_hat is not None:
                pick = srcs[int(np.argmin(np.asarray(eps_hat)[srcs]))]
            else:
                pick = srcs[0]
            a[pick, j] = 1.0
    return a
