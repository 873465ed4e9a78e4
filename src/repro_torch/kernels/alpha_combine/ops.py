"""Weighted source->target parameter mixing, ``out = alpha^T @ theta``.

``alpha_combine`` launches the CUDA kernel in ``csrc/alpha_combine.cu``
for CUDA tensors and computes ``alpha_combine_plain`` for CPU tensors;
there is no other fallback.  It replaces the Pallas TPU kernel
``repro/kernels/alpha_combine/kernel.py`` (``_combine_kernel`` /
``alpha_combine_flat``).  On the H100 the transfer's shape (S = T = 10,
P = 48,158) is bound by its 3.85 MB of bytes and, in practice, by the
launch; at S = T = 256 it is bound by its fp32 FMAs.  The kernel streams
theta coalesced along P, stages alpha slabs in shared memory and keeps
the sums in registers (see the source's header).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.nn.param import flatten_to_vector, unflatten_from_vector

_SIGNATURE = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
              ctypes.c_void_p)


def alpha_combine_plain(theta: torch.Tensor,
                        alpha: torch.Tensor) -> torch.Tensor:
    """theta (S, P), alpha (S, T) -> (T, P) float32."""
    return torch.einsum("sp,st->tp", theta.float(), alpha.float())


def alpha_combine(theta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """theta (S, P), alpha (S, T) -> (T, P) float32.  CPU tensors take
    the plain version; CUDA tensors must be contiguous float32 on one
    device, and launch the kernel."""
    if theta.dim() != 2 or alpha.dim() != 2 \
            or theta.shape[0] != alpha.shape[0]:
        raise ValueError(f"alpha_combine: theta {tuple(theta.shape)} and "
                         f"alpha {tuple(alpha.shape)} must be (S, P), (S, T)")
    if theta.device.type == "cpu" and alpha.device.type == "cpu":
        return alpha_combine_plain(theta, alpha)
    for name, t in (("theta", theta), ("alpha", alpha)):
        if t.device.type != "cuda" or t.device != theta.device:
            raise ValueError(f"alpha_combine: {name} is on {t.device}; "
                             f"both inputs must be on one CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"alpha_combine: {name} must be contiguous "
                             f"float32, got {t.dtype}")
    (s, p), t_ = theta.shape, alpha.shape[1]
    out = torch.empty((t_, p), device=theta.device, dtype=torch.float32)
    if s == 0 or t_ == 0 or p == 0:
        return out.zero_()
    launch = _build.entry("alpha_combine", "alpha_combine_f32", _SIGNATURE)
    err = launch(theta.data_ptr(), alpha.data_ptr(), out.data_ptr(), s, t_,
                 p, torch.cuda.current_stream(theta.device).cuda_stream)
    _build.check("alpha_combine", err)
    alpha_combine.launches += 1
    return out


alpha_combine.launches = 0


def alpha_combine_tree(params_stack: Dict[str, torch.Tensor],
                       alpha: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Stacked parameter dict (leading source axis S) -> the same dict
    with leading target axis T, entry t = sum_s alpha[s, t] params[s],
    mixed as one flat (S, P) matrix in JAX tree order."""
    flat = flatten_to_vector(params_stack, lead=1).contiguous()
    mixed = alpha_combine(flat, alpha.float().contiguous())
    return unflatten_from_vector(mixed, params_stack, lead=1)
