"""Weighted source->target parameter mixing, ``out = alpha^T @ theta``.

``alpha_combine`` launches the CUDA kernels in ``csrc/alpha_combine.cu``
for CUDA tensors and computes ``alpha_combine_plain`` for CPU tensors;
there is no other fallback.  It replaces the Pallas TPU kernel
``repro/kernels/alpha_combine/kernel.py`` (``_combine_kernel`` /
``alpha_combine_flat``).  The product runs on the tensor cores in TF32
with the 3xTF32 split (fp32 SGEMM's accuracy): up to 16 targets (the
transfer's S = T = 10, P = 48,158, bound by its 3.85 MB and the host) one
``mma.sync`` kernel; past them alpha is split once into a scratch and a
``wgmma`` kernel reads theta from device memory once for up to 256
targets (see the source's header).  The typed ``ctypes`` entry, and for
each (S, T) how many kernels a call launches and how much scratch it
needs (asked of the source, which lays the scratch out), are looked up
once.

The kernels are the opaque op ``torch.ops.repro_torch.alpha_combine``:
its CUDA implementation launches them, its CPU implementation is the
plain version, its fake implementation gives a ``meta`` trace their
output, and its FLOP formula (``launch/hlo.py`` reads it) is the
function's 2·S·T·P.  A CPU or ``meta`` call whose inputs require grad
(with grad enabled) runs the differentiable plain version outside the
op, and is counted as its matmul.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.nn.param import flatten_to_vector, unflatten_from_vector

_SIGNATURE = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_void_p)


def alpha_combine_plain(theta: torch.Tensor,
                        alpha: torch.Tensor) -> torch.Tensor:
    """theta (S, P), alpha (S, T) -> (T, P) float32."""
    return torch.einsum("sp,st->tp", theta.float(), alpha.float())


@functools.lru_cache(maxsize=None)
def _entry():
    return _build.entry("alpha_combine", "alpha_combine_f32", _SIGNATURE)


@functools.lru_cache(maxsize=None)
def _plan(s: int, t: int) -> Tuple[int, int]:
    """(kernels a call launches, bytes of scratch it needs) for S sources
    and T targets: one kernel and none up to 16 targets; past them two
    (alpha's split into the scratch, then the product)."""
    scratch = ctypes.c_longlong()
    launches = _build.entry("alpha_combine", "alpha_combine_plan",
                            (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))(
        s, t, ctypes.byref(scratch))
    return launches, scratch.value


def _ready(theta: torch.Tensor, alpha: torch.Tensor) -> bool:
    """The inputs are what the kernel takes as they are: contiguous
    float32 (S, P) theta and (S, T) alpha on one CUDA device."""
    return (theta.is_cuda and alpha.is_cuda
            and theta.dtype is torch.float32 and alpha.dtype is torch.float32
            and theta.dim() == 2 and alpha.dim() == 2
            and theta.shape[0] == alpha.shape[0]
            and theta.is_contiguous() and alpha.is_contiguous()
            and theta.get_device() == alpha.get_device())


def _combine_launch(theta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """One call's kernels on checked CUDA inputs."""
    (s, p), t_ = theta.shape, alpha.shape[1]
    out = theta.new_empty((t_, p))
    if s == 0 or t_ == 0 or p == 0:
        return out.zero_()
    launches, nbytes = _plan(s, t_)
    scratch = theta.new_empty(nbytes, dtype=torch.uint8) if nbytes else None
    with torch.cuda.device(theta.device):   # the launch's current device
        err = _entry()(theta.data_ptr(), alpha.data_ptr(), out.data_ptr(),
                       s, t_, p,
                       None if scratch is None else scratch.data_ptr(),
                       torch._C._cuda_getCurrentRawStream(theta.get_device()))
    if err:
        _build.check("alpha_combine", err)
    alpha_combine.launches += launches
    return out


@torch.library.custom_op("repro_torch::alpha_combine", mutates_args=(),
                         device_types="cuda")
def _combine_op(theta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return _combine_launch(theta, alpha)


@_combine_op.register_kernel("cpu")
def _combine_cpu(theta, alpha):
    return alpha_combine_plain(theta, alpha).contiguous()


@_combine_op.register_fake
def _combine_fake(theta, alpha):
    return theta.new_empty((alpha.shape[1], theta.shape[1]),
                           dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.alpha_combine)
def _combine_flops(theta_shape, alpha_shape, *, out_shape=None,
                   **kwargs) -> int:
    return 2 * theta_shape[0] * alpha_shape[1] * theta_shape[1]


def alpha_combine(theta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """theta (S, P), alpha (S, T) -> (T, P) float32.  CPU (and ``meta``)
    tensors take the plain version (its shapes); CUDA tensors must be
    contiguous float32 on one device, and launch the kernels
    (``launches`` counts each kernel); with grad enabled neither may
    require grad (no backward kernel)."""
    if not _ready(theta, alpha):
        if theta.dim() != 2 or alpha.dim() != 2 \
                or theta.shape[0] != alpha.shape[0]:
            raise ValueError(f"alpha_combine: theta {tuple(theta.shape)} "
                             f"and alpha {tuple(alpha.shape)} must be "
                             f"(S, P), (S, T)")
        if not theta.is_cuda and not alpha.is_cuda:
            if torch.is_grad_enabled() and (theta.requires_grad
                                            or alpha.requires_grad):
                return alpha_combine_plain(theta, alpha)
            return _combine_op(theta, alpha)
        for name, t in (("theta", theta), ("alpha", alpha)):
            if not t.is_cuda or t.device != theta.device:
                raise ValueError(f"alpha_combine: {name} is on {t.device}; "
                                 f"both inputs must be on one CUDA device")
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"alpha_combine: {name} must be contiguous "
                                 f"float32, got {t.dtype}")
    _build.refuse_grad("alpha_combine", "repro_torch.kernels."
                       "alpha_combine.ops.alpha_combine_plain", theta, alpha)
    return _combine_op(theta, alpha)


alpha_combine.launches = 0


def alpha_combine_slab(theta: torch.Tensor,
                       alpha_cols: torch.Tensor) -> torch.Tensor:
    """Per-shard transfer slab: the FULL flattened source stack against a
    block of target columns.  theta (S, P), alpha_cols (S, T_loc) ->
    (T_loc, P) float32, through ``alpha_combine`` (the same kernels, any
    S and T; the same plain version for CPU tensors; its launches counted
    on ``alpha_combine.launches``).  This is the sharded pool's transfer:
    each shard gathers theta once and mixes only its own targets."""
    return alpha_combine(theta, alpha_cols.float().contiguous())


def alpha_combine_tree(params_stack: Dict[str, torch.Tensor],
                       alpha: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Stacked parameter dict (leading source axis S) -> the same dict
    with leading target axis T, entry t = sum_s alpha[s, t] params[s],
    mixed as one flat (S, P) matrix in JAX tree order."""
    flat = flatten_to_vector(params_stack, lead=1).contiguous()
    mixed = alpha_combine(flat, alpha.float().contiguous())
    return unflatten_from_vector(mixed, params_stack, lead=1)
