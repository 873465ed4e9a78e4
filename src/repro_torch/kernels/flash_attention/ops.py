"""Flash attention (forward): causal, sliding-window or bidirectional.

``flash_attention`` launches the CUDA kernel in ``csrc/flash_attention.cu``
for CUDA tensors and computes ``flash_attention_plain`` for CPU tensors;
there is no other fallback.  It replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py`` (``_flash_kernel`` /
``flash_attention_bhsd``) and its wrapper ``ops.flash_attention``.

Unlike the JAX wrapper it takes K/V with their KV heads un-repeated
(GQA: query head h reads KV head h // (H / KV)); with KV = H it is the
same call.  The kernel reads the (B, S, H, D) tensors through their
strides and masks ragged edges itself, so the wrapper pads and
transposes nothing.  On the H100 it is bound by its 4 D flops per live
(query, key) pair.  bf16 inputs (the serve path) take the tensor-core
kernel: Q and K/V tiles staged by TMA, both products on ``wgmma``, P
split into two bf16 halves so that the output stays within one bf16 ulp
of the plain version; D = 112 is staged and multiplied as 128 (TMA
zero-fills the extra columns).  fp32 inputs take the SIMT kernel (fp32
FMAs from shared memory).  Both keep the online softmax in registers and
skip key tiles wholly outside a query tile's causal or window range (see
the source's header).

The kernel is the opaque op ``torch.ops.repro_torch.flash_attention``:
its CUDA implementation launches the kernel, its CPU implementation is
the plain version, its fake implementation gives a ``meta`` trace the
kernel's output, and its FLOP formula (``launch/hlo.py`` reads it) is
4·D per live (query, key) pair, so a count sees the attention once, by
the work it needs.  A CPU or ``meta`` call whose inputs require grad
(with grad enabled) runs the differentiable plain version outside the
op, and is counted as its matmuls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

NEG_INF = -2.0e9
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURE = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
              + (ctypes.c_longlong,) * 12 + (ctypes.c_int,) * 2
              + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KV, D), KV dividing H -> (B, Sq, H, D)
    in q's dtype.  ``repro.kernels.flash_attention.ref.attention_ref``
    with the kernel's semantics: query i sits at i + Sk - Sq (the Pallas
    kernel's offset as its wrapper passes it; with no padding its
    ``valid_k`` is Sk), and masked probabilities are zeroed before the
    sum, so a row with no live key gives 0 (the ref's softmax would give
    the mean of v)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    # (B, H, Sq, Sk) fp32, updated in place: at (1, 9216, 32, 64) it is
    # 10.9 GB, and the einsum's output is the only other copy; out of
    # place where autograd needs the intermediates
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / d ** 0.5),
                     k.float())
    if s.requires_grad:
        s = s.masked_fill(~mask, NEG_INF)
        s = (s - s.amax(-1, keepdim=True)).exp() * mask
    else:
        s.masked_fill_(~mask, NEG_INF)
        s.sub_(s.amax(-1, keepdim=True)).exp_().mul_(mask)
    denom = s.sum(-1, keepdim=True).clamp_min_(1e-20)
    out = torch.einsum("bhqk,bkhd->bhqd", s, v.float()) / denom
    return out.transpose(1, 2).to(q.dtype)


def check_staging(name: str, t: torch.Tensor) -> None:
    """The bf16 kernel copies 16-byte rows with ``cp.async``: ``t``'s data
    pointer must be 16-byte aligned and its B, S and H strides multiples
    of 8 elements.  Raises ``ValueError`` otherwise; nothing falls back."""
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"flash_attention: bf16 {name} needs a 16-byte "
                         f"aligned data pointer and strides in B, S and H "
                         f"that are multiples of 8 elements, got pointer "
                         f"{t.data_ptr():#x} and strides {t.stride()}")


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be "
                         f"(B, Sq, H, D), (B, Sk, KV, D) with KV | H")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")


@functools.lru_cache(maxsize=None)
def live_pairs(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs one (batch, head) keeps, query i at position
    i + sk - sq."""
    total = 0
    for i in range(sk - sq, sk):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: Optional[int]) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b == 0 or sq == 0 or h == 0:
        return out
    if sk == 0:
        return out.zero_()
    launch = _build.entry("flash_attention", "flash_attention_fwd",
                          _SIGNATURE)
    with torch.cuda.device(q.device):      # the launch's current device
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, h, kv, sq, sk, d,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *out.stride()[:3],
                     int(causal), window or 0, 1.0 / d ** 0.5,
                     _DTYPES[q.dtype],
                     torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: Optional[int]) -> torch.Tensor:
    return _flash_launch(q, k, v, causal, window)


@_flash_op.register_kernel("cpu")
def _flash_cpu(q, k, v, causal, window):
    # contiguous, as the kernel writes it and the fake says: a later
    # reshape then copies on no device
    return flash_attention_plain(q, k, v, causal=causal,
                                 window=window).contiguous()


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, *,
                 out_shape=None, **kwargs) -> int:
    b, sq, h, d = q_shape
    return 4 * d * b * h * live_pairs(sq, k_shape[1], causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype,
    query i at absolute position i + Sk - Sq.  CPU (and ``meta``)
    tensors take the plain version (its shapes); CUDA tensors (float32 or
    bfloat16, one dtype, unit stride in D, D in ``HEAD_DIMS``, on one
    device; bf16 also as ``check_staging`` says) launch the kernel; with
    grad enabled none may require grad."""
    _check(q, k, v, window)
    if all(t.device.type != "cuda" for t in (q, k, v)):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        return _flash_op(q, k, v, causal, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}; "
                             f"all inputs must be on one CUDA device")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; q, k "
                             f"and v must all be float32 or bfloat16")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride "
                             f"in D, got strides {t.stride()}")
        if t.dtype == torch.bfloat16:
            check_staging(name, t)
    _build.refuse_grad("flash_attention", "repro_torch.kernels."
                       "flash_attention.ops.flash_attention_plain", q, k, v)
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {q.shape[3]} not in "
                         f"{HEAD_DIMS}")
    return _flash_op(q, k, v, causal, window)


flash_attention.launches = 0
