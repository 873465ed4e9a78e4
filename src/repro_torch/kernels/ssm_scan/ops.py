"""Chunked gated linear attention (the rwkv / mamba scan).

``gla_chunked`` launches the CUDA kernels in ``csrc/ssm_scan.cu`` for
CUDA tensors and computes ``gla_chunked_plain``
(``repro_torch.nn.linear_attn.gla_chunked``) for CPU tensors; there is no
other fallback.  It replaces the Pallas TPU kernel
``repro/kernels/ssm_scan/kernel.py`` (``_gla_kernel`` /
``gla_chunked_bhncd``) and its wrapper ``ops.gla_chunked``, with the same
(B, L, H, D) signature.

Unlike JAX's wrapper it pads and transposes nothing: the kernels stage
each tensor in its own dtype (float32 or bfloat16) through its strides by
16-byte copies (``check_staging``) and mask the ragged last chunk as JAX
pads it.  Three launches a call (``gla_chunked.launches`` counts each):
every chunk's own state contribution in parallel, a scan of the chunks'
starting states through a scratch the wrapper allocates, and every
chunk's output in parallel, its products on the tensor cores in 3xTF32.
The intra-chunk decay is cut into 16-row sub-chunks so that no factor
overflows (JAX's factoring overflows float32 at rwkv6-1.6b's chunk of
128; see ``nn/linear_attn.py``).  The kernels agree with the plain
version within the bars ``chip_smoke.py`` states, not bit for bit (see
the source's header).  No kernel has a backward pass: with grad enabled,
an input that requires grad raises (``_build.refuse_grad``).

The kernels are the opaque op ``torch.ops.repro_torch.gla_chunked``:
its CUDA implementation launches them, its CPU implementation is the
plain version, its fake implementation gives a ``meta`` trace their
outputs, and its FLOP formula (``launch/hlo.py`` reads it) counts the
chunked form's products as the JAX package's chunked scan computes them
(``gla_flops``), so that a step's count is the same on every route.  A
CPU or ``meta`` call whose inputs require grad (with grad enabled) runs
the differentiable plain version outside the op, and is counted as its
matmuls.

``gla_chunked_float64_sums`` names the plain version where a check
holds the kernels to float64 sums: the plain version sums its products
in float64 itself.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.nn.linear_attn import VARIANTS
from repro_torch.nn.linear_attn import gla_chunked as gla_chunked_plain

SUB, CMAX, DKMAX = 16, 128, 64          # the kernel's limits
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURE = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7
              + (ctypes.c_longlong,) * 15 + (ctypes.c_int,) * 4
              + (ctypes.c_void_p,))


def _check(q, k, v, log_w, variant, bonus, initial_state):
    if variant not in VARIANTS:
        raise ValueError(f"gla_chunked: variant {variant!r} not in "
                         f"{VARIANTS}")
    if q.dim() != 4 or k.shape != q.shape or log_w.shape != q.shape \
            or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"gla_chunked: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, log_w {tuple(log_w.shape)}, v "
                         f"{tuple(v.shape)} must be (B, L, H, Dk) x 3 and "
                         f"(B, L, H, Dv)")
    b, _, h, dk = q.shape
    if bonus is not None and bonus.shape != (h, dk):
        raise ValueError(f"gla_chunked: bonus {tuple(bonus.shape)} must be "
                         f"{(h, dk)}")
    if initial_state is not None \
            and initial_state.shape != (b, h, dk, v.shape[3]):
        raise ValueError(f"gla_chunked: initial_state "
                         f"{tuple(initial_state.shape)} must be "
                         f"{(b, h, dk, v.shape[3])}")


def check_staging(name: str, t: torch.Tensor) -> None:
    """The kernels stage rows with 16-byte ``cp.async``: ``t``'s data
    pointer must be 16-byte aligned and its B, L and H strides multiples
    of 16 bytes (8 bfloat16 or 4 float32 elements).  Raises
    ``ValueError`` otherwise; nothing falls back."""
    step = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % step for s in t.stride()[:3]):
        raise ValueError(f"gla_chunked: {name} ({t.dtype}) needs a 16-byte "
                         f"aligned data pointer and strides in B, L and H "
                         f"that are multiples of {step} elements, got "
                         f"pointer {t.data_ptr():#x} and strides "
                         f"{t.stride()}")


@functools.lru_cache(maxsize=None)
def _plan(b: int, l: int, h: int, dk: int, dv: int,
          chunk: int) -> Tuple[int, int]:
    """(kernels a call launches, fp32 scratch it needs in floats), from
    the C entry ``ssm_scan_plan``: 3, or 1 (the scan alone) when L = 0."""
    floats = ctypes.c_longlong()
    kernels = _build.entry("ssm_scan", "ssm_scan_plan",
                           (ctypes.c_int,) * 6 + (ctypes.c_void_p,))(
        b, l, h, dk, dv, chunk, ctypes.byref(floats))
    if kernels == 0:
        raise ValueError(f"gla_chunked: the kernels do not take (B, L, H, "
                         f"Dk, Dv, chunk) = {(b, l, h, dk, dv, chunk)}")
    return kernels, floats.value


def _gla_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, chunk: int, variant: str,
                bonus: Optional[torch.Tensor],
                initial_state: Optional[torch.Tensor],
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call's kernels on checked CUDA inputs."""
    b, l, h, dk = q.shape
    dv = v.shape[3]
    dev = q.device
    y = torch.empty((b, l, h, dv), dtype=v.dtype, device=dev)
    s_fin = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    if b == 0 or h == 0 or dv == 0:
        return y, s_fin
    u = (torch.zeros(h, dk, device=dev) if bonus is None or variant != "rwkv"
         else bonus.float().contiguous())
    s0 = None if initial_state is None \
        else initial_state.float().contiguous()
    kernels, floats = _plan(b, l, h, dk, dv, chunk)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    launch = _build.entry("ssm_scan", "ssm_scan_fwd", _SIGNATURE)
    with torch.cuda.device(dev):           # the launch's current device
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     log_w.data_ptr(), u.data_ptr(),
                     0 if s0 is None else s0.data_ptr(),
                     y.data_ptr(), s_fin.data_ptr(), scratch.data_ptr(),
                     b, l, h, dk, dv, chunk, int(variant == "rwkv"),
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *log_w.stride()[:3], *y.stride()[:3],
                     *(_BF16[t.dtype] for t in (q, k, v, log_w)),
                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check("ssm_scan", err)
    gla_chunked.launches += kernels
    return y, s_fin


@torch.library.custom_op("repro_torch::gla_chunked", mutates_args=(),
                         device_types="cuda")
def _gla_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            log_w: torch.Tensor, chunk: int, variant: str,
            bonus: Optional[torch.Tensor],
            initial_state: Optional[torch.Tensor],
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _gla_launch(q, k, v, log_w, chunk, variant, bonus, initial_state)


@_gla_op.register_kernel("cpu")
def _gla_cpu(q, k, v, log_w, chunk, variant, bonus, initial_state):
    y, s_fin = gla_chunked_plain(q, k, v, log_w, chunk=chunk,
                                 variant=variant, bonus=bonus,
                                 initial_state=initial_state)
    # contiguous, as the kernels write them and the fake says; L = 0
    # hands the initial state back, and an op's output is its own
    return y.contiguous(), (s_fin.clone() if s_fin is initial_state
                            else s_fin.contiguous())


@_gla_op.register_fake
def _gla_fake(q, k, v, log_w, chunk, variant, bonus, initial_state):
    b, l, h, dk = q.shape
    dv = v.shape[3]
    return (q.new_empty((b, l, h, dv), dtype=v.dtype),
            q.new_empty((b, h, dk, dv), dtype=torch.float32))


def gla_flops(b: int, l: int, h: int, dk: int, dv: int, chunk: int,
              variant: str) -> int:
    """The chunked form's products, as the JAX package's chunked scan
    computes them over L padded to whole chunks: per chunk and head the
    (C x C) scores (2 C^2 Dk) and their product with v (2 C^2 Dv), the
    carried state's readout and update (2 x 2 C Dk Dv), and rwkv's bonus
    diagonal (2 C Dk).  The kernels skip the score blocks above the
    diagonal; the count is the function's, the same on every route."""
    n = -(-l // chunk)
    per = 2 * chunk * chunk * (dk + dv) + 4 * chunk * dk * dv
    if variant == "rwkv":
        per += 2 * chunk * dk
    return b * h * n * per


@register_flop_formula(torch.ops.repro_torch.gla_chunked)
def _gla_flops(q_shape, k_shape, v_shape, log_w_shape, chunk, variant,
               bonus_shape, initial_state_shape, *, out_shape=None,
               **kwargs) -> int:
    b, l, h, dk = q_shape
    return gla_flops(b, l, h, dk, v_shape[3], chunk, variant)


def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, *, chunk: int, variant: str = "mamba",
                bonus: Optional[torch.Tensor] = None,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, log_w (≤ 0): (B, L, H, Dk); v: (B, L, H, Dv); bonus (H, Dk)
    (rwkv; zeros if None); initial_state (B, H, Dk, Dv) or None.  Returns
    (y (B, L, H, Dv) in v's dtype, final_state (B, H, Dk, Dv) fp32).

    CPU (and ``meta``) tensors take the plain version (its shapes).  CUDA
    tensors (each float32 or bfloat16, unit stride in D, staged as
    ``check_staging`` says, on one device; Dk ≤ 64; chunk a multiple of
    16 up to 128) launch the kernels; with grad enabled none may require
    grad."""
    _check(q, k, v, log_w, variant, bonus, initial_state)
    tensors = [("q", q), ("k", k), ("v", v), ("log_w", log_w)]
    extra = [(n, t) for n, t in (("bonus", bonus),
                                 ("initial_state", initial_state))
             if t is not None]
    if all(t.device.type != "cuda" for _, t in tensors + extra):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for _, t in tensors + extra):
            return gla_chunked_plain(q, k, v, log_w, chunk=chunk,
                                     variant=variant, bonus=bonus,
                                     initial_state=initial_state)
        return _gla_op(q, k, v, log_w, chunk, variant, bonus, initial_state)
    dev = q.device
    for name, t in tensors + extra:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"gla_chunked: {name} is on {t.device}; all "
                             f"inputs must be on one CUDA device")
    for name, t in tensors:
        if t.dtype not in _BF16:
            raise ValueError(f"gla_chunked: {name} is {t.dtype}; q, k, v "
                             f"and log_w must each be float32 or bfloat16")
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"gla_chunked: {name} needs unit stride in "
                             f"D, got strides {t.stride()}")
        check_staging(name, t)
    _build.refuse_grad("ssm_scan", "repro_torch.nn.linear_attn."
                       "gla_chunked", q, k, v, log_w, bonus, initial_state)
    dk = q.shape[3]
    if dk > DKMAX or chunk % SUB or not SUB <= chunk <= CMAX:
        raise ValueError(f"gla_chunked: the kernel takes Dk <= {DKMAX} "
                         f"and a chunk that is a multiple of {SUB} up to "
                         f"{CMAX}, got Dk {dk}, chunk {chunk}")
    return _gla_op(q, k, v, log_w, chunk, variant, bonus, initial_state)


gla_chunked.launches = 0


# the reference the kernels' fp32 sums are held to: the plain version,
# whose products are summed in float64 from their fp32 factors
gla_chunked_float64_sums = gla_chunked_plain
