"""Pairwise prediction-disagreement matrix, eq. (4) for every pair.

``disagreement_counts`` launches the CUDA kernels in
``csrc/disagreement.cu`` for CUDA tensors and computes
``disagreement_counts_plain`` (the broadcast compare of the JAX package's
``ref.py``) for CPU tensors; there is no other fallback.  It replaces the
Pallas TPU kernel ``repro/kernels/disagreement/kernel.py``
(``_disagree_kernel`` / ``disagreement_counts``).  On the H100 it is
bound by its N^2 M compare-adds; the kernel tiles the (N, N) output and
cuts M into slices (so few tiles still fill the card), loops over its
slice inside the block with both prediction tiles staged in shared
memory, keeps the sums in registers, and a second kernel adds the
slices' partial counts in a fixed order (see the source's header).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

_SIGNATURE = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_void_p)
_BN, _BM = 32, 64           # the kernel's output tile edge and m-chunk


def disagreement_counts_plain(preds: torch.Tensor,
                              valid: torch.Tensor) -> torch.Tensor:
    """preds (N, M) int, valid (M,) -> raw counts (N, N) float32: the
    broadcast compare of ``ref.py``, over blocks of rows so the (rows, N,
    M) intermediate stays near 2**28 elements."""
    n, m = preds.shape
    rows = max(1, 2 ** 28 // max(n * m, 1))
    v = valid.float()[None, None, :]
    return torch.cat([((preds[i:i + rows, None, :] != preds[None, :, :])
                       .float() * v).sum(-1) for i in range(0, n, rows)]) \
        if n else torch.zeros((0, 0), device=preds.device)


def _splits(n: int, m: int, device: torch.device) -> int:
    """Slices of m, one block each, so about four blocks per SM are in
    flight however few output tiles there are; never a slice shorter
    than one chunk."""
    tiles = math.ceil(n / _BN) ** 2
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(math.ceil(4 * sms / tiles), math.ceil(m / _BM),
                      65535))


def disagreement_counts(preds: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """preds (N, M) int32, valid (M,) float32 -> raw counts (N, N)
    float32.  CPU tensors take the plain version; CUDA tensors must be
    contiguous, of those types, on one device, and launch the kernel."""
    if preds.dim() != 2 or valid.shape != (preds.shape[1],):
        raise ValueError(f"disagreement: preds {tuple(preds.shape)} and "
                         f"valid {tuple(valid.shape)} must be (N, M), (M,)")
    if preds.device.type == "cpu" and valid.device.type == "cpu":
        return disagreement_counts_plain(preds, valid)
    for name, t, dt in (("preds", preds, torch.int32),
                        ("valid", valid, torch.float32)):
        if t.device.type != "cuda" or t.device != preds.device:
            raise ValueError(f"disagreement: {name} is on {t.device}; both "
                             f"inputs must be on one CUDA device")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"disagreement: {name} must be contiguous "
                             f"{dt}, got {t.dtype}")
    n, m = preds.shape
    out = torch.empty((n, n), device=preds.device, dtype=torch.float32)
    if n == 0 or m == 0:
        return out.zero_()
    splits = _splits(n, m, preds.device)
    partials = torch.empty((splits, n, n), device=preds.device,
                           dtype=torch.float32) if splits > 1 else None
    launch = _build.entry("disagreement", "disagreement_counts_f32",
                          _SIGNATURE)
    err = launch(preds.data_ptr(), valid.data_ptr(), out.data_ptr(),
                 None if partials is None else partials.data_ptr(), n, m,
                 splits, torch.cuda.current_stream(preds.device).cuda_stream)
    _build.check("disagreement", err)
    disagreement_counts.launches += 1
    return out


disagreement_counts.launches = 0


def disagreement(preds: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """preds (N, M) int; valid (M,) bool/float or None -> the normalized
    (N, N) float32 disagreement matrix, counts / max(sum(valid), 1)."""
    if valid is None:
        valid = torch.ones(preds.shape[1], device=preds.device)
    valid = valid.to(torch.float32).contiguous()
    counts = disagreement_counts(preds.to(torch.int32).contiguous(), valid)
    return counts / torch.clamp(valid.sum(), min=1.0)
