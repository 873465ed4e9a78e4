"""Pairwise prediction-disagreement matrix, eq. (4) for every pair.

``disagreement_counts`` and ``disagreement`` launch the CUDA kernel in
``csrc/disagreement.cu`` for CUDA tensors and compute the plain version
(the broadcast compare of the JAX package's ``ref.py``) for CPU tensors;
there is no other fallback.  The kernel replaces the Pallas TPU kernel
``repro/kernels/disagreement/kernel.py`` (``_disagree_kernel`` /
``disagreement_counts``).  On the H100 it is bound by its N^2 M
compare-adds at scale and by the host at the main path's N = 10, so a
call makes exactly one launch and allocates only its output:
``disagreement`` divides by max(sum(valid), 1) inside the kernel, a null
``valid`` means every weight is 1, and the m axis is reduced across a
thread-block cluster (see the source's header).  The SM count, the
card's cluster capacities, the tile and cluster sizes of a shape and the
typed ``ctypes`` entry are looked up once, not per call.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

_SIGNATURE = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p)
_CHUNK = {16: 128, 32: 64}       # the kernel's m-chunk for each tile edge
_MAX_CLUSTER = 8                 # the portable cluster size


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


def tile_edge(n: int) -> int:
    """The kernel's output tile edge: 16 for n <= 16, else 32."""
    return 16 if n <= 16 else 32


def cluster_size(n: int, m: int, sms: int, caps: Sequence[int]) -> int:
    """The cluster size c (1..8, and no more than m's chunks) of the
    launch for an (n, m) input on a card of ``sms`` SMs that holds
    ``caps[c - 1]`` clusters of c blocks at once.  One cluster per output
    tile on or above the diagonal; the clusters run in waves of at most
    caps[c - 1], and a wave takes as long as its busiest SM, ceil(blocks
    / sms) blocks of 1/c of a tile each.  The c with the least total, the
    larger on a tie: a few tiles (n = 10 is one) still get 8 blocks, many
    (n = 256: 36 tiles) fill the SMs in one wave."""
    bn = tile_edge(n)
    nt = -(-n // bn)
    tiles = nt * (nt + 1) // 2
    top = max(1, min(_MAX_CLUSTER, -(-m // _CHUNK[bn])))

    def cost(c: int) -> float:
        left, total = tiles, 0.0
        while left > 0:
            wave = min(left, max(caps[c - 1], 1))
            left -= wave
            total += math.ceil(wave * c / sms) / c
        return total
    return min(range(1, top + 1), key=lambda c: (cost(c), -c))


@functools.lru_cache(maxsize=None)
def _plan(n: int, m: int, index: int) -> Tuple[int, int]:
    """(tile edge, cluster size) on device ``index``, whose SM count and
    cluster capacities are asked for once."""
    bn = tile_edge(n)
    return bn, cluster_size(n, m, _sms(index), _caps(index, bn))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _caps(index: int, bn: int) -> Tuple[int, ...]:
    query = _build.entry("disagreement", "disagreement_max_clusters",
                         (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    count = ctypes.c_int()
    caps = []
    with torch.cuda.device(index):
        for c in range(1, _MAX_CLUSTER + 1):
            _build.check("disagreement", query(bn, c, ctypes.byref(count)))
            caps.append(count.value)
    return tuple(caps)


@functools.lru_cache(maxsize=None)
def _entry():
    return _build.entry("disagreement", "disagreement_f32", _SIGNATURE)


def _launch(preds: torch.Tensor, valid: Optional[torch.Tensor],
            normalize: bool) -> torch.Tensor:
    """One launch on the current stream: preds (N, M) contiguous int32 and
    valid (M,) contiguous float32 or None, on one CUDA device."""
    _build.refuse_grad("disagreement", "repro_torch.kernels.disagreement."
                       "ops.disagreement_counts_plain", valid)
    n, m = preds.shape
    out = preds.new_empty((n, n), dtype=torch.float32)
    if n == 0 or m == 0:
        return out.zero_()
    index = preds.get_device()
    bn, cl = _plan(n, m, index)
    with torch.cuda.device(index):         # the launch's current device
        err = _entry()(preds.data_ptr(),
                       None if valid is None else valid.data_ptr(),
                       out.data_ptr(), n, m, bn, cl, normalize,
                       torch._C._cuda_getCurrentRawStream(index))
    if err:
        _build.check("disagreement", err)
    disagreement_counts.launches += 1
    return out


def _ready(preds: torch.Tensor, valid: Optional[torch.Tensor]) -> bool:
    """The inputs are what the kernel takes as they are: contiguous int32
    (N, M) preds and float32 (M,) valid (or None) on one CUDA device."""
    return (preds.is_cuda and preds.dtype is torch.int32
            and preds.dim() == 2 and preds.is_contiguous()
            and (valid is None
                 or (valid.is_cuda and valid.dtype is torch.float32
                     and valid.dim() == 1 and valid.is_contiguous()
                     and valid.shape[0] == preds.shape[1]
                     and valid.get_device() == preds.get_device())))


def _check_shapes(preds: torch.Tensor, valid: Optional[torch.Tensor]):
    if preds.dim() != 2 or (valid is not None
                            and tuple(valid.shape) != (preds.shape[1],)):
        shape = None if valid is None else tuple(valid.shape)
        raise ValueError(f"disagreement: preds {tuple(preds.shape)} and "
                         f"valid {shape} must be (N, M), (M,)")


def _refuse(preds: torch.Tensor, valid: Optional[torch.Tensor]) -> None:
    """Raise the ValueError that says why CUDA inputs are not taken."""
    for name, t, dt in (("preds", preds, torch.int32),
                        ("valid", valid, torch.float32)):
        if t is None:
            continue
        if not t.is_cuda or t.device != preds.device:
            raise ValueError(f"disagreement: {name} is on {t.device}; both "
                             f"inputs must be on one CUDA device")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"disagreement: {name} must be contiguous "
                             f"{dt}, got {t.dtype}")
    raise ValueError("disagreement: inputs not taken")


def _on_cpu(preds: torch.Tensor, valid: Optional[torch.Tensor]) -> bool:
    return not preds.is_cuda and (valid is None or not valid.is_cuda)


def disagreement_counts(preds: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """preds (N, M) int32, valid (M,) float32 -> raw counts (N, N)
    float32 (the JAX kernel's signature).  CPU tensors take the plain
    version; CUDA tensors must be contiguous, of those types, on one
    device, and launch the kernel once."""
    if _ready(preds, valid):
        return _launch(preds, valid, False)
    _check_shapes(preds, valid)
    if _on_cpu(preds, valid):
        return disagreement_counts_plain(preds, valid)
    _refuse(preds, valid)


disagreement_counts.launches = 0


def disagreement(preds: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """preds (N, M) int; valid (M,) bool/float or None -> the normalized
    (N, N) float32 disagreement matrix, counts / max(sum(valid), 1).  On
    the card: one launch for ``valid=None`` and int32 preds (a cast of a
    bool mask is the only other)."""
    if _ready(preds, valid):
        return _launch(preds, valid, True)
    _check_shapes(preds, valid)
    if _on_cpu(preds, valid):
        v = torch.ones(preds.shape[1]) if valid is None else valid.float()
        return disagreement_counts_plain(preds, v) \
            / torch.clamp(v.sum(), min=1.0)
    preds = preds.to(torch.int32).contiguous()
    if valid is not None:
        valid = valid.to(torch.float32).contiguous()
    if not _ready(preds, valid):
        _refuse(preds, valid)
    return _launch(preds, valid, True)
