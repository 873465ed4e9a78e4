"""Basic layers: RMSNorm, embedding, rotary embeddings, shard context.

The port of ``repro.nn.layers``.  ``ShardCtx`` carries a ``DeviceMesh``
and the logical rules into model code; its ``constrain`` redistributes
a DTensor activation (``nn.sharding.constrain``), and with no mesh it is
the identity, as JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.nn import sharding as shd
from repro_torch.nn.param import ParamSpec


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Carries mesh + logical rules into model code; None mesh = no-op
    (``src/repro/nn/layers.py:14-26``).  ``mesh`` is a ``DeviceMesh``."""
    mesh: Optional[Any] = None
    rules: Any = None

    def constrain(self, x, *axes):
        if self.mesh is None:
            return x
        return shd.constrain(x, self.mesh, self.rules, *axes)

    @property
    def size(self) -> int:
        """Devices in the mesh (1 without one)."""
        return 1 if self.mesh is None else self.mesh.size()


NO_SHARD = ShardCtx()


def on_mesh_of(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (made here, the same on every rank: positions, rope tables,
    masks) as a replicated DTensor on ``like``'s mesh when ``like`` is a
    DTensor; else ``t`` itself."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    dm = like.device_mesh
    return DTensor.from_local(t, dm, [Replicate()] * dm.ndim,
                              run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def kept(t: DTensor, *dims: int):
    """``t``'s placements with its splits of ``dims`` kept and any other
    replaced by ``Replicate``."""
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in t.placements]


def per_rank(fn, mesh, inputs, outputs):
    """``fn`` on each rank's local tensors: the per-rank route of a
    function that is independent per batch row or head (attention, the
    linear-attention scans, the MoE bookkeeping), where DTensor's own
    strategies would gather, flatten a split dim, or refuse.

    ``inputs``: one (tensor, layout) or (tensor, layout, gradient
    layout) for each argument of ``fn``.  Each tensor (a plain one taken
    as replicated on ``mesh``; None passed as None) is redistributed to
    its layout and handed to ``fn`` as its local tensor; its gradient
    comes back laid out as the gradient layout (by default the layout;
    ``Partial`` where a rank's use of an input it holds whole gives a
    part of its gradient), made contiguous: DTensor gives a local
    gradient the global shape's contiguous strides as its metadata, and
    one laid out otherwise (a per-rank product's) breaks a later
    ``view`` of it (torch 2.11 on the card).  ``outputs``: one (layout,
    global shape) for each result of ``fn`` (a tensor or a tuple),
    given back as DTensors with the shape's contiguous strides as their
    metadata.  With ``mesh`` None, ``fn`` on the tensors themselves."""
    if mesh is None:
        return fn(*(t for t, *_ in inputs))
    args = []
    for t, layout, *grads in inputs:
        if t is not None:
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            t = _ContiguousGrad.apply(t.redistribute(mesh, layout).to_local(
                grad_placements=grads[0] if grads else None))
        args.append(t)
    res = fn(*args)
    one = not isinstance(res, tuple)
    out = tuple(
        DTensor.from_local(r, mesh, layout, run_check=False,
                           shape=torch.Size(shape),
                           stride=torch.empty(shape, device="meta").stride())
        for r, (layout, shape) in zip((res,) if one else res, outputs))
    return out[0] if one else out


# ---------------------------------------------------------------- rmsnorm
def rmsnorm_spec(dim: int) -> ParamSpec:
    return ParamSpec((dim,), ("embed",), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Computed in float32, returned in ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def mm(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w.astype(dtype)`` with JAX's promotion: float32 activations
    against bfloat16 weights give a float32 product of the rounded
    weights."""
    w = w.to(dtype)
    t = torch.promote_types(x.dtype, w.dtype)
    return x.to(t) @ w.to(t)


# ---------------------------------------------------------------- embedding
def embedding_spec(vocab: int, dim: int) -> ParamSpec:
    return ParamSpec((vocab, dim), ("vocab", "embed"), init="embed",
                     scale=0.02)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Rows of ``table`` in the compute dtype.  The JAX package casts the
    whole table first; gathering first gives the same values without a
    cast copy of the (vocab, dim) table per call.

    A DTensor table sharded on its ``embed`` dim (FSDP, over 'data') is
    first gathered on that dim, as GSPMD gathers an FSDP leaf at its use;
    its vocab dim may stay sharded: DTensor's lookup masks the rows a
    rank does not hold, and the masked partial rows are summed over that
    axis here (an all-reduce), before any other op reads them."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table).to(compute_dtype)
    want = [Replicate() if getattr(p, "dim", None) == 1 else p
            for p in table.placements]
    if want != list(table.placements):
        table = table.redistribute(table.device_mesh, want)
    x = F.embedding(tokens, table)
    want = [Replicate() if p.is_partial() else p for p in x.placements]
    if want != list(x.placements):
        x = x.redistribute(x.device_mesh, want)
    return x.to(compute_dtype)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in float32 (TF32 stays off: ``repro_torch.device``)."""
    return torch.einsum("...d,vd->...v", x.float(), table.float())


# ---------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    """``1 / theta ** (arange(half) / half)`` in float32, as JAX does."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a Python-scalar base: a tensor made from ``theta`` on the GPU would
    # be a host-to-device copy, which waits for the stream on every call
    return 1.0 / (float(theta) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int.  Pairs
    are half-split (dim i with dim i + head_dim/2), not interleaved."""
    freqs = on_mesh_of(rope_freqs(x.shape[-1], theta, x.device),
                       positions)                            # (half,)
    angles = positions[..., :, None].float() * freqs         # (...,S,half)
    cos = torch.cos(angles)[..., :, None, :]                 # (...,S,1,half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
