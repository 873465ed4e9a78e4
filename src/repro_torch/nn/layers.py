"""Basic layers: RMSNorm, embedding, rotary embeddings.

The port of ``repro.nn.layers``.  There is no shard context: on one GPU
every ``ctx.constrain`` of the JAX package is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.param import ParamSpec


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
    cast copy of the (vocab, dim) table per call."""
    return F.embedding(tokens, table).to(compute_dtype)


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
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (half,)
    angles = positions[..., :, None].float() * freqs         # (...,S,half)
    cos = torch.cos(angles)[..., :, None, :]                 # (...,S,1,half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
