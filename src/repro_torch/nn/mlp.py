"""Dense MLPs: SwiGLU / GeGLU / plain GELU (the port of ``repro.nn.mlp``).

GELU is the tanh approximation, as ``jax.nn.gelu(approximate=True)``.
On a mesh the hidden activation is constrained at JAX's point
(``src/repro/nn/mlp.py:35``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import NO_SHARD, ShardCtx
from repro_torch.nn.param import ParamSpec


def mlp_specs(d_model: int, d_ff: int, activation: str):
    if activation in ("swiglu", "geglu"):
        return {
            "wi_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
            "wi_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
            "wo": ParamSpec((d_ff, d_model), ("mlp", "embed")),
        }
    return {
        "wi": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def _gelu(t: torch.Tensor) -> torch.Tensor:
    return F.gelu(t, approximate="tanh")


def mlp(params, x: torch.Tensor, activation: str,
        dtype: torch.dtype = torch.bfloat16,
        ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """JAX's ``mlp(params, x, activation, ctx, dtype)``; ``dtype`` comes
    before ``ctx`` here, as the port's callers pass it by position."""
    if activation in ("swiglu", "geglu"):
        g = torch.einsum("bsd,df->bsf", x, params["wi_gate"].to(dtype))
        u = torch.einsum("bsd,df->bsf", x, params["wi_up"].to(dtype))
        act = F.silu if activation == "swiglu" else _gelu
        h = act(g) * u
    else:
        h = _gelu(torch.einsum("bsd,df->bsf", x, params["wi"].to(dtype)))
    h = ctx.constrain(h, "batch", None, "mlp")
    return torch.einsum("bsf,fd->bsd", h, params["wo"].to(dtype))
