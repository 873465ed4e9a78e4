"""Mamba2 (SSD) block on the GLA primitive: the port of ``repro.nn.mamba``.

Structure follows arXiv:2405.21060: in_proj -> [z | x | B | C | dt], short
causal conv over (x,B,C), per-head scalar decay a_t = exp(-softplus(dt) *
exp(A_log)), SSD recurrence S_t = a_t S_{t-1} + (dt*x_t) B_t^T with output
C_t . S_t + D*x_t, gated RMSNorm, out_proj.  ngroups=1 (B,C shared across
heads), as in JAX.

``mamba_block`` runs the recurrence through the ``ssm_scan`` kernel's
wrapper (``"mamba"`` variant; its plain version on CPU tensors), or with
``impl="plain"`` through ``nn.linear_attn.gla_chunked`` (differentiable),
where JAX calls its jnp ``gla_chunked``; ``mamba_decode`` steps
``gla_decode``.  The casts are JAX's: the projections' weights are cast
to ``dtype`` (bfloat16 unless given; JAX's zamba passes none) and a
product of activations and weights of two dtypes is taken in the wider
(``nn.layers.mm``).  The SSD inputs keep JAX's broadcasts: q = C and
k = B are views with stride 0 over heads, which the kernel reads through
its strides; the decay, broadcast over the state dimension, is made
contiguous (the kernel reads log_w with unit stride in it).

On a mesh (``ctx``; DTensor weights and activations) ``in_proj``'s
output dim is one "heads" dim of z | x | B | C | dt, so a rank's
columns straddle the five parts: its bf16 weight is gathered across
'model' before the product (at (4, 2048) on zamba2-7b under half the
bytes of gathering the product), z | x | B | C | dt come out whole on
every rank, and the conv runs on every channel.  The SSD inputs are
then laid out for the scan's heads split: x (hence v) and the decay
are constrained to ("batch", None, "heads"), and q = C and k = B are
each rank's own stride-0 views over its heads (``_over_heads``:
nothing of (B, S, H/m, N) is materialised), so the ``ssm_scan`` op
runs on each rank's H/m heads through its sharding rule.  ``_gated_norm``'s mean over d_inner is then a sum across the
ranks (DTensor's reduction of a split dim).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.nn.layers import NO_SHARD, ShardCtx, kept, mm, per_rank
from repro_torch.nn.linear_attn import gla_chunked, gla_decode
from repro_torch.nn.param import ParamSpec


def dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    nheads = d_inner // ssm.head_dim
    conv_ch = d_inner + 2 * ssm.state_dim        # x, B, C all convolved
    return d_inner, nheads, conv_ch


def mamba_specs(cfg: ModelConfig):
    d = cfg.d_model
    ssm = cfg.ssm
    d_inner, nheads, conv_ch = dims(cfg)
    n = ssm.state_dim
    proj_out = 2 * d_inner + 2 * n + nheads      # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "heads")),
        "conv_w": ParamSpec((ssm.conv_width, conv_ch), (None, "heads"),
                            scale=0.5),
        "conv_b": ParamSpec((conv_ch,), ("heads",), init="zeros"),
        "a_log": ParamSpec((nheads,), ("heads",), init="zeros"),
        "dt_bias": ParamSpec((nheads,), ("heads",), init="zeros"),
        "d_skip": ParamSpec((nheads,), ("heads",), init="ones"),
        "norm_scale": ParamSpec((d_inner,), ("heads",), init="ones"),
        "out_proj": ParamSpec((d_inner, d), ("heads", "embed")),
    }


def _causal_conv(x, w, b, conv_state=None):
    """x: (B, S, C); w: (W, C) depthwise.  Returns (y, new_state (B, W-1,
    C)).  Summed tap by tap in x's dtype, as JAX does."""
    width = w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros(x.shape[0], width - 1, x.shape[2])
    xp = torch.cat([conv_state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
            for i in range(width))
    y = F.silu((y + b.to(x.dtype)).float()).to(x.dtype)
    return y, xp[:, -(width - 1):]


def _split_proj(cfg, zxbcdt):
    d_inner, nheads, _ = dims(cfg)
    n = cfg.ssm.state_dim
    return torch.split(zxbcdt, [d_inner, d_inner, n, n, nheads], dim=-1)


def _over_heads(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (B, S, N) broadcast to (B, S, H, N) over ``like``'s heads
    (dim 2), a view with stride 0 over heads.  A DTensor ``like`` (batch
    and heads split at most) gets each rank's view over its own heads,
    laid out as ``like``: ``t`` is gathered to ``like``'s rows, and its
    gradient is a partial sum over the ranks that split the heads."""
    b, s, h = like.shape[:3]
    n = t.shape[-1]
    if not isinstance(like, DTensor):
        return t[:, :, None, :].expand(b, s, h, n)
    rows = kept(like, 0)
    grads = [Partial() if isinstance(p, Shard) and p.dim == 2 else r
             for p, r in zip(like.placements, rows)]
    h_local = like.to_local().shape[2]
    return per_rank(lambda t: t[:, :, None, :].expand(t.shape[0], s,
                                                      h_local, n),
                    like.device_mesh, [(t, rows, grads)],
                    [(like.placements, (b, s, h, n))])


def _ssd_inputs(cfg, xin, bmat, cmat, dt, a_log, dt_bias,
                ctx: ShardCtx = NO_SHARD):
    """Map mamba tensors onto GLA (q,k,v,log_w); q, k and log_w are
    broadcast views (stride 0 over heads, log_w also over N).  On a mesh
    x and dt are laid out for the scan's heads split first."""
    b, s, _ = xin.shape
    _, nheads, _ = dims(cfg)
    hd = cfg.ssm.head_dim
    n = cfg.ssm.state_dim
    dt = ctx.constrain(F.softplus(dt.float() + dt_bias.float()),
                       "batch", None, "heads")
    decay = -dt * torch.exp(a_log.float())                # (B,S,H) log-decay
    xh = ctx.constrain(xin.reshape(b, s, nheads, hd),
                       "batch", None, "heads", None)
    v = xh * dt[..., None].to(xh.dtype)                   # dt-scaled input
    q = _over_heads(cmat, xh)                             # C
    k = _over_heads(bmat, xh)                             # B
    log_w = decay[..., None].expand(b, s, nheads, n)
    return q, k, v, log_w, xh


def _gated_norm(y, z, scale, eps=1e-5):
    f32 = (y * F.silu(z.float()).to(y.dtype)).float()
    var = f32.square().mean(-1, keepdim=True)
    return (f32 * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def in_proj(p, x, dtype, ctx: ShardCtx = NO_SHARD):
    """z | x | B | C | dt (B, S, proj_out) of x (B, S, D).  On a mesh the
    projection's output dim is gathered (in ``dtype``) before the
    product, so that the five parts come out whole on every rank and
    ``_split_proj`` cuts no split dim (the layouts ROADMAP item j weighs
    against this one are counted by ``tools/mesh_bf16_gap.py layer``)."""
    w = ctx.constrain(p["in_proj"].to(dtype), "embed", None)
    return mm(x, w, dtype)


def _conv_ssd(p, x, cfg, conv_state, dtype, ctx: ShardCtx = NO_SHARD):
    """in_proj, the causal conv and the SSD inputs shared by the block
    and the decode step: (z, q, k, v, log_w, xh, new conv state)."""
    d_inner = dims(cfg)[0]
    z, xin, bmat, cmat, dt = _split_proj(cfg, in_proj(p, x, dtype, ctx))
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                        conv_state)
    xin, bmat, cmat = torch.split(
        conv_out, [d_inner, cfg.ssm.state_dim, cfg.ssm.state_dim], dim=-1)
    q, k, v, log_w, xh = _ssd_inputs(cfg, xin, bmat, cmat, dt,
                                     p["a_log"], p["dt_bias"], ctx)
    return z, q, k, v, log_w, xh, conv_state


def _out(p, y, z, xh, dtype):
    """The D skip, gated RMSNorm and out_proj of y (B, S, H, hd)."""
    b, s = y.shape[:2]
    y = y + xh * p["d_skip"].to(xh.dtype)[None, None, :, None]
    y = _gated_norm(y.reshape(b, s, -1), z, p["norm_scale"])
    return mm(y, p["out_proj"], dtype)


def mamba_block(p, x, cfg: ModelConfig, *, state=None,
                ctx: ShardCtx = NO_SHARD, dtype=torch.bfloat16,
                impl="kernel"):
    """Full-sequence SSD.  state: None or (conv_state, ssm_state).
    Returns (out (B,S,D), (conv_state, ssm_state)).  ``impl="kernel"``
    runs the ``ssm_scan`` wrapper (the CUDA kernels, which have no
    backward pass, or the plain version on the CPU); ``"plain"`` runs
    ``nn.linear_attn.gla_chunked`` on any device, differentiable."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"mamba_block: impl {impl!r} is not 'kernel' or "
                         f"'plain'")
    z, q, k, v, log_w, xh, conv_state = _conv_ssd(
        p, x, cfg, None if state is None else state[0], dtype, ctx)
    scan = ssm_ops.gla_chunked if impl == "kernel" else gla_chunked
    y, s_final = scan(q, k, v, log_w.contiguous(), chunk=cfg.ssm.chunk,
                      variant="mamba",
                      initial_state=None if state is None else state[1])
    return _out(p, y, z, xh, dtype), (conv_state, s_final)


def mamba_decode(p, x, cfg: ModelConfig, *, state,
                 ctx: ShardCtx = NO_SHARD, dtype=torch.bfloat16):
    """x: (B,1,D); state = (conv_state (B,W-1,C), ssm_state (B,H,N,hd))."""
    z, q, k, v, log_w, xh, conv_state = _conv_ssd(p, x, cfg, state[0],
                                                  dtype, ctx)
    y, s_new = gla_decode(q[:, 0], k[:, 0], v[:, 0], log_w[:, 0], state[1],
                          variant="mamba")
    return _out(p, y[:, None], z, xh, dtype), (conv_state, s_new)


def init_mamba_state(batch: int, cfg: ModelConfig, dtype=torch.bfloat16,
                     device=None):
    d_inner, nheads, conv_ch = dims(cfg)
    return (torch.zeros((batch, cfg.ssm.conv_width - 1, conv_ch),
                        dtype=dtype, device=device),
            torch.zeros((batch, nheads, cfg.ssm.state_dim, cfg.ssm.head_dim),
                        device=device))


def mamba_state_specs(batch: int, cfg: ModelConfig, dtype="bfloat16"):
    d_inner, nheads, conv_ch = dims(cfg)
    return (ParamSpec((batch, cfg.ssm.conv_width - 1, conv_ch),
                      ("batch", None, "heads"), init="zeros", dtype=dtype),
            ParamSpec((batch, nheads, cfg.ssm.state_dim, cfg.ssm.head_dim),
                      ("batch", "heads", "state", None), init="zeros",
                      dtype="float32"))
