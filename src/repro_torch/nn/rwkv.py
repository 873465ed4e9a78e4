"""RWKV6 ("Finch") block: data-dependent-decay time-mix + channel-mix.

The port of ``repro.nn.rwkv`` (arXiv:2404.05892 structure): token-shift
lerps with learned per-channel mixes, a low-rank data-dependent decay
``w_t = exp(-softplus(w0 + tanh(x_w A) B))``, per-channel bonus ``u``, the
WKV recurrence (the GLA primitive, ``"rwkv"`` variant), per-head group
norm and ``silu(g)`` gating.  ``time_mix`` runs the WKV through the
``ssm_scan`` kernel's wrapper (its plain version on CPU tensors), or with
``impl="plain"`` through ``nn.linear_attn.gla_chunked`` (differentiable),
where JAX calls its ``nn.linear_attn.gla_chunked``; ``time_mix_decode``
steps ``gla_decode``.  The casts are JAX's: weights are cast to ``dtype``
(bfloat16 unless given; the JAX model passes none) and a product of
activations and weights of two dtypes is taken in the wider
(``nn.layers.mm``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.nn.layers import NO_SHARD, ShardCtx, mm
from repro_torch.nn.linear_attn import gla_chunked, gla_decode
from repro_torch.nn.param import ParamSpec

LORA = 64


def time_mix_specs(cfg: ModelConfig):
    d = cfg.d_model
    h = cfg.num_heads
    hd = cfg.resolved_head_dim()
    if h * hd != d:
        raise ValueError("rwkv6 requires heads * head_dim == d_model")
    mixes = {f"mu_{n}": ParamSpec((d,), ("embed",), init="ones", scale=0.5)
             for n in ("r", "k", "v", "g", "w")}
    return {
        **mixes,
        "wr": ParamSpec((d, d), ("embed", "heads")),
        "wk": ParamSpec((d, d), ("embed", "heads")),
        "wv": ParamSpec((d, d), ("embed", "heads")),
        "wg": ParamSpec((d, d), ("embed", "heads")),
        "w0": ParamSpec((d,), ("embed",), init="zeros"),
        "w_lora_a": ParamSpec((d, LORA), ("embed", None), scale=0.1),
        "w_lora_b": ParamSpec((LORA, d), (None, "embed"), scale=0.1),
        "bonus": ParamSpec((h, hd), ("heads", "qkv"), init="zeros"),
        "ln_scale": ParamSpec((h, hd), ("heads", "qkv"), init="ones"),
        "wo": ParamSpec((d, d), ("heads", "embed")),
    }


def channel_mix_specs(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), ("embed",), init="ones", scale=0.5),
        "mu_r": ParamSpec((d,), ("embed",), init="ones", scale=0.5),
        "wk": ParamSpec((d, f), ("embed", "mlp")),
        "wv": ParamSpec((f, d), ("mlp", "embed")),
        "wr": ParamSpec((d, d), ("embed", "embed")),
    }


def _shift(x, prev):
    """x: (B,S,D); prev: (B,D) last token of the previous segment."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _lerp(x, shifted, mu):
    return x + (shifted - x) * mu.to(x.dtype)


def _group_norm(y, scale, eps=1e-5):
    """y: (B,S,H,hd) per-head layer norm (rwkv's GroupNorm), in fp32."""
    f32 = y.float()
    mean = f32.mean(-1, keepdim=True)
    var = f32.var(-1, unbiased=False, keepdim=True)
    out = (f32 - mean) * torch.rsqrt(var + eps) * scale.float()
    return out.to(y.dtype)


def _rkvgw(p, x, xs, h, hd, dtype):
    xr = _lerp(x, xs, p["mu_r"])
    xk = _lerp(x, xs, p["mu_k"])
    xv = _lerp(x, xs, p["mu_v"])
    xg = _lerp(x, xs, p["mu_g"])
    xw = _lerp(x, xs, p["mu_w"])
    b, s, _ = x.shape
    r = mm(xr, p["wr"], dtype).reshape(b, s, h, hd)
    k = mm(xk, p["wk"], dtype).reshape(b, s, h, hd)
    v = mm(xv, p["wv"], dtype).reshape(b, s, h, hd)
    g = mm(xg, p["wg"], dtype)
    lora = torch.tanh(xw.float() @ p["w_lora_a"].float()) \
        @ p["w_lora_b"].float()
    log_w = -F.softplus(p["w0"].float() + lora)          # (B,S,D) <= 0
    return r, k, v, g, log_w.reshape(b, s, h, hd)


def _out(p, y, g, dtype):
    """Group norm, silu(g) gate and the output projection."""
    b, s = y.shape[:2]
    y = _group_norm(y, p["ln_scale"]).reshape(b, s, -1)
    y = y * F.silu(g.float()).to(y.dtype)
    return mm(y, p["wo"], dtype)


def _heads_split(rkvgw, ctx: ShardCtx):
    """r, k, v and log_w (B, S, H, hd) laid out ("batch", None, "heads",
    None), the layout the ("embed", "heads") projections give them on
    'model'; g (B, S, D) as it is."""
    return tuple(ctx.constrain(t, "batch", None, "heads", None)
                 if t.dim() == 4 else t for t in rkvgw)


def time_mix(p, x, cfg: ModelConfig, *, prev_x, state,
             ctx: ShardCtx = NO_SHARD, dtype=torch.bfloat16, impl="kernel"):
    """Full-sequence WKV.  prev_x: (B,D); state: (B,H,hd,hd) fp32 or
    None.  Returns (out, (last x, state)).  ``impl="kernel"`` runs the
    ``ssm_scan`` wrapper (the CUDA kernels, which have no backward pass,
    or the plain version on the CPU); ``"plain"`` runs
    ``nn.linear_attn.gla_chunked`` on any device, differentiable, as JAX
    differentiates its jnp ``gla_chunked``.  On a mesh the scan's inputs
    are laid out ("batch", None, "heads", None) first, the layout the
    ("embed", "heads") projections give them on 'model', so the scan
    runs on each rank's rows and heads whatever split DTensor chose for
    the products."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"time_mix: impl {impl!r} is not 'kernel' or "
                         f"'plain'")
    r, k, v, g, log_w = _heads_split(
        _rkvgw(p, x, _shift(x, prev_x), cfg.num_heads,
               cfg.resolved_head_dim(), dtype), ctx)
    scan = ssm_ops.gla_chunked if impl == "kernel" else gla_chunked
    y, s_final = scan(r, k, v, log_w, chunk=cfg.ssm.chunk, variant="rwkv",
                      bonus=p["bonus"], initial_state=state)
    return _out(p, y, g, dtype), (x[:, -1], s_final)


def time_mix_decode(p, x, cfg: ModelConfig, *, prev_x, state,
                    ctx: ShardCtx = NO_SHARD, dtype=torch.bfloat16):
    """x: (B,1,D), one step through ``gla_decode``; on a mesh its inputs
    laid out as ``time_mix`` lays out the scan's, so the readout runs on
    each rank's rows and heads."""
    r, k, v, g, log_w = _heads_split(
        _rkvgw(p, x, prev_x[:, None], cfg.num_heads,
               cfg.resolved_head_dim(), dtype), ctx)
    y, s_new = gla_decode(r[:, 0], k[:, 0], v[:, 0], log_w[:, 0], state,
                          variant="rwkv", bonus=p["bonus"])
    return _out(p, y[:, None], g, dtype), (x[:, -1], s_new)


def channel_mix(p, x, *, prev_x, dtype=torch.bfloat16):
    xs = _shift(x, prev_x)
    xk = _lerp(x, xs, p["mu_k"])
    xr = _lerp(x, xs, p["mu_r"])
    kk = torch.square(F.relu(mm(xk, p["wk"], dtype)))
    vv = mm(kk, p["wv"], dtype)
    r = torch.sigmoid(mm(xr, p["wr"], dtype).float()).to(dtype)
    return r * vv, x[:, -1]
