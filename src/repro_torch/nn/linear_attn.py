"""Chunked gated-linear-attention (GLA) primitive: the port of
``repro.nn.linear_attn``.

One recurrence covers the linear-attention family:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: (Dk, Dv))
    mamba2 : y_t = q_t . S_t                      (current token decayed in)
    rwkv6  : y_t = q_t . S_{t-1} + (q_t . (u*k_t)) v_t   (bonus term u)

``gla_decode`` is the recurrent step, as in JAX.  ``gla_chunked`` is the
plain PyTorch version of the ``ssm_scan`` CUDA kernel
(``kernels/ssm_scan``): JAX's function, computed with the kernel's
arithmetic, chunk by chunk in a Python loop.

Numerics.  JAX factors a chunk's intra-chunk decay as ``q·exp(lc)`` times
``k·exp(−lc)``, with ``lc`` the inclusive cumulative log-decay.
``exp(−lc)`` overflows float32 once a chunk decays by more than e^88:
rwkv6-1.6b at its own init decays by about ln 2 a step, so a 128-step
chunk reaches 2^128.  Here each chunk is cut into sub-chunks of ``SUB``
rows instead:

* query sub-chunk i against an earlier key sub-chunk j:
  ``att_ts = Σ_d (q̂_td g_ijd) k̂_sd`` with ``q̂ = q·exp(q_lc_t − r_i)``,
  ``k̂ = k·exp(e_j − lc_s)`` and ``g_ij = exp(r_i − e_j)``, where ``r_i``
  is ``q_lc`` on i's first row and ``e_j`` is ``lc`` on j's last row;
* the diagonal block: ``exp(q_lc_t − lc_s)`` pair by pair, after the mask;
* the inter-chunk terms are JAX's (``q·exp(q_lc)``, ``k·exp(lc_C − lc)``,
  ``S·exp(lc_C)``).

``q_lc`` is ``lc`` (mamba) or ``lc`` one row earlier (rwkv; 0 on a
chunk's first row).  Every exponent is ≤ 0, so nothing overflows; where
JAX's form stays in range the two agree to rounding.  ``lc`` is a cumsum
along a dimension that is not the innermost, which PyTorch takes in
order on the GPU too, as the kernel does; the diagonal blocks are summed
in fp64 and rounded once, as in the kernel.  Every other product (the
scores, att·v, the readout of the state, each chunk's state
contribution) is summed in float64 from its fp32 factors and rounded
once to fp32 (``_sum64``): the function is the same, its sums closer to
exact than fp32 sums in cuBLAS's order, which lay up to 0.87 of the
kernels' fp32 bar from them at rwkv6's scale, the kernels' own up to
0.69 (``tools/ssm_scan_fp32_bar.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.nn.layers import per_rank

SUB = 16        # rows of a sub-chunk (its gcd with chunk, if not a divisor)
VARIANTS = ("mamba", "rwkv")


def _chunk(x: torch.Tensor, i: int, chunk: int) -> torch.Tensor:
    """Chunk ``i`` of (B, L, H, D) as fp32 (B, H, chunk, D); rows past L
    are zeros, as JAX pads them (k = v = 0 adds nothing to the state,
    log_w = 0 decays nothing)."""
    part = x[:, i * chunk:(i + 1) * chunk].float().transpose(1, 2)
    return F.pad(part, (0, 0, 0, chunk - part.shape[2]))


def _sum64(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of fp32 factors, summed in float64 and
    rounded once to fp32."""
    return torch.einsum(eq, a.double(), b.double()).float()


def _on_shards(fn, q, k, v, log_w, state, bonus, head: int):
    """``fn(q, k, v, log_w, state, bonus)`` on each rank's own rows and
    heads when q is a DTensor (``per_rank``), else on the tensors
    themselves.  q, k, log_w and v have batch on dim 0 and heads on dim
    ``head``; state (B, H, Dk, Dv) has them on dims 0 and 1, bonus (H,
    Dk) its heads on dim 0.  Each mesh dim that splits q's batch or
    heads splits every input's (bonus replicated under a batch split,
    its gradient then a sum over those ranks); any other split is
    gathered.  ``fn`` returns (y laid out as q, state)."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, log_w, state, bonus)
    roles = [p.dim if isinstance(p, Shard) and p.dim in (0, head) else None
             for p in q.placements]

    def layout(batch, heads):
        pl = [Shard(batch) if r == 0 and batch is not None
              else Shard(heads) if r == head else Replicate()
              for r in roles]
        # a rank's rows give a partial sum of the gradient of an input
        # it holds whole along a split of the rows (the bonus)
        return pl, [Partial() if r is not None and not isinstance(p, Shard)
                    else p for r, p in zip(roles, pl)]

    seq, st = layout(0, head), layout(0, 1)
    y_shape = q.shape[:head + 1] + v.shape[head + 1:]
    s_shape = q.shape[:1] + q.shape[head:head + 1] + q.shape[-1:] \
        + v.shape[-1:]
    return per_rank(
        lambda *a: tuple(t.contiguous() for t in fn(*a)), q.device_mesh,
        [(t, *seq) for t in (q, k, v, log_w)]
        + [(state, *st), (bonus, *layout(None, 0))],
        [(seq[0], y_shape), (st[0], s_shape)])


def gla_chunked(q, k, v, log_w, *, chunk: int, variant: str = "mamba",
                bonus: Optional[torch.Tensor] = None,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, log_w (≤ 0): (B, L, H, Dk); v: (B, L, H, Dv); bonus (rwkv):
    (H, Dk), zeros if None; initial_state: (B, H, Dk, Dv) or None.

    Returns (y (B, L, H, Dv) in v's dtype, final_state (B, H, Dk, Dv)
    fp32).  Any L: the last chunk is masked as JAX pads it.  DTensors:
    each rank its own rows and heads (``_on_shards``)."""
    return _on_shards(
        lambda q, k, v, log_w, s, u: _gla_chunked(
            q, k, v, log_w, chunk=chunk, variant=variant, bonus=u,
            initial_state=s),
        q, k, v, log_w, initial_state, bonus, head=2)


def _gla_chunked(q, k, v, log_w, *, chunk, variant, bonus, initial_state):
    if variant not in VARIANTS:
        raise ValueError(f"gla_chunked: variant {variant!r} not in "
                         f"{VARIANTS}")
    b, l, h, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    sub = math.gcd(chunk, SUB)
    ns = chunk // sub
    rwkv = variant == "rwkv"
    s = (torch.zeros(b, h, dk, dv, device=dev) if initial_state is None
         else initial_state.float())
    u = (torch.zeros(h, dk, device=dev) if bonus is None
         else bonus.float())[None, :, None, None, :]      # (1,H,1,1,Dk)
    ti = torch.arange(sub, device=dev)
    live = (ti[:, None] > ti[None, :]) if rwkv \
        else (ti[:, None] >= ti[None, :])                 # (t, s)
    blk = torch.arange(ns, device=dev)
    earlier = blk[None, :] < blk[:, None]                 # (i, j): j < i
    ys = []
    for n in range(-(-l // chunk)):
        qc, kc, vc, lw = (_chunk(x, n, chunk) for x in (q, k, v, log_w))
        lc = torch.cumsum(lw, dim=2)                      # (B,H,C,Dk)
        q_lc = F.pad(lc, (0, 0, 1, 0))[:, :, :-1] if rwkv else lc
        # sub-chunk views (B, H, NS, SUB, D)
        q5, k5, lc5, qlc5 = (t.reshape(b, h, ns, sub, dk)
                             for t in (qc, kc, lc, q_lc))
        r = qlc5[:, :, :, :1]                             # (B,H,NS,1,Dk)
        e = lc5[:, :, :, -1:]
        q_hat = q5 * torch.exp(qlc5 - r)
        k_hat = k5 * torch.exp(e - lc5)
        g = torch.exp((r - e.transpose(2, 3)).masked_fill(
            ~earlier[:, :, None], float("-inf")))         # (B,H,NSi,NSj,Dk)
        qg = q_hat[:, :, :, None] * g[:, :, :, :, None]   # (B,H,i,j,t,Dk)
        att = _sum64("bhijtd,bhjsd->bhitjs", qg, k_hat)
        del qg
        # the diagonal blocks, pair by pair after the mask, summed in
        # fp64 and rounded once (torch.sum's order is its own; the
        # kernel's fp64 sum rounds to the same fp32 value)
        w = torch.exp((qlc5[:, :, :, :, None] - lc5[:, :, :, None])
                      .masked_fill(~live[..., None], float("-inf")))
        q64, k64 = q5.double(), k5.double()
        diag = ((q64[:, :, :, :, None] * k64[:, :, :, None])
                * w.double()).sum(-1)
        del w
        if rwkv:
            diag = diag + torch.diag_embed((q64 * u.double() * k64).sum(-1))
        torch.diagonal(att, dim1=2, dim2=4).copy_(
            diag.permute(0, 1, 3, 4, 2).float())
        att = att.reshape(b, h, chunk, chunk)
        y = _sum64("bhts,bhsv->bhtv", att, vc) \
            + _sum64("bhtd,bhdv->bhtv", qc * torch.exp(q_lc), s)
        lt = lc[:, :, -1:]                                # (B,H,1,Dk)
        s = s * torch.exp(lt).transpose(2, 3) \
            + _sum64("bhtd,bhtv->bhdv", kc * torch.exp(lt - lc), vc)
        ys.append(y)
    if not ys:
        return v.new_empty(b, 0, h, dv), s
    y = torch.cat(ys, dim=2)[:, :, :l].transpose(1, 2)
    return y.to(v.dtype), s


def gla_decode(q, k, v, log_w, state, *, variant: str = "mamba",
               bonus: Optional[torch.Tensor] = None):
    """Single-token recurrent step.

    q, k, log_w: (B, H, Dk); v: (B, H, Dv); state: (B, H, Dk, Dv) fp32.
    Returns (y (B, H, Dv) in v's dtype, new_state).  DTensors: each rank
    its own rows and heads (``_on_shards``)."""
    return _on_shards(
        lambda q, k, v, log_w, s, u: _gla_decode(q, k, v, log_w, s,
                                                 variant, u),
        q, k, v, log_w, state, bonus, head=1)


def _gla_decode(q, k, v, log_w, state, variant, bonus):
    q32, k32, v32 = q.float(), k.float(), v.float()
    w = torch.exp(log_w.float())
    outer = torch.einsum("bhd,bhv->bhdv", k32, v32)
    new_state = state * w[..., None] + outer
    if variant == "mamba":
        y = torch.einsum("bhd,bhdv->bhv", q32, new_state)
    else:
        y = torch.einsum("bhd,bhdv->bhv", q32, state) + torch.einsum(
            "bhd,hd,bhd->bh", q32, bonus.float(), k32)[..., None] * v32
    return y.to(v.dtype), new_state
