"""Top-k Mixture-of-Experts with grouped, capacity-bounded dispatch: the
port of ``repro.nn.moe``.

A group is a batch row.  Each token's k choices are laid out token-major
over (S, k); a choice's place in its expert is the count of earlier
choices of that expert in the group (JAX's cumsum positions), and a
choice past the expert's capacity ``ceil(S k / E * capacity_factor)``
goes to a trash slot and contributes 0.  So prefill at a capacity factor
under E may drop tokens where decode (S = 1) does not.  The expert
products stay ``torch.einsum``, as JAX computes them outside any Pallas
kernel.

On a mesh (``ctx``; DTensor weights and activations) the bookkeeping
stays shard-local, as JAX's docstring says of its groups: the router's
probabilities are a DTensor product, then each rank picks the top k,
computes the slots, the dispatch's ``index_put`` and the combine's
gather on its own batch rows (``nn.layers.per_rank``; any other split
of x is gathered).  The dispatched (G, E, C, D) tensor and the
experts' output are constrained at JAX's two points
(``src/repro/nn/moe.py:89, 92``), and the expert MLP runs as DTensor
einsums on the weights the rules lay out: under the default rules the
experts are replicated (the meshes have no 'expert' axis) and F is
split on 'model'; under ``EXPERT_PARALLEL_RULES`` the experts are split
on 'data', which the dispatch's batch claims first.  No expert weight
moves then: DTensor all-gathers the dispatched activations over
'data' for each expert product (each rank runs its own experts on
every group) and sends the outputs back to their groups' ranks (an
all-to-all), as ``tools/mesh_bf16_gap.py collectives`` lists.  The
load-balance loss reduces its counts and mean probabilities over the
whole batch, as one process does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.configs.base import MoEConfig
from repro_torch.nn.layers import NO_SHARD, ShardCtx, kept, per_rank
from repro_torch.nn.param import ParamSpec


def moe_specs(d_model: int, d_ff: int, moe: MoEConfig, activation: str):
    e = moe.num_experts
    specs = {
        "router": ParamSpec((d_model, e), ("embed", None), scale=0.1),
        "wo": ParamSpec((e, d_ff, d_model), ("experts", "mlp", "embed")),
    }
    if activation in ("swiglu", "geglu"):
        specs["wi_gate"] = ParamSpec((e, d_model, d_ff),
                                     ("experts", "embed", "mlp"))
        specs["wi_up"] = ParamSpec((e, d_model, d_ff),
                                   ("experts", "embed", "mlp"))
    else:
        specs["wi"] = ParamSpec((e, d_model, d_ff),
                                ("experts", "embed", "mlp"))
    return specs


def _gelu(t: torch.Tensor) -> torch.Tensor:
    return F.gelu(t, approximate="tanh")


def _expert_mlp(params, h, activation: str, dtype):
    """h: (G, E, C, D) -> (G, E, C, D); weights cast to ``dtype`` at use.
    The products run expert-major on a contiguous (E, G, C, ·) copy:
    ``einsum`` flattens (G, C) into the rows of a batched product over
    E, which a DTensor split on G can take only from contiguous rows."""
    h = h.transpose(0, 1).contiguous()
    if "wi_gate" in params:
        g = torch.einsum("egcd,edf->egcf", h, params["wi_gate"].to(dtype))
        u = torch.einsum("egcd,edf->egcf", h, params["wi_up"].to(dtype))
        act = F.silu if activation == "swiglu" else _gelu
        z = act(g) * u
    else:
        z = _gelu(torch.einsum("egcd,edf->egcf", h,
                               params["wi"].to(dtype)))
    return torch.einsum("egcf,efd->egcd", z,
                        params["wo"].to(dtype)).transpose(0, 1)


def capacity(seq: int, moe: MoEConfig) -> int:
    """Slots an expert has in a group of ``seq`` tokens."""
    return max(1, int(math.ceil(seq * moe.top_k / moe.num_experts
                                * moe.capacity_factor)))


def _router_probs(params, x):
    """The fp32 router's probabilities (B, S, E) on x (B, S, D)."""
    logits = torch.einsum("bsd,de->bse", x.float(),
                          params["router"].float())
    return torch.softmax(logits, dim=-1)


def route(params, x, moe: MoEConfig):
    """The fp32 router on x (B, S, D): (probs (B, S, E), the top-k expert
    ids (B, S, k), largest first)."""
    probs = _router_probs(params, x)
    return probs, torch.topk(probs, moe.top_k, dim=-1).indices


def dispatch_slots(expert_ids, cap: int, num_experts: int):
    """Each choice's slot in the (E * cap + 1)-row dispatch buffer of its
    group, token-major over (S, k); the last row is the trash slot of the
    choices past their expert's capacity.  Returns (slot (B, S k), kept
    (B, S k) bool)."""
    b = expert_ids.shape[0]
    flat_e = expert_ids.reshape(b, -1)                         # (B, N)
    onehot = F.one_hot(flat_e, num_experts)                    # (B, N, E)
    pos = torch.gather(onehot.cumsum(1), 2, flat_e[..., None])[..., 0] - 1
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, num_experts * cap))
    return slot, keep


def moe_mlp(params, x: torch.Tensor, moe: MoEConfig, activation: str,
            dtype: torch.dtype = torch.bfloat16,
            expert_ids: Optional[torch.Tensor] = None,
            ctx: ShardCtx = NO_SHARD
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D).  Returns (y (B, S, D) in ``dtype``, the fp32
    Switch/GShard load-balance loss).

    ``expert_ids`` (B, S, k), for checks only, pins the routing: the
    gates are then the router's probabilities at those ids, renormalised
    as usual.  A near-tie between the k-th and (k+1)-th choice flips with
    the rounding of the input, and a flipped token's output differs by
    O(1); pinning holds two routes of the same model to rounding."""
    return moe_mlp_routed(params, x, moe, activation, dtype, expert_ids,
                          ctx)[:2]


def moe_mlp_routed(params, x, moe: MoEConfig, activation: str,
                   dtype: torch.dtype = torch.bfloat16,
                   expert_ids: Optional[torch.Tensor] = None,
                   ctx: ShardCtx = NO_SHARD):
    """``moe_mlp``'s (y, aux) and the expert ids it routed to."""
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    cap = capacity(s, moe)

    probs = _router_probs(params, x)
    mean_probs = probs.mean(dim=(0, 1))
    # the bookkeeping runs on each rank's own rows (``per_rank``; every
    # row with no mesh)
    mesh = x.device_mesh if isinstance(x, DTensor) else None
    rows = None if mesh is None else kept(x, 0)
    summed = None if mesh is None else [
        Partial() if isinstance(p, Shard) else p for p in rows]

    def dispatch(x, probs, pinned):
        picked = torch.topk(probs, k, dim=-1).indices
        ids = picked if pinned is None else pinned.to(picked)
        gate_vals = torch.gather(probs, -1, ids)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
        # the first choices counted, for the load-balance loss
        first = F.one_hot(ids[..., 0], e).float().sum(dim=(0, 1))
        # grouped dispatch (group = batch row)
        bl = x.shape[0]
        slot, _ = dispatch_slots(ids, cap, e)
        x_rep = torch.repeat_interleave(x, k, dim=1).to(dtype)  # (B, N, D)
        disp = torch.zeros((bl, e * cap + 1, d), dtype=dtype,
                           device=x.device)
        disp = disp.index_put((_groups(bl, x.device), slot), x_rep,
                              accumulate=True)
        return (disp[:, :e * cap].reshape(bl, e, cap, d), gate_vals, slot,
                ids.contiguous(), first)

    h, gate_vals, slot, ids, first = per_rank(
        dispatch, mesh, [(x, rows), (probs, rows), (expert_ids, rows)],
        [(rows, (b, e, cap, d)), (rows, (b, s, k)), (rows, (b, s * k)),
         (rows, (b, s, k)), (summed, (e,))])

    # Switch/GShard load-balance auxiliary loss (first choice only)
    density = first / (b * s)
    aux = e * torch.sum(density * mean_probs) * moe.router_aux_weight

    h = ctx.constrain(h, "batch", "experts", None, None)
    y_exp = _expert_mlp(params, h, activation, dtype)          # (B,E,C,D)
    y_exp = ctx.constrain(y_exp, "batch", "experts", None, None)

    def combine(y_exp, slot, gate_vals):
        bl = y_exp.shape[0]
        y_flat = torch.cat([y_exp.reshape(bl, e * cap, d),
                            torch.zeros((bl, 1, d), dtype=dtype,
                                        device=y_exp.device)], dim=1)
        y_rep = y_flat[_groups(bl, y_exp.device), slot].reshape(bl, s, k, d)
        gates = gate_vals.reshape(bl, s, k, 1).to(dtype)
        return torch.sum(y_rep * gates, dim=2)

    y = per_rank(combine, mesh, [(y_exp, rows), (slot, rows),
                                 (gate_vals, rows)], [(rows, (b, s, d))])
    return y, aux.float(), ids


def _groups(b: int, device) -> torch.Tensor:
    """(B, 1) row indices of the dispatch's groups."""
    return torch.arange(b, device=device)[:, None]
