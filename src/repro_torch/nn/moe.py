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
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
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
    """h: (G, E, C, D) -> (G, E, C, D); weights cast to ``dtype`` at use."""
    if "wi_gate" in params:
        g = torch.einsum("gecd,edf->gecf", h, params["wi_gate"].to(dtype))
        u = torch.einsum("gecd,edf->gecf", h, params["wi_up"].to(dtype))
        act = F.silu if activation == "swiglu" else _gelu
        z = act(g) * u
    else:
        z = _gelu(torch.einsum("gecd,edf->gecf", h,
                               params["wi"].to(dtype)))
    return torch.einsum("gecf,efd->gecd", z, params["wo"].to(dtype))


def capacity(seq: int, moe: MoEConfig) -> int:
    """Slots an expert has in a group of ``seq`` tokens."""
    return max(1, int(math.ceil(seq * moe.top_k / moe.num_experts
                                * moe.capacity_factor)))


def route(params, x, moe: MoEConfig):
    """The fp32 router on x (B, S, D): (probs (B, S, E), the top-k expert
    ids (B, S, k), largest first)."""
    logits = torch.einsum("bsd,de->bse", x.float(),
                          params["router"].float())
    probs = torch.softmax(logits, dim=-1)
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
            expert_ids: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D).  Returns (y (B, S, D) in ``dtype``, the fp32
    Switch/GShard load-balance loss).

    ``expert_ids`` (B, S, k), for checks only, pins the routing: the
    gates are then the router's probabilities at those ids, renormalised
    as usual.  A near-tie between the k-th and (k+1)-th choice flips with
    the rounding of the input, and a flipped token's output differs by
    O(1); pinning holds two routes of the same model to rounding."""
    return moe_mlp_routed(params, x, moe, activation, dtype, expert_ids)[:2]


def moe_mlp_routed(params, x, moe: MoEConfig, activation: str,
                   dtype: torch.dtype = torch.bfloat16,
                   expert_ids: Optional[torch.Tensor] = None):
    """``moe_mlp``'s (y, aux) and the expert ids it routed to."""
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    cap = capacity(s, moe)

    probs, picked = route(params, x, moe)
    ids = picked if expert_ids is None else expert_ids.to(picked)
    gate_vals = torch.gather(probs, -1, ids)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # Switch/GShard load-balance auxiliary loss (first choice only)
    density = F.one_hot(ids[..., 0], e).float().mean(dim=(0, 1))
    mean_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(density * mean_probs) * moe.router_aux_weight

    # grouped dispatch (group = batch row)
    slot, _ = dispatch_slots(ids, cap, e)
    gidx = torch.arange(b, device=x.device)[:, None]
    x_rep = torch.repeat_interleave(x, k, dim=1).to(dtype)     # (B, N, D)
    disp = torch.zeros((b, e * cap + 1, d), dtype=dtype, device=x.device)
    disp = disp.index_put((gidx, slot), x_rep, accumulate=True)
    h = disp[:, :e * cap].reshape(b, e, cap, d)

    y_exp = _expert_mlp(params, h, activation, dtype)          # (B,E,C,D)
    y_flat = torch.cat([y_exp.reshape(b, e * cap, d),
                        torch.zeros((b, 1, d), dtype=dtype,
                                    device=x.device)], dim=1)
    y_rep = y_flat[gidx, slot].reshape(b, s, k, d)
    gates = gate_vals.reshape(b, s, k, 1).to(dtype)
    y = torch.sum(y_rep * gates, dim=2)
    return y, aux.float(), ids
