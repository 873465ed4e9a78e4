"""Roofline terms of a counted step (the port of ``repro.launch.roofline``):

    compute    = FLOPs_per_device / peak bf16 FLOP/s
    memory     = bytes_per_device / HBM bytes/s
    collective = collective_bytes_per_device / NVLink bytes/s (one way)

plus MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) and the usefulness
ratio MODEL_FLOPS / (FLOPs · chips).  The counts and formulas are JAX's;
the peaks are the H100's (``launch.mesh.HW``).  ``mfu`` is the share of
the card's bf16 peak that a measured step's MODEL_FLOPS reach: it reads
the same work whatever implements a kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import HW


def count_params_from_cfg(cfg: ModelConfig) -> Dict[str, float]:
    """Analytic parameter counts (total and activated-per-token)."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    hd = cfg.resolved_head_dim()
    attn = d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    gated = cfg.mlp_activation in ("swiglu", "geglu")
    mlp_mats = 3 if gated else 2
    mlp = mlp_mats * d * f
    if cfg.arch_type == "ssm":                     # rwkv6 time+channel mix
        tm = 5 * d * d + 2 * 64 * d
        cm = 2 * d * f + d * d
        per_layer = tm + cm
        attn = 0
        total = L * per_layer + 2 * v * d
        return {"total": total, "active": total}
    if cfg.moe is not None:
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        router = d * e
        per_layer = attn + router + e * mlp
        per_layer_active = attn + router + k * mlp
        total = L * per_layer + 2 * v * d
        active = L * per_layer_active + 2 * v * d
        return {"total": total, "active": active}
    per_layer = attn + mlp
    if cfg.ssm is not None and cfg.arch_type == "hybrid":
        # zamba2: mamba per layer + shared attn blocks
        d_in = cfg.ssm.expand * d
        mamba_l = d * (2 * d_in + 2 * cfg.ssm.state_dim + d_in // cfg.ssm.head_dim) \
            + d_in * d
        shared = cfg.hybrid.num_shared_blocks * (attn + mlp)
        total = L * (mamba_l + d) + shared + 2 * v * d
        return {"total": total, "active": total}
    n_enc = cfg.encdec.num_encoder_layers if cfg.encdec else 0
    total = (L + n_enc) * per_layer + (n_enc * 0) + 2 * v * d
    if cfg.encdec:
        total += L * attn                           # cross attention
    return {"total": total, "active": total}


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6·N·D for training, 2·N·D for inference (per global step)."""
    counts = count_params_from_cfg(cfg)
    n_active = counts["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1                 # decode: one token
    return 2.0 * n_active * tokens


def mfu(cfg: ModelConfig, shape: InputShape, seconds: float,
        chips: int = 1) -> float:
    """Model FLOPs utilization of a step measured at ``seconds`` on
    ``chips`` cards: ``model_flops / (seconds · chips · peak bf16)``."""
    return model_flops(cfg, shape) / (seconds * chips
                                      * HW["peak_flops_bf16"])


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    model_flops: float
    hlo_flops_total: float
    usefulness: float              # model_flops / hlo_flops_total
    dominant: str

    def as_dict(self):
        return dataclasses.asdict(self)


def derive_roofline(cfg: ModelConfig, shape: InputShape, *, chips: int,
                    hlo_flops_per_device: float,
                    hlo_bytes_per_device: float,
                    collective_bytes_per_device: Optional[float]) -> Roofline:
    """The three terms; the collective term is ``None`` where the
    collective bytes are (not counted), and ``dominant`` is then chosen
    from the other two."""
    compute = hlo_flops_per_device / HW["peak_flops_bf16"]
    memory = hlo_bytes_per_device / HW["hbm_bw"]
    coll = None if collective_bytes_per_device is None \
        else collective_bytes_per_device / HW["nvlink_bw"]
    mf = model_flops(cfg, shape)
    total_hlo = hlo_flops_per_device * chips
    useful = mf / total_hlo if total_hlo > 0 else float("nan")
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dominant = max((k for k, t in terms.items() if t is not None),
                   key=terms.get)
    return Roofline(compute, memory, coll, mf, total_hlo, useful, dominant)
