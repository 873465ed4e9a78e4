"""Model factory: config -> model instance (dense decoders and rwkv6)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import LMBase
from repro_torch.models.decoder import DecoderLM
from repro_torch.models.rwkv_model import RWKVModel


def build_model(cfg: ModelConfig) -> LMBase:
    if cfg.encdec is not None or cfg.arch_type == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type} family is not ported yet "
            f"(ROADMAP.md queue 1, item 14: mamba and zamba, encdec)")
    if cfg.arch_type == "ssm":
        return RWKVModel(cfg)
    return DecoderLM(cfg)      # raises for MoE and stub frontends
