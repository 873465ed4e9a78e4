"""Model factory: config -> model instance (dense decoders so far)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import LMBase
from repro_torch.models.decoder import DecoderLM


def build_model(cfg: ModelConfig) -> LMBase:
    if cfg.encdec is not None or cfg.arch_type in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type} family is not ported yet "
            f"(ROADMAP.md queue 1, item 14: rwkv and mamba, zamba and "
            f"encdec)")
    return DecoderLM(cfg)      # raises for MoE and stub frontends
