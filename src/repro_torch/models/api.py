"""Model factory: config -> model instance (dense decoders, rwkv6 and the
zamba2 hybrid)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import LMBase
from repro_torch.models.decoder import DecoderLM
from repro_torch.models.rwkv_model import RWKVModel
from repro_torch.models.zamba import ZambaModel


def build_model(cfg: ModelConfig) -> LMBase:
    if cfg.encdec is not None:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet "
            f"(ROADMAP.md queue 1, item 6.5: encdec)")
    if cfg.arch_type == "hybrid":
        return ZambaModel(cfg)
    if cfg.arch_type == "ssm":
        return RWKVModel(cfg)
    return DecoderLM(cfg)      # raises for MoE and stub frontends
