"""Model factory: config -> model instance (decoders dense, MoE and with a
stub frontend; rwkv6; the zamba2 hybrid; the encoder-decoder)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import LMBase
from repro_torch.models.decoder import DecoderLM
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.rwkv_model import RWKVModel
from repro_torch.models.zamba import ZambaModel


def build_model(cfg: ModelConfig) -> LMBase:
    if cfg.encdec is not None:
        return EncDecModel(cfg)
    if cfg.arch_type == "ssm":
        return RWKVModel(cfg)
    if cfg.arch_type == "hybrid":
        return ZambaModel(cfg)
    # dense / moe / vlm / audio-decoder
    return DecoderLM(cfg)
