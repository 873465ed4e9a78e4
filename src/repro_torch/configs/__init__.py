"""Architecture configs the port can build (copies of ``repro.configs``).

Registered: the five dense decoders (llama3.2-1b, repro-100m, gemma-7b,
granite-34b, minitron-8b), rwkv6-1.6b and the hybrid zamba2-7b.  The MoE
(grok-1, llama4-scout), encoder-decoder (seamless-m4t) and stub-frontend
(internvl2-2b) configs come with the slices that port their models
(``ROADMAP.md`` queue 1, items 6.4 and 6.5).
"""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, HybridConfig, EncDecConfig,
    FrontendStub, InputShape, INPUT_SHAPES, register, get_config, all_configs,
)

_LOADED = False

_MODULES = ["granite_34b", "rwkv6_1p6b", "minitron_8b", "llama3p2_1b",
            "gemma_7b", "zamba2_7b", "repro_100m"]


def load_all():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _LOADED = True
