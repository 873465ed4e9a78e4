"""Architecture configs the port can build (copies of ``repro.configs``).

Registered: every config of the JAX package — the five dense decoders
(llama3.2-1b, repro-100m, gemma-7b, granite-34b, minitron-8b), rwkv6-1.6b,
the hybrid zamba2-7b, the MoE decoders grok-1-314b and
llama4-scout-17b-a16e, the stub-frontend decoder internvl2-2b and the
encoder-decoder seamless-m4t-large-v2.
"""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, HybridConfig, EncDecConfig,
    FrontendStub, InputShape, INPUT_SHAPES, register, get_config, all_configs,
)

_LOADED = False

_MODULES = [
    "grok_1_314b", "granite_34b", "rwkv6_1p6b", "minitron_8b",
    "llama3p2_1b", "gemma_7b", "seamless_m4t_large_v2",
    "llama4_scout_17b_a16e", "zamba2_7b", "internvl2_2b", "repro_100m",
]


def load_all():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _LOADED = True
