"""Architecture configs the port can build (copies of ``repro.configs``).

The dense decoders and rwkv6-1.6b are registered; the other families'
configs come with the slices that port their models (``ROADMAP.md``
queue 1, item 14).
"""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, HybridConfig, EncDecConfig,
    FrontendStub, InputShape, INPUT_SHAPES, register, get_config, all_configs,
)

_LOADED = False

_MODULES = ["rwkv6_1p6b", "llama3p2_1b", "repro_100m"]


def load_all():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _LOADED = True
