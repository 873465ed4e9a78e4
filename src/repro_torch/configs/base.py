"""Model / run configuration system (a copy of ``repro.configs.base``).

Each architecture the port can build gets a ``ModelConfig`` in its own
module; all are registered in ``REGISTRY`` and selectable via
``--arch <id>`` in the launchers.  Configs are plain frozen dataclasses.
The one difference from the JAX package: ``attention_impl`` names the
port's paths, ``"dot" | "chunked" | "kernel"`` (JAX's ``"xla" |
"chunked" | "pallas"``; ``repro_torch.convert.ATTENTION_IMPL_FROM_JAX``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # Layers that are MoE; "all" or every-nth.
    moe_every: int = 1  # 1 = every layer is MoE


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # per-head recurrent state size (N)
    head_dim: int = 64           # mamba2 P
    expand: int = 2              # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128             # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: mamba2 backbone + a shared attention block applied
    every ``attn_every`` layers (weights shared across applications)."""
    attn_every: int = 6
    num_shared_blocks: int = 2


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    num_encoder_layers: int = 24
    # encoder input is a stub embedding sequence (audio frames / patches)
    encoder_seq: int = 1024


@dataclasses.dataclass(frozen=True)
class FrontendStub:
    """[audio]/[vlm] carve-out: precomputed frame/patch embeddings."""
    kind: str = "none"        # "audio" | "vision" | "none"
    num_embeds: int = 0       # frames or patches per example
    embed_dim: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # one of ARCH_TYPES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None      # default d_model // num_heads
    # activation: "swiglu" | "geglu" | "gelu"
    mlp_activation: str = "swiglu"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention variants
    sliding_window: Optional[int] = None     # if set, SW attention available
    use_sliding_for_long: bool = True        # use SW for long_500k decode
    attention_impl: str = "dot"              # "dot" | "chunked" | "kernel"
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: FrontendStub = FrontendStub()
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "nothing_saveable"   # or "dots_saveable"
    # citation for the assigned config
    source: str = ""

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Whether long_500k decode is runnable (sub-quadratic path)."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        if self.encdec is not None:
            return False   # enc-dec cross attention over full memory: skip
        return self.sliding_window is not None and self.use_sliding_for_long

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                max_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant of the same family (<=512 d_model, 2 layers)."""
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        hd = max(16, d_model // heads)
        repl = dict(
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=d_model * 4,
            vocab_size=min(self.vocab_size, 1024),
            remat=False,
        )
        if self.moe is not None:
            repl["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, max_experts),
                top_k=min(self.moe.top_k, 2))
        if self.ssm is not None:
            repl["ssm"] = dataclasses.replace(
                self.ssm, state_dim=32, head_dim=32, chunk=32)
        if self.hybrid is not None:
            repl["hybrid"] = dataclasses.replace(
                self.hybrid, attn_every=2, num_shared_blocks=1)
        if self.encdec is not None:
            repl["encdec"] = dataclasses.replace(
                self.encdec, num_encoder_layers=num_layers, encoder_seq=32)
        if self.frontend.kind != "none":
            repl["frontend"] = dataclasses.replace(
                self.frontend, num_embeds=min(self.frontend.num_embeds, 16),
                embed_dim=d_model)
        if self.sliding_window is not None:
            repl["sliding_window"] = 64
        return dataclasses.replace(self, **repl)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import all config modules lazily
        from repro_torch import configs as _c  # noqa
        _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs():
    from repro_torch import configs as _c
    _c.load_all()
    return dict(_REGISTRY)
