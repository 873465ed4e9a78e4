"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553; InternViT + InternLM2.  [arXiv:2404.16821]

LM backbone only: the InternViT vision encoder + projector is a stub —
input_specs() provides precomputed patch embeddings interleaved with tokens.
"""
from repro_torch.configs.base import ModelConfig, FrontendStub, register

CONFIG = register(ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    mlp_activation="swiglu",
    frontend=FrontendStub(kind="vision", num_embeds=256, embed_dim=2048),
    sliding_window=8192,
    source="arXiv:2404.16821",
))
