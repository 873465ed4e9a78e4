"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    # gated (3-matrix) expert MLP: 64L x 8e x 3 x 6144 x 32768
    # + attn + embeddings = ~316B, matching the 314B nameplate
    mlp_activation="geglu",
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    sliding_window=8192,   # beyond-paper SW variant for long_500k decode
    source="hf:xai-org/grok-1",
))
