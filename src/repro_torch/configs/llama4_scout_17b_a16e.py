"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1; early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Sliding-window long-context decode mirrors Llama-4's real chunked-attention
(iRoPE) design, so long_500k runs with the SW variant.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp_activation="swiglu",
    moe=MoEConfig(num_experts=16, top_k=1, capacity_factor=1.25),
    sliding_window=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
