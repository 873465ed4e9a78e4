"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64; Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]
"""
from repro_torch.configs.base import (ModelConfig, SSMConfig, HybridConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    mlp_activation="swiglu",
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=128),
    hybrid=HybridConfig(attn_every=6, num_shared_blocks=2),
    # Shared attention blocks get an 8k window so long_500k decode keeps a
    # window-sized KV ring buffer (documented adaptation; mamba state is O(1)).
    sliding_window=8192,
    source="arXiv:2411.15242",
))
