"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536; Finch, data-dependent decay.  [arXiv:2404.05892]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # rwkv6 heads: d_model / head_dim(64)
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    mlp_activation="rwkv_channel_mix",
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=1, chunk=128),
    source="arXiv:2404.05892",
))
