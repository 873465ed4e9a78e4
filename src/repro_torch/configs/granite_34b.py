"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152; llama-arch, code.  [arXiv:2405.04324]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-34b",
    arch_type="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,          # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_activation="gelu",
    sliding_window=8192,     # SW variant enables long_500k decode
    source="arXiv:2405.04324",
))
