"""repro-100m — in-house ~100M-param dense decoder used by the end-to-end
training example (examples/train_100m.py) and CI-scale integration tests.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="repro-100m",
    arch_type="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=3072,
    vocab_size=32768,
    mlp_activation="swiglu",
    tie_embeddings=True,
    sliding_window=1024,
    remat=False,
    source="in-house",
))
