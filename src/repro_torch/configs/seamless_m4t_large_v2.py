"""seamless-m4t-large-v2 [audio] — enc-dec, 24L decoder d_model=1024 16H
(kv=16) d_ff=8192 vocab=256206; multimodal.  [arXiv:2308.11596]

Transformer backbone only: the mel-spectrogram + conv feature extractor is a
stub — input_specs() provides precomputed frame embeddings.
long_500k is SKIPPED for this arch (enc-dec full cross-attention; see
DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, EncDecConfig, FrontendStub, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    num_layers=24,                 # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    mlp_activation="gelu",
    encdec=EncDecConfig(num_encoder_layers=24, encoder_seq=1024),
    frontend=FrontendStub(kind="audio", num_embeds=1024, embed_dim=1024),
    source="arXiv:2308.11596",
))
