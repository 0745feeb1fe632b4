"""SeamlessM4T-medium text backbone: 12L enc + 12L dec, MHA, vocab 256206.
[arXiv:2308.11596; hf] — audio frontend is a STUB (precomputed frame embeddings).
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,               # decoder
    num_encoder_layers=12,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frontend=FrontendConfig(kind="audio", num_embeds=1024, embed_dim=1024),
    rope_theta=1e4,
    max_position=65536,
    source="arXiv:2308.11596; hf",
)
