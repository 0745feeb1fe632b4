"""Mamba2-2.7B: attention-free SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
    tie_embeddings=True,
    max_position=1048576,
    source="arXiv:2405.21060; unverified",
)
