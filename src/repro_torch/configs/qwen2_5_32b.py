"""Qwen2.5-32B (paper evaluation model). [arXiv:2501.15383]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    rope_theta=1e6,
    max_position=32768,
    source="arXiv:2501.15383",
)
