"""Mixtral-8x7B (paper evaluation model). [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    moe=MoEConfig(num_experts=8, top_k=2, period=1),
    rope_theta=1e6,
    max_position=32768,
    source="arXiv:2401.04088",
)
