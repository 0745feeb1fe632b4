"""Qwen3-30B-A3B: 128-expert top-8 fine-grained MoE. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    moe=MoEConfig(num_experts=128, top_k=8, period=1),
    rope_theta=1e6,
    max_position=262144,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
