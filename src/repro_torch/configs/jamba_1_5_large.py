"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE every 2nd layer.
[arXiv:2403.19887; hf] — attn_layer_period=8/offset=4, expert_layer_period=2/offset=1.
"""
from repro_torch.configs.base import (AttentionPattern, ModelConfig, MoEConfig, SSMConfig)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, period=2, offset=1),
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, chunk_size=256),
    attn=AttentionPattern(attn_period=8, attn_offset=4),
    rope_theta=1e4,
    max_position=262144,
    source="arXiv:2403.19887; hf",
)
