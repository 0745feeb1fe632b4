"""Gemma-3 1B: 5:1 local:global attention, sliding window 512, 262k vocab.
[hf:google/gemma-3-1b-pt; unverified] — layer (i+1)%6==0 is global, rest local.
"""
from repro_torch.configs.base import AttentionPattern, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    attn=AttentionPattern(attn_period=1, sliding_window=512, global_period=6),
    tie_embeddings=True,
    rope_theta=1e6,
    max_position=131072,
    source="hf:google/gemma-3-1b-pt; unverified",
)
