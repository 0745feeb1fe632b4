"""PaliGemma-3B: SigLIP (stub) + gemma 18L decoder backbone. [arXiv:2407.07726; hf]"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    frontend=FrontendConfig(kind="vision", num_embeds=256, embed_dim=1152),
    tie_embeddings=True,
    rope_theta=1e4,
    max_position=8192,
    source="arXiv:2407.07726; hf",
)
