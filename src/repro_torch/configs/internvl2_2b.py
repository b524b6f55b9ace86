"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.

InternViT + InternLM2, arXiv:2404.16821.  The ViT frontend is a STUB:
``input_specs`` provides precomputed patch embeddings [B, 1024, 1024-dim],
projected into the LM by a learned projector (the only vision param here).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_553,
    rope_theta=1_000_000.0,
    num_patches=1024,
    vision_dim=1024,
    act="silu",
    remat="full",
    attn_block_kv=1024,
    microbatches={"train_4k": 2},
)
