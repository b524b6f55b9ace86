"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400,
MoE 2 shared + 64 routed top-6 (fine-grained).  arXiv:2401.06066.

64 experts divide the 16-way "model" axis -> true expert parallelism
(4 experts per model shard).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102_400,
    rope_theta=10_000.0,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    capacity_factor=1.25,
    moe_impl="einsum",
    act="silu",
    remat="full",
    attn_block_kv=1024,
    microbatches={"train_4k": 2},
)
