"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention.  arXiv:2401.04088.

Per the assignment spec this config keeps SWA (window 4096), which bounds the
decode KV cache and makes the ``long_500k`` cell runnable.  8 experts don't
divide the 16-way "model" axis, so experts are replicated with TP inside each
expert FFN ("expert_mlp" -> model), see sharding/partition.py.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=32_768,
    rope_theta=1_000_000.0,
    attention_window=4096,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=16_384,
    capacity_factor=1.25,
    moe_impl="einsum",
    act="silu",
    remat="full",
    attn_block_kv=1024,
    seq_shard_residual=True,
    microbatches={"train_4k": 8},
)
