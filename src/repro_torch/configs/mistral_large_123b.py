"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  hf:mistralai/Mistral-Large-Instruct-2407.

Largest dense arch in the pool: FSDP ("data"-axis param sharding) is what
makes it fit 16 GB/chip; training uses full remat + microbatching.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=32_768,
    rope_theta=1_000_000.0,
    act="silu",
    remat="full",
    attn_block_kv=1024,
    seq_shard_residual=True,
    microbatches={"train_4k": 8},
)
