"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (kv=32, i.e. MHA) d_ff=13440
vocab=92416.  Qwen1.5 arch (QKV bias), hf:Qwen/CodeQwen1.5-7B.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13_440,
    vocab_size=92_416,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    act="silu",
    remat="full",
    attn_block_kv=1024,
    microbatches={"train_4k": 4},
)
