"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000.  Griffin: RG-LRU + local attention, (rec, rec, attn) pattern.
arXiv:2402.19427.

38 layers = 12 x (rec,rec,attn) super-blocks + 2 tail rec layers.
Local-attention window 2048 + O(1) recurrent state -> ``long_500k`` runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    rope_theta=10_000.0,
    attention_window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    conv_width=4,
    act="gelu",
    gated_mlp=True,
    logit_softcap=30.0,
    tie_embeddings=True,
    remat="full",
    attn_block_kv=1024,
    microbatches={"train_4k": 4},
)
