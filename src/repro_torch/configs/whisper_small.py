"""whisper-small [audio]: enc-dec, 12L each, d_model=768 12H d_ff=3072
vocab=51865.  arXiv:2212.04356.

Conv/mel frontend is a STUB: ``input_specs`` supplies 1500 precomputed frame
embeddings.  12 heads don't divide the 16-way model axis -> attention is
replicated and TP shards only the MLPs/vocab (see partition.py).  Decoder
positions are sinusoidal (real model: 448 learned positions — the assigned
32k decode shape exceeds that; approximation noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    use_rope=False,
    qkv_bias=True,
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    encoder_layers=12,
    encoder_seq=1500,
    remat="full",
    prefer_full_dp=True,
    attn_block_kv=1024,
    microbatches={"train_4k": 1},
)
