"""mamba2-370m [ssm]: 48L d_model=1024, attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality), arXiv:2405.21060.  d_inner = 2*1024 = 2048,
headdim 64 -> 32 SSD heads, ngroups 1, chunk 256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    use_rope=False,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_groups=1,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
    remat="full",
    microbatches={"train_4k": 2},
)
