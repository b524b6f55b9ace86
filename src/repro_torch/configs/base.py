"""Config system: model configs, input-shape specs, mesh/train configs.

Every assigned architecture gets one ``configs/<id>.py`` exporting
``CONFIG: ModelConfig``.  The registry (``configs/__init__.py``) resolves
``--arch <id>`` strings.  ``ShapeSpec`` describes the assigned input shapes
(train_4k / prefill_32k / decode_32k / long_500k) and which lowering entry
point (train_step vs prefill vs serve_step) they exercise.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    attention_window: int | None = None  # sliding-window attention (SWA)
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    use_rope: bool = True
    causal: bool = True
    gated_mlp: bool = True  # SwiGLU/GeGLU vs plain 2-matrix MLP
    act: str = "silu"
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    logit_softcap: float | None = None

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (fine-grained MoE)
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"  # einsum (GShard dispatch) | sort (dropless-ish)
    moe_group: int = 512  # GShard dispatch group size (tokens)
    router_aux_coef: float = 0.01

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4

    # --- hybrid (griffin / RG-LRU) ---
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend output length (whisper: 1500 frames)

    # --- VLM stub ---
    num_patches: int = 0  # precomputed patch embeddings prepended to text
    vision_dim: int = 0  # ViT output dim (stub); projector maps -> d_model

    # --- numerics / memory policy ---
    dtype: str = "bfloat16"
    accum_dtype: str = "float32"  # matmul partial-sum / TP-psum dtype
                                  # ("bfloat16" halves row-parallel all-reduces)
    decode_embed_lookup: str = "take"  # "onehot": one-hot matmul against the
                                       # vocab-sharded table (tiny psum instead
                                       # of gathering the whole table)
    prefer_full_dp: bool = False  # shard batch over the model axis too (for
                                  # archs whose attention cannot TP-shard)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: str = "full"  # none | dots | full
    attn_block_kv: int = 0  # 0 = naive attention; >0 = online-softmax KV blocking
    seq_shard_residual: bool = False  # Megatron-style sequence-sharded residuals
    # ONE knob for the attention-kernel family (kernels/attention/); the
    # names are kept from the JAX package so configs stay interchangeable:
    #   auto   - the hand-written CUDA kernels for CUDA tensors, the plain
    #            torch path for CPU tensors
    #   pallas - the CUDA kernels (a CPU tensor still takes the plain path)
    #   xla    - always the plain torch gather/softmax path
    # REPRO_KERNEL_MODE overrides at runtime (see dispatch.mode_from).
    kernel_mode: str = "auto"
    # KV block-pool storage dtype (serve paged cache only):
    #   fp16 - native: pool leaves keep the model dtype (the unquantized
    #          baseline; bit-identical to the pre-quantization engines)
    #   int8 - symmetric int8 with per-(position, kv-head) f32 scales
    #          carried as sibling k_scale/v_scale pool leaves
    #   fp8  - float8_e4m3fn storage, same scale layout
    # Dequant is fused into the paged/span gather on both kernel paths
    # (see core/quant.py and docs/paged_cache.md).
    kv_dtype: str = "fp16"
    # Communication/compute overlap for the sharded serve step
    # (sharding/overlap.py): micro-batched span pipeline + two-deep host
    # dispatch queue.  auto = on when the model mesh axis shards anything,
    # off otherwise; the serve CLI's --overlap flag overrides this.
    comm_overlap: str = "auto"
    # DEPRECATED: both map onto kernel_mode="pallas" in __post_init__.
    use_flash_kernel: bool = False
    use_paged_kernel: bool = False

    # --- training defaults (per-arch tuned; overridable) ---
    microbatches: dict[str, int] = dataclasses.field(
        default_factory=lambda: {"train_4k": 1}
    )

    def __post_init__(self):
        if self.kernel_mode not in ("auto", "pallas", "xla"):
            raise ValueError(
                f"kernel_mode {self.kernel_mode!r}: expected auto|pallas|xla")
        if self.kv_dtype not in ("fp16", "int8", "fp8"):
            raise ValueError(
                f"kv_dtype {self.kv_dtype!r}: expected fp16|int8|fp8")
        if self.comm_overlap not in ("auto", "on", "off"):
            raise ValueError(
                f"comm_overlap {self.comm_overlap!r}: expected auto|on|off")
        if self.kv_dtype != "fp16" and self.family == "encdec":
            # cross-attention K/V lives in slot-resident caches (fully_paged()
            # is False for enc-dec); quantizing only the self-attn pool would
            # split the dtype story mid-model, so gate it off explicitly.
            raise ValueError(
                "kv_dtype quantization is not supported for family='encdec' "
                "(cross-attention caches are not pooled); use kv_dtype='fp16'")
        if self.use_paged_kernel or self.use_flash_kernel:
            import warnings

            flag = "use_paged_kernel" if self.use_paged_kernel else "use_flash_kernel"
            warnings.warn(
                f"cfg.{flag} is deprecated and will be removed: it now maps "
                f"onto kernel_mode='pallas' (was kernel_mode="
                f"{self.kernel_mode!r}). Set kernel_mode instead.",
                DeprecationWarning, stacklevel=3,
            )
            object.__setattr__(self, "kernel_mode", "pallas")

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Rough parameter count (for MODEL_FLOPS = 6*N*D roofline accounting).
    # The precise count comes from the decl tree; this is a sanity check.
    # ------------------------------------------------------------------
    def approx_params(self) -> int:
        from repro_torch.models.params import param_count  # lazy, avoids cycle

        return param_count(self)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch x shape) cell is runnable, with the reason if not.

    ``long_500k`` needs sub-quadratic attention / bounded decode state:
    it runs for SSM, hybrid (RG-LRU + local attn) and SWA archs, and is
    skipped for pure full-attention archs (see DESIGN.md section 7).
    """
    if shape.name == "long_500k":
        bounded = (
            cfg.family in ("ssm", "hybrid")
            or cfg.attention_window is not None
        )
        if not bounded:
            return False, "pure full attention: 500k decode state unbounded/quadratic"
    return True, ""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    z_loss_coef: float = 1e-4
    seed: int = 0
    # distributed-optimization knobs
    grad_compression: str = "none"  # none | bf16 | int8_ef (error feedback)
    moment_dtype: str = "float32"  # bf16 halves Adam mu/nu memory
    microbatches: int = 1
    # fault tolerance
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    straggler_threshold: float = 2.0  # x median step time -> flagged


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps the architectural *shape* (family, GQA ratio, MoE topology,
    block pattern, enc-dec split) while shrinking width/depth/vocab.
    """
    kw: dict = dict(
        num_layers=min(cfg.num_layers, 2 if not cfg.block_pattern else len(cfg.block_pattern)),
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 4 // max(1, cfg.q_per_kv))),
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        remat="none",
        attn_block_kv=0,
        seq_shard_residual=False,
        dtype="float32",
    )
    if cfg.num_kv_heads == cfg.num_heads:
        kw["num_kv_heads"] = 4  # keep MHA archs MHA
    if cfg.num_experts:
        kw.update(
            num_experts=min(cfg.num_experts, 8),
            experts_per_token=min(cfg.experts_per_token, 2),
            moe_d_ff=64,
            # drop-free capacity (cf >= E/k) so prefill/decode token grouping
            # cannot change which tokens are processed -> exact equivalence
            # between teacher-forced forward and prefill+decode in tests
            capacity_factor=8.0,
        )
    if cfg.family == "ssm":
        kw.update(ssm_headdim=32, ssm_state=16, ssm_chunk=32, d_ff=0)
    if cfg.family == "hybrid":
        kw.update(lru_width=128, attention_window=16)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2, encoder_seq=24)
    if cfg.family == "vlm":
        kw.update(num_patches=8, vision_dim=64)
    if cfg.attention_window:
        kw.setdefault("attention_window", 16)
    kw.update(overrides)
    return cfg.replace(**kw)
