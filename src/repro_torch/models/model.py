"""Model facade: ``build_model(cfg, device=...)`` -> :class:`DecoderLM`.

The port's slices are the dense decoder (granite, yi, codeqwen,
mistral-large), the moe family (deepseek-moe, mixtral: the dense
attention with a mixture-of-experts FFN), the ssm family (mamba2), the
hybrid family (recurrentgemma: RG-LRU layers beside local-attention
layers, their K/V pooled and their recurrent state slot-indexed) and the
vlm family (internvl2: the dense decoder over projected patch embeddings
concatenated before the text tokens); encdec raises
``NotImplementedError``.  Weights are
drawn from a seeded ``torch.Generator`` on the target device
(:mod:`repro_torch.models.params`), or loaded from the JAX package's tree
with ``model.load_state_dict(convert.params_from_jax(tree))``.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as params_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import (RMSNorm, dense, embed_tokens,
                                       lm_logits, rmsnorm)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must really be there — a
    caller that wants the CPU says so, nothing drops to it silently."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                f"pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:  # "cuda" means the current card, by index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DecoderLM(nn.Module):
    """Decoder-only LM: embedding (a vlm's projected patches before it),
    ``num_layers`` dense, moe, ssm or hybrid layers in the JAX run order,
    final RMSNorm, LM head over the padded vocab."""

    def __init__(self, cfg: ModelConfig, *, device, seed: int = 0):
        super().__init__()
        params_mod.check_family(cfg)
        self.cfg = cfg
        self.dtype = params_mod.torch_dtype(cfg.dtype)
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        decls = params_mod.decl_tree(cfg)

        def init(d, shape=None):
            return params_mod.init_leaf(d, d.shape if shape is None else shape,
                                        self.dtype, gen, device)

        emb = decls["embed"]
        self.embedding = nn.Parameter(init(emb["embedding"]), requires_grad=False)
        self.lm_head = (nn.Parameter(init(emb["lm_head"]), requires_grad=False)
                        if "lm_head" in emb else None)
        layers = []
        for kind, stack, sub in params_mod.layer_plan(cfg):
            tree = decls["stack"][stack]
            layers.append(_build_layer(kind, tree if sub is None else tree[sub],
                                       init))
        self.layers = nn.ModuleList(layers)
        self.final_norm = RMSNorm(init(decls["final_norm"]["scale"]))
        if cfg.family == "vlm":
            vp = decls["vision_proj"]
            self.vision_proj = nn.ParameterDict({
                k: nn.Parameter(init(d), requires_grad=False)
                for k, d in vp.items()})
        else:
            self.vision_proj = None

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def serving_view(self, cfg: ModelConfig) -> "DecoderLM":
        """These weights run under ``cfg``, which may differ from the
        model's own config only in how it is served (``kv_dtype``,
        ``kernel_mode``, and a moe layer's ``capacity_factor`` and
        ``moe_impl``): a shallow copy sharing every parameter, so one
        model object serves native and quantized pools, kernel and plain
        paths, and any expert capacity alike."""
        if cfg == self.cfg:
            return self
        if self.cfg.replace(kv_dtype=cfg.kv_dtype, kernel_mode=cfg.kernel_mode,
                            capacity_factor=cfg.capacity_factor,
                            moe_impl=cfg.moe_impl) != cfg:
            raise ValueError("the engine's config differs from the model's "
                             "beyond kv_dtype, kernel_mode, capacity_factor "
                             "and moe_impl")
        view = copy.copy(self)
        view.cfg = cfg
        return view

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ------------------------------------------------------------------
    def _head(self):
        return self.embedding.t() if self.lm_head is None else self.lm_head

    def _logits(self, x):
        x = rmsnorm(self.final_norm.scale, x, self.cfg.norm_eps)
        logits = lm_logits(self._head(), x, self.cfg.vocab_size)
        if self.cfg.logit_softcap:
            c = self.cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    def _embed_inputs(self, tokens, patch_embeds=None):
        """Token embeddings; a vlm's ``patch_embeds`` [B, P, vision_dim]
        go through ``vision_proj`` and are concatenated BEFORE the tokens
        (JAX ``DecoderLM._embed_inputs``), so text position i sits at
        P + i."""
        x = embed_tokens(self.embedding, tokens, self.dtype)
        if self.cfg.family != "vlm":
            return x
        if patch_embeds is None:
            raise ValueError(f"{self.cfg.name!r} (vlm) needs patch_embeds "
                             f"[B, {self.cfg.num_patches}, "
                             f"{self.cfg.vision_dim}]")
        vp = self.vision_proj
        patches = dense(vp["w"], patch_embeds.to(self.dtype), vp["b"])
        return torch.cat([patches, x], dim=1)

    def forward(self, tokens, patch_embeds=None, with_aux: bool = False):
        """tokens [B, S] (a vlm: and ``patch_embeds`` [B, P, vision_dim])
        -> float32 logits [B, P + S, V_padded]; causal self-attention (or
        the ssm / RG-LRU scan) over the whole sequence, no cache.
        ``with_aux`` returns (logits, aux) instead, aux the moe
        load-balance loss summed over the layers (0 for other families),
        as the JAX ``forward``'s third output."""
        x = self._embed_inputs(tokens, patch_embeds)
        positions = torch.arange(x.shape[1], device=tokens.device)
        x, _, aux = tf_mod.apply_stack(self.layers, x, self.cfg,
                                       positions=positions)
        if with_aux:
            return self._logits(x), torch.as_tensor(
                aux, dtype=torch.float32, device=x.device)
        return self._logits(x)

    def prefill(self, tokens, max_len: int | None = None, ring: bool = True,
                patch_embeds=None):
        """tokens [B, S] (a vlm: and ``patch_embeds``, P positions before
        the tokens) -> (caches, last logits [B, V_padded]).  Attention
        layers give {"k", "v"} [A, B, C, Hkv, D]: ``max_len`` sets the
        cache capacity C (default P + S; a sliding window caps it,
        ring-arranged); ``ring=False`` keeps full-length K/V under a window
        (paged prefill: the pool stores absolute positions and masks the
        window).  ssm layers give their decode state {"ssm", "conv_x",
        "conv_b", "conv_c"}, rec layers {"lru", "conv"}, each [L_kind, B,
        ...]; a hybrid returns both kinds."""
        x = self._embed_inputs(tokens, patch_embeds)
        positions = torch.arange(x.shape[1], device=tokens.device)
        x, caches, _ = tf_mod.apply_stack(self.layers, x, self.cfg,
                                          positions=positions, mode="prefill",
                                          cache_len=max_len, ring=ring)
        return caches, self._logits(x[:, -1:])[:, 0]

    def prefill_chunk(self, tokens, prefix, start: int):
        """Tail prefill after a prefix-cache hit: only ``tokens`` [B, S]
        (positions ``start .. start+S-1``) run through the stack; ``prefix``
        holds the gathered K/V of positions [0, start), {"k", "v"}
        [L, B, start, Hkv, D].  -> (tail caches [L, B, S, Hkv, D], last
        logits [B, V_padded]).  Attention stacks only."""
        self._attention_only("prefill_chunk")
        x = embed_tokens(self.embedding, tokens, self.dtype)
        positions = torch.arange(start, start + tokens.shape[1],
                                 device=tokens.device)
        x, tail, _ = tf_mod.apply_stack(self.layers, x, self.cfg,
                                        positions=positions, caches=prefix,
                                        mode="decode")
        return tail, self._logits(x[:, -1:])[:, 0]

    def decode_step(self, caches, tokens, index, block_tables=None):
        """One token per row: tokens [B]; index = the token's absolute
        position, [B] or (contiguous caches only) 0-d for a lockstep batch.
        With ``block_tables`` [B, W] int32 ``caches`` is the paged pool,
        else the contiguous caches {"k", "v"} [L, B, C, Hkv, D]; an ssm
        stack takes its slot-indexed state [L, B, ...] and no tables.
        Writes each token's K/V (advances the state) in place; returns
        logits [B, V_padded]."""
        x = embed_tokens(self.embedding, tokens[:, None], self.dtype)
        positions = index[:, None] if index.dim() else index.reshape(1)
        x, _, _ = tf_mod.apply_stack(self.layers, x, self.cfg,
                                     positions=positions, caches=caches,
                                     index=index, block_tables=block_tables,
                                     mode="decode")
        return self._logits(x)[:, 0]

    def span_step(self, pool, tokens, row_start, row_len, block_tables):
        """Per-row query spans through the pool: tokens [B, Q]; row ``b``
        holds ``row_len[b]`` valid tokens at ``row_start[b] + j`` (padding
        columns scatter into the NULL block and give garbage logits).
        Writes the spans' K/V in place; returns logits [B, Q, V_padded].
        Attention stacks only (a recurrent state cannot resume a chunk)."""
        self._attention_only("span_step")
        x = embed_tokens(self.embedding, tokens, self.dtype)
        positions = row_start[:, None] + torch.arange(
            tokens.shape[1], dtype=row_start.dtype, device=tokens.device)[None]
        x, _, _ = tf_mod.apply_stack(self.layers, x, self.cfg,
                                     positions=positions, caches=pool,
                                     index=row_start,
                                     block_tables=block_tables,
                                     row_len=row_len, mode="decode")
        return self._logits(x)

    def chunk_resumable(self) -> bool:
        """A token-only attention stack (JAX asserts ``family in ("dense",
        "moe")``), every cache leaf pooled: a prompt may resume mid-way
        from pooled K/V (chunked prefill, prefix reuse, span rows).  A
        recurrent state cannot, and vlm patches sit off the token grid."""
        return self.cfg.family in ("dense", "moe") and self.fully_paged()

    def _attention_only(self, what: str):
        """The chunk-resumable paths refuse every other stack."""
        if not self.chunk_resumable():
            raise ValueError(f"{what} needs an attention-only stack; "
                             f"{self.cfg.name!r} is family "
                             f"{self.cfg.family!r}")

    # ------------------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int):
        """Contiguous (ring under a sliding window) caches of ``batch``
        rows, as :meth:`prefill` builds them: name -> (shape, dtype).
        Attention stacks only."""
        self._attention_only("cache_specs")
        return tf_mod.stack_cache_spec(self.cfg, batch, max_len, self.dtype)

    def paged_cache_specs(self, num_slots: int, num_blocks: int, block_size: int):
        """The engine's cache leaves: name -> (shape, dtype).  Attention
        layers: {"k", "v"} [A, NB, bs, Hkv, D], plus {"k_scale",
        "v_scale"} [A, NB, bs, Hkv] f32 for a quantized pool, pooled.
        ssm / rec layers: their decode state [L_kind, num_slots, ...],
        slot-indexed.  A hybrid holds both (``fully_paged()`` False)."""
        spec = tf_mod.stack_state_spec(self.cfg, num_slots, self.dtype)
        if tf_mod.num_attention_layers(self.cfg):
            spec.update(tf_mod.stack_paged_cache_spec(
                self.cfg, num_blocks, block_size, self.dtype))
        return spec

    def paged_leaf_mask(self) -> dict[str, bool]:
        """name -> True where the cache leaf is block-pooled."""
        return {n: tf_mod.leaf_kind(n) == "attn"
                for n in self.paged_cache_specs(1, 1, 1)}

    def fully_paged(self) -> bool:
        """Every cache leaf is pooled: the precondition for prefix reuse."""
        return all(self.paged_leaf_mask().values())


def _build_layer(kind: str, units: dict, init):
    """One layer of ``kind`` from its layers-stacked decl subtree, each
    tensor drawn as one layer's slice of the stacked decl (the JAX init
    scales)."""
    def one(d):
        return init(d, d.shape[1:])

    def proj(tree):  # a dense's w (its bias, if any, is taken separately)
        return {k: one(v["w"]) for k, v in tree.items()}

    if kind == "ssm":
        # one tensor per entry: a decl, a norm's scale, a dense's w
        return tf_mod.SSMLayer({
            k: one(v if isinstance(v, params_mod.ParamDecl)
                   else next(iter(v.values())))
            for k, v in units["mamba"].items()})
    if kind == "rec":
        ln1, ln2 = one(units["ln1"]["scale"]), one(units["ln2"]["scale"])
        rec = {k: one(v["w"] if isinstance(v, dict) else v)
               for k, v in units["rec"].items()}
        return tf_mod.RecLayer(ln1, rec, ln2, proj(units["mlp"]))
    a = units["attn"]
    attn = proj(a)
    for n in "qkv":
        if "b" in a[f"w{n}"]:
            attn[f"b{n}"] = one(a[f"w{n}"]["b"])
    ln1, ln2 = one(units["ln1"]["scale"]), one(units["ln2"]["scale"])
    if kind == "moe":
        m = units["moe"]
        moe = {"router": one(m["router"]["w"])}
        moe.update({k: one(d) for k, d in m["experts"].items()})
        for k, v in m.get("shared", {}).items():
            moe[f"shared_{k}"] = one(v["w"])
        return tf_mod.MoELayer(ln1, attn, ln2, moe)
    return tf_mod.DenseLayer(ln1, attn, ln2, proj(units["mlp"]))


def build_model(cfg: ModelConfig, *, device="cuda", seed: int = 0) -> DecoderLM:
    """A randomly initialised :class:`DecoderLM` on ``device`` (CUDA unless
    the caller asks for the CPU)."""
    return DecoderLM(cfg, device=resolve_device(device), seed=seed)
