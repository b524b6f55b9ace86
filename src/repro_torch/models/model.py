"""Model facade: ``build_model(cfg, device=...)`` -> :class:`DecoderLM`.

The port's slice is the dense decoder (granite, yi, codeqwen,
mistral-large); other families raise ``NotImplementedError``.  Weights are
drawn from a seeded ``torch.Generator`` on the target device
(:mod:`repro_torch.models.params`), or loaded from the JAX package's tree
with ``model.load_state_dict(convert.params_from_jax(tree))``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as params_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import embed_tokens, lm_logits, rmsnorm
from repro_torch.models.transformer import RMSNorm


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
    """Dense decoder-only LM: embedding, ``num_layers`` dense units,
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

        def layer_slice(tree):
            return {k: init(d, d.shape[1:]) for k, d in tree.items()}

        emb = decls["embed"]
        self.embedding = nn.Parameter(init(emb["embedding"]), requires_grad=False)
        self.lm_head = (nn.Parameter(init(emb["lm_head"]), requires_grad=False)
                        if "lm_head" in emb else None)
        units = decls["stack"]["units"]
        layers = []
        for _ in range(cfg.num_layers):
            a = units["attn"]
            attn = {f"w{n}": init(a[f"w{n}"]["w"], a[f"w{n}"]["w"].shape[1:])
                    for n in "qkvo"}
            for n in "qkv":
                if "b" in a[f"w{n}"]:
                    attn[f"b{n}"] = init(a[f"w{n}"]["b"], a[f"w{n}"]["b"].shape[1:])
            mlp = {k: init(v["w"], v["w"].shape[1:])
                   for k, v in units["mlp"].items()}
            ln = layer_slice({"ln1": units["ln1"]["scale"],
                              "ln2": units["ln2"]["scale"]})
            layers.append(tf_mod.DenseLayer(ln["ln1"], attn, ln["ln2"], mlp))
        self.layers = nn.ModuleList(layers)
        self.final_norm = RMSNorm(init(decls["final_norm"]["scale"]))

    @property
    def device(self) -> torch.device:
        return self.embedding.device

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

    def forward(self, tokens):
        """tokens [B, S] -> float32 logits [B, S, V_padded]; causal
        self-attention over the whole sequence, no cache."""
        x = embed_tokens(self.embedding, tokens, self.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x, _ = tf_mod.apply_stack(self.layers, x, self.cfg, positions=positions)
        return self._logits(x)

    def prefill(self, tokens, max_len: int | None = None, ring: bool = True):
        """tokens [B, S] -> (caches {"k", "v"} [L, B, C, Hkv, D], last
        logits [B, V_padded]).  ``max_len`` sets the cache capacity C
        (default S; a sliding window caps it, ring-arranged); ``ring=False``
        keeps full-length K/V under a window (paged prefill: the pool
        stores absolute positions and masks the window)."""
        x = embed_tokens(self.embedding, tokens, self.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x, caches = tf_mod.apply_stack(self.layers, x, self.cfg,
                                       positions=positions, mode="prefill",
                                       cache_len=max_len, ring=ring)
        return caches, self._logits(x[:, -1:])[:, 0]

    def prefill_chunk(self, tokens, prefix, start: int):
        """Tail prefill after a prefix-cache hit: only ``tokens`` [B, S]
        (positions ``start .. start+S-1``) run through the stack; ``prefix``
        holds the gathered K/V of positions [0, start), {"k", "v"}
        [L, B, start, Hkv, D].  -> (tail caches [L, B, S, Hkv, D], last
        logits [B, V_padded])."""
        x = embed_tokens(self.embedding, tokens, self.dtype)
        positions = torch.arange(start, start + tokens.shape[1],
                                 device=tokens.device)
        x, tail = tf_mod.apply_stack(self.layers, x, self.cfg,
                                     positions=positions, caches=prefix,
                                     mode="decode")
        return tail, self._logits(x[:, -1:])[:, 0]

    def decode_step(self, caches, tokens, index, block_tables=None):
        """One token per row: tokens [B]; index = the token's absolute
        position, [B] or (contiguous caches only) 0-d for a lockstep batch.
        With ``block_tables`` [B, W] int32 ``caches`` is the paged pool,
        else the contiguous caches {"k", "v"} [L, B, C, Hkv, D].  Writes
        each token's K/V in place; returns logits [B, V_padded]."""
        x = embed_tokens(self.embedding, tokens[:, None], self.dtype)
        positions = index[:, None] if index.dim() else index.reshape(1)
        x, _ = tf_mod.apply_stack(self.layers, x, self.cfg, positions=positions,
                                  caches=caches, index=index,
                                  block_tables=block_tables, mode="decode")
        return self._logits(x)[:, 0]

    def span_step(self, pool, tokens, row_start, row_len, block_tables):
        """Per-row query spans through the pool: tokens [B, Q]; row ``b``
        holds ``row_len[b]`` valid tokens at ``row_start[b] + j`` (padding
        columns scatter into the NULL block and give garbage logits).
        Writes the spans' K/V in place; returns logits [B, Q, V_padded]."""
        x = embed_tokens(self.embedding, tokens, self.dtype)
        positions = row_start[:, None] + torch.arange(
            tokens.shape[1], dtype=row_start.dtype, device=tokens.device)[None]
        x, _ = tf_mod.apply_stack(self.layers, x, self.cfg, positions=positions,
                                  caches=pool, index=row_start,
                                  block_tables=block_tables, row_len=row_len,
                                  mode="decode")
        return self._logits(x)

    # ------------------------------------------------------------------
    def paged_cache_specs(self, num_slots: int, num_blocks: int, block_size: int):
        """{"k", "v"} -> (shape [L, NB, bs, Hkv, D], dtype): every cache
        leaf of the dense stack is pooled (``num_slots`` holds no state)."""
        return tf_mod.stack_paged_cache_spec(self.cfg, num_blocks, block_size,
                                             self.dtype)

    def fully_paged(self) -> bool:
        """Every cache leaf is pooled: the precondition for prefix reuse."""
        return True


def build_model(cfg: ModelConfig, *, device="cuda", seed: int = 0) -> DecoderLM:
    """A randomly initialised :class:`DecoderLM` on ``device`` (CUDA unless
    the caller asks for the CPU)."""
    return DecoderLM(cfg, device=resolve_device(device), seed=seed)
