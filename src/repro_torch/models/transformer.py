"""Decoder stack for the ``dense`` layer kind (pre-norm attention + SwiGLU
MLP, residual adds), the ``moe`` kind (the same attention, then the
mixture-of-experts FFN of :mod:`repro_torch.models.moe` in place of the
MLP; its load-balance loss summed over the layers), the ``ssm`` kind
(a Mamba-2 unit, :mod:`repro_torch.models.ssm`) and the hybrid's ``rec``
kind (ln1 -> RG-LRU block -> residual, ln2 -> MLP -> residual;
:mod:`repro_torch.models.rglru`) beside its ``attn`` layers (a dense
layer under the config's local window) — ``repro.models.transformer``
with the ``lax.scan`` over stacked units written as a Python loop over
``nn.Module`` layers in the JAX run order (``params.layer_plan``).

One loop serves every mode: forward (no cache, the full-recompute
oracle), prefill (returns each layer's fresh K/V, or its ssm / rec
decode state), tail prefill after a prefix hit (returns the tail's K/V),
contiguous decode and paged decode/span (caches updated in place; an ssm
or rec layer's slot-indexed state likewise).  Cache leaves are stacked
by kind: attention layer ``a`` (the a-th attention layer in run order)
reads ``k``/``v``[a], rec layer ``r`` reads ``lru``/``conv``[r].
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import quant
from repro_torch.models.attention import Attention, attention_block
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru
from repro_torch.models import ssm
from repro_torch.models.layers import RMSNorm, apply_mlp, rmsnorm
from repro_torch.models.params import layer_plan


class MLP(nn.Module):
    def __init__(self, tensors: dict):
        super().__init__()
        for name in ("w_up", "w_gate", "w_down"):
            t = tensors.get(name)
            if t is None:
                setattr(self, name, None)
            else:
                self.register_parameter(name, nn.Parameter(t, requires_grad=False))


class DenseLayer(nn.Module):
    """One ``dense`` unit: ln1 -> attention -> residual, ln2 -> MLP ->
    residual."""

    def __init__(self, ln1, attn: dict, ln2, mlp: dict):
        super().__init__()
        self.ln1 = RMSNorm(ln1)
        self.attn = Attention(attn)
        self.ln2 = RMSNorm(ln2)
        self.mlp = MLP(mlp)


class MoELayer(nn.Module):
    """One ``moe`` unit: ln1 -> attention -> residual, ln2 -> MoE FFN ->
    residual."""

    def __init__(self, ln1, attn: dict, ln2, moe: dict):
        super().__init__()
        self.ln1 = RMSNorm(ln1)
        self.attn = Attention(attn)
        self.ln2 = RMSNorm(ln2)
        self.moe = moe_mod.MoE(moe)


class SSMLayer(nn.Module):
    """One ``ssm`` unit: ``{"mamba": ...}`` as the JAX ``layer_decl``."""

    def __init__(self, mamba: dict):
        super().__init__()
        self.mamba = ssm.Mamba2(mamba)


class RecLayer(nn.Module):
    """One hybrid ``rec`` layer: ln1 -> RG-LRU block -> residual, ln2 ->
    MLP -> residual (JAX ``transformer.apply_layer``)."""

    def __init__(self, ln1, rec: dict, ln2, mlp: dict):
        super().__init__()
        self.ln1 = RMSNorm(ln1)
        self.rec = rglru.GriffinRec(rec)
        self.ln2 = RMSNorm(ln2)
        self.mlp = MLP(mlp)


# decode-state leaves of the state-carrying kinds; every other cache leaf
# (k, v, k_scale, v_scale) belongs to the attention layers
STATE_LEAVES = {"ssm": ("ssm", "conv_x", "conv_b", "conv_c"),
                "rec": ("lru", "conv")}


def layer_kind(layer) -> str:
    """"ssm", "rec" or "attn": which cache leaves the layer reads."""
    if isinstance(layer, SSMLayer):
        return "ssm"
    return "rec" if isinstance(layer, RecLayer) else "attn"


def leaf_kind(name: str) -> str:
    return next((k for k, names in STATE_LEAVES.items() if name in names),
                "attn")


def apply_rec_layer(layer: RecLayer, x, cfg, *, state=None):
    """One rec layer -> (x, new_state); ``state`` given => S == 1 decode."""
    h = rmsnorm(layer.ln1.scale, x, cfg.norm_eps)
    y, new_state = rglru.griffin_rec_block(layer.rec, h, cfg, state=state)
    x = x + y
    h = rmsnorm(layer.ln2.scale, x, cfg.norm_eps)
    return x + apply_mlp(layer.mlp, h, cfg.act), new_state


def apply_layer(layer, x, cfg, *, positions, cache=None,
                index=None, block_tables=None, row_len=None, build_cache=False,
                cache_len=None, ring=True):
    """A dense or moe unit -> (x, new_cache, aux); aux is the moe load-
    balance loss (0.0 for a dense unit).  See :func:`attention_block` for
    the cache modes."""
    h = rmsnorm(layer.ln1.scale, x, cfg.norm_eps)
    y, new_cache = attention_block(
        layer.attn, h, cfg, positions=positions, cache=cache, index=index,
        block_tables=block_tables, row_len=row_len, build_cache=build_cache,
        cache_len=cache_len, ring=ring)
    x = x + y
    h = rmsnorm(layer.ln2.scale, x, cfg.norm_eps)
    if isinstance(layer, MoELayer):
        y, aux = moe_mod.moe_block(layer.moe, h, cfg)
        return x + y, new_cache, aux
    return x + apply_mlp(layer.mlp, h, cfg.act), new_cache, 0.0


def apply_stack(layers, x, cfg, *, positions, caches=None, index=None,
                block_tables=None, row_len=None, mode="forward",
                cache_len=None, ring=True):
    """Run every layer; returns (x, new_caches, aux) — aux the moe
    layers' load-balance loss summed over the stack (0.0 without one).

    ``mode``: "forward" (no caches; new_caches None), "prefill" (new_caches
    = each layer's fresh K/V stacked: {"k", "v"} [L, B, C, Hkv, D];
    ``ring=False`` keeps full-length K/V under a sliding window, for the
    paged pool, quantized with {"k_scale", "v_scale"} [L, B, C, Hkv] when
    ``cfg.kv_dtype`` is int8/fp8) or "decode".  In decode mode ``caches`` holds stacked
    leaves [L, ...] and layer ``l`` reads ``caches[leaf][l]``:

    * paged pool [L, NB, bs, Hkv, D] with ``block_tables`` (and
      ``row_len`` for spans), or contiguous caches [L, B, C, Hkv, D]
      without: written in place, new_caches None;
    * ``index is None``: tail prefill against a gathered prefix
      [L, B, P, Hkv, D] (+ scales [L, B, P, Hkv] from a quantized pool);
      new_caches = the tail's K/V [L, B, S, Hkv, D], quantized like the
      prefix.

    ssm and rec layers ignore positions, index and tables: prefill
    returns their decode state ({"ssm", "conv_x", "conv_b", "conv_c"} or
    {"lru", "conv"} [L_kind, B, ...]), decode advances the slot-indexed
    state ``caches`` [L_kind, B, ...] in place.  A hybrid stack's caches
    hold both kinds side by side, each leaf stacked over its own kind's
    layers (ordinal within the kind, in run order).
    """
    if mode not in ("forward", "prefill", "decode"):
        raise ValueError(f"apply_stack mode {mode!r}")
    outs = {"attn": [], "ssm": [], "rec": []}
    seen = dict.fromkeys(outs, 0)
    aux = 0.0
    for layer in layers:
        kind = layer_kind(layer)
        j = seen[kind]
        seen[kind] += 1
        lc = None if caches is None else {
            n: t[j] for n, t in caches.items() if leaf_kind(n) == kind}
        if kind != "attn":
            if kind == "ssm":
                x, c = ssm.apply_layer(layer.mamba, x, cfg, state=lc)
            else:
                x, c = apply_rec_layer(layer, x, cfg, state=lc)
            if lc is not None:  # decode: the new state replaces the old
                for n, t in c.items():
                    lc[n].copy_(t)
            elif mode == "prefill":
                outs[kind].append(c)
            continue
        x, c, a = apply_layer(layer, x, cfg, positions=positions, cache=lc,
                              index=index, block_tables=block_tables,
                              row_len=row_len, build_cache=mode == "prefill",
                              cache_len=cache_len, ring=ring)
        aux = aux + a
        if c is not None:
            outs[kind].append(c)
    new = {n: torch.stack([quant.raw(c[n]) for c in cs]).view(cs[0][n].dtype)
           for cs in outs.values() if cs for n in cs[0]}
    return x, new or None, aux


def num_attention_layers(cfg) -> int:
    """Layers that keep K/V: every layer, but for ssm (none) and the
    hybrid (its ``attn`` layers)."""
    return sum(kind in ("dense", "moe", "attn")
               for kind, *_ in layer_plan(cfg))


def stack_paged_cache_spec(cfg, num_blocks: int, block_size: int, dtype):
    """Pool leaves of the stack's attention layers: {"k", "v"} -> (shape,
    dtype), shape ``[attn layers, num_blocks, block_size, Hkv, D]``.  A quantized pool
    (``cfg.kv_dtype`` int8/fp8) stores the data leaves in the storage
    dtype and adds f32 ``k_scale``/``v_scale`` leaves
    ``[layers, num_blocks, block_size, Hkv]`` (one scale per position and
    kv head), as the JAX ``paged_cache_spec``."""
    shape = (num_attention_layers(cfg), num_blocks, block_size,
             cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_dtype == "fp16":
        return {"k": (shape, dtype), "v": (shape, dtype)}
    sd = quant.storage_dtype(cfg.kv_dtype)
    return {"k": (shape, sd), "v": (shape, sd),
            "k_scale": (shape[:-1], torch.float32),
            "v_scale": (shape[:-1], torch.float32)}


def stack_state_spec(cfg, num_slots: int, dtype):
    """Slot-indexed decode state of the stack's ssm or rec layers:
    name -> (shape, dtype), shape ``[layers of the kind, num_slots, ...]``
    (empty for a stack without such layers)."""
    kinds = [kind for kind, *_ in layer_plan(cfg)]
    spec = {}
    for kind, fn in (("ssm", ssm.mamba2_state_spec),
                     ("rec", rglru.griffin_rec_state_spec)):
        n = kinds.count(kind)
        if n:
            spec.update({name: ((n,) + shape, dt) for name, (shape, dt)
                         in fn(cfg, num_slots, dtype).items()})
    return spec


def stack_cache_spec(cfg, batch: int, max_len: int, dtype):
    """Contiguous caches of the stack's attention layers: {"k", "v"} ->
    (shape, dtype), shape ``[attn layers, batch, C, Hkv, D]`` with C =
    ``max_len``, or the window under a sliding window (a ring, as
    prefill builds it)."""
    c = max_len if cfg.attention_window is None else min(
        max_len, cfg.attention_window)
    shape = (num_attention_layers(cfg), batch, c, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}
