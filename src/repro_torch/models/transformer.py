"""Decoder stack for the ``dense`` layer kind: pre-norm attention + SwiGLU
MLP, residual adds — ``repro.models.transformer`` with the ``lax.scan``
over stacked layers written as a Python loop over ``nn.Module`` layers.

One loop serves every mode: forward (no cache, the full-recompute
oracle), prefill (returns each layer's fresh K/V), tail prefill after a
prefix hit (returns the tail's K/V), contiguous decode and paged
decode/span (caches updated in place).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention, attention_block
from repro_torch.models.layers import apply_mlp, rmsnorm


class MLP(nn.Module):
    def __init__(self, tensors: dict):
        super().__init__()
        for name in ("w_up", "w_gate", "w_down"):
            t = tensors.get(name)
            if t is None:
                setattr(self, name, None)
            else:
                self.register_parameter(name, nn.Parameter(t, requires_grad=False))


class RMSNorm(nn.Module):
    def __init__(self, scale):
        super().__init__()
        self.scale = nn.Parameter(scale, requires_grad=False)


class DenseLayer(nn.Module):
    """One ``dense`` unit: ln1 -> attention -> residual, ln2 -> MLP ->
    residual."""

    def __init__(self, ln1, attn: dict, ln2, mlp: dict):
        super().__init__()
        self.ln1 = RMSNorm(ln1)
        self.attn = Attention(attn)
        self.ln2 = RMSNorm(ln2)
        self.mlp = MLP(mlp)


def apply_layer(layer: DenseLayer, x, cfg, *, positions, cache=None,
                index=None, block_tables=None, row_len=None, build_cache=False,
                cache_len=None, ring=True):
    """-> (x, new_cache) — see :func:`attention_block` for the cache modes."""
    h = rmsnorm(layer.ln1.scale, x, cfg.norm_eps)
    y, new_cache = attention_block(
        layer.attn, h, cfg, positions=positions, cache=cache, index=index,
        block_tables=block_tables, row_len=row_len, build_cache=build_cache,
        cache_len=cache_len, ring=ring)
    x = x + y
    h = rmsnorm(layer.ln2.scale, x, cfg.norm_eps)
    return x + apply_mlp(layer.mlp, h, cfg.act), new_cache


def apply_stack(layers, x, cfg, *, positions, caches=None, index=None,
                block_tables=None, row_len=None, mode="forward",
                cache_len=None, ring=True):
    """Run every layer; returns (x, new_caches).

    ``mode``: "forward" (no caches; new_caches None), "prefill" (new_caches
    = each layer's fresh K/V stacked: {"k", "v"} [L, B, C, Hkv, D];
    ``ring=False`` keeps full-length K/V under a sliding window, for the
    paged pool) or "decode".  In decode mode ``caches`` holds stacked
    leaves [L, ...] and layer ``l`` reads ``caches[leaf][l]``:

    * paged pool [L, NB, bs, Hkv, D] with ``block_tables`` (and
      ``row_len`` for spans), or contiguous caches [L, B, C, Hkv, D]
      without: written in place, new_caches None;
    * ``index is None``: tail prefill against a gathered prefix
      [L, B, P, Hkv, D]; new_caches = the tail's K/V [L, B, S, Hkv, D].
    """
    if mode not in ("forward", "prefill", "decode"):
        raise ValueError(f"apply_stack mode {mode!r}")
    outs = []
    for i, layer in enumerate(layers):
        lc = None if caches is None else {n: t[i] for n, t in caches.items()}
        x, c = apply_layer(layer, x, cfg, positions=positions, cache=lc,
                           index=index, block_tables=block_tables,
                           row_len=row_len, build_cache=mode == "prefill",
                           cache_len=cache_len, ring=ring)
        if c is not None:
            outs.append(c)
    if not outs:
        return x, None
    return x, {n: torch.stack([c[n] for c in outs]) for n in outs[0]}


def stack_paged_cache_spec(cfg, num_blocks: int, block_size: int, dtype):
    """Pool leaves of the whole stack: {"k", "v"} -> (shape, dtype), shape
    ``[layers, num_blocks, block_size, Hkv, D]``."""
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}
