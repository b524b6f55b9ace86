"""Decoder stack for the ``dense`` layer kind: pre-norm attention + SwiGLU
MLP, residual adds — ``repro.models.transformer`` with the ``lax.scan``
over stacked layers written as a Python loop over ``nn.Module`` layers.

Two modes share one loop: forward (no cache, the full-recompute oracle)
and paged decode/span (one pooled K/V leaf per layer, updated in place).
"""
from __future__ import annotations

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


def apply_layer(layer: DenseLayer, x, cfg, *, positions, pool=None, index=None,
                block_tables=None, row_len=None):
    h = rmsnorm(layer.ln1.scale, x, cfg.norm_eps)
    x = x + attention_block(layer.attn, h, cfg, positions=positions, pool=pool,
                            index=index, block_tables=block_tables,
                            row_len=row_len)
    h = rmsnorm(layer.ln2.scale, x, cfg.norm_eps)
    return x + apply_mlp(layer.mlp, h, cfg.act)


def apply_stack(layers, x, cfg, *, positions, pool=None, index=None,
                block_tables=None, row_len=None):
    """Run every layer.  With ``pool`` ({"k", "v"} stacked [L, NB, bs,
    Hkv, D]) layer ``l`` reads and writes ``pool[leaf][l]``."""
    for i, layer in enumerate(layers):
        lp = None if pool is None else {name: t[i] for name, t in pool.items()}
        x = apply_layer(layer, x, cfg, positions=positions, pool=lp,
                        index=index, block_tables=block_tables, row_len=row_len)
    return x


def stack_paged_cache_spec(cfg, num_blocks: int, block_size: int, dtype):
    """Pool leaves of the whole stack: {"k", "v"} -> (shape, dtype), shape
    ``[layers, num_blocks, block_size, Hkv, D]``."""
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}
