"""Grouped-query attention block for the dense decoder: the train/forward
path (naive causal/window attention, no cache) and the two paged serve
paths — single-token decode and per-row query spans — over the pooled
``[NB, bs, Hkv, D]`` K/V leaves, mirroring ``repro.models.attention``.

Pool writes happen in place (see :mod:`repro_torch.models.cache_utils`).
Each paged call asks :func:`repro_torch.kernels.attention.dispatch.resolve`
which backend runs: the CUDA kernels through the ops wrappers, or their
plain torch versions.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.attention import dispatch as kdispatch
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.kernels.attention import paged
from repro_torch.models import cache_utils
from repro_torch.models.layers import dense, rope


class Attention(nn.Module):
    """Projections of one attention layer, in the JAX ``[in, out...]``
    layout: wq [d, Hq, hd], wk/wv [d, Hkv, hd], wo [Hq, hd, d]."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        for name in ("bq", "bk", "bv"):
            if name not in tensors:
                setattr(self, name, None)


def _out_proj(attn: Attention, o):
    b, s, hq, hd = o.shape
    w = attn.wo.to(o.dtype).reshape(hq * hd, -1)
    return torch.matmul(o.reshape(b, s, hq * hd), w)


def attention_block(attn: Attention, x, cfg, *, positions, pool=None,
                    index=None, block_tables=None, row_len=None):
    """Returns y.

    * forward (``pool is None``): causal self-attention over x at
      ``positions`` [S]; no cache.
    * paged decode (``row_len is None``): x holds one token per slot at
      absolute position ``index`` [B]; its K/V is written into the pool
      through ``block_tables`` [B, W], then it attends its table.
    * paged span (``row_len`` [B] given): row ``b`` of x holds
      ``row_len[b]`` valid tokens at ``index[b] + j``; the span's K/V is
      scattered first (padding -> NULL block), then every query attends
      its row's table causally at absolute positions.

    ``pool`` is one layer's {"k", "v"} [NB, bs, Hkv, D], updated in place.
    """
    window = cfg.attention_window
    q = dense(attn.wq, x, attn.bq)
    k = dense(attn.wk, x, attn.bk)
    v = dense(attn.wv, x, attn.bv)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if pool is None:
        o = paged.masked_attention(q, k, v, positions, positions, window=window)
    elif row_len is None:
        o = _paged_decode_attend(q, k, v, pool, index, block_tables, window, cfg)
    else:
        o = _paged_span_attend(q, k, v, pool, index, row_len, block_tables,
                               window, cfg)
    return _out_proj(attn, o)


def _decide(variant, q, cfg):
    return kdispatch.resolve(kdispatch.mode_from(cfg), variant,
                             head_dim=q.shape[-1], dtype=str(q.dtype),
                             platform=q.device.type)


def _paged_decode_attend(q, k_new, v_new, pool, index, block_tables, window, cfg):
    """Single-token decode against the pool: write at
    ``table[b, index // bs]`` offset ``index % bs``, then attend.  Retired
    or masked slots point at the NULL block, absorbing their writes."""
    cache_utils.paged_cache_write(pool["k"], pool["v"], k_new, v_new,
                                  block_tables, index)
    if _decide("paged_decode", q, cfg).backend == "cuda":
        return att_ops.paged_attention(pool, q, block_tables, index,
                                       window=window)
    return paged.paged_decode_plain(q, pool["k"], pool["v"], block_tables,
                                    index, window=window)


def _paged_span_attend(q, k_new, v_new, pool, row_start, row_len,
                       block_tables, window, cfg):
    """Per-row query spans against the pool: scatter the span's K/V into
    its blocks FIRST (padding columns into the NULL block), then attend —
    intra-chunk causality needs no special case because chunk tokens sit
    at their final pool positions before the read."""
    cache_utils.paged_span_write(pool["k"], pool["v"], k_new, v_new,
                                 block_tables, row_start, row_len)
    if _decide("paged_span", q, cfg).backend == "cuda":
        return att_ops.paged_span_attention(pool, q, block_tables, row_start,
                                            row_len, window=window)
    return paged.paged_span_plain(q, pool["k"], pool["v"], block_tables,
                                  row_start, row_len, window=window)
