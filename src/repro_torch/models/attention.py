"""Grouped-query attention block for the dense decoder, mirroring
``repro.models.attention``: self-attention without a cache (forward and
prefill, dense flash kernel), tail prefill against a resident prefix
(prefix-cache hit), single-token decode against a contiguous full or ring
cache (the fixed-batch engine), and the two paged serve paths —
single-token decode and per-row query spans — over the pooled
``[NB, bs, Hkv, D]`` K/V leaves.

Cache writes happen in place (see :mod:`repro_torch.models.cache_utils`).
Each kernel call site asks
:func:`repro_torch.kernels.attention.dispatch.resolve` which backend runs:
the CUDA kernels through the ops wrappers, or their plain torch versions.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.attention import dispatch as kdispatch
from repro_torch.kernels.attention import flash
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


def attention_block(attn: Attention, x, cfg, *, positions, cache=None,
                    index=None, block_tables=None, row_len=None,
                    build_cache=False, cache_len=None, ring=True):
    """Returns (y, new_cache).

    * self-attention (``cache is None``): causal attention over x at
      positions ``0..S-1``.  With ``build_cache`` the layer's fresh
      {"k", "v"} cache is returned — capacity ``min(cache_len, window)``,
      ring-arranged; ``ring=False`` (paged prefill) keeps full-length K/V
      even under a sliding window.  Otherwise new_cache is None.
    * tail prefill (``cache`` given, ``index is None``): x is the tail of
      a prompt whose first ``P`` positions are in ``cache`` ({"k", "v"}
      [B, P, Hkv, D]); returns the tail's K/V only.
    * contiguous decode (``cache`` given, no ``block_tables``): one token
      per row at absolute position ``index`` (0-d or [B]); the cache
      [B, C, Hkv, D] is written in place (new_cache None).
    * paged decode (``block_tables`` given, ``row_len is None``): x holds
      one token per slot at absolute position ``index`` [B]; its K/V is
      written into the pool ``cache`` through ``block_tables`` [B, W],
      then it attends its table.
    * paged span (``row_len`` [B] given): row ``b`` of x holds
      ``row_len[b]`` valid tokens at ``index[b] + j``; the span's K/V is
      scattered first (padding -> NULL block), then every query attends
      its row's table causally at absolute positions.
    """
    window = cfg.attention_window
    q = dense(attn.wq, x, attn.bq)
    k = dense(attn.wk, x, attn.bk)
    v = dense(attn.wv, x, attn.bv)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    new_cache = None
    if cache is None:
        o = _dense_attend(q, k, v, 0, window, cfg)
        if build_cache:
            new_cache = _build_cache(k, v, window if ring else None, cache_len)
    elif index is None:
        o, new_cache = _chunk_attend(q, k, v, cache, window, cfg)
    elif block_tables is None:
        o = _decode_attend(q, k, v, cache, index, window)
    elif row_len is None:
        o = _paged_decode_attend(q, k, v, cache, index, block_tables, window,
                                 cfg)
    else:
        o = _paged_span_attend(q, k, v, cache, index, row_len, block_tables,
                               window, cfg)
    return _out_proj(attn, o), new_cache


def _decide(variant, q, cfg):
    return kdispatch.resolve(kdispatch.mode_from(cfg), variant,
                             head_dim=q.shape[-1], dtype=str(q.dtype),
                             platform=q.device.type)


def _dense_attend(q, k, v, q_offset: int, window, cfg):
    """Causal (windowed) attention of q at ``q_offset + i`` over k/v at
    ``0..Skv-1``.  Multi-query spans go through the dense dispatch (the
    flash kernel or its plain version); a single query takes the naive
    path, as in the JAX package (no kernel serves Sq == 1 there)."""
    if q.shape[1] == 1:
        q_pos = torch.full((1,), q_offset, device=q.device)
        return paged.masked_attention(q, k, v, q_pos,
                                      torch.arange(k.shape[1], device=q.device),
                                      window=window)
    if _decide("dense", q, cfg).backend == "cuda":
        return att_ops.flash_attention(q, k, v, causal=True, window=window,
                                       q_offset=q_offset)
    return flash.flash_attention_plain(q, k, v, causal=True, window=window,
                                       q_offset=q_offset)


def _build_cache(k, v, window, cache_len=None):
    """Prefill -> {"k", "v"} cache of capacity C = min(cache_len, window).

    Slot invariant (full and ring caches): slot s holds position p with
    p % C == s, taking the greatest such p seen.  Positions below S <= C
    land at slot p directly; truncation keeps the last C positions rolled
    so the invariant survives decode-time wraparound."""
    s = k.shape[1]
    c = cache_len if cache_len is not None else s
    if window is not None:
        c = min(c, window)
    if s < c:
        pad = (0, 0, 0, 0, 0, c - s)
        return {"k": torch.nn.functional.pad(k, pad),
                "v": torch.nn.functional.pad(v, pad)}
    if s == c:
        return {"k": k, "v": v}
    if window is None:
        raise ValueError(f"cannot truncate full-attention cache {s} -> {c}")
    shift = (s - c) % c
    return {"k": torch.roll(k[:, s - c:], shift, dims=1),
            "v": torch.roll(v[:, s - c:], shift, dims=1)}


def _chunk_attend(q, k_new, v_new, prefix, window, cfg):
    """Tail prefill against a resident prefix (prefix-cache hit).

    prefix: {"k", "v"} [B, P, Hkv, D], the gathered prefix blocks.  Attends
    q (positions ``P + i``) over prefix ++ tail with the causal/window
    mask and returns ONLY the tail K/V (the prefix blocks are shared and
    never rewritten)."""
    p = prefix["k"].shape[1]
    kc = torch.cat([prefix["k"].to(k_new.dtype), k_new], dim=1)
    vc = torch.cat([prefix["v"].to(v_new.dtype), v_new], dim=1)
    o = _dense_attend(q, kc, vc, p, window, cfg)
    return o, {"k": k_new, "v": v_new}


def _decode_attend(q, k_new, v_new, cache, index, window):
    """Single-token decode against a contiguous full or ring cache:
    write in place at the token's slot, then attend (naive path: one
    query, as in the JAX package)."""
    kc, vc = cache["k"], cache["v"]
    cache_utils.slot_cache_write(kc, vc, k_new, v_new, index, window)
    kv_pos, kv_valid = cache_utils.slot_positions(index, kc.shape[1], window)
    q_pos = index.long().reshape(-1, 1) if index.dim() else index.long().reshape(1)
    if kv_valid.dim() == 1:
        kv_valid = kv_valid.expand(q.shape[0], -1)
    return paged.masked_attention(q, kc, vc, q_pos, kv_pos, window=window,
                                  kv_valid=kv_valid)


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
