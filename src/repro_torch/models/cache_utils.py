"""Cache writes and slot-position helpers, updated IN PLACE.

The JAX package updates its caches functionally (``.at[].set`` on donated
buffers).  Here the tensors are mutated in place: the paged pool with
``index_copy_`` on a flat ``[NB * bs, Kh, D]`` view of one layer's
``[NB, bs, Kh, D]`` leaf, the contiguous ``[B, C, Kh, D]`` caches of the
fixed-batch engine with an indexed store — no copy is ever made.

Position convention of the contiguous caches (full and ring): slot ``s``
of a capacity-``C`` cache holds absolute position ``p`` with
``p % C == s``, taking the greatest such ``p`` at or below the decode
index.

NULL routing is the same contract as the JAX package: padding columns of
a span, and positions past a row's table, land in the reserved NULL
block 0 (garbage nobody reads) and never in a live block.

A quantized pool (``k``/``v`` codes in int8 or float8_e4m3fn plus
``k_scale``/``v_scale`` f32 leaves ``[NB, bs, Kh]``) is written by
quantize-on-write: each token row's codes and scale land at the same
flat destination.  fp8 leaves are written through their ``uint8`` view
(:func:`repro_torch.core.quant.raw`): some torch builds have no indexed
copy for float8.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant

NULL_BLOCK = 0


def ring_slot(index, capacity: int, window: int | None):
    """Cache slot for absolute position ``index`` (scalar or [B])."""
    return index % capacity if window is not None else index


def slot_positions(index, capacity: int, window: int | None):
    """(kv_pos, kv_valid) for a capacity-``C`` slot cache at decode index.

    index 0-d -> [C] vectors; index [B] -> [B, C] (every slot at its own
    depth).  Ring caches store in slot ``s`` the greatest ``p <= index``
    with ``p % C == s``; full caches store position ``s`` in slot ``s``."""
    slots = torch.arange(capacity, dtype=torch.long, device=index.device)
    idx = index.long()[..., None]  # [1] or [B, 1]
    if window is not None:
        kv_pos = idx - (idx - slots) % capacity
        return kv_pos, kv_pos >= 0
    return slots.expand(idx.shape[:-1] + (capacity,)), slots <= idx


def slot_cache_write(kc, vc, k_new, v_new, index, window: int | None) -> None:
    """Write one token per batch row into a contiguous [B, C, Kh, D] cache.

    k_new/v_new: [B, 1, Kh, D]; index: 0-d (lockstep batch) or [B]."""
    slot = ring_slot(index.long(), kc.shape[1], window)
    if slot.dim() == 0:
        kc[:, slot] = k_new[:, 0].to(kc.dtype)
        vc[:, slot] = v_new[:, 0].to(vc.dtype)
        return
    rows = torch.arange(kc.shape[0], device=kc.device)
    kc[rows, slot] = k_new[:, 0].to(kc.dtype)
    vc[rows, slot] = v_new[:, 0].to(vc.dtype)


def _flat(leaf: torch.Tensor) -> torch.Tensor:
    """[NB, bs, ...] -> the [NB * bs, ...] view writes go through."""
    leaf = quant.raw(leaf)
    return leaf.view((leaf.shape[0] * leaf.shape[1],) + tuple(leaf.shape[2:]))


def _rows(new: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Token rows [N, ...] in the leaf's dtype, fp8 as bytes."""
    return quant.raw(new.reshape((-1,) + tuple(leaf.shape[2:])).to(leaf.dtype))


def _write_rows(entry: dict, k_new, v_new, dest, kv_dtype: str | None) -> None:
    """Scatter token rows [N, Kh, D] to flat ``dest`` [N] of every leaf of
    a pool entry; ``kv_dtype`` int8/fp8 quantizes them first (codes and
    scales to the same destination)."""
    for name, new in (("k", k_new), ("v", v_new)):
        leaf = entry[name]
        if kv_dtype is None:
            _flat(leaf).index_copy_(0, dest, _rows(new, leaf))
            continue
        codes, scale = quant.kv_quantize(new, kv_dtype)
        _flat(leaf).index_copy_(0, dest, _rows(codes, leaf))
        sleaf = entry[name + "_scale"]
        _flat(sleaf).index_copy_(0, dest, _rows(scale, sleaf))


def paged_cache_write(kp, vp, k_new, v_new, block_tables, index) -> None:
    """Write one token per slot into the pooled [NB, bs, Kh, D] layout.

    k_new/v_new: [B, 1, Kh, D]; block_tables: [B, W]; index: [B].  The
    destination is ``table[b, index // bs] * bs + index % bs`` — unique per
    live slot (retired or masked slots point at the NULL block)."""
    _write_rows({"k": kp, "v": vp}, k_new[:, 0], v_new[:, 0],
                _decode_dest(block_tables, index, kp.shape[1]), None)


def _decode_dest(block_tables, index, bs: int):
    """Flat pool destinations [B] of one token per slot at ``index``."""
    index = index.long()
    w = (index // bs).clamp(max=block_tables.shape[1] - 1)
    blk = block_tables.long().gather(1, w[:, None])[:, 0]
    return blk * bs + index % bs


def quantized_cache_write(entry, k_new, v_new, block_tables, index,
                          kv_dtype: str) -> None:
    """:func:`paged_cache_write` for a quantized pool entry (``k``, ``v``,
    ``k_scale``, ``v_scale``): quantize-on-write, in place."""
    _write_rows(entry, k_new[:, 0], v_new[:, 0],
                _decode_dest(block_tables, index, entry["k"].shape[1]),
                kv_dtype)


def span_dest(block_tables, row_start, row_len, q: int, bs: int):
    """Flat pool destinations [B * Q] for a per-row query span: column j of
    row b sits at absolute position ``row_start[b] + j``; padding columns
    (``j >= row_len``) and positions past the table route into the NULL
    block's ``[0, bs)`` range."""
    j = torch.arange(q, device=block_tables.device)[None, :]
    pos = row_start.long()[:, None] + j  # [B, Q]
    w_raw = pos // bs
    width = block_tables.shape[1]
    valid = (j < row_len.long()[:, None]) & (w_raw < width)
    blk = block_tables.long().gather(1, w_raw.clamp(0, width - 1))
    return torch.where(valid, blk * bs + pos % bs, pos % bs).reshape(-1)


def paged_span_write(kp, vp, k_new, v_new, block_tables, row_start, row_len
                     ) -> None:
    """Write a per-row query span into the pooled [NB, bs, Kh, D] layout.

    k_new/v_new: [B, Q, Kh, D] — row ``b`` holds ``row_len[b]`` valid tokens
    at absolute positions ``row_start[b] + j``.  Valid destinations are
    unique (disjoint block tables per row)."""
    dest = span_dest(block_tables, row_start, row_len, k_new.shape[1],
                     kp.shape[1])
    _write_rows({"k": kp, "v": vp}, k_new, v_new, dest, None)


def quantized_span_write(entry, k_new, v_new, block_tables, row_start,
                         row_len, kv_dtype: str) -> None:
    """:func:`paged_span_write` for a quantized pool entry: each token row
    is quantized per (position, kv head) and its codes and scales land at
    the same flat destination, so a read always sees a matching pair."""
    dest = span_dest(block_tables, row_start, row_len, k_new.shape[1],
                     entry["k"].shape[1])
    _write_rows(entry, k_new, v_new, dest, kv_dtype)


def copy_pool_blocks(leaf, src, dst) -> None:
    """Copy whole pool blocks ``src[i] -> dst[i]`` within one layers-stacked
    pool leaf ``[layers, NB, bs, ...]`` — the block axis is axis 1."""
    leaf = quant.raw(leaf)
    leaf.index_copy_(1, dst, leaf.index_select(1, src))
