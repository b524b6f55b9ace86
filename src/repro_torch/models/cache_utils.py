"""Paged-pool cache writes, updated IN PLACE.

The JAX package updates the pool functionally (``.at[].set`` on donated
buffers).  Here the pool tensors are mutated in place with
``index_copy_`` on a flat ``[NB * bs, Kh, D]`` view of one layer's
``[NB, bs, Kh, D]`` leaf — no copy of the pool is ever made.

NULL routing is the same contract as the JAX package: padding columns of
a span, and positions past a row's table, land in the reserved NULL
block 0 (garbage nobody reads) and never in a live block.
"""
from __future__ import annotations

import torch

NULL_BLOCK = 0


def _flat(leaf: torch.Tensor) -> torch.Tensor:
    return leaf.view((leaf.shape[0] * leaf.shape[1],) + tuple(leaf.shape[2:]))


def paged_cache_write(kp, vp, k_new, v_new, block_tables, index) -> None:
    """Write one token per slot into the pooled [NB, bs, Kh, D] layout.

    k_new/v_new: [B, 1, Kh, D]; block_tables: [B, W]; index: [B].  The
    destination is ``table[b, index // bs] * bs + index % bs`` — unique per
    live slot (retired or masked slots point at the NULL block)."""
    bs = kp.shape[1]
    index = index.long()
    w = (index // bs).clamp(max=block_tables.shape[1] - 1)
    blk = block_tables.long().gather(1, w[:, None])[:, 0]
    dest = blk * bs + index % bs
    _flat(kp).index_copy_(0, dest, k_new[:, 0].to(kp.dtype))
    _flat(vp).index_copy_(0, dest, v_new[:, 0].to(vp.dtype))


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
    b, q = k_new.shape[0], k_new.shape[1]
    dest = span_dest(block_tables, row_start, row_len, q, kp.shape[1])
    _flat(kp).index_copy_(0, dest, k_new.reshape((b * q,) + tuple(k_new.shape[2:]))
                          .to(kp.dtype))
    _flat(vp).index_copy_(0, dest, v_new.reshape((b * q,) + tuple(v_new.shape[2:]))
                          .to(vp.dtype))


def copy_pool_blocks(leaf, src, dst) -> None:
    """Copy whole pool blocks ``src[i] -> dst[i]`` within one layers-stacked
    pool leaf ``[layers, NB, bs, ...]`` — the block axis is axis 1."""
    leaf.index_copy_(1, dst, leaf.index_select(1, src))
