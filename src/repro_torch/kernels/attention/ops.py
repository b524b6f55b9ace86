"""Model- and engine-layout wrappers of the attention kernels.

The public signatures are the JAX package's (``ops.flash_attention``,
``ops.paged_attention``, ``ops.paged_span_attention``).  The dense kernel
takes the model layout q ``[B, Sq, Hq, D]``, k/v ``[B, Skv, Hkv, D]`` as
is (no head-major swap, no padding).  The paged kernels take pool leaves
``{"k", "v"}`` in the engine layout ``[NB, bs, Hkv, D]``, q
``[B, Q, Hq, D]`` with q head ``h = kh * G + g``; a quantized pool adds
its ``{"k_scale", "v_scale"}`` leaves ``[NB, bs, Hkv]``.  Unlike the JAX
wrapper, nothing here transposes the pool or its scales: the CUDA kernels
read both in place through their strides, and the GQA span fold (row
``j * G + g``) is done by the kernel's own indexing.

A CUDA tensor launches the kernel (or the launch raises); a CPU tensor
takes the plain torch version — the only case in which it does.  Each
paged wrapper counts its launches on a native pool in ``.launches`` and
on a quantized pool in ``.quant_launches``; the dense one in
``.launches``.
"""
from __future__ import annotations

from repro_torch.kernels.attention import flash, paged


def _pool(cache):
    """(k, v, scale kwargs) of a pool entry; the scales in place."""
    return cache["k"], cache["v"], {"k_scales": cache.get("k_scale"),
                                    "v_scales": cache.get("v_scale")}


def _count(wrapper, scales):
    if scales["k_scales"] is None:
        wrapper.launches += 1
    else:
        wrapper.quant_launches += 1


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    q_offset: int = 0):
    """Dense prefill.  q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D]; query i at
    position ``q_offset + i``.  Returns [B, Sq, Hq, D]."""
    if not q.is_cuda:
        return flash.flash_attention_plain(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset)
    out = flash.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    flash_attention.launches += 1
    return out


def paged_attention(cache, q, block_tables, index, *, window: int | None = None):
    """Paged decode.  cache: {"k","v"} [NB, bs, Hkv, D] (+ {"k_scale",
    "v_scale"} [NB, bs, Hkv]); q: [B, 1, Hq, D]; block_tables: [B, W]
    int32; index: [B] int32.  Returns [B, 1, Hq, D]."""
    kp, vp, scales = _pool(cache)
    if not q.is_cuda:
        return paged.paged_decode_plain(q, kp, vp, block_tables, index,
                                        window=window, **scales)
    out = paged.paged_decode_fwd(q, kp, vp, block_tables, index,
                                 window=window, **scales)
    _count(paged_attention, scales)
    return out


def paged_span_attention(cache, q, block_tables, row_start, row_len, *,
                         window: int | None = None):
    """Ragged multi-query paged attention.  q: [B, Q, Hq, D]; row ``b`` has
    ``row_len[b]`` valid queries at ``row_start[b] + j``.  Returns
    [B, Q, Hq, D]; padded query rows are garbage the caller discards."""
    kp, vp, scales = _pool(cache)
    if not q.is_cuda:
        return paged.paged_span_plain(q, kp, vp, block_tables, row_start,
                                      row_len, window=window, **scales)
    out = paged.paged_span_fwd(q, kp, vp, block_tables, row_start, row_len,
                               window=window, **scales)
    _count(paged_span_attention, scales)
    return out


def reset_counts() -> None:
    """Zero every kernel launch count and plain-path call count."""
    flash_attention.launches = 0
    flash.flash_attention_plain.calls = 0
    for wrapper in (paged_attention, paged_span_attention):
        wrapper.launches = 0
        wrapper.quant_launches = 0
    paged.paged_decode_plain.calls = 0
    paged.paged_span_plain.calls = 0


reset_counts()
