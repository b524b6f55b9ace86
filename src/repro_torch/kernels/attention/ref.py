"""Float64 oracle of the attention kernels (dense flash and paged), and
the check a kernel's output is held to against it.

The port's own copy of the JAX package's one dense reference
(``repro.kernels.attention.ref.dense_ref``) and its adapters
(``flash_ref``, the JAX ``attention_ref``; ``paged_attention_ref``,
``paged_span_ref``): one mask definition, and the adapters only build
positions or gather a row's table into a dense view.  It
validates the CUDA bodies and their plain versions independently of
either.  Inputs are torch tensors (computed on their device) or numpy
arrays (computed on the CPU, returned as numpy); every value is upcast
to float64, exact for bf16, f32, int8 and e4m3 codes, and every product
and sum stays float64.  A quantized pool gives its codes plus
``k_scales``/``v_scales`` in the engine layout ``[NB, bs, Hkv]``; the
oracle dequantizes codes x scales in float64.

:func:`check_ratio` is the check, stated before the tensor-core span body
first ran on the card: per valid element ``|k - r| <= rtol * |r| + atol *
max|r|``, the maximum taken over the case's valid elements, with (rtol,
atol) = (2^-8, 1e-3) for a bf16 output (the unit roundoff of its bf16
rounding, and slack for float32 summation order) and (1e-4, 1e-4) for
float32.  A ratio <= 1 passes.  ``SPLIT_CHECK`` compares a row split over
several CTAs with the same row from one.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CHECK = {torch.bfloat16: (2.0 ** -8, 1e-3), torch.float32: (1e-4, 1e-4)}
# (rtol, atol) of a bf16 span output with key splits against the same rows
# from one split: the same f32 sums in another order, each rounded once to
# bf16, so an order difference may flip one rounding (one ulp, <= 2^-7 |r|)
SPLIT_CHECK = (2.0 ** -7, 1e-3)
_F64 = torch.float64


def _f64(x, device):
    if isinstance(x, torch.Tensor):
        # via float32: exact for every dtype here, and fp8 -> f64 direct
        # casts are missing on some builds
        return x.to(device).to(torch.float32 if x.dtype != _F64 else _F64).to(_F64)
    return torch.from_numpy(np.asarray(x, np.float64)).to(device)


def _i64(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x, np.int64)).to(device)


def dense_ref(q, k, v, q_pos, kv_pos, *, causal=True, window=None):
    """Dense GQA attention in float64 (the JAX ``dense_ref`` without its
    ``kv_valid``).

    q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D] (q head h reads kv head
    h // (Hq // Hkv)); q_pos: [Sq] or [B, Sq]; kv_pos: [Skv] or [B, Skv].
    Mask: (not causal or kv_pos <= q_pos) and (no window or kv_pos >
    q_pos - window).  A fully masked query returns zeros.  Returns float64
    [B, Sq, Hq, D] (numpy when q is numpy)."""
    as_numpy = not isinstance(q, torch.Tensor)
    dev = torch.device("cpu") if as_numpy else q.device
    q, k, v = (_f64(x, dev) for x in (q, k, v))
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qp = _i64(q_pos, dev).broadcast_to((b, sq))
    kp = _i64(kv_pos, dev).broadcast_to((b, skv))
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= kp[:, None, :] <= qp[:, :, None]
    if window is not None:
        mask &= kp[:, None, :] > qp[:, :, None] - window
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(d)
    s = s.masked_fill(~mask[:, None, None], -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=np.finfo(np.float64).tiny)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, sq, hq, d)
    return out.numpy() if as_numpy else out


def flash_ref(q, k, v, *, causal=True, window=None, q_offset=0):
    """Dense-prefill adapter: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]; query
    i sits at position q_offset + i, key j at j.  Returns float64."""
    dev = q.device if isinstance(q, torch.Tensor) else torch.device("cpu")
    return dense_ref(q, k, v, q_offset + torch.arange(q.shape[1], device=dev),
                     torch.arange(k.shape[1], device=dev), causal=causal,
                     window=window)


def _gathered(pages, scales, block_tables, dev):
    """A row's dense [B, W * bs, Hkv, D] float64 view of a pool leaf,
    codes x scales for a quantized one.  Gathered before the upcast (a
    pool is far larger than a row's table); 1-byte floats move through
    their byte view."""
    bt = _i64(block_tables, dev)
    b, w = bt.shape
    if isinstance(pages, torch.Tensor):
        pages = pages.to(dev)
        if pages.is_floating_point() and pages.element_size() == 1:
            g = pages.view(torch.uint8)[bt].view(pages.dtype)
        else:
            g = pages[bt]
    else:
        g = np.asarray(pages)[bt.cpu().numpy()]
    g = _f64(g, dev)  # [B, W, bs, Hkv, D]
    if scales is not None:
        s = scales.to(dev)[bt] if isinstance(scales, torch.Tensor) \
            else np.asarray(scales)[bt.cpu().numpy()]
        g = g * _f64(s, dev)[..., None]
    return g.reshape(b, w * g.shape[2], *g.shape[3:])


def paged_attention_ref(q, k_pages, v_pages, block_tables, index, *,
                        window=None, k_scales=None, v_scales=None):
    """Paged-decode adapter: q [B, 1, Hq, D]; pool [NB, bs, Hkv, D]
    (+ scales [NB, bs, Hkv]); block_tables [B, W]; index [B], the token's
    position (keys <= index attend).  Returns float64 [B, 1, Hq, D]."""
    as_numpy = not isinstance(q, torch.Tensor)
    dev = torch.device("cpu") if as_numpy else q.device
    kg = _gathered(k_pages, k_scales, block_tables, dev)
    vg = _gathered(v_pages, v_scales, block_tables, dev)
    out = dense_ref(_f64(q, dev), kg, vg, _i64(index, dev)[:, None],
                    torch.arange(kg.shape[1], device=dev), window=window)
    return out.numpy() if as_numpy else out


def span_valid(row_len, q_len: int, device=None):
    """bool [B, Q]: query j of row b is valid when j < row_len[b]."""
    rl = _i64(row_len, device or "cpu")
    return torch.arange(q_len, device=rl.device)[None, :] < rl[:, None]


def paged_span_ref(q, k_pages, v_pages, block_tables, row_start, row_len, *,
                   window=None, k_scales=None, v_scales=None):
    """Ragged-span adapter: q [B, Q, Hq, D]; query j of row b sits at
    position row_start[b] + j; queries j >= row_len[b] are zeroed (the
    kernels leave them garbage by contract).  Returns float64
    [B, Q, Hq, D]."""
    as_numpy = not isinstance(q, torch.Tensor)
    dev = torch.device("cpu") if as_numpy else q.device
    kg = _gathered(k_pages, k_scales, block_tables, dev)
    vg = _gathered(v_pages, v_scales, block_tables, dev)
    q_len = q.shape[1]
    q_pos = _i64(row_start, dev)[:, None] + torch.arange(q_len, device=dev)
    out = dense_ref(_f64(q, dev), kg, vg, q_pos,
                    torch.arange(kg.shape[1], device=dev), window=window)
    out = out * span_valid(row_len, q_len, dev)[..., None, None]
    return out.numpy() if as_numpy else out


def check_ratio(out, ref, rtol=None, atol=None, *, valid=None) -> float:
    """max over the valid elements of |out - ref| / (rtol |ref| + atol
    max|ref|); <= 1 passes.  (rtol, atol) default to ``CHECK[out.dtype]``;
    ``valid`` is a bool mask over the leading dims (e.g. :func:`span_valid`).
    inf when ``out`` is not finite there."""
    if rtol is None or atol is None:
        rtol, atol = CHECK[out.dtype]
    got = torch.as_tensor(out)
    dev = got.device
    got = _f64(got, dev)
    r = _f64(ref if isinstance(ref, torch.Tensor) else torch.as_tensor(ref), dev)
    if valid is not None:
        m = torch.as_tensor(valid, device=dev, dtype=torch.bool)
        m = m.reshape(*m.shape, *[1] * (got.dim() - m.dim())).expand_as(got)
        got, r = got[m], r[m]
    err = (got - r).abs()
    if not torch.isfinite(err).all():
        return math.inf
    if err.numel() == 0:
        return 0.0
    bound = rtol * r.abs() + atol * r.abs().max()
    return (err / bound.clamp(min=1e-300)).max().item()
