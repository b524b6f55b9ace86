"""Paged attention over the block pool: the hand-written CUDA kernels
(``csrc/paged_attention.cu``) and, beside each, its plain torch version.

Both read K/V straight from the engine's pool layout ``[NB, bs, Hkv, D]``
through per-row block tables; q and the output keep the engine layout
``[B, Q, Hq, D]`` with q head ``h = kh * G + g``.

* :func:`paged_decode_fwd` / :func:`paged_decode_plain` — one query token
  per slot (``Q == 1``) at absolute position ``index[b]``.
* :func:`paged_span_fwd` / :func:`paged_span_plain` — ragged rows: row
  ``b`` holds ``row_len[b]`` queries at positions ``row_start[b] + j``;
  query rows past ``row_len`` are garbage by contract (the CUDA kernel
  writes zeros for a row with ``row_len == 0``).

The plain versions are the JAX package's XLA path (gather the row's
blocks into a ``[W * bs]`` view, masked float32 softmax): the CPU path
and the reference the kernels are held against on the card.  The
``*_fwd`` launchers run only on CUDA tensors and raise on anything the
kernel does not take.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e38
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernels are built for
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS_PER_CTA = 16  # decode: kDecodeWarps * kDecodeRows in the source
_STAGES = 4  # kStages in the source: K/V blocks staged per CTA
_SMEM_LIMIT = 227 * 1024  # shared memory one CTA may use on Hopper


# ----------------------------------------------------------------------
# plain torch versions
# ----------------------------------------------------------------------
def _gather(pages, block_tables):
    b, w = block_tables.shape
    g = pages[block_tables.long()]  # [B, W, bs, Hkv, D]
    return g.reshape(b, w * pages.shape[1], *pages.shape[2:])


def masked_attention(q, k, v, q_pos, kv_pos, *, window=None, kv_valid=None,
                     causal=True):
    """Naive GQA attention, float32 softmax (the JAX ``_sdpa_naive``).

    q: [B, Sq, Hq, D]; k/v: [B, S, Hkv, D]; q_pos: [B, Sq] or [Sq];
    kv_pos: [B, S] or [S]; kv_valid: optional bool [B, S].  Returns
    q-shaped output in v's dtype."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * (1.0 / (d ** 0.5))
    qp = (q_pos if q_pos.dim() == 2 else q_pos[None])[:, :, None]
    kp = (kv_pos if kv_pos.dim() == 2 else kv_pos[None])[:, None, :]
    mask = kp <= qp if causal else torch.ones(
        (1, 1, 1), dtype=torch.bool, device=q.device)  # [B|1, Sq|1, S|1]
    if window is not None:
        mask = mask & (kp > qp - window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full((), NEG_INF, device=scores.device))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype).reshape(b, sq, hq, d)


def paged_decode_plain(q, k_pages, v_pages, block_tables, index, *,
                       window: int | None = None):
    """q: [B, 1, Hq, D]; pages [NB, bs, Hkv, D]; block_tables [B, W];
    index [B] (absolute position of the token; keys <= index attend)."""
    paged_decode_plain.calls += 1
    kg, vg = _gather(k_pages, block_tables), _gather(v_pages, block_tables)
    kv_pos = torch.arange(kg.shape[1], device=q.device)
    index = index.long()
    return masked_attention(q, kg, vg, index[:, None], kv_pos, window=window,
                            kv_valid=kv_pos[None, :] <= index[:, None])


def paged_span_plain(q, k_pages, v_pages, block_tables, row_start, row_len, *,
                     window: int | None = None):
    """q: [B, Q, Hq, D]; row b's query j sits at row_start[b] + j."""
    paged_span_plain.calls += 1
    kg, vg = _gather(k_pages, block_tables), _gather(v_pages, block_tables)
    kv_pos = torch.arange(kg.shape[1], device=q.device)
    q_pos = row_start.long()[:, None] + torch.arange(q.shape[1], device=q.device)
    return masked_attention(q, kg, vg, q_pos, kv_pos, window=window)


paged_decode_plain.calls = 0
paged_span_plain.calls = 0


# ----------------------------------------------------------------------
# CUDA kernels
# ----------------------------------------------------------------------
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE).lib
    lib.paged_decode_launch.argtypes = ([_P] * 6 + [_I] * 7 + [_L] * 6
                                        + [_I, _F, _P])
    lib.paged_decode_launch.restype = _I
    lib.paged_span_launch.argtypes = ([_P] * 7 + [_I] * 8 + [_L] * 6
                                      + [_I, _F, _P])
    lib.paged_span_launch.restype = _I
    return lib


def build_kernels() -> build.Built:
    """Compile (first use) and load the paged-attention library."""
    _lib()
    return build.load(SOURCE)


def _check(q, k_pages, v_pages, block_tables, rows: dict, *, max_g=None):
    if not q.is_cuda:
        raise ValueError("the CUDA paged kernels take CUDA tensors")
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), *rows.items()):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_IDS:
        raise ValueError(f"dtype {q.dtype} unsupported (float32, bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("pool and q dtypes differ "
                         f"({k_pages.dtype}/{v_pages.dtype} vs {q.dtype})")
    if q.dim() != 4 or not q.is_contiguous():
        raise ValueError("q must be a contiguous [B, Q, Hq, D] tensor")
    b, _, hq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} unsupported {HEAD_DIMS}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != d:
        raise ValueError(f"pool pages must be [NB, bs, Hkv, {d}], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    hkv, bs = k_pages.shape[2], k_pages.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if max_g is not None and hq // hkv > max_g:
        raise ValueError(f"GQA group {hq // hkv} > {max_g} rows per CTA")
    item = q.element_size()
    if bs % 8 or _STAGES * 2 * bs * d * item > _SMEM_LIMIT:
        raise ValueError(f"block_size {bs} must be a multiple of 8 and "
                         f"{_STAGES} staged K/V blocks of {bs} x {d} must fit "
                         f"shared memory")
    chunk = 16 // item  # elements per 16-byte async copy
    for t in (k_pages, v_pages):
        if t.stride(3) != 1 or any(s % chunk for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"pool pages need a unit head_dim stride, strides "
                             f"that are multiples of {chunk} and 16-byte "
                             f"alignment")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != b or not block_tables.is_contiguous():
        raise ValueError(f"block_tables must be contiguous int32 [{b}, W]")
    for name, t in rows.items():
        if t.dtype != torch.int32 or t.shape != (b,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{b}]")
    return b, hq, hkv, d, block_tables.shape[1], bs


def _window(window):
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    return 0 if window is None else int(window)


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def paged_decode_fwd(q, k_pages, v_pages, block_tables, index, *,
                     window: int | None = None):
    """Launch the CUDA paged-decode kernel on the current stream.
    q: [B, 1, Hq, D] -> [B, 1, Hq, D]."""
    if q.dim() == 4 and q.shape[1] != 1:
        raise ValueError(f"paged decode takes one query per slot, got {q.shape}")
    b, hq, hkv, d, w, bs = _check(q, k_pages, v_pages, block_tables,
                                  {"index": index}, max_g=_MAX_ROWS_PER_CTA)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), index.data_ptr(), out.data_ptr(),
        _DTYPE_IDS[q.dtype], b, hq, hkv, d, w, bs,
        *_strides(k_pages), *_strides(v_pages), _window(window),
        1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {rc}")
    return out


def paged_span_fwd(q, k_pages, v_pages, block_tables, row_start, row_len, *,
                   window: int | None = None):
    """Launch the CUDA ragged-span kernel on the current stream.
    q: [B, Q, Hq, D] -> [B, Q, Hq, D]."""
    b, hq, hkv, d, w, bs = _check(q, k_pages, v_pages, block_tables,
                                  {"row_start": row_start, "row_len": row_len})
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().paged_span_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), row_start.data_ptr(), row_len.data_ptr(),
        out.data_ptr(), _DTYPE_IDS[q.dtype], b, q.shape[1], hq, hkv, d, w, bs,
        *_strides(k_pages), *_strides(v_pages), _window(window),
        1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"paged_span launch failed: CUDA error {rc}")
    return out
