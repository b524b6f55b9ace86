"""Paged attention over the block pool: the hand-written CUDA kernels
(``csrc/paged_attention.cu``) and, beside each, its plain torch version.

Both read K/V straight from the engine's pool layout ``[NB, bs, Hkv, D]``
through per-row block tables; q and the output keep the engine layout
``[B, Q, Hq, D]`` with q head ``h = kh * G + g``.  A quantized pool
(int8 or float8_e4m3fn codes) comes with its per-(position, kv-head)
float32 scales ``k_scales``/``v_scales`` in the engine layout
``[NB, bs, Hkv]``; the kernels dequantize inside the softmax loop, the
plain versions dequantize the gathered view to q's dtype.

* :func:`paged_decode_fwd` / :func:`paged_decode_plain` — one query token
  per slot (``Q == 1``) at absolute position ``index[b]``; the CUDA body's
  4 warps divide each block's keys, and each slot's visited keys split
  over the CTAs that :func:`decode_split_plan` counts from the shapes.
* :func:`paged_span_fwd` / :func:`paged_span_plain` — ragged rows: row
  ``b`` holds ``row_len[b]`` queries at positions ``row_start[b] + j``;
  query rows past ``row_len`` are garbage by contract (the CUDA kernel
  writes zeros for a row with ``row_len == 0``).  With bf16 q the span
  runs on the tensor cores, each row's visited keys split over the CTAs
  that :func:`span_split_plan` counts from the shapes; f32 q runs the
  CUDA-core body.

The plain versions are the JAX package's XLA path (gather the row's
blocks into a ``[W * bs]`` view, dequantized through the gathered scales
for a quantized pool, masked float32 softmax): the CPU path
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

from repro_torch.core import quant
from repro_torch.kernels import build

NEG_INF = -2.0e38
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernels are built for
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
# pool storage: 0 = q's dtype (native), else quantized codes with scales
_KV_IDS = {torch.int8: 1, torch.float8_e4m3fn: 2}
_MAX_ROWS_PER_CTA = 16  # decode: kDecodeWarps * kDecodeRows in the source
_STAGES = 4  # kStages in the source: K/V blocks staged per CTA
_SMEM_LIMIT = 227 * 1024  # shared memory one CTA may use on Hopper
SPAN_TILE_ROWS = 128  # kTcRows in the source: folded rows per tensor-core CTA
MAX_SPLITS = 16  # key splits of one row (the merge's lanes hold <= 32)
MIN_SPLIT_BLOCKS = 4  # table entries a split covers at the least
# decode CTAs (4 warps, ~32 KB of ring) the plan puts on each SM: two hide
# each other's per-block latency (7-11 % faster than one at the main
# path's decode shape on an H100, every pool; PERF.md, section 6)
DECODE_FILL = 2


# ----------------------------------------------------------------------
# plain torch versions
# ----------------------------------------------------------------------
def _gather(pages, block_tables):
    b, w = block_tables.shape
    g = quant.raw(pages)[block_tables.long()]  # [B, W, bs, Hkv(, D)]
    return g.reshape(b, w * pages.shape[1], *pages.shape[2:]).view(pages.dtype)


def _gathered_view(pages, scales, block_tables, dtype):
    """A row's logical [B, W * bs, Hkv, D] view of one pool leaf; a
    quantized leaf is dequantized to ``dtype`` through its gathered
    scales (the JAX ``_gathered_view``)."""
    if (pages.dtype in _KV_IDS) != (scales is not None):
        raise ValueError(f"a {pages.dtype} pool takes "
                         f"{'its scales' if scales is None else 'no scales'}")
    g = _gather(pages, block_tables)
    if scales is None:
        return g
    return quant.kv_dequantize(g, _gather(scales, block_tables), dtype)


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
                       window: int | None = None, k_scales=None,
                       v_scales=None):
    """q: [B, 1, Hq, D]; pages [NB, bs, Hkv, D] (scales [NB, bs, Hkv] for
    a quantized pool); block_tables [B, W]; index [B] (absolute position
    of the token; keys <= index attend)."""
    paged_decode_plain.calls += 1
    kg = _gathered_view(k_pages, k_scales, block_tables, q.dtype)
    vg = _gathered_view(v_pages, v_scales, block_tables, q.dtype)
    kv_pos = torch.arange(kg.shape[1], device=q.device)
    index = index.long()
    return masked_attention(q, kg, vg, index[:, None], kv_pos, window=window,
                            kv_valid=kv_pos[None, :] <= index[:, None])


def paged_span_plain(q, k_pages, v_pages, block_tables, row_start, row_len, *,
                     window: int | None = None, k_scales=None, v_scales=None):
    """q: [B, Q, Hq, D]; row b's query j sits at row_start[b] + j."""
    paged_span_plain.calls += 1
    kg = _gathered_view(k_pages, k_scales, block_tables, q.dtype)
    vg = _gathered_view(v_pages, v_scales, block_tables, q.dtype)
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
    lib.paged_decode_launch.argtypes = ([_P] * 10 + [_I] * 8 + [_L] * 12
                                        + [_I, _F, _I, _P])
    lib.paged_decode_launch.restype = _I
    lib.paged_span_launch.argtypes = ([_P] * 11 + [_I] * 9 + [_L] * 12
                                      + [_I, _F, _I, _P])
    lib.paged_span_launch.restype = _I
    return lib


def build_kernels() -> build.Built:
    """Compile (first use) and load the paged-attention library."""
    _lib()
    return build.load(SOURCE)


def span_split_plan(b: int, hkv: int, rows: int, w: int, sms: int):
    """(row tiles, key splits) of the tensor-core span body for a batch of
    ``b`` rows of ``rows`` folded query rows (Q*G) over ``w`` table
    entries, on a card of ``sms`` SMs.  From the shapes alone (row_start
    and row_len stay on the device): one CTA per (row, kv head, tile of
    128 folded rows, split); splits are added until the CTAs fill the SMs
    once, each split keeping at least ``MIN_SPLIT_BLOCKS`` table entries of
    a full table.  The kernel divides each row's own visited range by the
    split count, so a row's result depends on it only through f32
    summation order."""
    tiles = -(-rows // SPAN_TILE_ROWS)
    splits = -(-sms // (b * hkv * tiles))
    return tiles, max(1, min(splits, MAX_SPLITS, w // MIN_SPLIT_BLOCKS))


def decode_split_plan(b: int, hkv: int, w: int, sms: int) -> int:
    """Key splits of the decode body for ``b`` slots over ``w`` table
    entries, on a card of ``sms`` SMs.  From the shapes alone (the
    positions stay on the device): one CTA per (slot, kv head, split);
    splits are added until the CTAs fill the SMs ``DECODE_FILL`` times,
    each split keeping at least ``MIN_SPLIT_BLOCKS`` table entries of a
    full table."""
    splits = -(-DECODE_FILL * sms // (b * hkv))
    return max(1, min(splits, MAX_SPLITS, w // MIN_SPLIT_BLOCKS))


def _check_splits(splits):
    if splits is not None and (not isinstance(splits, int)
                               or not 1 <= splits <= MAX_SPLITS):
        raise ValueError(f"splits={splits!r}: expected an int in "
                         f"[1, {MAX_SPLITS}]")


def _workspace(splits, b, hkv, rows, d, device):
    """The merge's f32 workspace, [splits, B, Hkv, rows] x D and then x
    (m, l), in one allocation: (tensor, part_acc pointer, part_ml
    pointer), the tensor to be held through the launch; no workspace and
    null pointers for one split."""
    if splits == 1:
        return None, 0, 0
    n = splits * b * hkv * rows
    ws = torch.empty(n * (d + 2), dtype=torch.float32, device=device)
    return ws, ws.data_ptr(), ws.data_ptr() + n * d * 4


def _ring_smem(bs: int, d: int, item: int, quantized: bool) -> int:
    """The CUDA-core bodies' ring: _STAGES blocks of K and V codes, plus
    their bs K and bs V f32 scales when quantized (stage_bytes)."""
    return _STAGES * (2 * bs * d * item + (2 * bs * 4 if quantized else 0))


def _decode_smem(bs: int, d: int, item: int, quantized: bool) -> int:
    """Shared memory of the decode CTA (decode_smem_bytes in the source):
    the ring, whose bytes then hold the 4 warps' f32 acc and (m, l) of 4
    rows each."""
    return max(_ring_smem(bs, d, item, quantized),
               _MAX_ROWS_PER_CTA * (d + 2) * 4)


def _span_tc_smem(bs: int, d: int, item: int, quantized: bool) -> int:
    """Shared memory of the tensor-core span CTA (tc_smem_bytes in the
    source): the 128-row q tile and the ring at the padded bf16 row of
    d + 8, codes unpadded plus one converted bf16 K/V block when
    quantized."""
    ld, bs16 = d + 8, -(-bs // 16) * 16
    q_tile = SPAN_TILE_ROWS * ld * 2
    if quantized:
        return q_tile + _STAGES * (2 * bs * d * item + 8 * bs) + 2 * bs16 * ld * 2
    return q_tile + _STAGES * 2 * bs16 * ld * 2


def _check(q, k_pages, v_pages, block_tables, rows: dict, k_scales, v_scales,
           *, max_g=None, span=False):
    """Every argument check of the launchers; device-agnostic first, the
    CUDA device last (so the CPU tests reach each check)."""
    if q.dtype not in _DTYPE_IDS:
        raise ValueError(f"dtype {q.dtype} unsupported (float32, bfloat16)")
    if k_pages.dtype != v_pages.dtype:
        raise ValueError(f"K and V pools differ ({k_pages.dtype} vs "
                         f"{v_pages.dtype})")
    quantized = k_pages.dtype in _KV_IDS
    if not quantized and k_pages.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pages.dtype} is neither q's "
                         f"({q.dtype}) nor a quantized storage dtype "
                         f"(int8, float8_e4m3fn)")
    if quantized != (k_scales is not None) or \
            (k_scales is None) != (v_scales is None):
        raise ValueError(
            f"a {k_pages.dtype} pool takes "
            f"{'k_scales and v_scales' if quantized else 'no scales'}")
    if q.dim() != 4 or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("q must be a contiguous, 16-byte aligned "
                         "[B, Q, Hq, D] tensor")
    b, _, hq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} unsupported {HEAD_DIMS}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != d:
        raise ValueError(f"pool pages must be [NB, bs, Hkv, {d}], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    hkv, bs = k_pages.shape[2], k_pages.shape[1]
    if quantized:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.dtype != torch.float32 or t.device != q.device \
                    or t.shape != k_pages.shape[:3]:
                raise ValueError(f"{name} must be float32 "
                                 f"{list(k_pages.shape[:3])} on {q.device}, "
                                 f"got {t.dtype} {list(t.shape)} on {t.device}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if max_g is not None and hq // hkv > max_g:
        raise ValueError(f"GQA group {hq // hkv} > {max_g} rows per CTA")
    item = k_pages.element_size()
    if not span:
        smem = _decode_smem(bs, d, item, quantized)
    elif q.dtype == torch.bfloat16:
        smem = _span_tc_smem(bs, d, item, quantized)
    else:
        smem = _ring_smem(bs, d, item, quantized)
    if bs % 8 or smem > _SMEM_LIMIT:
        raise ValueError(f"block_size {bs} must be a multiple of 8 and "
                         f"{_STAGES} staged K/V blocks of {bs} x {d} must fit "
                         f"shared memory ({smem} > {_SMEM_LIMIT} bytes)")
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
    if not q.is_cuda:
        raise ValueError("the CUDA paged kernels take CUDA tensors")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), *rows.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    return b, hq, hkv, d, block_tables.shape[1], bs


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _window(window):
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    return 0 if window is None else int(window)


def _pool_args(k_pages, v_pages, k_scales, v_scales):
    """(storage id, scale pointers, 12 element strides) of a pool: K and V
    pages [blk, pos, head], then the K and V scales (0 for a native pool)."""
    strides = [s for t in (k_pages, v_pages) for s in t.stride()[:3]]
    if k_scales is None:
        return 0, 0, 0, strides + [0] * 6
    return (_KV_IDS[k_pages.dtype], k_scales.data_ptr(), v_scales.data_ptr(),
            strides + [s for t in (k_scales, v_scales) for s in t.stride()])


def paged_decode_fwd(q, k_pages, v_pages, block_tables, index, *,
                     window: int | None = None, k_scales=None, v_scales=None,
                     splits: int | None = None):
    """Launch the CUDA paged-decode kernel on the current stream.
    q: [B, 1, Hq, D] -> [B, 1, Hq, D].  ``splits`` key splits per slot
    (default: :func:`decode_split_plan`; 1 writes the output from one CTA
    per (slot, kv head), with no merge)."""
    if q.dim() == 4 and q.shape[1] != 1:
        raise ValueError(f"paged decode takes one query per slot, got {q.shape}")
    window = _window(window)
    _check_splits(splits)
    b, hq, hkv, d, w, bs = _check(q, k_pages, v_pages, block_tables,
                                  {"index": index}, k_scales, v_scales,
                                  max_g=_MAX_ROWS_PER_CTA)
    if splits is None:
        splits = decode_split_plan(b, hkv, w, _sm_count(q.device.index))
    kv, ks, vs, strides = _pool_args(k_pages, v_pages, k_scales, v_scales)
    out = torch.empty_like(q)
    ws, part_acc, part_ml = _workspace(splits, b, hkv, hq // hkv, d, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
        block_tables.data_ptr(), index.data_ptr(), out.data_ptr(), part_acc,
        part_ml, _DTYPE_IDS[q.dtype], kv, b, hq, hkv, d, w, bs, *strides,
        window, 1.0 / math.sqrt(d), splits, stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {rc}")
    return out


def paged_span_fwd(q, k_pages, v_pages, block_tables, row_start, row_len, *,
                   window: int | None = None, k_scales=None, v_scales=None,
                   splits: int | None = None):
    """Launch the CUDA ragged-span kernel on the current stream.
    q: [B, Q, Hq, D] -> [B, Q, Hq, D].  bf16 q: ``splits`` key splits per
    row (default: :func:`span_split_plan`; 1 writes the output from one
    CTA per row tile, with no merge); f32 q takes no splits."""
    window = _window(window)
    _check_splits(splits)
    if q.dtype != torch.bfloat16 and splits not in (None, 1):
        raise ValueError(f"splits={splits}: the {q.dtype} span body does not "
                         f"split keys")
    b, hq, hkv, d, w, bs = _check(q, k_pages, v_pages, block_tables,
                                  {"row_start": row_start, "row_len": row_len},
                                  k_scales, v_scales, span=True)
    rows = q.shape[1] * (hq // hkv)
    if q.dtype != torch.bfloat16:
        splits = 1
    elif splits is None:
        splits = span_split_plan(b, hkv, rows, w, _sm_count(q.device.index))[1]
    kv, ks, vs, strides = _pool_args(k_pages, v_pages, k_scales, v_scales)
    out = torch.empty_like(q)
    ws, part_acc, part_ml = _workspace(splits, b, hkv, rows, d, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().paged_span_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
        block_tables.data_ptr(), row_start.data_ptr(), row_len.data_ptr(),
        out.data_ptr(), part_acc, part_ml, _DTYPE_IDS[q.dtype], kv,
        b, q.shape[1], hq, hkv, d, w, bs, *strides, window,
        1.0 / math.sqrt(d), splits, stream)
    if rc != 0:
        raise RuntimeError(f"paged_span launch failed: CUDA error {rc}")
    return out
