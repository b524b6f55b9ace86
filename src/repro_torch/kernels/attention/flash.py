"""Dense flash attention: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) and, beside it, its plain torch version.

Both take the model layout: q ``[B, Sq, Hq, D]``, k/v ``[B, Skv, Hkv, D]``
with q head ``h`` reading kv head ``h // (Hq // Hkv)``; query ``i`` sits
at absolute position ``q_offset + i`` and key ``j`` at ``j``.  The mask is
``(not causal or j <= q_pos) and (window is None or j > q_pos - window)``
over the true lengths ``Sq`` and ``Skv``.

* :func:`flash_attention_fwd` launches the kernel on CUDA tensors only and
  raises on anything it does not take.  It reads q/k/v in place through
  their strides (unit stride on D, 16-byte aligned): no transpose or
  padded copy.
* :func:`flash_attention_plain` is the float32 masked softmax of the same
  function (:func:`repro_torch.kernels.attention.paged.masked_attention`,
  the JAX package's XLA path): the CPU path and the reference the kernel
  is held against on the card.

Unlike the JAX wrapper (``ops.flash_attention``), nothing is padded to a
block multiple, so a non-causal call with a ragged ``Skv`` attends only
the real keys (the JAX kernel also attends the zero padding there).
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention.paged import HEAD_DIMS, masked_attention

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None, q_offset: int = 0):
    """q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D] -> [B, Sq, Hq, D]."""
    flash_attention_plain.calls += 1
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    return masked_attention(q, k, v, q_pos, kv_pos, window=window,
                            causal=causal)


flash_attention_plain.calls = 0


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE).lib
    lib.flash_attention_launch.argtypes = ([_P] * 4 + [_I] * 7 + [_L] * 9
                                           + [_I] * 3 + [_F, _P])
    lib.flash_attention_launch.restype = _I
    return lib


def build_kernels() -> build.Built:
    """Compile (first use) and load the flash-attention library."""
    _lib()
    return build.load(SOURCE)


def _check(q, k, v):
    if not q.is_cuda:
        raise ValueError("the CUDA flash kernel takes CUDA tensors")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from q's {q.dtype}")
    if q.dtype not in _DTYPE_IDS:
        raise ValueError(f"dtype {q.dtype} unsupported (float32, bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Sq, Hq, D] and k/v [B, Skv, Hkv, D], "
                         f"got {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} unsupported {HEAD_DIMS}")
    if hq % k.shape[2]:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {k.shape[2]}")
    chunk = 16 // q.element_size()  # elements per 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % chunk for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a unit head_dim stride, strides "
                             f"that are multiples of {chunk} and 16-byte "
                             f"alignment")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0):
    """Launch the CUDA flash kernel on the current stream.
    q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D] -> [B, Sq, Hq, D] in q's dtype."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} must be >= 0")
    b, sq, hq, d = q.shape
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_IDS[q.dtype], b, sq, k.shape[1], hq, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(q_offset),
        int(causal), 0 if window is None else int(window), 1.0 / math.sqrt(d),
        stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    return out
