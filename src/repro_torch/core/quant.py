"""Per-(position, kv-head) symmetric quantization of the KV block pool —
the port's copy of ``repro.core.quant``'s KV half.

``scale = max(amax / qmax, 1e-12)`` with amax over head_dim; storage is
``round(x / scale)`` clipped to +-127 (int8) or ``x / scale`` clipped to
+-448 and cast (fp8 e4m3fn, no inf encoding).  The float32 operations run
in the JAX package's order, so both packages produce the same codes and
scales bit for bit.  Quantization is elementwise and deterministic:
re-writing the same values reproduces the same (code, scale) pair, which
prefix reuse and preemption-resume rely on.

Some torch builds lack indexed copies for ``float8_e4m3fn`` (``index_copy_``
on the CPU, for one); :func:`raw` gives the byte view every data move of
an fp8 leaf goes through.
"""
from __future__ import annotations

import torch

# KV pool storage dtypes.  "fp16" means "native": the pool keeps the model
# dtype and has no scale leaves.
KV_DTYPES = ("fp16", "int8", "fp8")

# symmetric clip range per storage dtype
QMAX = {"int8": 127.0, "fp8": 448.0}

_STORAGE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def storage_dtype(kv_dtype: str) -> torch.dtype:
    """torch dtype that quantized pool leaves are stored in."""
    if kv_dtype not in _STORAGE:
        raise ValueError(f"no storage dtype for kv_dtype={kv_dtype!r}")
    return _STORAGE[kv_dtype]


def raw(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or its ``uint8`` view when it holds fp8 codes."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Zero-filled tensor of any pool dtype (fp8 filled through bytes)."""
    if dtype == torch.float8_e4m3fn:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def kv_quantize(x: torch.Tensor, kv_dtype: str):
    """[..., D] float -> (codes [..., D] storage dtype, scale [...] f32)."""
    qmax = QMAX[kv_dtype]
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / qmax, min=1e-12)
    y = xf / scale[..., None]
    if kv_dtype == "int8":
        q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    else:
        q = torch.clamp(y, -qmax, qmax).to(storage_dtype(kv_dtype))
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`kv_quantize`: codes * scale -> ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)
