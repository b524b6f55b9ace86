"""Mamba-2 block: state-space duality (SSD) with a chunked scan — the port
of ``repro.models.ssm``.

Prefill runs the whole prompt through the depthwise causal conv and the
SSD scan (:func:`ssd_chunked`: the CUDA kernel on a CUDA tensor, its plain
chunked version on a CPU tensor or under ``kernel_mode="xla"``) and
returns the per-slot decode state; decode advances that state one token
at a time in plain torch (:func:`ssd_step`, :func:`_conv_step`), as the
JAX package decodes without a kernel.

Decode state per layer, slot-indexed (never pooled)::

    {"ssm": [B, H, N, P] float32,
     "conv_x": [B, W-1, d_inner], "conv_b"/"conv_c": [B, W-1, G*N]}

The conv leaves hold the last W-1 RAW (pre-conv) inputs, in the model
dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.attention import dispatch as kdispatch
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import RMSNorm, dense, rmsnorm, rmsnorm_gated

_PARAMS = ("wz", "wx", "wb", "wc", "wdt", "conv_x", "conv_x_b", "conv_b",
           "conv_b_b", "conv_c", "conv_c_b", "A_log", "D", "dt_bias",
           "out_proj")


class Mamba2(nn.Module):
    """One ssm unit's parameters (``repro.models.ssm.mamba2_decl``): the
    pre-norm ``norm``, the input projections (dense ``[in, out]``
    layout), the conv weights ``[W, C]`` and biases, ``A_log``, ``D``,
    ``dt_bias``, the gated ``out_norm`` and ``out_proj``."""

    def __init__(self, tensors: dict):
        super().__init__()
        self.norm = RMSNorm(tensors["norm"])
        self.out_norm = RMSNorm(tensors["out_norm"])
        for name in _PARAMS:
            self.register_parameter(
                name, nn.Parameter(tensors[name], requires_grad=False))


def _causal_conv(x, w, b):
    """Depthwise causal 1D conv + bias + SiLU.  x: [B, S, C]; w: [W, C];
    b: [C] float32."""
    width, c = w.shape
    xt = F.pad(x.transpose(1, 2), (width - 1, 0))  # [B, C, W-1+S]
    y = F.conv1d(xt, w.t()[:, None].to(x.dtype), groups=c)
    # back to [B, S, C] in memory: the scan reads heads x P with unit stride
    return F.silu(y.transpose(1, 2).contiguous().float() + b).to(x.dtype)


def _conv_step(x_new, conv_state, w, b):
    """x_new: [B, 1, C]; conv_state: [B, W-1, C] (previous raw inputs).
    Returns (y [B, 1, C], new conv state)."""
    full = torch.cat([conv_state, x_new], dim=1)  # [B, W, C]
    y = (full.float() * w.float()).sum(dim=1) + b
    return F.silu(y)[:, None].to(x_new.dtype), full[:, 1:]


def ssd_chunked(x, dt, a_log, bmat, cmat, chunk, *, mode="auto"):
    """SSD over chunks from a zero state.  x: [B, S, H, P]; dt: [B, S, H]
    (post-softplus); a_log: [H]; bmat/cmat: [B, S, G, N].  Returns
    (y [B, S, H, P], final state [B, H, N, P] float32)."""
    return ssd_ops.ssd_scan(x, dt, a_log, bmat, cmat, chunk=chunk, mode=mode)


def ssd_step(state, x, dt, a_log, bvec, cvec):
    """One decode step.  state: [B, H, N, P]; x: [B, H, P]; dt: [B, H];
    bvec/cvec: [B, G, N].  Returns (y [B, H, P], new state)."""
    b, h, n, p = state.shape
    g = bvec.shape[1]
    hg = h // g
    a = -torch.exp(a_log.float())
    dtf = dt.float()
    da = torch.exp(dtf * a)  # [B, H]
    xdt = x.float().reshape(b, g, hg, p) * dtf.reshape(b, g, hg)[..., None]
    inc = bvec.float()[:, :, None, :, None] * xdt[:, :, :, None, :]
    new = (state.reshape(b, g, hg, n, p) * da.reshape(b, g, hg)[..., None, None]
           + inc)
    y = torch.einsum("bgn,bgenp->bgep", cvec.float(), new)
    return y.reshape(b, h, p).to(x.dtype), new.reshape(b, h, n, p)


def mamba2_state_spec(cfg, batch: int, dtype) -> dict:
    """Decode-state leaves of one layer: name -> (shape, dtype)."""
    di = cfg.ssm_d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    w = cfg.conv_width
    return {
        "ssm": ((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                torch.float32),
        "conv_x": ((batch, w - 1, di), dtype),
        "conv_b": ((batch, w - 1, gn), dtype),
        "conv_c": ((batch, w - 1, gn), dtype),
    }


def mamba2_block(m: Mamba2, x, cfg, *, state=None):
    """x: [B, S, d_model] -> (y, new_state).  ``state`` given => S == 1
    decode."""
    b, s, _ = x.shape
    h, p = cfg.ssm_heads, cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    z = dense(m.wz, x)
    xin = dense(m.wx, x)
    braw = dense(m.wb, x)
    craw = dense(m.wc, x)
    dt = F.softplus(dense(m.wdt, x).float() + m.dt_bias)
    if state is None:
        xc = _causal_conv(xin, m.conv_x, m.conv_x_b)
        bc = _causal_conv(braw, m.conv_b, m.conv_b_b)
        cc = _causal_conv(craw, m.conv_c, m.conv_c_b)
        y, final = ssd_chunked(
            xc.reshape(b, s, h, p), dt, m.A_log, bc.reshape(b, s, g, n),
            cc.reshape(b, s, g, n), cfg.ssm_chunk, mode=kdispatch.mode_from(cfg))
        k = cfg.conv_width - 1
        new_state = {"ssm": final, "conv_x": _tail(xin, k),
                     "conv_b": _tail(braw, k), "conv_c": _tail(craw, k)}
    else:
        xc, cx = _conv_step(xin, state["conv_x"], m.conv_x, m.conv_x_b)
        bc, cb = _conv_step(braw, state["conv_b"], m.conv_b, m.conv_b_b)
        cc, ccs = _conv_step(craw, state["conv_c"], m.conv_c, m.conv_c_b)
        y, ssm = ssd_step(state["ssm"], xc[:, 0].reshape(b, h, p), dt[:, 0],
                          m.A_log, bc[:, 0].reshape(b, g, n),
                          cc[:, 0].reshape(b, g, n))
        y = y[:, None]
        new_state = {"ssm": ssm, "conv_x": cx, "conv_b": cb, "conv_c": ccs}
    # D skip on the conv-activated input stream
    d_skip = m.D.reshape(h, 1) * xc.reshape(b, -1, h, p).float()
    y = (y.reshape(b, -1, h, p).float() + d_skip).reshape(b, -1, h * p)
    y = rmsnorm_gated(m.out_norm.scale, y.to(x.dtype), z, cfg.norm_eps)
    return dense(m.out_proj, y), new_state


def apply_layer(m: Mamba2, x, cfg, *, state=None):
    """One ssm unit: pre-norm, mixer, residual.  -> (x, new_state)."""
    y, new_state = mamba2_block(m, rmsnorm(m.norm.scale, x, cfg.norm_eps), cfg,
                                state=state)
    return x + y, new_state


def _tail(x, k: int):
    """Last k positions along axis 1, left-padded with zeros if S < k."""
    s = x.shape[1]
    if s >= k:
        return x[:, s - k:]
    return F.pad(x, (0, 0, k - s, 0))
