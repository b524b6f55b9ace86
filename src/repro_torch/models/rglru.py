"""Griffin / RecurrentGemma temporal block: the RG-LRU recurrence
(arXiv:2402.19427) — the port of ``repro.models.rglru``.

Recurrent block:   x -> [gelu(W_gate x)] * [RG-LRU(conv1d(W_in x))] -> W_out
RG-LRU:            r_t = sigmoid(W_a x_t + b_a);  i_t = sigmoid(W_x x_t + b_x)
                   a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
                   h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gate matrices are block-diagonal, one block per head.  The JAX
package runs the sequence recurrence as an f32 ``associative_scan`` in
plain jnp (no Pallas kernel); the port runs it in plain torch, chunked
(:func:`rglru_scan`): within a chunk of ``RG_CHUNK`` tokens every
output is a masked weighted sum of the chunk's inputs with weights
``exp(L_t - L_s)`` (``L`` the chunk-local cumulative ``log a``, masked
before the ``exp`` so no factor exceeds 1), and the state crosses chunks
in a loop of ``S / RG_CHUNK`` steps.  ``log a`` comes straight from the
gate, never as ``log(a)``.  Decode is one fused step (:func:`rglru_step`).

Decode state per layer, slot-indexed (never pooled)::

    {"lru": [B, lru_width] float32, "conv": [B, W-1, lru_width]}

The conv leaf holds the last W-1 raw (pre-conv) inputs, in the model
dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense

RG_C = 8.0
RG_CHUNK = 64  # tokens a chunk of the scan: [B, T, T, lru] f32 weights

_PARAMS = ("w_gate", "w_in", "conv_w", "conv_b", "rg_a_w", "rg_a_b",
           "rg_x_w", "rg_x_b", "lam", "w_out")


class GriffinRec(nn.Module):
    """One recurrent block's parameters (``griffin_rec_decl``): the
    dense ``w_gate``/``w_in`` [d, lru] and ``w_out`` [lru, d], the conv
    ``conv_w`` [W, lru] and f32 ``conv_b``, the block-diagonal gate
    matrices ``rg_a_w``/``rg_x_w`` [G, bw, bw] with f32 biases, and the
    f32 ``lam`` [G, bw]."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name in _PARAMS:
            self.register_parameter(
                name, nn.Parameter(tensors[name], requires_grad=False))


def griffin_rec_state_spec(cfg, batch: int, dtype) -> dict:
    """Decode-state leaves of one rec layer: name -> (shape, dtype)."""
    return {"lru": ((batch, cfg.lru_width), torch.float32),
            "conv": ((batch, cfg.conv_width - 1, cfg.lru_width), dtype)}


def _conv_linear(x, w, b):
    """Depthwise causal conv, no activation.  x: [B, S, C]; w: [W, C];
    b: [C] float32."""
    width, c = w.shape
    xt = F.pad(x.transpose(1, 2), (width - 1, 0))  # [B, C, W-1+S]
    y = F.conv1d(xt, w.t()[:, None].to(x.dtype), groups=c)
    return (y.transpose(1, 2).float() + b).to(x.dtype)


def _conv_linear_step(x_new, conv_state, w, b):
    """x_new: [B, 1, C]; conv_state: [B, W-1, C] (previous raw inputs).
    Returns (y [B, 1, C], new conv state)."""
    full = torch.cat([conv_state, x_new], dim=1)  # [B, W, C]
    y = (full.float() * w.float()).sum(dim=1) + b
    return y[:, None].to(x_new.dtype), full[:, 1:]


def _rg_gates(m: GriffinRec, xg):
    """xg: [B, S, G, bw] -> (log_a, gated input), both f32 [B, S, G, bw]:
    ``a = exp(log_a)`` and the input term ``sqrt(1 - a^2) * i * x``."""
    b, s, g, bw = xg.shape
    xf = xg.float()
    # both gates' block-diagonal products in one batched matmul over heads
    w = torch.cat([m.rg_a_w, m.rg_x_w], dim=-1).float()  # [G, bw, 2 bw]
    ri = torch.bmm(xf.permute(2, 0, 1, 3).reshape(g, b * s, bw), w)
    ri = ri.reshape(g, b, s, 2 * bw).permute(1, 2, 0, 3)
    r = torch.sigmoid(ri[..., :bw] + m.rg_a_b)
    i = torch.sigmoid(ri[..., bw:] + m.rg_x_b)
    log_a = -RG_C * F.softplus(m.lam) * r
    a = torch.exp(log_a)
    return log_a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)


def rglru_scan(m: GriffinRec, x, h0=None):
    """x: [B, S, lru] -> (h_seq [B, S, lru] in x.dtype, h_last [B, lru]
    f32); ``h0`` [B, lru] is the state before the first token (zero when
    None).  Chunked f32 recurrence, see the module docstring."""
    bsz, s, lru = x.shape
    g, bw = m.lam.shape
    log_a, u = _rg_gates(m, x.reshape(bsz, s, g, bw))
    log_a, u = log_a.reshape(bsz, s, lru), u.reshape(bsz, s, lru)
    h = (torch.zeros((bsz, lru), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    causal = torch.ones((RG_CHUNK, RG_CHUNK), dtype=torch.bool,
                        device=x.device).tril()[:, :, None]
    out = torch.empty((bsz, s, lru), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, RG_CHUNK):
        t = min(RG_CHUNK, s - c0)
        cum = log_a[:, c0:c0 + t].cumsum(dim=1)  # L_t, chunk-local
        # exp(L_t - L_s) for s <= t; the mask goes in before the exp
        w = (cum[:, :, None] - cum[:, None]).masked_fill(
            ~causal[:t, :t], float("-inf")).exp_()
        y = (w * u[:, None, c0:c0 + t]).sum(dim=2) + cum.exp() * h[:, None]
        out[:, c0:c0 + t] = y
        h = y[:, -1]
    return out.to(x.dtype), h


def rglru_step(m: GriffinRec, x, h0):
    """One decode step.  x: [B, 1, lru]; h0: [B, lru] f32.  Returns
    (h [B, 1, lru] in x.dtype, new state [B, lru] f32)."""
    bsz, _, lru = x.shape
    g, bw = m.lam.shape
    log_a, u = _rg_gates(m, x.reshape(bsz, 1, g, bw))
    h = torch.exp(log_a[:, 0]).reshape(bsz, lru) * h0.float() \
        + u[:, 0].reshape(bsz, lru)
    return h[:, None].to(x.dtype), h


def griffin_rec_block(m: GriffinRec, x, cfg, *, state=None):
    """x: [B, S, d_model] -> (y, new_state).  ``state`` given => S == 1
    decode."""
    gate = F.gelu(dense(m.w_gate, x).float(), approximate="tanh").to(x.dtype)
    u = dense(m.w_in, x)
    if state is None:
        uc = _conv_linear(u, m.conv_w, m.conv_b)
        h, h_last = rglru_scan(m, uc)
        new_state = {"lru": h_last, "conv": _rec_tail(u, cfg.conv_width - 1)}
    else:
        uc, conv_new = _conv_linear_step(u, state["conv"], m.conv_w, m.conv_b)
        h, h_last = rglru_step(m, uc, state["lru"])
        new_state = {"lru": h_last, "conv": conv_new}
    return dense(m.w_out, gate * h), new_state


def _rec_tail(x, k: int):
    """Last k positions along axis 1, left-padded with zeros if S < k."""
    s = x.shape[1]
    if s >= k:
        return x[:, s - k:]
    return F.pad(x, (0, 0, k - s, 0))
