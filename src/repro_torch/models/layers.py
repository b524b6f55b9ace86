"""Layer primitives on tensors: RMSNorm (plain and Mamba-2's gated),
dense, rotary embedding, embeddings, LM head and the SwiGLU MLP.

Plain functions over tensors, mirroring ``repro.models.layers``.  Dense
weights keep the JAX package's ``[in, out...]`` layout, so a projection is
one ``torch.matmul`` against the weight viewed as ``[in, prod(out)]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class RMSNorm(nn.Module):
    """A norm's scale as a module parameter (state-dict key ``.scale``)."""

    def __init__(self, scale):
        super().__init__()
        self.scale = nn.Parameter(scale, requires_grad=False)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rmsnorm_gated(scale: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Mamba-2 gated RMSNorm: norm(x * silu(gate)) in float32."""
    xf = x.float() * F.silu(gate.float())
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def dense(w: torch.Tensor, x: torch.Tensor, b: torch.Tensor | None = None
          ) -> torch.Tensor:
    """y[..., o1, o2, ...] = x[..., i] @ w[i, o1, o2, ...] (+ b).

    Float32 accumulation: a float32 product runs in float32 (TF32 stays off
    unless the caller enables it), and cuBLAS accumulates bf16 products in
    float32 before rounding the output to x.dtype."""
    out_dims = w.shape[1:]
    y = torch.matmul(x, w.to(x.dtype).reshape(w.shape[0], -1))
    y = y.reshape(*x.shape[:-1], *out_dims)
    if b is not None:
        y = (y.float() + b).to(x.dtype)
    return y


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] integer (broadcastable)."""
    d = x.shape[-1]
    half = d // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., :, None].float() * freq  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor, dtype
                 ) -> torch.Tensor:
    return embedding[tokens].to(dtype)


def lm_logits(head: torch.Tensor, x: torch.Tensor, vocab_size: int
              ) -> torch.Tensor:
    """Float32 logits over the padded vocab; pad ids masked to -1e9.
    ``head`` is [d_model, V_padded]."""
    logits = torch.matmul(x, head.to(x.dtype)).float()
    v = logits.shape[-1]
    if v != vocab_size:
        pad = torch.arange(v, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits


_ACTS = {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh"),
         "relu": F.relu}


def apply_mlp(mlp, x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU (gated) or plain two-matrix MLP; ``mlp`` holds w_up,
    optional w_gate, w_down."""
    up = dense(mlp.w_up, x)
    if mlp.w_gate is not None:
        h = _ACTS[act](dense(mlp.w_gate, x)) * up
    else:
        h = _ACTS[act](up)
    return dense(mlp.w_down, h)
