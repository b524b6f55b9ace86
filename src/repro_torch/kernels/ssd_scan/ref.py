"""Sequential-recurrence oracle of the SSD scan, in float64.

The definitional SSM semantics, one step per token::

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * B_t (outer) x_t,  a = -exp(a_log)
    y_t = C_t . h_t

It validates both the chunked algorithm (:func:`repro_torch.kernels.
ssd_scan.scan.ssd_chunked_plain`) and the CUDA kernel independently of
either, as ``repro.kernels.ssd_scan.ref.ssd_sequential_ref`` does in the
JAX package.  Every input is upcast to float64 (exact for bf16 and f32
values) and so is every product and sum; the results stay in float64.

:func:`check_ratio` is the check a scan's output is held to against the
oracle, stated before the kernel first ran on the card: per element
``|got - ref| <= rtol * |ref| + atol * max|ref|`` with (rtol, atol) =
(2^-8, 1e-3) for a bf16 output (half an ulp of the output rounding, and
float32 summation-order slack) and (2e-4, 2e-4) for float32 (the JAX
kernel test's 2e-4, scaled to |y|); the float32 final state takes the
float32 pair.
"""
from __future__ import annotations

import torch

CHECK = {torch.bfloat16: (2.0 ** -8, 1e-3), torch.float32: (2e-4, 2e-4)}


def ssd_sequential_ref(x, dt, a_log, bmat, cmat, initial_state=None):
    """x: [B, S, H, P]; dt: [B, S, H] (post-softplus); a_log: [H];
    bmat/cmat: [B, S, G, N], head ``h`` reading group ``h // (H // G)``
    (G == H is the JAX oracle's per-head layout).  Returns float64
    (y [B, S, H, P], final state [B, H, N, P])."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    f64 = torch.float64
    bh = bmat.to(f64).repeat_interleave(h // g, dim=2)  # [B, S, H, N]
    ch = cmat.to(f64).repeat_interleave(h // g, dim=2)
    xf, dtf = x.to(f64), dt.to(f64)
    a = -torch.exp(a_log.to(f64))  # [H]
    state = (torch.zeros((b, h, n, p), dtype=f64, device=x.device)
             if initial_state is None else initial_state.to(f64).clone())
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * a)  # [B, H]
        inc = bh[:, t, :, :, None] * (xf[:, t] * dtf[:, t, :, None])[:, :, None, :]
        state = state * da[..., None, None] + inc
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], state))
    y = torch.stack(ys, 1) if ys else xf.new_zeros((b, 0, h, p))
    return y, state


def check_ratio(got, oracle) -> float:
    """max over elements of |got - oracle| / (rtol |oracle| + atol
    max|oracle|) at ``got``'s dtype's (rtol, atol); <= 1 passes.  inf or
    nan when ``got`` is not finite."""
    rtol, atol = CHECK[got.dtype]
    r = oracle.to(torch.float64)
    err = (got.to(torch.float64) - r).abs()
    if not torch.isfinite(err).all():
        return float("inf")
    scale = atol * r.abs().max().clamp(min=1e-30)
    return (err / (rtol * r.abs() + scale)).max().item() if err.numel() else 0.0
