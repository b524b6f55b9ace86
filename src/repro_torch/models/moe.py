"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, shared
experts — the port of ``repro.models.moe``.

Plain torch, as the JAX package computes it outside any kernel (no
Pallas kernel routes, dispatches or runs the experts).  Both dispatches
of ``cfg.moe_impl`` keep the reference's semantics exactly, because a
drop is discrete:

  * ``einsum`` — GShard: the flattened ``[B*S]`` tokens split into
    groups of ``g = min(moe_group, t)``; each expert takes at most
    ``c = max(int(g * k / E * capacity_factor), 1)`` (token, choice)
    slots a group, token-major priority; one-hot dispatch and combine
    products around the expert FFN.  The combine weights are rounded to
    the activation dtype before the combine product, as JAX's
    ``combine.astype(dtype)``.
  * ``sort`` — a stable argsort of the flattened expert choices ranks
    every slot within its expert over all ``t`` tokens; slots ranked
    below ``ce = max(int(t * k / E * capacity_factor), 1)`` are kept.
    The kept (expert, rank) pairs are unique, so the capacity buffer is
    written by one scatter of the kept slots; each token's k slots are
    contiguous, so the combine is a sum over them — no float atomics.

Every token of the batch takes capacity, the inactive decode rows and
the padding columns of a chunk row included, as in the reference.  Where
``t > moe_group`` and ``t`` is no multiple of it the reference fails at
its reshape; :func:`moe_block` raises ``ValueError`` there.

Top-k ties take the lower expert index first, as ``jax.lax.top_k``
(:func:`repro_torch.core.sampling.top_k`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.sampling import top_k
from repro_torch.models.layers import dense

# the reference's moe-local table (the sort dispatch falls back to silu
# outside it; layers' own table also holds relu)
_ACTS = {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh")}

class MoE(nn.Module):
    """One layer's MoE parameters: ``router`` [d, E], ``w_gate`` /
    ``w_up`` [E, d, ff], ``w_down`` [E, ff, d], and optionally
    ``shared_w_gate`` / ``shared_w_up`` [d, S*ff], ``shared_w_down``
    [S*ff, d] — the JAX ``moe_decl`` leaves of one layer."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.has_shared = "shared_w_up" in tensors


def _bmm_f32(a, b):
    """Batched product of ``a`` and ``b`` (in ``a``'s dtype) accumulated
    AND returned in float32 — the reference's
    ``preferred_element_type=float32`` without a rounding to ``a.dtype``.
    A float32 ``a`` is a plain product; a bf16 one on CUDA asks cuBLAS for
    a float32 output; on the CPU the bf16 values are widened first (their
    products are exact in float32)."""
    b = b.to(a.dtype)
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def expert_ffn(moe: MoE, h, act):
    """h: [E, n, d] -> [E, n, d] through each expert's gated FFN, with the
    reference's casts: ``up`` rounded to h's dtype, ``gate`` kept in
    float32, ``mid`` rounded, the down product accumulated in float32."""
    up = torch.bmm(h, moe.w_up.to(h.dtype))
    gate = _bmm_f32(h, moe.w_gate)
    mid = (act(gate) * up.float()).to(h.dtype)
    return torch.bmm(mid, moe.w_down.to(h.dtype))


def router(moe: MoE, x, cfg):
    """x: [..., d] -> (gates [..., K] f32, idx [..., K] int64, aux 0-d):
    a float32 router, softmax, top-k (lower index first on ties),
    renormalized gates and the load-balance loss ``E * sum_e f_e p_e``."""
    logits = dense(moe.router, x.float()).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, cfg.experts_per_token)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    e = cfg.num_experts
    onehot = F.one_hot(idx, e).float()  # [..., K, E]
    f = onehot.reshape(-1, e).mean(dim=0)  # share of (token, choice) slots
    p = probs.reshape(-1, e).mean(dim=0)
    aux = e * (f * p).sum()
    return gates, idx, aux


def capacity(g: int, cfg) -> int:
    """Slots an expert takes per group of ``g`` tokens (einsum dispatch)."""
    c = int(g * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor)
    return max(c, 1)


def group_size(t: int, cfg) -> int:
    """GShard group of ``t`` flattened tokens: ``min(moe_group, t)``; the
    reference's reshape fails where ``t`` is no multiple of it."""
    g = min(int(getattr(cfg, "moe_group", 512)), t)
    if t % g:
        raise ValueError(
            f"moe_block: {t} tokens do not split into groups of {g} "
            f"(moe_group {cfg.moe_group}); the reference's dispatch "
            f"reshape fails here too")
    return g


def einsum_slots(idx, e: int, c: int):
    """GShard slot positions: idx [G, g, K] -> (pos_in [G, g, K] int64,
    the slot's rank within its expert in token-major order; keep [G, g, K]
    bool, pos_in < c)."""
    G, g, k = idx.shape
    oh = F.one_hot(idx, e).reshape(G, g * k, e)
    pos = (torch.cumsum(oh, dim=1) - 1).reshape(G, g, k, e)
    pos_in = (pos * oh.reshape(G, g, k, e)).sum(-1)
    return pos_in, pos_in < c


def sort_slots(idx, e: int, ce: int):
    """Sort-dispatch ranks: idx [t, K] (flattened) -> (rank [t*K] int64,
    the slot's rank within its expert after a stable sort; keep, rank <
    ce)."""
    flat_e = idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    counts = F.one_hot(flat_e, e).sum(0)  # bincount would sync the host
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(flat_e.numel(), device=idx.device) \
        - starts[flat_e[order]]
    rank = torch.empty_like(rank_sorted).index_copy_(0, order, rank_sorted)
    return rank, rank < ce


def _dispatch_einsum(moe, xg, gates, idx, cfg):
    """GShard dispatch: [G, g, d] -> [E, G, C, d] -> expert FFN ->
    combine."""
    G, g, d = xg.shape
    e = cfg.num_experts
    c = capacity(g, cfg)
    pos_in, keep = einsum_slots(idx, e, c)
    oh_e = F.one_hot(idx, e).float()  # [G, g, K, E]
    oh_c = F.one_hot(torch.where(keep, pos_in, c), c + 1)[..., :c].float()
    combine = torch.einsum("GsKE,GsKC->GsEC",
                           oh_e * (gates * keep)[..., None], oh_c)
    dispatch = torch.einsum("GsKE,GsKC->GsEC", oh_e * keep[..., None], oh_c)
    dtype = xg.dtype
    # one-hot dispatch: every output element is one token's value or zero
    expert_in = torch.einsum("GsEC,Gsd->EGCd", dispatch.to(dtype), xg)
    out = expert_ffn(moe, expert_in.reshape(e, G * c, d), _ACTS[cfg.act])
    out = out.reshape(e, G, c, d)
    return torch.einsum("EGCd,GsEC->Gsd", out, combine.to(dtype))


def _dispatch_sort(moe, xg, gates, idx, cfg):
    """Sort dispatch: permute token copies into [E, ce, d] buffers by a
    scatter of the kept slots."""
    G, g, d = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = G * g
    ce = max(int(t * k / e * cfg.capacity_factor), 1)
    act = _ACTS[cfg.act if cfg.act in _ACTS else "silu"]
    x_flat = xg.reshape(t, d)
    flat_e = idx.reshape(t * k)
    rank, keep = sort_slots(idx.reshape(t, k), e, ce)
    # kept (expert, rank) pairs are unique; a dropped slot lands in a spare
    # column ce that is cut off before the FFN (no data-dependent shape, so
    # no host sync, and no accumulation)
    buf = torch.zeros((e, ce + 1, d), dtype=xg.dtype, device=xg.device)
    tok_of_slot = torch.arange(t, device=xg.device).repeat_interleave(k)
    buf[flat_e, torch.where(keep, rank, ce)] = x_flat[tok_of_slot]
    out = expert_ffn(moe, buf[:, :ce], act)  # [E, ce, d]
    safe_e = torch.where(keep, flat_e, 0)
    safe_rank = torch.where(keep, rank, 0)
    y_slots = out[safe_e, safe_rank].float() \
        * (gates.reshape(t * k) * keep)[:, None]
    # a token's k slots are contiguous: its combine is a sum over them
    y = y_slots.reshape(t, k, d).sum(dim=1)
    return y.to(xg.dtype).reshape(G, g, d)


def moe_block(moe: MoE, x, cfg):
    """x: [B, S, d] -> (y [B, S, d], aux 0-d f32)."""
    if getattr(cfg, "accum_dtype", "float32") != "float32":
        raise NotImplementedError(
            f"accum_dtype {cfg.accum_dtype!r}: the port accumulates every "
            f"product in float32")
    b, s, d = x.shape
    t = b * s
    g = group_size(t, cfg)
    xg = x.reshape(t // g, g, d)
    gates, idx, aux = router(moe, xg, cfg)
    if cfg.moe_impl == "einsum":
        y = _dispatch_einsum(moe, xg, gates, idx, cfg)
    elif cfg.moe_impl == "sort":
        y = _dispatch_sort(moe, xg, gates, idx, cfg)
    else:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
    y = y.reshape(b, s, d)
    if moe.has_shared:
        act = _ACTS[cfg.act]
        up = dense(moe.shared_w_up, x)
        gate = dense(moe.shared_w_gate, x)
        mid = (act(gate.float()) * up.float()).to(x.dtype)
        y = y + dense(moe.shared_w_down, mid)
    return y, aux
