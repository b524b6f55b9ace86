"""Token sampling on device: greedy argmax or filtered-temperature draws.

Mirrors ``repro.core.sampling.filter_logits`` / ``sample_logits``.  Greedy
decode (``temperature <= 0``) consumes no randomness and ignores the
top-k / top-p filters (the argmax survives any filter): exact argmax over
the unpadded vocab, first index on ties.  Temperature > 0 draws from an
explicit ``torch.Generator`` (the engine seeds one per dispatch); the bits
differ from JAX's threefry stream, the distribution does not.
"""
from __future__ import annotations

import torch

NEG_FILTERED = -2.0e38  # mask value for filtered-out vocab entries


def filter_logits(lg, top_k: int = 0, top_p: float = 1.0):
    """Top-k then nucleus (top-p) filtering over the last axis.  The
    max-probability token is always kept; top-k keeps ties with the k-th
    value."""
    if top_k and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, NEG_FILTERED)
    if top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        exclusive = torch.cumsum(probs, dim=-1) - probs
        keep = exclusive < top_p  # column 0 always kept
        inf = torch.full((), float("inf"), device=lg.device, dtype=srt.dtype)
        thresh = torch.where(keep, srt, inf).min(dim=-1, keepdim=True).values
        lg = lg.masked_fill(lg < thresh, NEG_FILTERED)
    return lg


def sample_logits(logits, generator, temperature: float, vocab: int,
                  top_k: int = 0, top_p: float = 1.0):
    """logits [..., V_padded] -> int32 token ids [...]."""
    lg = logits[..., :vocab]
    if temperature <= 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    lg = filter_logits(lg.float() / temperature, top_k, top_p)
    probs = torch.softmax(lg, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return draw.reshape(lg.shape[:-1]).to(torch.int32)
