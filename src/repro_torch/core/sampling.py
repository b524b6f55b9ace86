"""Token sampling on device: greedy argmax or filtered-temperature draws.

Mirrors ``repro.core.sampling.filter_logits`` / ``sample_logits``.  Greedy
decode (``temperature <= 0``) consumes no randomness and ignores the
top-k / top-p filters (the argmax survives any filter): exact argmax over
the unpadded vocab, first index on ties.  Temperature > 0 draws from an
explicit ``torch.Generator`` (the engine seeds one per dispatch); the bits
differ from JAX's threefry stream, the distribution does not.
:func:`spec_accept` verifies speculative draft spans (greedy longest
argmax prefix, or rejection sampling that keeps the target distribution
of :func:`target_log_probs`).
"""
from __future__ import annotations

import torch

NEG_FILTERED = -2.0e38  # mask value for filtered-out vocab entries

# the fork plane of the seed derivation: the engine's dispatch seeds are
# hashed from (seed, dispatch, salt) with small salts, so a fork seed can
# never collide with a dispatch stream
_FORK_SALT = 1 << 19
_SEED_MASK = 2**62 - 1


def fork_seed(seed: int, fork_index: int) -> int:
    """Generator seed of fork ``fork_index`` of an n-way fan sampled from
    a generator seeded with ``seed`` (``repro.core.sampling.fork_key``).
    Fork 0 is the parent and keeps ``seed`` unchanged, so its stream is
    bit-identical to an unforked request's; siblings get seeds that are
    pure functions of (seed, fork index), so one engine seed reproduces
    every stream of the fan."""
    if fork_index == 0:
        return int(seed)
    return hash((int(seed), _FORK_SALT + int(fork_index))) & _SEED_MASK


def top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries on the last axis,
    largest first and the lower index first among equal values — the
    order of ``jax.lax.top_k``, which ``torch.topk`` does not promise."""
    srt = torch.sort(x, dim=-1, descending=True, stable=True)
    return srt.values[..., :k], srt.indices[..., :k]


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
    return _categorical(torch.softmax(lg, dim=-1), generator).to(torch.int32)


def _categorical(probs, generator):
    """One draw per row of ``probs`` [..., V] (unnormalized, >= 0)."""
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return draw.reshape(probs.shape[:-1])


def target_log_probs(logits, temperature: float, vocab: int,
                     top_k: int = 0, top_p: float = 1.0):
    """Normalized log-probs of the distribution :func:`sample_logits`
    draws from — the one speculative rejection sampling must preserve.
    Only meaningful for ``temperature > 0``."""
    lg = filter_logits(logits[..., :vocab].float() / temperature, top_k, top_p)
    return torch.log_softmax(lg, dim=-1)


def spec_accept(logits, drafts, draft_len, draft_q, generator,
                temperature: float, vocab: int, top_k: int = 0,
                top_p: float = 1.0):
    """Verify per-row draft spans against the target logits of one span
    pass (``repro.core.sampling.spec_accept``).

    logits [B, K+1, V_padded]: ``logits[:, j]`` predicts the token after
    span position j of ``[root, d_0 .. d_{K-1}]``; drafts [B, K] int;
    draft_len [B] (0 = inactive row, its outputs are garbage); draft_q
    [B, K, V] proposal probabilities, or None for a deterministic proposer
    (a point mass: ``d_j`` is accepted with probability ``p(d_j)``).
    Returns (out_tokens [B, K+1] int32, n_acc [B] int32): row ``b``
    commits ``out_tokens[b, :n_acc[b] + 1]``, the accepted prefix plus
    one correction (first rejection) or bonus (all accepted) token.
    Greedy is the longest argmax-matching prefix and draws nothing; at
    temperature > 0 the draws come from ``generator`` only, and the
    residual ``max(p - q, 0)`` is used only at a rejected position."""
    lg = logits[..., :vocab]
    b, k = drafts.shape
    drafts = drafts.long()
    ar = torch.arange(k, device=lg.device)
    valid = ar[None, :] < draft_len.long()[:, None]
    if temperature <= 0.0:
        tgt = torch.argmax(lg, dim=-1)  # [B, K+1]
        match = (drafts == tgt[:, :k]) & valid
        n_acc = torch.cumprod(match.long(), dim=1).sum(dim=1)
        final = tgt.gather(1, n_acc[:, None])[:, 0]
    else:
        p = torch.exp(target_log_probs(lg, temperature, vocab, top_k, top_p))
        p_d = p[:, :k].gather(2, drafts[..., None])[..., 0]
        if draft_q is None:
            ratio = p_d  # point-mass proposal: q(d) == 1
        else:
            q_d = draft_q.float().gather(2, drafts[..., None])[..., 0]
            ratio = p_d / q_d.clamp(min=1e-20)
        u = torch.rand(drafts.shape, generator=generator, device=lg.device)
        accept = (u < ratio) & valid
        n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)
        # the stop position samples norm(max(p - q, 0)) only where a draft
        # was rejected (n_acc < draft_len); the bonus position after a
        # fully accepted span was never tested and samples plain p
        if draft_q is None:
            q_ext = torch.nn.functional.one_hot(
                torch.nn.functional.pad(drafts, (0, 1)), vocab).to(p.dtype)
        else:
            q_ext = torch.nn.functional.pad(draft_q.to(p.dtype), (0, 0, 0, 1))
        at = n_acc[:, None, None].expand(-1, 1, p.shape[-1])
        p_at = p.gather(1, at)[:, 0]
        q_at = q_ext.gather(1, at)[:, 0]
        rejected = (n_acc < draft_len.long())[:, None]
        res = torch.where(rejected, (p_at - q_at).clamp(min=0.0), p_at)
        # p == q exactly leaves an empty residual: fall back to p
        res = torch.where(res.sum(-1, keepdim=True) > 0, res, p_at)
        final = _categorical(res, generator)
    pad = torch.nn.functional.pad(drafts, (0, 1))
    hit = torch.arange(k + 1, device=lg.device)[None, :] == n_acc[:, None]
    out = torch.where(hit, final[:, None], pad)
    return out.to(torch.int32), n_acc.to(torch.int32)
