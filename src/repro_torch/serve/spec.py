"""Draft proposers for speculative decoding through the unified serve step
— the port of ``repro.serve.spec``.

The unified engine's spec mode (:mod:`repro_torch.serve.step`) turns the
one-token decode lane into verified spans: each decode-active slot
proposes ``K`` draft tokens, the target scores all ``K + 1`` span
positions in one pass through the paged span path, and the accepted
prefix commits (:func:`repro_torch.core.sampling.spec_accept`).  Two
proposers:

  * :class:`NGramProposer` — prompt-lookup drafting on the host (numpy):
    the continuation after the most recent earlier occurrence of the
    context's trailing n-gram.  A point-mass proposal.
  * :class:`DraftModelProposer` — a small model sharing the target's
    vocab, decoding over its own slot-indexed contiguous cache on the
    engine's device.  The cache is position-addressed, so writes of
    rejected drafts are inert: every position is rewritten in order by the
    committed token (catch-up) before a later query attends it.

Both expose the interface the engine consumes::

    reset_slot(slot)                  # a new occupant was admitted
    propose(slots, contexts, k)       # -> (drafts [n, k] int32 numpy,
                                      #     q [n, k, V] float32 tensor | None)

``contexts[i]`` is the committed context (prompt + generated tokens) of
engine slot ``slots[i]``; ``q is None`` declares a deterministic proposer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sampling import target_log_probs


class DraftProposer:
    """Interface consumed by the spec-mode unified engine."""

    def reset_slot(self, slot: int) -> None:
        """A new request was admitted into ``slot``: drop its drafting
        state."""

    def propose(self, slots, contexts, k: int):
        raise NotImplementedError


class NGramProposer(DraftProposer):
    """Prompt-lookup drafting: the longest ``n`` in ``[min_ngram,
    max_ngram]`` whose trailing n-gram occurred earlier wins; without a
    match the last token is repeated."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def _continuation(self, ctx: np.ndarray, k: int) -> np.ndarray:
        out = np.full((k,), int(ctx[-1]) if len(ctx) else 0, np.int32)
        ln = len(ctx)
        for n in range(min(self.max_ngram, ln - 1), self.min_ngram - 1, -1):
            pat = ctx[ln - n:]
            # windows over ctx[:-1]: a match has >= 1 continuation token
            # and is never the trailing pattern itself
            wins = np.lib.stride_tricks.sliding_window_view(ctx[:ln - 1], n)
            hits = np.nonzero((wins == pat[None, :]).all(axis=1))[0]
            if len(hits):
                p = int(hits[-1]) + n
                cont = ctx[p:p + k]
                out[:len(cont)] = cont
                break
        return out

    def propose(self, slots, contexts, k: int):
        drafts = np.zeros((len(slots), k), np.int32)
        for i, ctx in enumerate(contexts):
            drafts[i] = self._continuation(np.asarray(ctx), k)
        return drafts, None  # deterministic: point-mass proposal


class DraftModelProposer(DraftProposer):
    """Small-model drafting over a slot-indexed contiguous cache
    ``[L, num_slots, C, Hkv, D]`` (``model.cache_specs``); ``_len[slot]``
    counts the COMMITTED positions written.  Each :meth:`propose`:

      1. *prefill* — a slot reset since its last proposal prefills its
         whole context but the last token, scattered into its region;
      2. *catch-up* — committed tokens past ``_len`` (accepted drafts and
         the last correction) are replayed through batched decode steps,
         so the cache holds the committed tokens at their positions before
         anything attends them;
      3. *proposal* — ``k`` decode steps from each row's last token
         (argmax when greedy; at temperature > 0 draws from
         :func:`target_log_probs` and returns that distribution as ``q``).

    Every step runs all ``num_slots`` rows; rows not proposing write at or
    past their ``_len``, which the next catch-up rewrites before a read.
    Write positions stop at ``max_len - 1`` (the JAX scatter drops the
    writes past the cache instead): only rows holding no drafting state
    reach it, since the engine clamps every span to its capacity.
    ``model`` is a :class:`repro_torch.models.model.DecoderLM` (None builds
    one seeded ``seed + 1`` on ``device``)."""

    def __init__(self, cfg, model=None, *, num_slots: int, max_len: int,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0, device="cuda"):
        from repro_torch.models.model import build_model, resolve_device

        if cfg.family != "dense":
            raise ValueError("draft model must be an attention-only family")
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = build_model(cfg, device=self.device, seed=seed + 1)
        if model.device != self.device:
            raise ValueError(f"draft model is on {model.device}, proposer "
                             f"on {self.device}")
        self.model = model.serving_view(cfg)
        self.num_slots = int(num_slots)
        self.capacity = int(max_len)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self._caches = {name: torch.zeros(shape, dtype=dt, device=self.device)
                        for name, (shape, dt) in self.model.cache_specs(
                            self.num_slots, self.capacity).items()}
        self._len = np.zeros((self.num_slots,), np.int64)
        self._calls = 0  # proposal counter (seeds the draft's draws)

    def reset_slot(self, slot: int) -> None:
        self._len[slot] = 0

    def _t(self, x, dtype=torch.int32):
        return torch.from_numpy(np.asarray(x)).to(self.device, dtype)

    def _prefill(self, slot: int, tokens: np.ndarray) -> None:
        """Prefill one context ([L] tokens) and scatter its cache region
        into the slot."""
        new, _ = self.model.prefill(self._t(tokens[None]), max_len=self.capacity)
        for name, leaf in self._caches.items():
            leaf[:, slot] = new[name][:, 0].to(leaf.dtype)

    def _generator(self) -> torch.Generator | None:
        if self.temperature <= 0.0:
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(hash((self.seed, self._calls)) & (2**62 - 1))
        return g

    def propose(self, slots, contexts, k: int):
        contexts = [np.asarray(c, np.int64) for c in contexts]
        cap = self.capacity
        with torch.inference_mode():
            # 1) whole-context prefill for slots reset since their last call
            for s, ctx in zip(slots, contexts):
                if self._len[s] == 0 and len(ctx) > 1:
                    self._prefill(s, ctx[:-1])
                    self._len[s] = len(ctx) - 1
            # 2) batched catch-up of the committed tokens past _len
            need = {s: max(len(ctx) - 1 - int(self._len[s]), 0)
                    for s, ctx in zip(slots, contexts)}
            t_max = max(need.values(), default=0)
            if t_max > 0:
                feed = np.zeros((self.num_slots, t_max), np.int32)
                for s, ctx in zip(slots, contexts):
                    take = ctx[self._len[s]:self._len[s] + need[s]]
                    feed[s, :len(take)] = take
                feed = self._t(feed)
                idx = self._t(np.minimum(self._len, cap - 1))
                for t in range(t_max):
                    self.model.decode_step(self._caches, feed[:, t], idx)
                    idx = (idx + 1).clamp(max=cap - 1)
                for s in slots:
                    self._len[s] += need[s]
            # 3) k decode steps from each proposing row's last token
            tok = np.zeros((self.num_slots,), np.int32)
            idx = np.minimum(self._len, cap - 1).astype(np.int32)
            for s, ctx in zip(slots, contexts):
                if len(ctx):
                    tok[s] = ctx[-1]
                    idx[s] = min(len(ctx) - 1, cap - 1)
            gen = self._generator()
            self._calls += 1
            tok, idx = self._t(tok), self._t(idx)
            vocab = self.cfg.vocab_size
            drafts, qs = [], []
            for _ in range(k):
                lg = self.model.decode_step(self._caches, tok, idx)
                if gen is None:
                    tok = torch.argmax(lg[:, :vocab], dim=-1).to(torch.int32)
                else:
                    probs = torch.exp(target_log_probs(
                        lg, self.temperature, vocab, self.top_k, self.top_p))
                    tok = torch.multinomial(probs, 1, generator=gen)[:, 0].to(
                        torch.int32)
                    qs.append(probs)
                drafts.append(tok)
                idx = (idx + 1).clamp(max=cap - 1)
            for s, ctx in zip(slots, contexts):
                self._len[s] = len(ctx)  # the last-token feed wrote L-1
            sel = self._t(list(slots), torch.long)
            out = torch.stack(drafts, dim=1)[sel].cpu().numpy()
            # q stays on the device: the engine scatters it into the verify
            # batch there
            q = torch.stack(qs, dim=1)[sel] if qs else None
        return out.astype(np.int32), q


def make_proposer(spec: str, cfg, *, num_slots: int, max_len: int,
                  temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                  seed: int = 0, device="cuda"):
    """CLI factory: ``ngram`` or ``draft:<arch>`` (a reduced single-layer
    config of ``<arch>`` with the target's vocab, random weights seeded
    ``seed + 1``, on ``device``)."""
    if spec == "ngram":
        return NGramProposer()
    if spec.startswith("draft:"):
        from repro_torch.configs import get_config, reduced

        dcfg = reduced(get_config(spec[len("draft:"):]), num_layers=1)
        dcfg = dcfg.replace(vocab_size=cfg.vocab_size)
        return DraftModelProposer(
            dcfg, num_slots=num_slots, max_len=max_len,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            device=device)
    raise ValueError(f"unknown --spec {spec!r} (ngram | draft:<arch>)")
