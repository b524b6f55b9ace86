"""Unified token-budget serve step: chunked prefill + decode in one batch.

:class:`UnifiedServeEngine` is the port of ``repro.serve.step``'s non-spec
engine.  Each scheduler iteration runs ONE dispatch under a token budget
(``max_step_tokens``):

  * every decode-active slot gets 1 token — the decode sub-batch runs
    ``steps`` decode iterations (``_decode_scan``) through the paged
    decode kernel, inactive rows' block tables masked to the NULL block;
  * the rest of the budget goes to prefill **chunks**: up to
    ``chunk_rows`` in-flight prompts stream ``chunk_size`` slices into the
    paged pool through the ragged span kernel (``DecoderLM.span_step``),
    sampling ONLY rows that complete their prompt and folding that first
    token and its decode position into the slot registers on device.

Only the token-only attention families (dense, moe) stream chunks
(:attr:`chunkable`).  The others are admitted whole, through the
inherited grouped-prefill path (``_prefill_groups`` / ``_do_prefill``)
and its admission policy, with no prefix cache or chunk rows: a
state-carrying family (ssm: mamba2, the SSD scan kernel in every layer;
hybrid: recurrentgemma, the flash kernel in its attention layers) cannot
resume a prompt mid-way, and a vlm prompt (internvl2) carries patch
embeddings off the token grid.  Their prompt tokens (patches included)
are folded into the next dispatch's counter triple; the decode
dispatches run through the pool where the family has one (hybrid, vlm)
and without block tables where it has none (ssm).

Block allocation is just-in-time per chunk: admission demands blocks for
the request's FIRST chunk only (+1 decode headroom), later chunks allocate
as they stream, and a dry pool preempts decode slots newest-first.
Prefix-cache hits skip whole leading blocks (the chunk cursor starts at
the hit boundary); full prompt blocks are registered when the prompt
completes, so a preemption-resumed request re-hits its own prompt.

The run loop keeps the JAX engine's one-deep pipeline: dispatch N+1 is
planned and enqueued on the card's stream before dispatch N's tokens are
fetched, so the fetch (the one host sync) overlaps device compute.

**Speculative decoding** (``spec=`` a :mod:`repro_torch.serve.spec`
proposer) turns the decode lane into verified spans: each decode-active
slot proposes up to ``K`` drafts, and ONE span pass per dispatch
(``DecoderLM.span_step``, the ragged span kernel) scores all ``K + 1``
positions of every slot, with the prefill chunk rows in the same batch;
:func:`repro_torch.core.sampling.spec_accept` commits the accepted prefix
plus one correction or bonus token on the device.  Rejected drafts leave
K/V past the committed frontier, which the next span overwrites before
any query attends it; trailing blocks holding only such residue go back
to the pool after each dispatch.  Draft + verify positions are charged
against ``max_step_tokens``, each dispatch is fetched synchronously (the
next drafts need its tokens), and ``EV_SPEC_DRAFTED`` /
``EV_SPEC_ACCEPTED`` / ``EV_SPEC_K`` are emitted per dispatch.
``spec_adaptive`` walks ``K`` with an EMA of the acceptance rate.

**n-way forks** (``submit(n_samples=n)``): the prompt prefills ONCE;
when its last chunk samples, the dispatch also samples a fan of first
tokens, one column per fork (column 0 is the chunk sample itself, so
fork 0 equals an unforked request; sibling i draws from its own
generator, :func:`repro_torch.core.sampling.fork_seed`).  Each sibling
adopted into a free slot aliases every parent block through
``BlockPool.fork`` (zero copies; the shared partial tail is copied on
write at its first decode write, in ``_ensure_blocks`` and in the spec
planner alike) and its registers are seeded on the device from the fan
still in flight.  Siblings that find no free slot requeue at the front
and re-admit through the prefix cache.

**Beam search** (:meth:`UnifiedServeEngine.beam_search`) runs on an idle
engine on the same mechanism: the prompt prefills once as one span row
into beam 0's blocks, the other beams alias them, every step is one
paged decode over the beam rows, and each host-side prune reseats a beam
by ``pool.fork`` of its source (``EV_FORK``, value source + 1) before
the old rows are freed; the write frontier is copied on write.

Per-iteration ``EV_STEP_BUDGET`` / ``EV_CHUNK_TOKENS`` /
``EV_DECODE_TOKENS`` counters go to the ``tracer`` when one is given.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.sampling import sample_logits, spec_accept, top_k
from repro_torch.serve.block_pool import NULL_BLOCK
from repro_torch.serve.engine import EV_TOKENS_DECODED, ContinuousServeEngine
from repro_torch.serve.queue import Request, _now_ns


@dataclasses.dataclass
class ChunkPlan:
    """One prefill chunk scheduled into the current unified step."""
    slot: int
    req: Request
    start: int  # absolute position of the chunk's first token
    length: int  # valid tokens (<= chunk_size)
    tokens: np.ndarray  # [length] int32
    sample: bool  # True when this chunk completes the prompt
    # fork children adopted into free slots when this chunk completed a
    # fan-out parent's prompt; each reads its first token from its own
    # column of the dispatch's fan
    forked: list[Request] = dataclasses.field(default_factory=list)

    def fans(self) -> bool:
        """This chunk completes the ONE prefill of an n-way fan-out (a
        preemption-resumed parent keeps its forks: no second fan)."""
        r = self.req
        return self.sample and r.n_samples > 1 and r.fork_of < 0 \
            and not r.forks


@dataclasses.dataclass
class _Inflight:
    """A dispatch whose tokens are not fetched yet."""
    toks: torch.Tensor  # [steps, num_slots] decode tokens (device)
    ck_fan: torch.Tensor | None  # [chunk_rows, F] first-token fan (device)
    pairs: list
    chunks: list


class UnifiedServeEngine(ContinuousServeEngine):
    """Continuous batching through the unified token-budget step."""

    def __init__(self, cfg, model=None, *, max_step_tokens: int | None = None,
                 chunk_size: int | None = None, chunk_rows: int = 2,
                 mixed_burst: int = 4, spec=None, spec_k: int = 4,
                 spec_adaptive: bool = False, **kwargs):
        super().__init__(cfg, model, **kwargs)
        self.chunk_size = int(chunk_size or max(2 * self.block_size, 16))
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.chunk_rows = max(1, int(chunk_rows))
        self.mixed_burst = max(1, min(int(mixed_burst), self.max_decode_burst))
        self.max_step_tokens = int(
            max_step_tokens
            or (self.num_slots + self.chunk_size * self.chunk_rows))
        if self.max_step_tokens < self.num_slots:
            raise ValueError(
                f"max_step_tokens {self.max_step_tokens} < num_slots "
                f"{self.num_slots}: decode alone would overrun the budget")
        # chunked prefill resumes a prompt mid-way from pooled K/V
        self.chunkable = self.model.chunk_resumable()
        self._progress = np.zeros((self.num_slots,), np.int64)
        self._target = np.zeros((self.num_slots,), np.int64)
        self._prefilling = np.zeros((self.num_slots,), bool)
        # whole-prompt tokens prefilled since the last dispatch (not
        # chunkable), folded into the next dispatch's counter triple
        self._whole_tokens = 0
        if self.tracer is not None:
            for code in (ev.EV_STEP_BUDGET, ev.EV_CHUNK_TOKENS,
                         ev.EV_DECODE_TOKENS):
                self.tracer.register(code, ev.SERVE_CTR_LABELS[code])
            self.tracer.register(
                ev.EV_FORK, "CoW fork: child stream minted (parent rid+1)")
        # speculative decoding: draft/verify spans through the span path
        self.spec = spec
        self.spec_k_max = max(1, int(spec_k))
        self.spec_adaptive = bool(spec_adaptive)
        self._spec_k = self.spec_k_max  # current width (adaptive shrinks it)
        self._accept_ema = 1.0  # optimistic start: first dispatches run wide
        if spec is not None:
            if not self.chunkable:
                raise ValueError(
                    "speculative decoding needs the fully-paged span path "
                    f"(dense/moe families); {cfg.family!r} cannot run it")
            self.stats.update(spec_dispatches=0, spec_drafted=0,
                              spec_accepted=0, spec_rollback_blocks=0)
            if self.tracer is not None:
                for code in (ev.EV_SPEC_DRAFTED, ev.EV_SPEC_ACCEPTED,
                             ev.EV_SPEC_K):
                    self.tracer.register(code, ev.SERVE_CTR_LABELS[code])

    @property
    def supports_fork(self) -> bool:
        # n-way fan-out rides the chunk-sampling fork path: chunkable
        # configs only; the others keep the base class's loud refusal
        return self.chunkable

    # ------------------------------------------------------------------
    # one dispatch: decode sub-batch + chunk sub-batch
    # ------------------------------------------------------------------
    def _unified_impl(self, tok, idx, active, tables, chunks, steps):
        """One token-budget iteration, enqueued on the device.

        Decode sub-batch: ``steps`` iterations over the slot pool; inactive
        rows' tables are masked to NULL so a mid-prefill slot's stale
        registers can never scribble on the blocks its chunks stream into.
        Chunk sub-batch: the span rows scatter into the pool (slots
        disjoint from every decode write) and sample only where a chunk
        completes its prompt; each sampled first token and its decode
        position go straight into the slot registers.
        Returns (tok, idx, toks [steps, S], ck_fan [C, F] or None)."""
        gen = self._generator()
        bt = (tables.masked_fill(~active[:, None], NULL_BLOCK)
              if self._has_paged else None)
        if steps:
            tok, idx, toks = self._decode_scan(tok, idx, active, bt, gen, steps)
        else:
            toks = torch.zeros((0, self.num_slots), dtype=torch.int32,
                               device=self.device)
        if not chunks:
            return tok, idx, toks, None
        ck_tokens, ck_start, ck_len, ck_slot = self._pack_chunks(chunks)
        logits = self.model.span_step(self._caches, ck_tokens, ck_start,
                                      ck_len, tables[ck_slot])
        tok, idx, ck_fan = self._fold_chunk_rows(logits, chunks, ck_len,
                                                 tok, idx)
        return tok, idx, toks, ck_fan

    def _pack_chunks(self, chunks: list[ChunkPlan]):
        """The chunk plans as fixed-shape device rows: tokens
        [chunk_rows, chunk_size], start, length and slot [chunk_rows]."""
        rows = self.chunk_rows
        ck_tokens = np.zeros((rows, self.chunk_size), np.int32)
        ck_start = np.zeros((rows,), np.int32)
        ck_len = np.zeros((rows,), np.int32)
        ck_slot = np.zeros((rows,), np.int64)
        for i, c in enumerate(chunks):
            ck_tokens[i, :c.length] = c.tokens
            ck_start[i], ck_len[i], ck_slot[i] = c.start, c.length, c.slot
        return (self._dev(ck_tokens), self._dev(ck_start), self._dev(ck_len),
                self._dev(ck_slot))

    def _fold_chunk_rows(self, logits, chunks, ck_len, tok, idx):
        """Sample each chunk row's last valid position, and fold the first
        token and decode position of every row that completes its prompt
        into the slot registers.  Shared by the unified and spec steps.
        Returns (tok, idx, ck_fan [chunk_rows, F]): column 0 is the
        chunk sample; where a row completes a fan-out prompt, column i < F
        is the first token of fork i (:meth:`_fan`)."""
        rows = self.chunk_rows
        last = logits[torch.arange(rows, device=self.device),
                      (ck_len.long() - 1).clamp(min=0)]
        ck_tok = sample_logits(last, self._generator(salt=1), self.temperature,
                               self.cfg.vocab_size, self.top_k, self.top_p)
        ck_fan = self._fan(last, ck_tok, chunks)
        done = [i for i, c in enumerate(chunks) if c.sample]
        if done:
            sel = self._dev(np.asarray(done, np.int64))
            slots = self._dev(np.asarray([chunks[i].slot for i in done], np.int64))
            pos = [chunks[i].start + chunks[i].length for i in done]
            tok = tok.index_copy(0, slots, ck_tok[sel])
            idx = idx.index_copy(0, slots, self._dev(np.asarray(pos, np.int32)))
        return tok, idx, ck_fan

    def _fan(self, last, ck_tok, chunks):
        """The sibling fan of a dispatch: [chunk_rows, F] first tokens.
        Column 0 is ``ck_tok`` itself (the parent's stream is untouched);
        column i draws from fork i's generator, a pure function of (seed,
        dispatch, i); greedy columns all equal the argmax.  F is 1 unless
        a chunk completes a fan-out prompt; then it covers every fork a
        free slot can adopt (at most ``num_slots - 1`` siblings), each
        column independent of how many are drawn."""
        n = max((min(c.req.n_samples, self.num_slots) for c in chunks
                 if c.fans()), default=1)
        if n == 1 or self.temperature <= 0.0:
            return ck_tok[:, None].expand(-1, n)
        fan = [ck_tok]
        for i in range(1, n):
            fan.append(sample_logits(last, self._generator(salt=1, fork=i),
                                     self.temperature, self.cfg.vocab_size,
                                     self.top_k, self.top_p))
        return torch.stack(fan, dim=1)

    # ------------------------------------------------------------------
    # one speculative dispatch: verify spans + chunk rows in one span pass
    # ------------------------------------------------------------------
    def _spec_impl(self, tok, idx, active, tables, drafts, draft_q, spec_len,
                   chunks):
        """One speculative dispatch in ONE span pass, enqueued on the
        device.  Every slot contributes a row ``[tok, d_0 .. d_{K-1}]`` at
        positions ``idx .. idx + K`` with ``spec_len`` valid tokens
        (``k + 1`` for a planned slot, 0 otherwise: an idle row scatters
        only into the NULL block and its outputs are discarded); the chunk
        rows ride the same batch, padded to the common width.
        :func:`spec_accept` commits each slot's accepted prefix plus one
        token into the registers; completed prompts sample their first
        token.  Returns (tok, idx, out_toks [S, K+1], n_acc [S], ck_fan
        [chunk_rows, F] or None)."""
        kmax = self.spec_k_max
        width = max(kmax + 1, self.chunk_size) if chunks else kmax + 1
        row_tokens = torch.nn.functional.pad(
            torch.cat([tok[:, None], drafts], dim=1), (0, width - (kmax + 1)))
        row_start, row_len = idx, spec_len
        row_bt = tables.masked_fill(~active[:, None], NULL_BLOCK)
        if chunks:
            ck_tokens, ck_start, ck_len, ck_slot = self._pack_chunks(chunks)
            row_tokens = torch.cat([row_tokens, torch.nn.functional.pad(
                ck_tokens, (0, width - self.chunk_size))])
            row_start = torch.cat([idx, ck_start])
            row_len = torch.cat([spec_len, ck_len])
            row_bt = torch.cat([row_bt, tables[ck_slot]])
        logits = self.model.span_step(self._caches, row_tokens, row_start,
                                      row_len, row_bt)
        s = self.num_slots
        out_toks, n_acc = spec_accept(
            logits[:s, :kmax + 1], drafts, (spec_len - 1).clamp(min=0),
            draft_q, self._generator(salt=2), self.temperature,
            self.cfg.vocab_size, self.top_k, self.top_p)
        # gate on `active` too: a slot dropped host-side after planning
        # never advances its registers
        spec_active = (spec_len > 0) & active
        final = out_toks.gather(1, n_acc.long()[:, None])[:, 0]
        tok = torch.where(spec_active, final, tok)
        idx = torch.where(spec_active, idx + n_acc + 1, idx)
        ck_fan = None
        if chunks:
            tok, idx, ck_fan = self._fold_chunk_rows(
                logits[s:, :self.chunk_size], chunks, ck_len, tok, idx)
        return tok, idx, out_toks, n_acc, ck_fan

    # ------------------------------------------------------------------
    # admission policy: blocks for the FIRST chunk only (JIT per chunk)
    # ------------------------------------------------------------------
    def can_admit(self, req: Request) -> bool:
        if not self.chunkable:  # whole prompts: the grouped-prefill policy
            return super().can_admit(req)
        pool = self.pool
        hits, _ = self._lookup_hits(req)
        start = len(hits) * self.block_size
        first = min(self.chunk_size, self._start_index(req) - start)
        need = pool.blocks_for(start + first) - len(hits)
        evictable_hits = sum(1 for b in hits if pool.ref(b) == 0)
        ok = pool.available() >= need + evictable_hits + 1
        if not ok:
            self._admit_plan = None
        return ok

    def on_admit(self, slot: int, req: Request):
        if self.spec is not None:
            # every occupant change passes through here: the proposer's
            # per-slot drafting state (a draft model's cursor) resets
            self.spec.reset_slot(slot)
        if not self.chunkable:
            return super().on_admit(slot, req)
        pool = self.pool
        hits, hashes = self._lookup_hits(req)
        self._admit_plan = None
        self._chain_memo.pop(req.rid, None)
        if self.prefix_cache:
            self._req_hashes[req.rid] = hashes
        pool.claim(hits)
        self._slot_blocks[slot] = list(hits)
        self._tables[slot] = NULL_BLOCK
        self._tables[slot, :len(hits)] = hits
        self._tables_dirty = True
        req.prefix_hit_tokens = len(hits) * self.block_size
        self.stats["prefix_hit_tokens"] += req.prefix_hit_tokens
        if self.tracer is not None:
            self.tracer.emit(ev.EV_PREFIX_HIT_TOKENS, req.prefix_hit_tokens)
        # the prefill cursor starts at the hit boundary: resident blocks
        # are never recomputed
        self._progress[slot] = req.prefix_hit_tokens
        self._target[slot] = self._start_index(req)
        self._slot_start[slot] = self._target[slot]
        self._slot_sched0[slot] = len(req.tokens)  # re-prefilled on resume
        self._prefilling[slot] = True
        self.stats["prefills"] += 1

    # ------------------------------------------------------------------
    # per-iteration budget planning
    # ------------------------------------------------------------------
    def _plan_one_chunk(self, slot, req, budget, pairs) -> ChunkPlan | None:
        """Size one slot's next chunk to the remaining budget, allocating
        its blocks just in time — preempting decode slots (newest first)
        when the pool runs dry, or shrinking the chunk to what fits."""
        progress, target = int(self._progress[slot]), int(self._target[slot])
        length = min(self.chunk_size, budget, target - progress)
        if length < 1:
            return None
        pool = self.pool
        missing = pool.blocks_for(progress + length) - len(self._slot_blocks[slot])
        while missing > pool.available() and pairs:
            self._preempt_one(pairs)  # mutates pairs in place
        if missing > pool.available():
            fit = (len(self._slot_blocks[slot]) + pool.available()) \
                * self.block_size - progress
            length = min(length, fit)
            if length < 1:
                return None
            missing = pool.blocks_for(progress + length) \
                - len(self._slot_blocks[slot])
        if missing > 0:
            self._grow_slot_blocks(slot, missing)
        tokens = np.asarray(req.input_ids()[progress:progress + length],
                            np.int32)
        return ChunkPlan(slot, req, progress, length, tokens,
                         sample=progress + length >= target)

    def _plan_chunks(self, pairs, decode_tokens: int | None = None
                     ) -> list[ChunkPlan]:
        """This iteration's prefill chunks — resumes first (oldest
        admission first), then FIFO admissions — up to ``chunk_rows``
        streams sharing the budget left after decode.  ``decode_tokens``
        overrides the decode charge (spec mode charges draft + verify
        positions, not one token a slot)."""
        if not self.chunkable:
            return []
        if decode_tokens is None:
            decode_tokens = len(pairs)
        budget = self.max_step_tokens - decode_tokens
        plans: list[ChunkPlan] = []
        live = sorted((s for s in range(self.num_slots) if self._prefilling[s]),
                      key=lambda s: self.scheduler.slots[s].admit_seq)
        for slot in live:
            if len(plans) >= self.chunk_rows or budget < 1:
                break
            plan = self._plan_one_chunk(slot, self.scheduler.slots[slot],
                                        budget, pairs)
            if plan is not None:
                plans.append(plan)
                budget -= plan.length
        admitted_any = False
        while len(plans) < self.chunk_rows and budget >= 1 and self.queue:
            admitted = self.scheduler.admit_one()
            if admitted is None:
                break
            admitted_any = True
            slot, req = admitted
            plan = self._plan_one_chunk(slot, req, budget, pairs)
            if plan is not None:
                plans.append(plan)
                budget -= plan.length
            else:
                break  # admitted but unfundable this step: resume next step
        if admitted_any and self.tracer is not None:
            self.tracer.emit(ev.EV_QUEUE_DEPTH, len(self.queue))
            self.tracer.emit(ev.EV_SLOTS_ACTIVE, self.scheduler.occupancy())
        return plans

    def _relieve_stalled_prefill(self):
        """Forward-progress safety valve: if nothing is dispatchable while
        several prefill streams jointly hold the pool dry, preempt the
        NEWEST stream so the oldest can finish."""
        live = sorted((s for s in range(self.num_slots) if self._prefilling[s]),
                      key=lambda s: self.scheduler.slots[s].admit_seq)
        if len(live) < 2:
            return False
        slot = live[-1]
        victim = self.scheduler.slots[slot]
        self._prefilling[slot] = False
        self._release_blocks(slot)
        self.scheduler.preempt(victim)
        self._preempted.append(victim)
        self.stats["preemptions"] += 1
        return True

    # ------------------------------------------------------------------
    # dispatch / fetch
    # ------------------------------------------------------------------
    def _dispatch(self, pairs, steps, chunks: list[ChunkPlan]):
        tr = self.tracer
        if not pairs and not chunks:
            return None
        self._prep_dispatch()
        t_dispatch = _now_ns()
        with (tr.phase(ev.PHASE_DECODE) if tr else contextlib.nullcontext()), \
                (tr.user_function(name="unified_step") if tr
                 else contextlib.nullcontext()):
            self._tok, self._idx, toks, ck_fan = self._unified_impl(
                self._tok, self._idx, self._active_dev, self._tables_dev,
                chunks, steps)
        self._dispatches += 1
        if pairs:
            self._note_kernel("paged_decode")
        if steps:
            # mirrors decode_syncs: the fetch side bumps it iff this
            # dispatch carried decode rows
            self.stats["decode_dispatches"] += 1
        if chunks:
            self._note_kernel("paged_span")
        for slot, req in pairs:
            req.scheduled += steps
            if req.scheduled >= req.max_new_tokens:
                self._active[slot] = False
                self._active_dirty = True
        n_chunk = self._advance_chunks(chunks, t_dispatch, ck_fan)
        # whole-prompt admissions (not chunkable) ride this dispatch's
        # triple: the documented bypass of max_step_tokens
        n_chunk += self._whole_tokens
        self._whole_tokens = 0
        if tr:
            tr.emit(ev.EV_STEP_BUDGET, len(pairs) + n_chunk)
            tr.emit(ev.EV_CHUNK_TOKENS, n_chunk)
            tr.emit(ev.EV_DECODE_TOKENS, len(pairs))
        return _Inflight(toks, ck_fan, pairs, chunks)

    def _advance_chunks(self, chunks: list[ChunkPlan], t_dispatch,
                        ck_fan=None) -> int:
        """Dispatch-side chunk bookkeeping (cursor advance, prompt-block
        registration at completion, fan-out forking); returns the chunk
        token count.  ``ck_fan`` is the dispatch's sibling fan, on the
        device (unified step, not fetched yet) or on the host (spec
        lane): the fork hook seeds child registers from it."""
        n_chunk = 0
        for row, c in enumerate(chunks):
            n_chunk += c.length
            slot, req = c.slot, c.req
            self._progress[slot] += c.length
            self.stats["prefill_tokens"] += c.length
            if req.t_admit_ns < 0:
                req.t_admit_ns = t_dispatch
            if c.sample:
                self._prefilling[slot] = False
                req.scheduled += 1
                if req.scheduled < req.max_new_tokens:
                    self._active[slot] = True
                    self._active_dirty = True
                if self.prefix_cache:
                    # publish full PROMPT blocks, now fully streamed in
                    hashes = self._req_hashes.pop(req.rid, [])
                    for j, h in enumerate(hashes[:req.prompt_len
                                                 // self.block_size]):
                        self.pool.register(self._slot_blocks[slot][j], h)
                if c.fans():
                    self._fork_fanout(row, c, ck_fan, t_dispatch)
        return n_chunk

    def _fork_fanout(self, row: int, c: ChunkPlan, ck_fan, t_dispatch):
        """Fan a completing fan-out prompt into its sibling decode streams.

        A child adopted into a free slot costs no block copy: its table
        aliases every parent block, the partial tail included, via
        ``pool.fork`` (one more reference each), and the shared tail is
        copied at the child's first decode write.  Its registers are
        seeded from the dispatch's fan (column ``fork_index``) without a
        host sync, at the parent's first decode position.  Children that
        find no free slot requeue at the FRONT, in fork order, and
        re-admit through the prompt blocks the parent just registered."""
        slot, req = c.slot, c.req
        tr = self.tracer
        kids = self.queue.fork_children(req)
        start = int(self._slot_start[slot])  # first decode write position
        overflow: list[Request] = []
        for kid in kids:
            if tr is not None:
                tr.emit(ev.EV_FORK, req.rid + 1)
            target = next((s for s in range(self.num_slots)
                           if self.scheduler.slots[s] is None), None)
            if target is None:
                overflow.append(kid)
                continue
            self.scheduler.adopt(target, kid)
            if self.spec is not None:
                self.spec.reset_slot(target)
            self._slot_blocks[target] = self.pool.fork(self._slot_blocks[slot])
            self._tables[target] = self._tables[slot]
            self._tables_dirty = True
            self._slot_start[target] = start
            self._slot_sched0[target] = 0
            self._progress[target] = self._target[target] = start
            self._prefilling[target] = False
            kid.scheduled = 1  # the fan token, in flight right now
            kid.t_admit_ns = t_dispatch
            hit = req.prompt_len // self.block_size * self.block_size
            kid.prefix_hit_tokens = hit  # full blocks served by aliasing
            self.stats["prefix_hit_tokens"] += hit
            if tr is not None:
                tr.emit(ev.EV_PREFIX_HIT_TOKENS, hit)
            if kid.max_new_tokens > 1:
                self._active[target] = True
                self._active_dirty = True
            first = ck_fan[row, kid.fork_index]
            self._tok[target] = first if torch.is_tensor(first) else int(first)
            self._idx[target] = start
            c.forked.append(kid)
        for kid in reversed(overflow):
            self.queue.requeue(kid)  # front, ascending fork order
        if overflow and tr is not None:
            tr.emit(ev.EV_QUEUE_DEPTH, len(self.queue))

    def _emit_chunk_tokens(self, chunks: list[ChunkPlan], ck) -> None:
        """Fetch-side chunk bookkeeping: append the first sampled token of
        each completed prompt and of every fork child seated at dispatch;
        retire single-token requests.  The row owner reads column 0 (the
        value its register got), even an overflow child re-admitted on
        the normal path: the fan covers only siblings adopted at their
        parent's dispatch."""
        for i, c in enumerate(chunks):
            if not c.sample:
                continue
            for req in [c.req] + c.forked:
                if req.t_first_ns < 0:
                    req.t_first_ns = _now_ns()  # resumes keep their TTFT
                col = 0 if req is c.req else req.fork_index
                req.tokens.append(int(ck[i, col]))
                self.stats["tokens_decoded"] += 1
                if self.tracer is not None:
                    self.tracer.emit(ev.EV_TOKENS_TOTAL,
                                     self.stats["tokens_decoded"])
                if len(req.tokens) >= req.max_new_tokens \
                        and self.scheduler.slots[req.slot] is req:
                    self._finish(req)

    def _process_unified(self, d: _Inflight):
        """Fetch one dispatch's tokens (the single host sync, overlapped
        with the next dispatch's device work) and run retirement."""
        toks = d.toks.cpu().numpy()
        ck = None if d.ck_fan is None else d.ck_fan.cpu().numpy()
        self._process_tokens(toks, d.pairs)
        self._emit_chunk_tokens(d.chunks, ck)

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------
    def run(self) -> dict[int, np.ndarray]:
        """Serve until queue and slots drain; one unified token-budget step
        per iteration, pipelined one deep (the fetch of step i overlaps the
        device work of step i+1).  Pure-decode dispatches burst up to
        ``max_decode_burst`` steps; chunk-carrying ones up to
        ``mixed_burst``.  Returns {rid: [new_tokens]} for requests
        completed by THIS call."""
        if self.spec is not None:
            return self._run_spec()
        tr = self.tracer
        done0 = len(self.scheduler.completed)
        inflight: collections.deque[_Inflight] = collections.deque()
        t_run0 = time.perf_counter()
        with torch.inference_mode():
            while inflight or not self.scheduler.drained():
                if not self.chunkable:
                    self._admit_whole_prompts()
                pairs = [(s, r) for s, r in self.scheduler.active()
                         if self._active[s]]
                if self.chunkable and tr and (self.queue
                                              or self._prefilling.any()):
                    with tr.phase(ev.PHASE_ADMIT):
                        chunks = self._plan_chunks(pairs)
                else:
                    chunks = self._plan_chunks(pairs)
                pairs, steps = self._ensure_blocks(
                    pairs, max_steps=self.mixed_burst if chunks else None)
                self._flush_cow()  # CoW copies land before the burst writes
                self.stats["peak_active"] = max(self.stats["peak_active"],
                                                self.scheduler.occupancy())
                if self.pool is not None:
                    self.stats["peak_blocks"] = max(self.stats["peak_blocks"],
                                                    self.pool.num_active())
                    self.stats["peak_shared"] = max(self.stats["peak_shared"],
                                                    self.pool.num_shared())
                dispatched = self._dispatch(pairs, steps, chunks)
                if dispatched is None and self._whole_tokens and tr:
                    # whole-prompt prefills with nothing left to decode
                    # (e.g. one-token requests retiring at prefill): no
                    # later dispatch will fold their triple in
                    tr.emit(ev.EV_STEP_BUDGET, self._whole_tokens)
                    tr.emit(ev.EV_CHUNK_TOKENS, self._whole_tokens)
                    tr.emit(ev.EV_DECODE_TOKENS, 0)
                    self._whole_tokens = 0
                if dispatched is None and not inflight \
                        and not self.scheduler.drained():
                    # several prefill streams can jointly wedge the pool
                    # with no decode victims left: preempt the newest
                    if not self._relieve_stalled_prefill():
                        raise RuntimeError(
                            "serve loop stalled: nothing dispatchable but "
                            "the scheduler is not drained")
                if dispatched is not None:
                    inflight.append(dispatched)
                # a stall or a preemption flushes the queue: victims must
                # drain their in-flight tokens before they are requeued
                keep = 1 if (dispatched is not None
                             and not self._preempted) else 0
                while len(inflight) > keep:
                    self._process_unified(inflight.popleft())
                self._drain_preempted()
        self.stats["seconds"] += time.perf_counter() - t_run0
        return {r.rid: np.asarray(r.tokens, np.int32)
                for r in self.scheduler.completed[done0:]}

    def _admit_whole_prompts(self):
        """Budget-looped whole-prompt admission of a family that cannot
        stream chunks, through the inherited grouped-prefill path."""
        tr = self.tracer
        if self.queue and tr:
            with tr.phase(ev.PHASE_ADMIT):
                admissions = self.scheduler.admissions()
        else:
            admissions = self.scheduler.admissions()
        for members in self._prefill_groups(admissions):
            # counted BEFORE the prefill: it appends the first sampled
            # token, growing input_ids()
            self._whole_tokens += sum(
                self._start_index(r) - r.prefix_hit_tokens for _, r in members)
            self._do_prefill(members)

    # ------------------------------------------------------------------
    # speculative decoding (spec mode)
    # ------------------------------------------------------------------
    def _slot_pos(self, slot: int, req: Request) -> int:
        """Absolute position of the slot's pending token: the last sampled,
        not yet written token the next verify span roots at."""
        return int(self._slot_start[slot]) + len(req.tokens) \
            - int(self._slot_sched0[slot]) - 1

    def _plan_spec(self, pairs):
        """Clamp each decode-active slot's draft width to the step budget,
        its remaining generation and the cache capacity, then allocate the
        blocks its span writes — oldest admissions first, each span
        shrinking to what the pool funds (width 0 is a one-token decode),
        and the NEWEST request preempted when even the pending token
        cannot be funded.  Returns (surviving pairs, spec_len [S]) with
        ``spec_len[slot] = k + 1`` for planned slots."""
        pool = self.pool
        while True:
            spec_len = np.zeros((self.num_slots,), np.int32)
            if not pairs:
                return pairs, spec_len
            k_base = max(0, min(self._spec_k,
                                self.max_step_tokens // len(pairs) - 1))
            ok = True
            for slot, req in sorted(pairs, key=lambda sr: sr[1].admit_seq):
                pos = self._slot_pos(slot, req)
                rem = req.max_new_tokens - len(req.tokens)
                k = max(0, min(k_base, rem - 1, self.capacity - 1 - pos))
                missing, shared = self._span_cost(slot, pos, k)
                while k > 0 and max(missing, 0) + len(shared) > pool.available():
                    k -= 1
                    missing, shared = self._span_cost(slot, pos, k)
                if max(missing, 0) + len(shared) > pool.available():
                    ok = False  # even the pending token cannot be funded
                    break
                if missing > 0:
                    self._grow_slot_blocks(slot, missing)
                for w in shared:
                    old = self._slot_blocks[slot][w]
                    fresh, copied = pool.cow(old)
                    if copied:
                        self._slot_blocks[slot][w] = fresh
                        self._tables[slot, w] = fresh
                        self._tables_dirty = True
                        self._cow_pairs.append((old, fresh))
                spec_len[slot] = k + 1
            if ok:
                return pairs, spec_len
            # blocks granted to older slots stay owned (unused tails roll
            # back after the dispatch): evict the newest request, replan
            self._preempt_one(pairs)

    def _span_cost(self, slot: int, pos: int, k: int):
        """(blocks to grow, table entries to copy on write) for a span
        writing positions ``pos .. pos + k``: a block another holder
        still references is copied first, charged like the growth."""
        pool, bs = self.pool, self.block_size
        blocks = self._slot_blocks[slot]
        missing = pool.blocks_for(pos + k + 1) - len(blocks)
        shared = [w for w in range(pos // bs,
                                   min((pos + k) // bs, len(blocks) - 1) + 1)
                  if pool.ref(blocks[w]) > 1]
        return missing, shared

    def _rollback_spec_blocks(self, slot: int, next_pos: int) -> None:
        """Return trailing blocks holding ONLY rejected-draft residue to
        the pool: committed content fills [0, next_pos) and the pending
        token writes AT ``next_pos``, so every block past ``next_pos``'s
        own holds speculation alone.  Such a block was grown by this slot
        and never registered, so no other holder can reference it."""
        keep = self.pool.blocks_for(next_pos + 1)
        blocks = self._slot_blocks[slot]
        if len(blocks) > keep:
            extra = blocks[keep:]
            del blocks[keep:]
            self._tables[slot, keep:] = NULL_BLOCK
            self._tables_dirty = True
            self.pool.free(extra)
            self.stats["spec_rollback_blocks"] += len(extra)

    def _propose(self, pairs, spec_len):
        """Host side of a dispatch's drafts: (drafts [S, K] on the device,
        q [S, K, V] on the device or None)."""
        kmax = self.spec_k_max
        drafts = np.zeros((self.num_slots, kmax), np.int32)
        q_all = None
        k_ask = max((int(spec_len[s]) - 1 for s, _ in pairs), default=0)
        if k_ask > 0:
            slots = [s for s, _ in pairs]
            dr, q = self.spec.propose(slots, [r.input_ids() for _, r in pairs],
                                      k_ask)
            drafts[slots, :k_ask] = dr[:, :k_ask]
            if q is not None and self.temperature > 0.0:
                # scattered on the device: q comes straight from the draft
                # model's proposal steps
                q_all = torch.zeros((self.num_slots, kmax, self.cfg.vocab_size),
                                    dtype=torch.float32, device=self.device)
                q_all[self._dev(np.asarray(slots, np.int64)), :k_ask] = \
                    q[:, :k_ask].float().to(self.device)
        return self._dev(drafts), q_all

    def _run_spec(self) -> dict[int, np.ndarray]:
        """Speculative serving loop: per iteration ONE span dispatch
        verifies every decode-active slot's drafts, with the prefill
        chunks in the same batch.  Synchronous: the next drafts depend on
        this dispatch's committed tokens."""
        tr = self.tracer
        done0 = len(self.scheduler.completed)
        t_run0 = time.perf_counter()
        with torch.inference_mode():
            while not self.scheduler.drained():
                pairs = [(s, r) for s, r in self.scheduler.active()
                         if self._active[s]]
                pairs, spec_len = self._plan_spec(pairs)
                decode_tokens = int(spec_len.sum())
                if tr and (self.queue or self._prefilling.any()):
                    with tr.phase(ev.PHASE_ADMIT):
                        chunks = self._plan_chunks(pairs, decode_tokens)
                else:
                    chunks = self._plan_chunks(pairs, decode_tokens)
                # chunk planning can preempt a spec-planned decode victim:
                # drop its span, so the budget never charges positions that
                # do not dispatch and its registers stay frozen
                live = {s for s, _ in pairs}
                for s in np.nonzero(spec_len)[0]:
                    if int(s) not in live:
                        spec_len[s] = 0
                decode_tokens = int(spec_len.sum())
                self.stats["peak_active"] = max(self.stats["peak_active"],
                                                self.scheduler.occupancy())
                self.stats["peak_blocks"] = max(self.stats["peak_blocks"],
                                                self.pool.num_active())
                self.stats["peak_shared"] = max(self.stats["peak_shared"],
                                                self.pool.num_shared())
                if not pairs and not chunks:
                    if not self.scheduler.drained() and not self._preempted:
                        if not self._relieve_stalled_prefill():
                            raise RuntimeError(
                                "serve loop stalled: nothing dispatchable but "
                                "the scheduler is not drained")
                    self._drain_preempted()
                    continue
                drafts, draft_q = self._propose(pairs, spec_len)
                self._flush_cow()  # CoW copies land before the span writes
                self._prep_dispatch()
                t_dispatch = _now_ns()
                with (tr.phase(ev.PHASE_DECODE) if tr
                      else contextlib.nullcontext()), \
                        (tr.user_function(name="spec_step") if tr
                         else contextlib.nullcontext()):
                    self._tok, self._idx, out_toks, n_acc, ck_fan = \
                        self._spec_impl(self._tok, self._idx, self._active_dev,
                                        self._tables_dev, drafts, draft_q,
                                        self._dev(spec_len), chunks)
                    out = out_toks.cpu().numpy()  # the dispatch's one sync
                    nacc = n_acc.cpu().numpy()
                    ck = None if ck_fan is None else ck_fan.cpu().numpy()
                self._dispatches += 1
                self._note_kernel("paged_span")  # verify rides the span
                self.stats["host_syncs"] += 1
                n_chunk = self._advance_chunks(chunks, t_dispatch, ck)
                drafted, accepted = self._commit_spec(pairs, spec_len, out,
                                                      nacc)
                self._emit_chunk_tokens(chunks, ck)
                if pairs:
                    self.stats["spec_dispatches"] += 1
                    self.stats["iterations"] += 1
                    self.stats["decode_syncs"] += 1
                    # dispatch and sync coincide in the spec lane; the
                    # invariant decode_syncs == decode_dispatches holds
                    self.stats["decode_dispatches"] += 1
                self.stats["spec_drafted"] += drafted
                self.stats["spec_accepted"] += accepted
                k_used = self._spec_k  # the width in effect this dispatch
                self._adapt_k(drafted, accepted)
                self._since_flush += 1
                if tr:
                    tr.emit(ev.EV_STEP_BUDGET, decode_tokens + n_chunk)
                    tr.emit(ev.EV_CHUNK_TOKENS, n_chunk)
                    tr.emit(ev.EV_DECODE_TOKENS, decode_tokens)
                    if pairs:
                        tr.emit(ev.EV_SPEC_DRAFTED, drafted)
                        tr.emit(ev.EV_SPEC_ACCEPTED, accepted)
                        tr.emit(ev.EV_SPEC_K, k_used)
                    tr.emit(EV_TOKENS_DECODED, self.stats["tokens_decoded"])
                    tr.emit(ev.EV_TOKENS_TOTAL, self.stats["tokens_decoded"])
                    tr.emit(ev.EV_QUEUE_DEPTH, len(self.queue))
                    if self.flush_every and self._since_flush >= self.flush_every:
                        tr.flush(self.flush_base)
                        self._since_flush = 0
                self._drain_preempted()
        self.stats["seconds"] += time.perf_counter() - t_run0
        return {r.rid: np.asarray(r.tokens, np.int32)
                for r in self.scheduler.completed[done0:]}

    def _commit_spec(self, pairs, spec_len, out, nacc) -> tuple[int, int]:
        """Append each planned slot's accepted prefix plus its correction
        or bonus token; retire finished requests and roll back the blocks
        of the rest.  Returns (drafted, accepted)."""
        drafted = accepted = 0
        for slot, req in pairs:
            if spec_len[slot] == 0:
                continue
            m = int(nacc[slot]) + 1
            drafted += int(spec_len[slot]) - 1
            accepted += int(nacc[slot])
            req.tokens.extend(int(t) for t in out[slot, :m])
            req.scheduled = len(req.tokens)
            self.stats["tokens_decoded"] += m
            if len(req.tokens) >= req.max_new_tokens:
                self._finish(req)  # releases every block, residue included
            else:
                self._rollback_spec_blocks(slot, self._slot_pos(slot, req))
        return drafted, accepted

    def _adapt_k(self, drafted: int, accepted: int) -> None:
        """Acceptance-rate EMA; ``spec_adaptive`` widens K above 0.7 and
        narrows it below 0.35."""
        if drafted <= 0:
            return
        self._accept_ema = 0.7 * self._accept_ema + 0.3 * accepted / drafted
        if self.spec_adaptive:
            if self._accept_ema > 0.7:
                self._spec_k = min(self._spec_k + 1, self.spec_k_max)
            elif self._accept_ema < 0.35:
                self._spec_k = max(1, self._spec_k - 1)

    # ------------------------------------------------------------------
    # beam search: fork + per-step score/prune on the same CoW mechanism
    # ------------------------------------------------------------------
    def _beam_prefill(self, prompt, table, width: int):
        """The prompt [L] as ONE span row writing into the beam's block
        table [W] -> top-``width`` first-token log-probs and their ids."""
        length = prompt.shape[0]
        logits = self.model.span_step(
            self._caches, prompt[None],
            torch.zeros((1,), dtype=torch.int32, device=self.device),
            torch.full((1,), length, dtype=torch.int32, device=self.device),
            table[None])
        return top_k(torch.log_softmax(logits[0, length - 1].float(), -1),
                     width)

    def _beam_step(self, tok, idx, active, tables, width: int):
        """One beam decode step: the serve loop's paged decode over every
        slot row (inactive rows NULL-masked), then each beam's
        top-``width`` log-prob candidates [S, width] for the host prune.
        log_softmax keeps the argmax, so width 1 is greedy decode."""
        bt = tables.masked_fill(~active[:, None], NULL_BLOCK)
        logits = self.model.decode_step(self._caches, tok, idx, bt)
        return top_k(torch.log_softmax(logits.float(), -1), width)

    def beam_search(self, prompt, num_tokens: int, *, width: int = 4
                    ) -> list[tuple[np.ndarray, float]]:
        """Beam-search ``num_tokens`` continuations of ``prompt``; returns
        [(tokens, cumulative log-prob)] best-first, ``width`` entries.

        Beams ARE forks: the prompt prefills ONCE into beam 0's blocks,
        beams 1..W-1 alias them via ``pool.fork``, and every prune that
        reseats beam b onto source s is another fork (``EV_FORK``, value
        s + 1), taken before b's old rows are freed.  The only copies are
        CoW of the shared write-frontier block.  Runs on an idle engine
        (the beams borrow the slot rows); the candidates of a step are
        ranked by a stable argsort of the [W, W] summed log-probs."""
        if not self.chunkable:
            raise ValueError(
                "beam_search needs the fully-paged span path (dense/moe "
                f"families); {self.cfg.family!r} cannot run it")
        if not 1 <= width <= self.num_slots:
            raise ValueError(f"width must be in [1, {self.num_slots}]")
        if self.queue or self.scheduler.any_active():
            raise RuntimeError("beam_search needs an idle engine "
                               "(no queued or active requests)")
        prompt = np.asarray(prompt, np.int32)
        plen = int(prompt.shape[0])
        if plen + num_tokens > self.capacity:
            raise ValueError(
                f"prompt {plen} + {num_tokens} beam tokens needs cache "
                f"capacity {plen + num_tokens} > {self.capacity}")
        t_beam0 = time.perf_counter()
        pool, bs, tr, w = self.pool, self.block_size, self.tracer, width
        # beam 0 owns the prompt blocks; 1..W-1 alias them (zero copies)
        blocks: list[list[int]] = [pool.alloc(pool.blocks_for(plen))]
        tables = np.full((self.num_slots, self.blocks_per_slot), NULL_BLOCK,
                         np.int32)
        tables[0, :len(blocks[0])] = blocks[0]
        for _ in range(1, w):
            blocks.append(pool.fork(blocks[0]))
            tables[len(blocks) - 1] = tables[0]
            if tr is not None:
                tr.emit(ev.EV_FORK, 0 + 1)
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += plen
        with torch.inference_mode():
            with (tr.phase(ev.PHASE_PREFILL) if tr
                  else contextlib.nullcontext()), \
                    (tr.user_function(name="beam_prefill") if tr
                     else contextlib.nullcontext()):
                val, ids = self._beam_prefill(self._dev(prompt),
                                              self._dev(tables[0]), w)
            val = val.cpu().numpy().astype(np.float64)
            ids = ids.cpu().numpy()
            self._note_kernel("paged_span")
            self.stats["host_syncs"] += 1
            scores = val.copy()  # [w] cumulative log-probs
            seqs = [[int(t)] for t in ids]
            tok = np.zeros((self.num_slots,), np.int32)
            idx = np.zeros((self.num_slots,), np.int32)
            active = np.zeros((self.num_slots,), bool)
            tok[:w], idx[:w], active[:w] = ids, plen, True
            active_dev = self._dev(active)
            # num_tokens - 1 decode steps: the last token's K/V is never
            # written, so its position needs no block and no CoW
            for step in range(1, num_tokens):
                # fund and exclusively own each beam's write block: the
                # decode writes tok's K/V at position plen + step - 1
                wblk = (plen + step - 1) // bs
                for b in range(w):
                    if wblk >= len(blocks[b]):
                        fresh = pool.alloc(1)
                        tables[b, len(blocks[b])] = fresh[0]
                        blocks[b].extend(fresh)
                    elif pool.ref(blocks[b][wblk]) > 1:
                        old = blocks[b][wblk]
                        fresh, copied = pool.cow(old)
                        if copied:
                            blocks[b][wblk] = fresh
                            tables[b, wblk] = fresh
                            self._cow_pairs.append((old, fresh))
                self._flush_cow()
                self.stats["peak_blocks"] = max(self.stats["peak_blocks"],
                                                pool.num_active())
                self.stats["peak_shared"] = max(self.stats["peak_shared"],
                                                pool.num_shared())
                with (tr.phase(ev.PHASE_DECODE) if tr
                      else contextlib.nullcontext()), \
                        (tr.user_function(name="beam_step") if tr
                         else contextlib.nullcontext()):
                    val, ids = self._beam_step(
                        self._dev(tok), self._dev(idx), active_dev,
                        self._dev(tables), w)
                val = val.cpu().numpy().astype(np.float64)[:w]
                ids = ids.cpu().numpy()[:w]
                self._note_kernel("paged_decode")
                self.stats["host_syncs"] += 1
                total = scores[:, None] + val  # [w, w] candidate scores
                flat = np.argsort(-total, axis=None, kind="stable")[:w]
                src, pick = flat // w, flat % w
                # reseat pruned beams: alias the surviving source's blocks
                # BEFORE releasing the old rows, so a row that is both
                # replaced and someone's source never drops to ref 0
                old_blocks = [blocks[b] for b in range(w)]
                old_tables = tables[:w].copy()
                for b in range(w):
                    s = int(src[b])
                    if s != b:
                        blocks[b] = pool.fork(old_blocks[s])
                        tables[b] = old_tables[s]
                        if tr is not None:
                            tr.emit(ev.EV_FORK, s + 1)
                for b in range(w):
                    if int(src[b]) != b:
                        pool.free(old_blocks[b])
                seqs = [seqs[int(s)] + [int(ids[int(s), int(p)])]
                        for s, p in zip(src, pick)]
                scores = total.reshape(-1)[flat]
                tok[:w] = [ids[int(s), int(p)] for s, p in zip(src, pick)]
                idx[:w] = plen + step
        for b in range(w):
            pool.free(blocks[b])  # unhashed: straight back to FREE
        self.stats["tokens_decoded"] += w * num_tokens
        self.stats["seconds"] += time.perf_counter() - t_beam0
        order = np.argsort(-scores, kind="stable")
        return [(np.asarray(seqs[int(r)], np.int32), float(scores[int(r)]))
                for r in order]
