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

Block allocation is just-in-time per chunk: admission demands blocks for
the request's FIRST chunk only (+1 decode headroom), later chunks allocate
as they stream, and a dry pool preempts decode slots newest-first.
Prefix-cache hits skip whole leading blocks (the chunk cursor starts at
the hit boundary); full prompt blocks are registered when the prompt
completes, so a preemption-resumed request re-hits its own prompt.

The run loop keeps the JAX engine's one-deep pipeline: dispatch N+1 is
planned and enqueued on the card's stream before dispatch N's tokens are
fetched, so the fetch (the one host sync) overlaps device compute.

Not ported yet (raise ``NotImplementedError``): the speculative lane
(``spec=``), n-way CoW fan-out (``n_samples > 1``), sessions and beam
search.  Per-iteration ``EV_STEP_BUDGET`` / ``EV_CHUNK_TOKENS`` /
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
from repro_torch.core.sampling import sample_logits
from repro_torch.serve.block_pool import NULL_BLOCK
from repro_torch.serve.engine import ContinuousServeEngine
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


@dataclasses.dataclass
class _Inflight:
    """A dispatch whose tokens are not fetched yet."""
    toks: torch.Tensor  # [steps, num_slots] decode tokens (device)
    ck_tok: torch.Tensor | None  # [chunk_rows] first tokens (device)
    pairs: list
    chunks: list


class UnifiedServeEngine(ContinuousServeEngine):
    """Continuous batching through the unified token-budget step."""

    def __init__(self, cfg, model=None, *, max_step_tokens: int | None = None,
                 chunk_size: int | None = None, chunk_rows: int = 2,
                 mixed_burst: int = 4, spec=None, **kwargs):
        if spec is not None:
            raise NotImplementedError(
                "the speculative decoding lane is not ported yet")
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
        self._progress = np.zeros((self.num_slots,), np.int64)
        self._target = np.zeros((self.num_slots,), np.int64)
        self._prefilling = np.zeros((self.num_slots,), bool)
        if self.tracer is not None:
            for code in (ev.EV_STEP_BUDGET, ev.EV_CHUNK_TOKENS,
                         ev.EV_DECODE_TOKENS):
                self.tracer.register(code, ev.SERVE_CTR_LABELS[code])

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
        Returns (tok, idx, toks [steps, S], ck_tok [C] or None)."""
        gen = self._generator()
        bt = tables.masked_fill(~active[:, None], NULL_BLOCK)
        if steps:
            tok, idx, toks = self._decode_scan(tok, idx, active, bt, gen, steps)
        else:
            toks = torch.zeros((0, self.num_slots), dtype=torch.int32,
                               device=self.device)
        if not chunks:
            return tok, idx, toks, None
        rows = self.chunk_rows
        ck_tokens = np.zeros((rows, self.chunk_size), np.int32)
        ck_start = np.zeros((rows,), np.int32)
        ck_len = np.zeros((rows,), np.int32)
        ck_slot = np.zeros((rows,), np.int64)
        for i, c in enumerate(chunks):
            ck_tokens[i, :c.length] = c.tokens
            ck_start[i], ck_len[i], ck_slot[i] = c.start, c.length, c.slot
        ck_len_dev = self._dev(ck_len)
        logits = self.model.span_step(
            self._caches, self._dev(ck_tokens), self._dev(ck_start), ck_len_dev,
            tables[self._dev(ck_slot)])
        last = logits[torch.arange(rows, device=self.device),
                      (ck_len_dev.long() - 1).clamp(min=0)]
        ck_tok = sample_logits(last, self._generator(salt=1), self.temperature,
                               self.cfg.vocab_size, self.top_k, self.top_p)
        done = [i for i, c in enumerate(chunks) if c.sample]
        if done:
            sel = self._dev(np.asarray(done, np.int64))
            slots = self._dev(np.asarray([chunks[i].slot for i in done], np.int64))
            pos = [chunks[i].start + chunks[i].length for i in done]
            tok = tok.index_copy(0, slots, ck_tok[sel])
            idx = idx.index_copy(0, slots, self._dev(np.asarray(pos, np.int32)))
        return tok, idx, toks, ck_tok

    # ------------------------------------------------------------------
    # admission policy: blocks for the FIRST chunk only (JIT per chunk)
    # ------------------------------------------------------------------
    def can_admit(self, req: Request) -> bool:
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

    def _plan_chunks(self, pairs) -> list[ChunkPlan]:
        """This iteration's prefill chunks — resumes first (oldest
        admission first), then FIFO admissions — up to ``chunk_rows``
        streams sharing the budget left after decode."""
        budget = self.max_step_tokens - len(pairs)
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
            self._tok, self._idx, toks, ck_tok = self._unified_impl(
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
        n_chunk = self._advance_chunks(chunks, t_dispatch)
        if tr:
            tr.emit(ev.EV_STEP_BUDGET, len(pairs) + n_chunk)
            tr.emit(ev.EV_CHUNK_TOKENS, n_chunk)
            tr.emit(ev.EV_DECODE_TOKENS, len(pairs))
        return _Inflight(toks, ck_tok, pairs, chunks)

    def _advance_chunks(self, chunks: list[ChunkPlan], t_dispatch) -> int:
        """Dispatch-side chunk bookkeeping (cursor advance, prompt-block
        registration at completion); returns the chunk token count."""
        n_chunk = 0
        for c in chunks:
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
        return n_chunk

    def _emit_chunk_tokens(self, chunks: list[ChunkPlan], ck) -> None:
        """Fetch-side chunk bookkeeping: append the first sampled token of
        each completed prompt; retire single-token requests."""
        for i, c in enumerate(chunks):
            if not c.sample:
                continue
            req = c.req
            if req.t_first_ns < 0:
                req.t_first_ns = _now_ns()  # resumes keep their TTFT
            req.tokens.append(int(ck[i]))
            self.stats["tokens_decoded"] += 1
            if self.tracer is not None:
                self.tracer.emit(ev.EV_TOKENS_TOTAL, self.stats["tokens_decoded"])
            if len(req.tokens) >= req.max_new_tokens \
                    and self.scheduler.slots[req.slot] is req:
                self._finish(req)

    def _process_unified(self, d: _Inflight):
        """Fetch one dispatch's tokens (the single host sync, overlapped
        with the next dispatch's device work) and run retirement."""
        toks = d.toks.cpu().numpy()
        ck = None if d.ck_tok is None else d.ck_tok.cpu().numpy()
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
        tr = self.tracer
        done0 = len(self.scheduler.completed)
        inflight: collections.deque[_Inflight] = collections.deque()
        t_run0 = time.perf_counter()
        with torch.inference_mode():
            while inflight or not self.scheduler.drained():
                pairs = [(s, r) for s, r in self.scheduler.active()
                         if self._active[s]]
                if tr and (self.queue or self._prefilling.any()):
                    with tr.phase(ev.PHASE_ADMIT):
                        chunks = self._plan_chunks(pairs)
                else:
                    chunks = self._plan_chunks(pairs)
                pairs, steps = self._ensure_blocks(
                    pairs, max_steps=self.mixed_burst if chunks else None)
                self._flush_cow()  # CoW copies land before the burst writes
                self.stats["peak_active"] = max(self.stats["peak_active"],
                                                self.scheduler.occupancy())
                self.stats["peak_blocks"] = max(self.stats["peak_blocks"],
                                                self.pool.num_active())
                self.stats["peak_shared"] = max(self.stats["peak_shared"],
                                                self.pool.num_shared())
                dispatched = self._dispatch(pairs, steps, chunks)
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

    def beam_search(self, prompt, num_tokens: int, *, width: int = 4):
        raise NotImplementedError("beam search is not ported yet")
