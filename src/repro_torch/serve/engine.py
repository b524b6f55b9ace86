"""Serving engines: continuous batching over a paged KV pool, and the
fixed-batch engine over contiguous caches — the port of
``repro.serve.engine``.

:class:`ContinuousServeEngine` holds the paged block pool (host
bookkeeping in :mod:`repro_torch.serve.block_pool`, device storage here),
request intake, admission, just-in-time block growth with newest-first
preemption, the decode scan, token fetch/retirement and the run stats —
the machinery the unified token-budget engine
(:mod:`repro_torch.serve.step`) inherits.  Its own two-path loop is the
unified engine's bit-exact oracle: admitted requests are grouped by
(length, prefix hit) and prefilled as one batch through the dense flash
kernel (``_prefill_impl``; a prefix hit runs only the prompt tail against
the gathered resident blocks, ``_chunk_impl``), scattered into their
blocks (``_admit_impl``), then every slot decodes in bursts of up to
``max_decode_burst`` steps through the paged decode kernel
(``_burst_impl``), one burst in flight while the host plans the next.

:class:`ServeEngine` keeps the fixed-batch ``generate`` API over
per-request contiguous (ring under a sliding window) caches — the
contiguous equivalence oracle of the paged engines.

A state-carrying family (ssm: mamba2) has no pooled leaf: the engine then
holds no block pool (``pool`` None, ``kv_bytes_per_token`` 0, no prefix
cache, no admission policy) and its slot-indexed decode state is written
at the admitted slots.  Every engine serves it: this one prefills each
admitted same-length group in one batch through the SSD scan kernel and
decodes the state in bursts (a group holds only prompts of one length,
so no padding enters a state); :class:`ServeEngine` prefills the
rectangular batch and advances the state in lockstep.  The hybrid
(recurrentgemma) holds both: its attention layers' K/V in the pool, its
RG-LRU state at the slots (``_paged_mask`` per leaf); with a leaf that is
not pooled there is no prefix cache.

Request extras (``submit(extras=...)``: a vlm's ``patch_embeds``
[num_patches, vision_dim]) ride the request to its prefill, where a
group's extras are stacked into one batch; the patches occupy positions
``0 .. num_patches - 1``, so every text position, the capacity check and
the decode start shift by ``num_patches``, and such prompts take no
prefix cache (patches are off the token-hash grid).  They are dropped at
retirement.

Multi-turn sessions (``submit(session=...)``) pin each finished turn's
full context in the pool through the prefix cache, so the next turn
prefix-hits it; :meth:`ContinuousServeEngine.close_session` releases the
pin.  n-way CoW fan-out (``submit(n_samples=n)``) rides the unified
step's chunk sampling (:mod:`repro_torch.serve.step`): this engine
refuses it loudly, and :class:`ServeEngine` serves one rectangular
batch with no such request option.

Not ported (raise or are absent): the mesh and its trace replay, the
two-deep ``overlap`` pipeline and the prefix export/import of the JAX
engine.  ``flush_every`` streams the tracer's records to ``flush_base``
segments mid-run, as in the JAX engine.

Device state lives in torch tensors on ``device``: the pool leaves
``{"k", "v"}`` [layers, NB, bs, Hkv, D] — with ``cfg.kv_dtype`` int8/fp8,
codes in the storage dtype plus ``{"k_scale", "v_scale"}``
[layers, NB, bs, Hkv] f32 — or an ssm stack's slot-indexed state
[layers, num_slots, ...] (updated IN PLACE by every dispatch — the
JAX engine donates and replaces them), the per-slot token
and position registers, the active mask and the block tables.  Work is
enqueued on the current CUDA stream and fetched one dispatch later, so the
host plans dispatch N+1 while the card runs dispatch N.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import events as ev
from repro_torch.core import quant
from repro_torch.core.sampling import fork_seed, sample_logits
from repro_torch.kernels.attention import dispatch as kdispatch
from repro_torch.models import cache_utils
from repro_torch.models.model import DecoderLM, build_model, resolve_device
from repro_torch.serve.block_pool import NULL_BLOCK, BlockPool
from repro_torch.serve.queue import Request, RequestQueue, _now_ns
from repro_torch.serve.scheduler import Scheduler

EV_TOKENS_DECODED = 84_001  # user event: tokens decoded so far (one run)


def patch_positions(cfg: ModelConfig) -> int:
    """Positions a request's patches take before its tokens (a vlm's
    ``num_patches``; 0 for every other family)."""
    return cfg.num_patches if cfg.family == "vlm" else 0


class ContinuousServeEngine:
    """Paged-pool engine base (see the module docstring for what is ported).

    ``model`` is a :class:`DecoderLM` on ``device``, served under ``cfg``
    (its ``kv_dtype`` and ``kernel_mode`` may differ from the model's
    own); None builds a seeded random one there.  ``device`` defaults to CUDA and raises when CUDA is
    absent — CPU runs pass ``device="cpu"``."""

    # n-way CoW fan-out needs the chunk-sampling path that forks sibling
    # rows off a completing prompt: only the unified step has it (and turns
    # this on for chunkable configs); this engine refuses fan-out loudly
    supports_fork = False

    def __init__(self, cfg: ModelConfig, model: DecoderLM | None = None, *,
                 device="cuda", num_slots: int, max_len: int,
                 block_size: int = 16, num_blocks: int | None = None,
                 prefix_cache: bool = True, tracer=None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0, max_prefills_per_iter: int = 1,
                 max_decode_burst: int = 8, flush_every: int = 0,
                 flush_base=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = build_model(cfg, device=self.device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        self.model = model.serving_view(cfg)
        self.num_slots = int(num_slots)
        self.block_size = bs = int(block_size)
        self.capacity = -(-int(max_len) // bs) * bs  # block-aligned
        self.blocks_per_slot = self.capacity // bs
        self.tracer = tracer
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.max_decode_burst = max(1, int(max_decode_burst))
        self.flush_every = int(flush_every)
        self.flush_base = flush_base
        self._since_flush = 0  # decode iterations since the last trace flush
        if flush_every and flush_base is None:
            raise ValueError("flush_every requires flush_base")
        if tracer is not None:
            tracer.register(EV_TOKENS_DECODED, "Tokens decoded")
            for code in (ev.EV_TOKENS_TOTAL, ev.EV_REQ_TTFT_US,
                         ev.EV_REQ_TPOT_US, ev.EV_PREFIX_HIT_TOKENS):
                tracer.register(code, ev.SERVE_CTR_LABELS[code])
            for code, label in ev.KERNEL_EVENT_LABELS.items():
                tracer.register(code, label)

        # attention K/V is block-addressed; ssm state stays slot-indexed
        self._paged_mask = self.model.paged_leaf_mask()
        self._has_paged = any(self._paged_mask.values())
        if num_blocks is None:
            # one full-capacity region per slot + the reserved NULL block;
            # the floor keeps one max-length request admissible
            num_blocks = max(self.num_slots * self.blocks_per_slot + 1,
                             self.blocks_per_slot + 2)
        self.num_blocks = int(num_blocks)
        if self._has_paged and self.num_blocks < self.blocks_per_slot + 2:
            raise ValueError(
                f"num_blocks {self.num_blocks} cannot hold one max-length "
                f"request ({self.blocks_per_slot} blocks + null + headroom)")
        specs = self.model.paged_cache_specs(self.num_slots, self.num_blocks, bs)
        block_bytes = sum(
            int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
            // self.num_blocks for name, (shape, dt) in specs.items()
            if self._paged_mask[name])
        self.kv_bytes_per_token = block_bytes // bs  # scale leaves included
        # torch dtype of the K/V leaves
        self.kv_storage = specs["k"][1] if self._has_paged else None
        self.pool = (BlockPool(self.num_blocks, bs, tracer=tracer,
                               kv_dtype=cfg.kv_dtype, block_bytes=block_bytes)
                     if self._has_paged else None)
        # prefix reuse resumes a prompt from pooled blocks on the token-hash
        # grid (vlm patches would shift block contents off it)
        self.prefix_cache = (bool(prefix_cache)
                             and self.model.chunk_resumable())

        self.queue = RequestQueue()
        self.scheduler = Scheduler(
            self.num_slots, self.queue, tracer=tracer,
            max_prefills_per_iter=max_prefills_per_iter,
            admission=self if self.pool is not None else None)

        # --- device state: the pool (updated in place) + slot registers ---
        self._caches = {name: quant.zeros(shape, dt, self.device)
                        for name, (shape, dt) in specs.items()}
        self._tok = torch.zeros((self.num_slots,), dtype=torch.int32,
                                device=self.device)
        self._idx = torch.zeros_like(self._tok)
        self._active = np.zeros((self.num_slots,), bool)  # host mirror
        self._active_dev = self._dev(self._active)
        self._active_dirty = False
        # per-slot block tables; entry w maps positions [w*bs, (w+1)*bs).
        # NULL rows make stale frozen-slot writes land in the garbage block.
        self._tables = np.full((self.num_slots, self.blocks_per_slot),
                               NULL_BLOCK, np.int32)
        self._tables_dev = self._dev(self._tables)
        self._tables_dirty = False
        self._slot_blocks: list[list[int]] = [[] for _ in range(self.num_slots)]
        # start position per slot (input_ids() grows as generated tokens
        # drain — decode block math needs the pinned start) and the tokens
        # already folded into it by a preemption resume
        self._slot_start = np.zeros((self.num_slots,), np.int64)
        self._slot_sched0 = np.zeros((self.num_slots,), np.int64)
        self._admit_plan = None  # (req, hits, hashes): can_admit -> on_admit
        self._req_hashes: dict[int, list[int]] = {}
        self._chain_memo: dict[int, tuple[int, list[int]]] = {}
        self._preempted: list[Request] = []  # requeue deferred past drain
        # session id -> {"context", "blocks"}: the pinned context
        self._sessions: dict[str, dict] = {}
        # copy-on-write transfers (src, dst) to apply before the next write
        self._cow_pairs: list[tuple[int, int]] = []
        self._dispatches = 0  # dispatch counter (seeds the sampling stream)

        self.stats = {"iterations": 0, "prefills": 0, "tokens_decoded": 0,
                      "prefill_tokens": 0, "prefix_hit_tokens": 0,
                      "preemptions": 0, "peak_active": 0, "peak_blocks": 0,
                      "peak_shared": 0, "host_syncs": 0, "decode_syncs": 0,
                      "decode_dispatches": 0, "seconds": 0.0,
                      "prefill_seconds": 0.0, "kernel_dispatch": {}}
        self._kernel_plan = (kdispatch.engine_plan(cfg, platform=self.device.type)
                             if self._has_paged else {})

    # ------------------------------------------------------------------
    def _dev(self, x) -> torch.Tensor:
        """Copy a host register to the device.  Always a copy (the host
        array keeps changing while earlier dispatches may still read the
        device one), and on CUDA an asynchronous one from pinned memory: a
        pageable copy would synchronise the stream and stall the pipeline
        on the dispatch still running."""
        t = torch.from_numpy(np.array(x))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _generator(self, salt: int = 0, fork: int = 0
                   ) -> torch.Generator | None:
        """Sampling stream of the current dispatch (None when greedy: argmax
        consumes no randomness).  Seeded from (engine seed, dispatch,
        salt) so a run is reproducible per seed; ``fork`` i > 0 derives
        sibling i's stream of an n-way fan from it (:func:`fork_seed`:
        fork 0 is the stream itself)."""
        if self.temperature <= 0.0:
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(fork_seed(
            hash((self.seed, self._dispatches, salt)) & (2**62 - 1), fork))
        return g

    def _note_kernel(self, variant: str):
        """Account one engine dispatch of an attention-kernel variant (none
        without attention layers)."""
        if not self._has_paged:
            return
        d = self._kernel_plan[variant]
        counts = self.stats["kernel_dispatch"]
        counts[d.tag] = counts.get(d.tag, 0) + 1
        if self.tracer is not None:
            self.tracer.emit(ev.EV_KERNEL_VARIANT, d.event_value)

    def _prep_dispatch(self):
        """Refresh dirty device registers before a dispatch."""
        if self._active_dirty:
            self._active_dev = self._dev(self._active)
            self._active_dirty = False
        if self._tables_dirty:
            self._tables_dev = self._dev(self._tables)
            self._tables_dirty = False

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def _prefill_impl(self, tokens, extras, generator, *, cache_len):
        """Cold prefill of a same-shape group (tokens [k, L], ``extras``
        name -> [k, ...]) at the block-aligned cache length -> (caches
        {"k", "v"} [layers, k, cache_len, Hkv, D] and any slot-indexed
        state [layers, k, ...], first sampled tokens [k]).  ring=False: a
        sliding window keeps FULL-length K/V (the pool stores absolute
        positions; the window is a mask, not a ring)."""
        caches, last = self.model.prefill(tokens, max_len=cache_len, ring=False,
                                          **extras)
        tok = sample_logits(last, generator, self.temperature,
                            self.cfg.vocab_size, self.top_k, self.top_p)
        return caches, tok

    def _chunk_impl(self, tokens, prefix_ids, generator, *, start, cache_len):
        """Prefix-hit prefill: gather the resident prefix blocks
        (``prefix_ids`` [k, m]) on the device into [layers, k, start, ...]
        per leaf, run only the prompt TAIL through the stack, and return
        the tail K/V padded to ``cache_len - start`` + first sampled
        tokens.  Every leaf moves (a quantized pool's codes and scales
        alike; fp8 codes as bytes)."""
        prefix = {name: quant.raw(leaf)[:, prefix_ids].reshape(
                      leaf.shape[0], prefix_ids.shape[0], start,
                      *leaf.shape[3:]).view(leaf.dtype)
                  for name, leaf in self._caches.items()}
        tail, last = self.model.prefill_chunk(tokens, prefix, start)
        pad = cache_len - start - tokens.shape[1]
        tail = {name: torch.nn.functional.pad(
                    quant.raw(t), (0, 0) * (t.dim() - 3) + (0, pad)).view(t.dtype)
                for name, t in tail.items()}
        tok = sample_logits(last, generator, self.temperature,
                            self.cfg.vocab_size, self.top_k, self.top_p)
        return tail, tok

    def _admit_impl(self, new, slots, block_ids, first_toks, start_idxs):
        """Scatter a prefilled group's caches into the pool (in place) and
        seed the slots' token/position registers.  Paged leaves land in
        their blocks (``block_ids`` [k, nblk]; ``new`` leaves [layers, k,
        nblk * bs, ...]); slot-indexed leaves land at ``slots``."""
        bs = self.block_size
        nblk = block_ids.shape[1]
        ids = block_ids.reshape(-1)
        for name, leaf in self._caches.items():
            nw = new[name].to(leaf.dtype)
            if not self._paged_mask[name]:
                leaf.index_copy_(1, slots, nw)
                continue
            nw = nw.reshape(nw.shape[0], nw.shape[1] * nblk, bs, *nw.shape[3:])
            quant.raw(leaf).index_copy_(1, ids, quant.raw(nw))
        self._tok = self._tok.index_copy(0, slots, first_toks)
        self._idx = self._idx.index_copy(0, slots, start_idxs)

    def _burst_impl(self, tok, idx, active, tables, generator, steps):
        """``steps`` decode iterations over the whole pool
        (:meth:`_decode_scan`); frozen slots' stale writes land in blocks
        they still own, or the NULL block once retired.  Returns the new
        registers and the [steps, num_slots] token block for one fetch."""
        bt = tables if self._has_paged else None
        return self._decode_scan(tok, idx, active, bt, generator, steps)

    def _decode_scan(self, tok, idx, active, bt, generator, steps):
        """``steps`` decode iterations: batched paged decode (``bt`` block
        tables, per-slot absolute positions) + on-device sampling; inactive
        slots are frozen (token/index don't advance).  Returns the new
        registers and the [steps, num_slots] token block."""
        toks = []  # ONE definition for the legacy burst and the unified step
        for _ in range(steps):
            logits = self.model.decode_step(self._caches, tok, idx, bt)
            nxt = sample_logits(logits, generator, self.temperature,
                                self.cfg.vocab_size, self.top_k, self.top_p)
            tok = torch.where(active, nxt, tok)
            idx = torch.where(active, idx + 1, idx)
            toks.append(tok)
        return tok, idx, torch.stack(toks)

    def _flush_cow(self):
        """Apply pending copy-on-write block copies before the next
        dispatch writes into the fresh blocks."""
        if not self._cow_pairs:
            return
        src = self._dev([p[0] for p in self._cow_pairs])
        dst = self._dev([p[1] for p in self._cow_pairs])
        self._cow_pairs = []
        for name, leaf in self._caches.items():
            if self._paged_mask[name]:
                cache_utils.copy_pool_blocks(leaf, src, dst)

    # ------------------------------------------------------------------
    # admission policy (Scheduler callback): blocks, not slots, gate entry
    # ------------------------------------------------------------------
    def _start_index(self, req: Request) -> int:
        """The request's first decode position: its inputs, after a vlm's
        patches."""
        return len(req.input_ids()) + patch_positions(self.cfg)

    def can_admit(self, req: Request) -> bool:
        """Enough free/evictable blocks for this prompt (+1 decode
        headroom)?  Prefix-hit blocks are discounted — but hits that are
        currently evictable consume availability when pinned, so they count
        back in."""
        pool = self.pool
        w0 = pool.blocks_for(self._start_index(req))
        hits, _ = self._lookup_hits(req)
        evictable_hits = sum(1 for b in hits if pool.ref(b) == 0)
        ok = pool.available() >= (w0 - len(hits)) + evictable_hits + 1
        if not ok:
            self._admit_plan = None  # hits may be evicted by the next try
        return ok

    def on_admit(self, slot: int, req: Request):
        """Pin prefix hits, allocate the remaining prompt blocks, and build
        the slot's block table."""
        pool = self.pool
        w0 = pool.blocks_for(self._start_index(req))
        hits, hashes = self._lookup_hits(req)
        self._admit_plan = None
        self._chain_memo.pop(req.rid, None)
        if self.prefix_cache:
            self._req_hashes[req.rid] = hashes
        pool.claim(hits)
        bids = hits + pool.alloc(w0 - len(hits))
        self._slot_blocks[slot] = bids
        self._tables[slot] = NULL_BLOCK
        self._tables[slot, :w0] = bids
        self._tables_dirty = True
        req.prefix_hit_tokens = len(hits) * self.block_size
        self.stats["prefix_hit_tokens"] += req.prefix_hit_tokens
        if self.tracer is not None:
            self.tracer.emit(ev.EV_PREFIX_HIT_TOKENS, req.prefix_hit_tokens)

    def _lookup_hits(self, req: Request) -> tuple[list[int], list[int]]:
        """(prefix-hit blocks, full hash chain), memoized per (rid, input
        length); the plan covers the atomic can_admit -> on_admit pair."""
        if not self.prefix_cache or req.extras:
            return [], []
        plan = self._admit_plan
        if plan is not None and plan[0] is req:
            return plan[1], plan[2]
        ids = req.input_ids()
        memo = self._chain_memo.get(req.rid)
        if memo is None or memo[0] != len(ids):
            memo = (len(ids), self.pool.hash_chain(ids))
            self._chain_memo[req.rid] = memo
        hashes = memo[1]
        hits = self.pool.resolve_hits(hashes, len(ids))
        self._admit_plan = (req, hits, hashes)
        return hits, hashes

    def _release_blocks(self, slot: int):
        if self.pool is None:
            return
        self.pool.free(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._tables[slot] = NULL_BLOCK
        self._tables_dirty = True

    def _grow_slot_blocks(self, slot: int, missing: int):
        """Append ``missing`` freshly allocated blocks to a slot's table."""
        fresh = self.pool.alloc(missing)
        a = len(self._slot_blocks[slot])
        self._tables[slot, a:a + missing] = fresh
        self._slot_blocks[slot].extend(fresh)
        self._tables_dirty = True

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, extras: dict | None = None,
               arrival_ns: int | None = None, n_samples: int = 1,
               session: str | None = None) -> Request:
        """Queue one request; every refusal comes before it is queued.
        ``n_samples > 1`` fans the prompt into n decode streams after one
        prefill (engines with :attr:`supports_fork` only); ``session``
        makes it a turn of a conversation whose context stays pinned in
        the pool (needs the prefix cache; a later turn's prompt must
        extend the stored context; not with fan-out).  ``extras`` are the
        request's prefill inputs beside its tokens (a vlm's
        ``patch_embeds`` [num_patches, vision_dim])."""
        # paged storage holds ABSOLUTE positions: the capacity bound
        # applies to SWA archs too (the window is a mask), and counts a
        # vlm's patches; an ssm state has no length
        plen = int(np.asarray(prompt).shape[0])
        need = plen + patch_positions(self.cfg) + int(max_new_tokens) - 1
        if self._has_paged and need > self.capacity:
            raise ValueError(
                f"prompt {plen} + {max_new_tokens} new tokens needs cache "
                f"capacity {need} > {self.capacity}")
        if n_samples > 1:
            if not self.supports_fork:
                raise ValueError(
                    f"n_samples={n_samples} needs CoW forking, which "
                    f"{type(self).__name__} does not support for "
                    f"family={self.cfg.family!r} (unified engine + chunkable "
                    f"config only)")
            if session is not None:
                raise ValueError("n_samples > 1 and session are mutually "
                                 "exclusive (a session persists ONE stream)")
        if session is not None:
            if not self.prefix_cache:
                raise ValueError(
                    "sessions persist context through the prefix cache; "
                    "enable prefix_cache (fully-paged model) to use session "
                    "ids")
            held = self._sessions.get(session)
            if held is not None:
                ctx = held["context"]
                p = np.asarray(prompt, np.int32)
                if len(p) <= len(ctx) or not np.array_equal(p[:len(ctx)], ctx):
                    raise ValueError(
                        f"session {session!r}: the new prompt must extend the "
                        f"stored {len(ctx)}-token context (turn k+1 = full "
                        f"conversation so far + new tokens)")
        req = self.queue.submit(prompt, max_new_tokens, extras=extras,
                                arrival_ns=arrival_ns, n_samples=n_samples,
                                session=session)
        if self.tracer is not None:
            self.tracer.emit(ev.EV_QUEUE_DEPTH, len(self.queue))
        return req

    # ------------------------------------------------------------------
    # multi-turn sessions: the full context stays pinned across requests
    # ------------------------------------------------------------------
    def _session_pin(self, req: Request):
        """At a session turn's retirement, publish and pin its context.

        The context in the pool is ``prompt ++ tokens[:-1]`` (the last
        sampled token's K/V is never written); every FULL block of it is
        registered under the chained hash and takes one more reference,
        so the conversation survives eviction until the next turn claims
        it or the session closes.  The previous turn's pin (a prefix of
        this one) is released after the new one is taken, so the context
        never drops to zero references in between."""
        sid = req.session
        context = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
        written = len(context) - 1  # the last token's K/V is not pooled
        nfull = written // self.block_size
        blocks = self._slot_blocks[req.slot][:nfull]
        hashes = self.pool.hash_chain(context[:nfull * self.block_size])
        for bid, h in zip(blocks, hashes):
            self.pool.register(bid, h)
        self.pool.incref(blocks)  # the session's pin
        prev = self._sessions.get(sid)
        self._sessions[sid] = {"context": context, "blocks": list(blocks)}
        if prev is not None:
            self.pool.free(prev["blocks"])  # hand over turn k's pin

    def close_session(self, session: str) -> int:
        """Release a session's pin: its blocks drop to the prefix cache
        (CACHED, evictable; a re-opened conversation may still hit them).
        Returns the number of pinned blocks released; an unknown id is a
        no-op 0."""
        held = self._sessions.pop(session, None)
        if held is None:
            return 0
        self.pool.free(held["blocks"])
        return len(held["blocks"])

    def _finish(self, req: Request):
        req.t_done_ns = _now_ns()
        self._active[req.slot] = False
        self._active_dirty = True
        if req.session is not None and self.prefix_cache:
            self._session_pin(req)  # before the slot's refs drop
        self._release_blocks(req.slot)
        req.extras.clear()  # prefill inputs (patches) are dead weight now
        if self.tracer is not None:
            self.tracer.emit(ev.EV_REQ_TTFT_US, max(req.ttft_ns() // 1000, 0))
            self.tracer.emit(ev.EV_REQ_TPOT_US, req.tpot_ns() // 1000)
        self.scheduler.retire(req)

    # ------------------------------------------------------------------
    # decode-time block management
    # ------------------------------------------------------------------
    def _preempt_one(self, pairs):
        """Evict the latest-admitted in-flight request: free its blocks now
        (requeue is deferred until its in-flight tokens are drained)."""
        slot, victim = max(pairs, key=lambda sr: sr[1].admit_seq)
        pairs.remove((slot, victim))
        self._active[slot] = False
        self._active_dirty = True
        self._release_blocks(slot)
        self.scheduler.preempt(victim)
        self._preempted.append(victim)
        self.stats["preemptions"] += 1
        return pairs

    def _ensure_blocks(self, pairs, max_steps: int | None = None):
        """Allocate the blocks this burst will write, preempting (newest
        first) when the pool cannot cover every active slot.  Returns the
        surviving pairs and the burst length (a power of two, capped at
        ``max_steps`` or ``max_decode_burst`` and at each slot's remaining
        cache capacity)."""
        cap = self.max_decode_burst if max_steps is None else max_steps
        while pairs:
            need = min(r.max_new_tokens - r.scheduled for _, r in pairs)
            steps = 1
            while steps < need:
                steps *= 2
            steps = min(steps, cap)
            if self.pool is None:
                return pairs, steps
            steps = min(steps, min(
                self.capacity + 1 - int(self._slot_start[s])
                - (r.scheduled - int(self._slot_sched0[s]))
                for s, r in pairs))
            shortfall: list[tuple[int, int]] = []  # (slot, missing blocks)
            shared: list[tuple[int, int]] = []  # (slot, w): CoW before write
            total = 0
            for slot, req in pairs:
                first_pos = (int(self._slot_start[slot]) + req.scheduled
                             - int(self._slot_sched0[slot]) - 1)
                last_pos = first_pos + steps - 1
                owned = len(self._slot_blocks[slot])
                missing = last_pos // self.block_size + 1 - owned
                if missing > 0:
                    shortfall.append((slot, missing))
                    total += missing
                for w in range(first_pos // self.block_size,
                               min(last_pos // self.block_size, owned - 1) + 1):
                    if self.pool.ref(self._slot_blocks[slot][w]) > 1:
                        shared.append((slot, w))
                        total += 1
            if total <= self.pool.available():
                for slot, missing in shortfall:
                    self._grow_slot_blocks(slot, missing)
                for slot, w in shared:
                    old = self._slot_blocks[slot][w]
                    fresh, copied = self.pool.cow(old)
                    if copied:
                        self._slot_blocks[slot][w] = fresh
                        self._tables[slot, w] = fresh
                        self._tables_dirty = True
                        self._cow_pairs.append((old, fresh))
                return pairs, steps
            pairs = self._preempt_one(pairs)
        return pairs, 0

    def _process_tokens(self, toks: np.ndarray, pairs):
        """Record one dispatch's fetched [steps, num_slots] token block.
        Preempted requests still drain their in-flight tokens here."""
        tr = self.tracer
        self.stats["host_syncs"] += 1
        if len(toks):  # chunk-only dispatches carry no decode rows
            self.stats["decode_syncs"] += 1
        for row in toks:
            for slot, req in pairs:
                if req.done or len(req.tokens) >= req.max_new_tokens:
                    continue
                req.tokens.append(int(row[slot]))
                self.stats["tokens_decoded"] += 1
                if len(req.tokens) >= req.max_new_tokens:
                    if self.scheduler.slots[req.slot] is req:
                        self._finish(req)
        self.stats["iterations"] += len(toks)
        # flush cadence counts DISPATCHES, floor 1: chunk-only steps must
        # still stream their records out
        self._since_flush += max(len(toks), 1)
        if tr:
            tr.emit(EV_TOKENS_DECODED, self.stats["tokens_decoded"])
            tr.emit(ev.EV_TOKENS_TOTAL, self.stats["tokens_decoded"])
            tr.emit(ev.EV_QUEUE_DEPTH, len(self.queue))
            if self.flush_every and self._since_flush >= self.flush_every:
                tr.flush(self.flush_base)
                self._since_flush = 0

    def _drain_preempted(self):
        """Requeue preempted requests (front of queue, earliest-admitted
        first) once their in-flight tokens have been processed."""
        for req in sorted(self._preempted, key=lambda r: r.admit_seq,
                          reverse=True):
            req.scheduled = len(req.tokens)
            self.queue.requeue(req)
            if self.tracer is not None:
                self.tracer.emit(ev.EV_QUEUE_DEPTH, len(self.queue))
        self._preempted.clear()

    # ------------------------------------------------------------------
    # serving loop: grouped prefill + decode bursts
    # ------------------------------------------------------------------
    def _prefill_groups(self, admissions: list[tuple[int, Request]]):
        """Group same-shape admissions so they prefill as ONE batch (a
        (length, prefix-hit, extras' shapes) bucket); mixed shapes degrade
        to singletons."""
        groups: dict[tuple, list[tuple[int, Request]]] = {}
        for slot, req in admissions:
            sig = (len(req.input_ids()), req.prefix_hit_tokens,
                   tuple(sorted((k, v.shape) for k, v in req.extras.items())))
            groups.setdefault(sig, []).append((slot, req))
        return list(groups.values())

    def _do_prefill(self, members: list[tuple[int, Request]]):
        t_wall0 = time.perf_counter()
        tr = self.tracer
        reqs = [r for _, r in members]
        slots = [s for s, _ in members]
        inputs = [r.input_ids() for r in reqs]
        starts = [self._start_index(r) for r in reqs]
        bs = self.block_size
        cache_len = -(-starts[0] // bs) * bs if self._has_paged else starts[0]
        w0 = cache_len // bs if self._has_paged else 0
        hit = reqs[0].prefix_hit_tokens  # same within a group (signature)
        gen = self._generator(salt=(1 << 20) + reqs[0].rid)
        t_admit = _now_ns()
        with (tr.phase(ev.PHASE_PREFILL) if tr else contextlib.nullcontext()), \
                (tr.user_function(name="prefill") if tr
                 else contextlib.nullcontext()):
            if hit:
                # tail-only prefill: resident prefix blocks are ref-bumped,
                # their K/V gathered on device; no recompute for hit tokens
                m = hit // bs
                tokens = self._dev(np.stack([ids[hit:] for ids in inputs]))
                prefix_ids = self._dev(np.asarray(
                    [self._slot_blocks[s][:m] for s in slots], np.int64))
                new, tok1 = self._chunk_impl(tokens, prefix_ids, gen,
                                             start=hit, cache_len=cache_len)
                block_ids = [self._slot_blocks[s][m:w0] for s in slots]
            else:
                extras = {k: self._dev(np.stack([r.extras[k] for r in reqs]))
                          for k in reqs[0].extras}
                new, tok1 = self._prefill_impl(self._dev(np.stack(inputs)),
                                               extras, gen, cache_len=cache_len)
                block_ids = [self._slot_blocks[s][:w0] for s in slots]
        self._admit_impl(new, self._dev(np.asarray(slots, np.int64)),
                         self._dev(np.asarray(block_ids, np.int64)), tok1,
                         self._dev(np.asarray(starts, np.int32)))
        self._note_kernel("dense")  # prefill/chunk run the dense variant
        for slot, st, req in zip(slots, starts, reqs):
            self._slot_start[slot] = st
            self._slot_sched0[slot] = len(req.tokens)  # re-prefilled tokens
        firsts = tok1.cpu().numpy()  # TTFT: first tokens materialized here
        self.stats["host_syncs"] += 1
        self.stats["prefills"] += len(reqs)
        self.stats["prefill_tokens"] += sum(
            st - r.prefix_hit_tokens for st, r in zip(starts, reqs))
        if self.prefix_cache:
            # publish full PROMPT blocks for future prefix hits (generated
            # tokens are never shared; hit blocks no-op re-register)
            for slot, req in zip(slots, reqs):
                hashes = self._req_hashes.pop(req.rid)[:req.prompt_len // bs]
                for j, h in enumerate(hashes):
                    self.pool.register(self._slot_blocks[slot][j], h)
        t_first = _now_ns()
        # wall spent blocked on prefill while decode slots waited — the
        # grouped-prefill engine's head-of-line stall
        self.stats["prefill_seconds"] += time.perf_counter() - t_wall0
        for (slot, req), first in zip(members, firsts):
            req.t_admit_ns = t_admit
            if req.t_first_ns < 0:
                req.t_first_ns = t_first  # resumed requests keep their TTFT
            req.tokens.append(int(first))
            req.scheduled = len(req.tokens)
            self.stats["tokens_decoded"] += 1
            self._active[slot] = True
            self._active_dirty = True
            if len(req.tokens) >= req.max_new_tokens:
                self._finish(req)

    def run(self) -> dict[int, np.ndarray]:
        """Serve until queue and slots drain.  Returns {rid: [new_tokens]}
        for the requests completed by THIS call.

        Each iteration prefills the admitted groups, then dispatches one
        decode burst of up to ``max_decode_burst`` steps (clamped to the
        smallest remaining token budget, bucketed up to a power of two);
        burst i is enqueued before burst i-1's tokens are fetched, so the
        fetch overlaps device work and retirement lags the device by one
        burst.  A preemption flushes the pipeline first: a victim's
        in-flight tokens must drain before it is requeued."""
        tr = self.tracer
        done0 = len(self.scheduler.completed)
        inflight: collections.deque = collections.deque()  # unfetched bursts
        t_run0 = time.perf_counter()
        with torch.inference_mode():
            while inflight or not self.scheduler.drained():
                if self.queue and tr:
                    with tr.phase(ev.PHASE_ADMIT):
                        admissions = self.scheduler.admissions()
                else:
                    admissions = self.scheduler.admissions()
                for members in self._prefill_groups(admissions):
                    self._do_prefill(members)
                self.stats["peak_active"] = max(self.stats["peak_active"],
                                                self.scheduler.occupancy())
                if self.pool is not None:
                    self.stats["peak_blocks"] = max(self.stats["peak_blocks"],
                                                    self.pool.num_active())
                    self.stats["peak_shared"] = max(self.stats["peak_shared"],
                                                    self.pool.num_shared())
                dispatched = None
                pairs = [(s, r) for s, r in self.scheduler.active()
                         if self._active[s]]
                pairs, steps = self._ensure_blocks(pairs)
                self._flush_cow()  # CoW copies land before the burst writes
                if pairs:
                    gen = self._generator()
                    self._dispatches += 1
                    self._prep_dispatch()
                    with (tr.phase(ev.PHASE_DECODE) if tr
                          else contextlib.nullcontext()), \
                            (tr.user_function(name="decode_step") if tr
                             else contextlib.nullcontext()):
                        self._tok, self._idx, toks = self._burst_impl(
                            self._tok, self._idx, self._active_dev,
                            self._tables_dev, gen, steps)
                    self._note_kernel("paged_decode")
                    self.stats["decode_dispatches"] += 1
                    for slot, req in pairs:
                        req.scheduled += steps
                        if req.scheduled >= req.max_new_tokens:
                            # fully scheduled: freeze the slot for the next
                            # burst (occupied until its tokens are fetched)
                            self._active[slot] = False
                            self._active_dirty = True
                    dispatched = (toks, pairs)
                    inflight.append(dispatched)
                keep = 1 if (dispatched is not None
                             and not self._preempted) else 0
                while len(inflight) > keep:
                    toks, done_pairs = inflight.popleft()
                    self._process_tokens(toks.cpu().numpy(), done_pairs)
                self._drain_preempted()
        self.stats["seconds"] += time.perf_counter() - t_run0
        return {r.rid: np.asarray(r.tokens, np.int32)
                for r in self.scheduler.completed[done0:]}

    def serve_batch(self, prompts: np.ndarray, *, num_tokens: int,
                    extras: dict | None = None) -> np.ndarray:
        """Submit a rectangular batch (``extras`` name -> [B, ...]) and run
        to completion.  Returns [B, num_tokens] in submission order."""
        reqs = [self.submit(p, num_tokens,
                            extras={k: v[b] for k, v in (extras or {}).items()})
                for b, p in enumerate(prompts)]
        out = self.run()
        return np.stack([out[r.rid] for r in reqs])

    def throughput_stats(self) -> dict:
        total, dt = self.stats["tokens_decoded"], self.stats["seconds"]
        out = {**self.stats, "tokens": total,
               "tok_per_s": total / dt if dt > 0 else float("nan")}
        out["host_syncs_per_decode_iter"] = (
            self.stats["decode_syncs"] / max(self.stats["iterations"], 1))
        if self.pool is not None:
            out.update(blocks_free=self.pool.num_free(),
                       blocks_cached=self.pool.num_cached(),
                       evictions=self.pool.stats["evictions"],
                       hit_blocks=self.pool.stats["hit_blocks"],
                       forks=self.pool.stats["forks"],
                       cow_copies=self.pool.stats["cow_copies"])
        return out


class ServeEngine:
    """Fixed-batch engine over CONTIGUOUS per-request caches: one
    rectangular batch, lockstep decode.

    The paged engines' equivalence oracle: the contiguous cache layout
    (ring-arranged under a sliding window) survives only here.  Sampling
    follows each decode step on the device; the loop fetches every token
    (one host sync per token).  An ssm stack's prefill returns its decode
    state, which each step advances in place; a hybrid's returns both, the
    attention ring (its window) and the RG-LRU state.  A vlm's
    ``extras`` (``patch_embeds`` [B, P, vision_dim]) prefill before the
    tokens, and decode starts at ``S + P``.  ``model`` is a
    :class:`DecoderLM` on ``device`` (CUDA unless the caller asks for the
    CPU); None builds a seeded random one there."""

    def __init__(self, cfg: ModelConfig, model: DecoderLM | None = None, *,
                 device="cuda", max_len: int, tracer=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = build_model(cfg, device=self.device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        self.model = model.serving_view(cfg)
        self.max_len = int(max_len)
        self.tracer = tracer
        self.host_syncs = 0
        if tracer is not None:
            tracer.register(EV_TOKENS_DECODED, "Tokens decoded")

    def _generator(self, seed: int, i: int, temperature: float):
        if temperature <= 0.0:
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(hash((int(seed), i)) & (2**62 - 1))
        return g

    def generate(self, prompts: np.ndarray, *, num_tokens: int,
                 extras: dict | None = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0) -> np.ndarray:
        """prompts: [B, S] int32 (``extras`` name -> [B, ...]).  Returns
        [B, num_tokens] generated ids."""
        b, s = prompts.shape
        start = s + patch_positions(self.cfg)
        tokens = torch.from_numpy(np.asarray(prompts, np.int32)).to(self.device)
        extras = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                  for k, v in (extras or {}).items()}
        tr = self.tracer
        vocab = self.cfg.vocab_size
        out = np.zeros((b, num_tokens), np.int32)
        with torch.inference_mode():
            if tr:
                with tr.phase(ev.PHASE_EVAL), tr.user_function(name="prefill"):
                    caches, logits = self.model.prefill(
                        tokens, max_len=self.max_len, **extras)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            else:
                caches, logits = self.model.prefill(tokens, max_len=self.max_len,
                                                    **extras)
            tok = sample_logits(logits, self._generator(seed, 0, temperature),
                                temperature, vocab, top_k, top_p)
            out[:, 0] = tok.cpu().numpy()
            self.host_syncs += 1
            for i in range(1, num_tokens):
                idx = torch.tensor(start + i - 1, dtype=torch.int32,
                                   device=self.device)
                gen = self._generator(seed, i, temperature)
                with (tr.user_function(name="decode_step") if tr
                      else contextlib.nullcontext()):
                    logits = self.model.decode_step(caches, tok, idx)
                    tok = sample_logits(logits, gen, temperature, vocab,
                                        top_k, top_p)
                if tr:
                    tr.emit(EV_TOKENS_DECODED, i)
                out[:, i] = tok.cpu().numpy()
                self.host_syncs += 1
        return out

    def throughput_stats(self, prompts, num_tokens: int, extras=None,
                         temperature: float = 0.0, top_k: int = 0,
                         top_p: float = 1.0, seed: int = 0) -> dict:
        syncs0 = self.host_syncs
        t0 = time.perf_counter()
        self.generate(prompts, num_tokens=num_tokens, extras=extras,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed)
        dt = time.perf_counter() - t0
        total = prompts.shape[0] * num_tokens
        return {"tokens": total, "seconds": dt, "tok_per_s": total / dt,
                "host_syncs": self.host_syncs - syncs0}
