"""Paged serve-engine base: the pool / admission / preemption machinery the
unified token-budget engine (:mod:`repro_torch.serve.step`) runs on.

This is the subset of ``repro.serve.engine.ContinuousServeEngine`` that
``UnifiedServeEngine`` inherits: the paged block pool (host bookkeeping in
:mod:`repro_torch.serve.block_pool`, device storage here), request intake,
the admission policy, just-in-time block growth with newest-first
preemption, the decode scan, token fetch/retirement and the run stats.
The legacy grouped-prefill loop (``_prefill_impl`` / ``_chunk_impl`` /
``_admit_impl`` / ``_burst_impl``) needs the dense flash kernel and comes
with the next slice; so do the mesh, the trace replay, sessions and the
prefix export/import of the JAX engine.

Device state lives in torch tensors on ``device``: the pool leaves
``{"k", "v"}`` [layers, NB, bs, Hkv, D] (updated IN PLACE by every
dispatch — the JAX engine donates and replaces them), the per-slot token
and position registers, the active mask and the block tables.  Work is
enqueued on the current CUDA stream and fetched one dispatch later, so the
host plans dispatch N+1 while the card runs dispatch N.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import events as ev
from repro_torch.core.sampling import sample_logits
from repro_torch.kernels.attention import dispatch as kdispatch
from repro_torch.models import cache_utils
from repro_torch.models.model import DecoderLM, build_model, resolve_device
from repro_torch.serve.block_pool import NULL_BLOCK, BlockPool
from repro_torch.serve.queue import Request, RequestQueue, _now_ns
from repro_torch.serve.scheduler import Scheduler

EV_TOKENS_DECODED = 84_001  # user event: tokens decoded so far (one run)


class ContinuousServeEngine:
    """Paged-pool engine base (see the module docstring for what is ported).

    ``model`` is a :class:`DecoderLM` on ``device``; None builds a seeded
    random one there.  ``device`` defaults to CUDA and raises when CUDA is
    absent — CPU runs pass ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, model: DecoderLM | None = None, *,
                 device="cuda", num_slots: int, max_len: int,
                 block_size: int = 16, num_blocks: int | None = None,
                 prefix_cache: bool = True, tracer=None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0, max_decode_burst: int = 8):
        if cfg.kv_dtype != "fp16":
            raise NotImplementedError(
                f"kv_dtype {cfg.kv_dtype!r}: quantized pools are not ported "
                f"yet (native-dtype pools only)")
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = build_model(cfg, device=self.device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        self.model = model
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
        if tracer is not None:
            tracer.register(EV_TOKENS_DECODED, "Tokens decoded")
            for code in (ev.EV_TOKENS_TOTAL, ev.EV_REQ_TTFT_US,
                         ev.EV_REQ_TPOT_US, ev.EV_PREFIX_HIT_TOKENS):
                tracer.register(code, ev.SERVE_CTR_LABELS[code])
            for code, label in ev.KERNEL_EVENT_LABELS.items():
                tracer.register(code, label)

        if num_blocks is None:
            # one full-capacity region per slot + the reserved NULL block;
            # the floor keeps one max-length request admissible
            num_blocks = max(self.num_slots * self.blocks_per_slot + 1,
                             self.blocks_per_slot + 2)
        self.num_blocks = int(num_blocks)
        if self.num_blocks < self.blocks_per_slot + 2:
            raise ValueError(
                f"num_blocks {self.num_blocks} cannot hold one max-length "
                f"request ({self.blocks_per_slot} blocks + null + headroom)")
        specs = model.paged_cache_specs(self.num_slots, self.num_blocks, bs)
        block_bytes = sum(
            int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
            // self.num_blocks for shape, dt in specs.values())
        self.kv_bytes_per_token = block_bytes // bs
        self.pool = BlockPool(self.num_blocks, bs, tracer=tracer,
                              kv_dtype=cfg.kv_dtype, block_bytes=block_bytes)
        self.prefix_cache = bool(prefix_cache) and model.fully_paged()

        self.queue = RequestQueue()
        self.scheduler = Scheduler(self.num_slots, self.queue, tracer=tracer,
                                   admission=self)

        # --- device state: the pool (updated in place) + slot registers ---
        self._caches = {name: torch.zeros(shape, dtype=dt, device=self.device)
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
        # copy-on-write transfers (src, dst) to apply before the next write
        self._cow_pairs: list[tuple[int, int]] = []
        self._dispatches = 0  # dispatch counter (seeds the sampling stream)

        self.stats = {"iterations": 0, "prefills": 0, "tokens_decoded": 0,
                      "prefill_tokens": 0, "prefix_hit_tokens": 0,
                      "preemptions": 0, "peak_active": 0, "peak_blocks": 0,
                      "peak_shared": 0, "host_syncs": 0, "decode_syncs": 0,
                      "decode_dispatches": 0, "seconds": 0.0,
                      "kernel_dispatch": {}}
        self._kernel_plan = kdispatch.engine_plan(cfg,
                                                  platform=self.device.type)

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

    def _generator(self, salt: int = 0) -> torch.Generator | None:
        """Sampling stream of the current dispatch (None when greedy: argmax
        consumes no randomness).  Seeded from (engine seed, dispatch,
        salt) so a run is reproducible per seed."""
        if self.temperature <= 0.0:
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(hash((self.seed, self._dispatches, salt)) & (2**62 - 1))
        return g

    def _note_kernel(self, variant: str):
        """Account one engine dispatch of an attention-kernel variant."""
        d = self._kernel_plan[variant]
        counts = self.stats["kernel_dispatch"]
        counts[d.tag] = counts.get(d.tag, 0) + 1
        if self.tracer is not None:
            self.tracer.emit(ev.EV_KERNEL_VARIANT, d.event_value)

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def _decode_scan(self, tok, idx, active, bt, generator, steps):
        """``steps`` decode iterations: batched paged decode (``bt`` block
        tables, per-slot absolute positions) + on-device sampling; inactive
        slots are frozen (token/index don't advance).  Returns the new
        registers and the [steps, num_slots] token block."""
        toks = []
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
        for leaf in self._caches.values():
            cache_utils.copy_pool_blocks(leaf, src, dst)

    # ------------------------------------------------------------------
    # admission policy (Scheduler callback): blocks, not slots, gate entry
    # ------------------------------------------------------------------
    def _start_index(self, req: Request) -> int:
        return len(req.input_ids())

    def _lookup_hits(self, req: Request) -> tuple[list[int], list[int]]:
        """(prefix-hit blocks, full hash chain), memoized per (rid, input
        length); the plan covers the atomic can_admit -> on_admit pair."""
        if not self.prefix_cache:
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
        if n_samples > 1:
            raise NotImplementedError(
                "n_samples > 1 (CoW fan-out) is not ported yet")
        if session is not None:
            raise NotImplementedError("sessions are not ported yet")
        if extras:
            raise NotImplementedError("request extras belong to vlm/encdec "
                                      "families, which are not ported")
        # paged storage holds ABSOLUTE positions: the capacity bound
        # applies to SWA archs too (the window is a mask)
        plen = int(np.asarray(prompt).shape[0])
        need = plen + int(max_new_tokens) - 1
        if need > self.capacity:
            raise ValueError(
                f"prompt {plen} + {max_new_tokens} new tokens needs cache "
                f"capacity {need} > {self.capacity}")
        req = self.queue.submit(prompt, max_new_tokens, arrival_ns=arrival_ns)
        if self.tracer is not None:
            self.tracer.emit(ev.EV_QUEUE_DEPTH, len(self.queue))
        return req

    def _finish(self, req: Request):
        req.t_done_ns = _now_ns()
        self._active[req.slot] = False
        self._active_dirty = True
        self._release_blocks(req.slot)
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
        if tr:
            tr.emit(EV_TOKENS_DECODED, self.stats["tokens_decoded"])
            tr.emit(ev.EV_TOKENS_TOTAL, self.stats["tokens_decoded"])
            tr.emit(ev.EV_QUEUE_DEPTH, len(self.queue))

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

    def run(self) -> dict[int, np.ndarray]:
        raise NotImplementedError(
            "the legacy grouped-prefill loop needs the dense flash kernel and "
            "is not ported yet; serve through UnifiedServeEngine")

    def throughput_stats(self) -> dict:
        total, dt = self.stats["tokens_decoded"], self.stats["seconds"]
        out = {**self.stats, "tokens": total,
               "tok_per_s": total / dt if dt > 0 else float("nan")}
        out["host_syncs_per_decode_iter"] = (
            self.stats["decode_syncs"] / max(self.stats["iterations"], 1))
        out.update(blocks_free=self.pool.num_free(),
                   blocks_cached=self.pool.num_cached(),
                   evictions=self.pool.stats["evictions"],
                   hit_blocks=self.pool.stats["hit_blocks"])
        return out
