"""Slot + block scheduler for continuous batching over the paged KV pool.

The engine owns a fixed pool of ``num_slots`` decode slots (static shapes —
cache buffers never change shape, requests move through them) AND a pool of
KV blocks (``serve/block_pool.py``).  The scheduler decides, each engine
iteration:

  * which queued requests to admit (FIFO, bounded by
    ``max_prefills_per_iter``) — admission is gated on **block
    availability**, not just a free slot: the engine-provided ``admission``
    policy answers "do enough free/evictable blocks exist for this
    prompt?", so slot count stops being the capacity bound.  The unified
    token-budget engine admits one request at a time (:meth:`admit_one`)
    and its policy demands blocks for the FIRST prefill chunk only — the
    rest allocates just-in-time as chunks stream through the step
    (serve/step.py).  Speculative dispatches extend the same discipline
    to draft positions: blocks for the K speculative slots allocate
    just-in-time per span, roll back when drafts are rejected, and
    draft+verify positions are charged against the step budget before
    chunk planning sees the remainder (docs/speculative.md);
  * when a request is finished, returning its slot to the pool;
  * when the engine must *preempt* a request (block pool dry mid-decode),
    recording the back-transition.

Admission is safe to run WHILE dispatches are still in flight (the
double-buffered dispatch queue plans step N+1 before step N's tokens are
fetched, ``--overlap``): every block an in-flight dispatch writes was
allocated at ITS dispatch time (``_ensure_blocks`` / the chunk planner),
so the availability the admission policy reads already accounts for all
unfetched work — there is no window where a planned-ahead dispatch and a
new admission can be promised the same block.  The only pipeline-aware
rule lives in the engine loop: a preemption flushes the in-flight queue
before :meth:`preempt`'s victim is requeued, so the victim's drained
token count is exact.

Every decision is stamped into the trace (paper Listing 2/4 discipline):
``EV_QUEUE_DEPTH`` / ``EV_SLOTS_ACTIVE`` counters, punctual
``EV_REQ_ADMIT`` / ``EV_REQ_RETIRE`` / ``EV_REQ_PREEMPT`` markers, and a
per-slot occupancy event type (``EV_SLOT_BASE + slot``: value = request
id + 1, 0 when freed) so Paraver can render slot timelines exactly like
task timelines.
"""
from __future__ import annotations

from repro_torch.core import events as ev
from repro_torch.serve.queue import Request, RequestQueue, RequestState


class Scheduler:
    def __init__(self, num_slots: int, queue: RequestQueue, *, tracer=None,
                 max_prefills_per_iter: int = 1, admission=None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self.queue = queue
        self.tracer = tracer
        self.max_prefills_per_iter = max(1, int(max_prefills_per_iter))
        self.admission = admission  # can_admit(req) / on_admit(slot, req)
        self.slots: list[Request | None] = [None] * num_slots
        self.completed: list[Request] = []  # retirement order
        self._admit_seq = 0
        if tracer is not None:
            tracer.register(ev.EV_QUEUE_DEPTH, ev.SERVE_CTR_LABELS[ev.EV_QUEUE_DEPTH])
            tracer.register(ev.EV_SLOTS_ACTIVE, ev.SERVE_CTR_LABELS[ev.EV_SLOTS_ACTIVE])
            tracer.register(ev.EV_REQ_ADMIT, "Serve request admitted (rid+1)")
            tracer.register(ev.EV_REQ_RETIRE, "Serve request retired (rid+1)")
            tracer.register(ev.EV_REQ_PREEMPT, "Serve request preempted (rid+1)")
            for s in range(num_slots):
                tracer.register(ev.EV_SLOT_BASE + s,
                                f"Serve slot {s} occupant (rid+1)", {0: "empty"})

    # ------------------------------------------------------------------
    def _emit(self, code: int, value: int):
        if self.tracer is not None:
            self.tracer.emit(code, value)

    def occupancy(self) -> int:
        return sum(r is not None for r in self.slots)

    def active(self) -> list[tuple[int, Request]]:
        return [(s, r) for s, r in enumerate(self.slots) if r is not None]

    def any_active(self) -> bool:
        return any(r is not None for r in self.slots)

    def drained(self) -> bool:
        return not self.queue and not self.any_active()

    def inflight(self) -> int:
        """Requests this engine has accepted but not retired: active slots
        plus its local queue.  A replica worker compares this against its
        admission cap to answer "full" instead of over-committing
        (serve/replica.py)."""
        return self.occupancy() + len(self.queue)

    # ------------------------------------------------------------------
    def admissions(self) -> list[tuple[int, Request]]:
        """Pop queued requests into free slots (FIFO), up to the
        per-iteration prefill budget, gated on the admission policy (block
        availability).  A blocked queue head blocks the whole queue —
        skipping it would starve long prompts behind short ones.  Returns
        [(slot, request)] for the engine to prefill."""
        out: list[tuple[int, Request]] = []
        while len(out) < self.max_prefills_per_iter:
            pair = self.admit_one()
            if pair is None:
                break
            out.append(pair)
        if out:
            self._emit(ev.EV_QUEUE_DEPTH, len(self.queue))
            self._emit(ev.EV_SLOTS_ACTIVE, self.occupancy())
        return out

    def admit_one(self) -> tuple[int, Request] | None:
        """Admit the queue head into the lowest free slot, if the admission
        policy allows it (for the unified token-budget step the policy only
        demands blocks for the request's FIRST prefill chunk — the rest is
        allocated just-in-time as chunks stream in).  Returns (slot, req) or
        None when the queue is empty, no slot is free, or the head is
        blocked (FIFO: a blocked head blocks the queue)."""
        if not self.queue:
            return None
        slot = next((s for s in range(self.num_slots)
                     if self.slots[s] is None), None)
        if slot is None:
            return None
        head = self.queue.peek()
        if self.admission is not None and not self.admission.can_admit(head):
            return None
        req = self.queue.pop()
        req.state = RequestState.ACTIVE
        req.slot = slot
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        self.slots[slot] = req
        if self.admission is not None:
            self.admission.on_admit(slot, req)
        self._emit(ev.EV_REQ_ADMIT, req.rid + 1)
        self._emit(ev.EV_SLOT_BASE + slot, req.rid + 1)
        return slot, req

    def adopt(self, slot: int, req: Request) -> None:
        """Seat a freshly forked child directly into a free slot, bypassing
        the queue AND the admission policy: the child allocates no blocks —
        its table aliases the parent's (serve/block_pool.py ``fork``), so
        the availability gate has nothing to gate.  Stamps the same
        admit/slot events as :meth:`admit_one` so per-slot Paraver
        timelines and admit-before-retire invariants hold for forks too."""
        if self.slots[slot] is not None:
            raise ValueError(f"slot {slot} is occupied")
        req.state = RequestState.ACTIVE
        req.slot = slot
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        self.slots[slot] = req
        self._emit(ev.EV_REQ_ADMIT, req.rid + 1)
        self._emit(ev.EV_SLOT_BASE + slot, req.rid + 1)
        self._emit(ev.EV_SLOTS_ACTIVE, self.occupancy())

    def retire(self, req: Request):
        """Return a finished request's slot to the pool."""
        if self.slots[req.slot] is not req:
            raise ValueError(f"request {req.rid} does not own slot {req.slot}")
        self.slots[req.slot] = None
        req.state = RequestState.DONE
        self.completed.append(req)
        self._emit(ev.EV_REQ_RETIRE, req.rid + 1)
        self._emit(ev.EV_SLOT_BASE + req.slot, 0)
        self._emit(ev.EV_SLOTS_ACTIVE, self.occupancy())

    def preempt(self, req: Request):
        """Evict an in-flight request from its slot (block pool dry).  The
        engine frees its blocks and requeues it once the request's in-flight
        tokens have been drained."""
        if self.slots[req.slot] is not req:
            raise ValueError(f"request {req.rid} does not own slot {req.slot}")
        self.slots[req.slot] = None
        req.state = RequestState.QUEUED
        req.preemptions += 1
        self._emit(ev.EV_REQ_PREEMPT, req.rid + 1)
        self._emit(ev.EV_SLOT_BASE + req.slot, 0)
        self._emit(ev.EV_SLOTS_ACTIVE, self.occupancy())
