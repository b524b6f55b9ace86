"""Request model + FIFO admission queue for the continuous-batching engine.

A :class:`Request` is the unit the scheduler moves through

    QUEUED -> ACTIVE (prefilled into a slot, decoding) -> DONE

with one backward edge: ACTIVE -> QUEUED when the block pool runs dry and
the request is *preempted* (its KV blocks are evicted; on re-admission the
prompt plus every token generated so far is re-prefilled — recompute-style
preemption, greedy-decode safe).  Requests carry their own latency
bookkeeping (arrival / admission / first token / completion timestamps) so
the engine can emit per-request TTFT / TPOT trace counters at retirement.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np


class RequestState:
    QUEUED = "queued"
    ACTIVE = "active"
    DONE = "done"


def _now_ns() -> int:
    return time.perf_counter_ns()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [L] int32 token ids
    max_new_tokens: int
    extras: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    arrival_ns: int = -1
    # n-way CoW fan-out: the parent request is admitted and prefilled ONCE;
    # at prompt completion it forks into n_samples decode streams whose
    # block tables alias the parent's prompt blocks (serve/step.py).
    n_samples: int = 1
    fork_of: int = -1  # parent rid for a forked child, -1 otherwise
    fork_index: int = 0  # 0 = the parent itself; 1..n-1 = siblings
    # multi-turn session: requests sharing a session id persist their full
    # context blocks across turns (turn k+1 prefix-hits turn k's context)
    session: str | None = None

    state: str = RequestState.QUEUED
    slot: int = -1
    tokens: list[int] = dataclasses.field(default_factory=list)
    scheduled: int = 0  # tokens dispatched to device (>= len(tokens): in-flight)
    admit_seq: int = -1  # global admission order (preemption priority)
    prefix_hit_tokens: int = 0  # prompt tokens served from the prefix cache
    preemptions: int = 0
    bounces: int = 0  # router re-routes (full replica / replica death)
    t_admit_ns: int = -1
    t_first_ns: int = -1
    t_done_ns: int = -1
    forks: list["Request"] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return self.state == RequestState.DONE

    def input_ids(self) -> np.ndarray:
        """Prefill input: the prompt, plus — after a preemption — every
        token already generated (recompute-style resume)."""
        if not self.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    def ttft_ns(self) -> int:
        """Time to first token, from arrival (queueing included)."""
        if self.t_first_ns < 0 or self.arrival_ns < 0:
            return -1
        return self.t_first_ns - self.arrival_ns

    def tpot_ns(self) -> int:
        """Mean time per output token after the first."""
        n = len(self.tokens)
        if self.t_done_ns < 0 or self.t_first_ns < 0 or n < 2:
            return 0
        return (self.t_done_ns - self.t_first_ns) // (n - 1)


class RequestQueue:
    """FIFO of waiting requests; assigns monotonically increasing ids."""

    def __init__(self):
        self._q: collections.deque[Request] = collections.deque()
        self._next_rid = 0

    def submit(self, prompt: np.ndarray, max_new_tokens: int, *,
               extras: dict | None = None, arrival_ns: int | None = None,
               n_samples: int = 1, session: str | None = None) -> Request:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D token ids, got {prompt.shape}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if n_samples < 1:
            raise ValueError("n_samples must be >= 1")
        req = Request(
            rid=self._next_rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
            extras=dict(extras or {}),
            arrival_ns=_now_ns() if arrival_ns is None else int(arrival_ns),
            n_samples=int(n_samples), session=session,
        )
        self._next_rid += 1
        self._q.append(req)
        return req

    def fork_children(self, parent: Request, n: int | None = None) -> list[Request]:
        """Mint the ``n_samples - 1`` sibling requests of a completing
        fan-out parent.  Children share the parent's prompt array (their
        block tables will alias its blocks — serve/step.py) and inherit its
        arrival time, so per-fork TTFT measures the real queue-to-first-
        token path.  Children are NOT enqueued: the engine adopts each one
        straight into a free decode slot, or requeues it at the front when
        slots are exhausted (where it re-admits via the prefix cache)."""
        n = parent.n_samples if n is None else int(n)
        kids = []
        for i in range(1, n):
            kid = Request(
                rid=self._next_rid, prompt=parent.prompt,
                max_new_tokens=parent.max_new_tokens,
                extras=dict(parent.extras), arrival_ns=parent.arrival_ns,
                fork_of=parent.rid, fork_index=i,
            )
            self._next_rid += 1
            kids.append(kid)
        parent.forks = kids
        return kids

    def requeue(self, req: Request) -> None:
        """Put a preempted request at the FRONT of the queue (it already
        waited once; preemption must not also cost it its turn)."""
        req.state = RequestState.QUEUED
        self._q.appendleft(req)

    def bounce(self, req: Request) -> Request:
        """Re-enqueue a request bounced off a replica (admission refused by
        a full worker, or the worker died before completing it).

        The SAME :class:`Request` object goes back to the front of the
        queue — critically, ``arrival_ns`` (the original enqueue time) is
        untouched, so TTFT measured at whichever replica eventually serves
        it still covers the full queue + bounce + re-admission path instead
        of silently resetting on re-admission.  Per-admission state
        (slot, generated tokens, timestamps after arrival) is cleared:
        the next replica re-prefills from the prompt."""
        req.state = RequestState.QUEUED
        req.slot = -1
        req.tokens = []
        req.scheduled = 0
        req.prefix_hit_tokens = 0
        req.t_admit_ns = -1
        req.t_first_ns = -1
        req.t_done_ns = -1
        req.bounces += 1
        self._q.appendleft(req)
        return req

    def peek(self) -> Request | None:
        return self._q[0] if self._q else None

    def pop(self) -> Request | None:
        return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
