"""Predefined event types and Paraver state ids (Extrae-compatible flavor).

Extrae reserves code ranges per source; we keep the same ranges so traces
open naturally next to Extrae-produced ones:

  * 4xxxxxxx  runtime/tracer events (flush, phases)
  * 5xxxxxxx  communication-model events (our XLA collectives ~ "MPI calls")
  * 42xxxxxx  counters (PAPI analogue: XLA cost-analysis + rusage)
  * 45xxxxxx  sampler events
  * 6xxxxxxx  user functions
  * >= 80000000  user events (``register``/``emit``)
"""
from __future__ import annotations

# ---- Paraver states (subset of the default semantic table) ----
STATE_IDLE = 0
STATE_RUNNING = 1
STATE_NOT_CREATED = 2
STATE_WAITING_MSG = 3
STATE_WAITING_LINK = 4
STATE_SYNC = 5
STATE_GROUP_COMM = 9
STATE_IO = 10
STATE_RUNTIME = 12
STATE_FLUSH = 13

STATE_LABELS = {
    STATE_IDLE: "Idle",
    STATE_RUNNING: "Running",
    STATE_NOT_CREATED: "Not created",
    STATE_WAITING_MSG: "Waiting a message",
    STATE_WAITING_LINK: "Blocking Send",
    STATE_SYNC: "Synchronization",
    STATE_GROUP_COMM: "Group Communication",
    STATE_IO: "I/O",
    STATE_RUNTIME: "Not used / runtime",
    STATE_FLUSH: "Flushing traces",
}

# ---- tracer/runtime phases ----
EV_PHASE = 40000001  # trainer/server phase; values below
PHASE_END = 0
PHASE_STEP = 1
PHASE_DATA = 2
PHASE_CKPT = 3
PHASE_COMPILE = 4
PHASE_EVAL = 5
PHASE_PREFILL = 6  # serve: prefill of one admitted request
PHASE_DECODE = 7  # serve: one batched decode iteration over the slot pool
PHASE_ADMIT = 8  # serve: scheduler admission window
PHASE_LABELS = {
    PHASE_END: "End",
    PHASE_STEP: "train_step",
    PHASE_DATA: "data_load",
    PHASE_CKPT: "checkpoint",
    PHASE_COMPILE: "compile",
    PHASE_EVAL: "eval",
    PHASE_PREFILL: "serve_prefill",
    PHASE_DECODE: "serve_decode",
    PHASE_ADMIT: "serve_admit",
}

EV_FLUSH = 40000003  # tracer buffer flush (begin=1/end=0)
EV_STEP_NUMBER = 40000050  # value = global step

# ---- collective ("MPI-call") events; value = routine id ----
EV_COLLECTIVE = 50000002
COLL_END = 0
COLL_ALL_REDUCE = 1
COLL_ALL_GATHER = 2
COLL_REDUCE_SCATTER = 3
COLL_ALL_TO_ALL = 4
COLL_PERMUTE = 5
COLL_SEND_RECV = 6
COLL_LABELS = {
    COLL_END: "End",
    COLL_ALL_REDUCE: "all-reduce",
    COLL_ALL_GATHER: "all-gather",
    COLL_REDUCE_SCATTER: "reduce-scatter",
    COLL_ALL_TO_ALL: "all-to-all",
    COLL_PERMUTE: "collective-permute",
    COLL_SEND_RECV: "send-recv",
}
COLL_IDS = {v: k for k, v in COLL_LABELS.items() if k != COLL_END}

# ---- counters (PAPI analogue) ----
EV_CTR_FLOPS = 42100001  # per-step HLO flops (per device), from cost_analysis
EV_CTR_BYTES = 42100002  # per-step HLO bytes accessed
EV_CTR_COLL_BYTES = 42100003  # per-step collective bytes (per device)
EV_CTR_RSS = 42100010  # max RSS (KiB)
EV_CTR_UTIME = 42100011  # user time (us)
EV_CTR_STIME = 42100012  # system time (us)
EV_CTR_MINFLT = 42100013  # minor page faults
CTR_LABELS = {
    EV_CTR_FLOPS: "HLO FLOPs per step (device)",
    EV_CTR_BYTES: "HLO bytes accessed per step (device)",
    EV_CTR_COLL_BYTES: "Collective bytes per step (device)",
    EV_CTR_RSS: "Max RSS (KiB)",
    EV_CTR_UTIME: "User time (us)",
    EV_CTR_STIME: "System time (us)",
    EV_CTR_MINFLT: "Minor page faults",
}

# ---- serving engine (continuous batching; paper Listing 4 discipline:
# every scheduler decision is bracketed/stamped with punctual events) ----
EV_QUEUE_DEPTH = 42200001  # counter: requests waiting for a slot
EV_SLOTS_ACTIVE = 42200002  # counter: occupied decode slots
EV_TOKENS_TOTAL = 42200003  # counter: cumulative tokens decoded this run
EV_BLOCKS_FREE = 42200004  # counter: KV blocks on the pool free list
EV_BLOCKS_CACHED = 42200005  # counter: evictable prefix-cache blocks (ref 0)
EV_BLOCKS_ACTIVE = 42200006  # counter: KV blocks referenced by live requests
EV_REQ_TTFT_US = 42200010  # per-request time-to-first-token (us), at retire
EV_REQ_TPOT_US = 42200011  # per-request mean time-per-output-token (us)
EV_PREFIX_HIT_TOKENS = 42200012  # per-admit: prompt tokens served from cache
# unified token-budget step (chunked prefill + decode in one mixed batch):
# one triple per scheduler iteration, so the prefill/decode interleave is a
# first-class Paraver timeline (EV_CHUNK_TOKENS > 0 while EV_DECODE_TOKENS
# > 0 IS the chunked-prefill overlap)
EV_STEP_BUDGET = 42200013  # counter: tokens scheduled this step (of budget)
EV_CHUNK_TOKENS = 42200014  # counter: prefill-chunk tokens this step
EV_DECODE_TOKENS = 42200015  # counter: decode tokens this step
# speculative decode (serve/spec.py): one triple per verify dispatch, so the
# draft/accept economy is a first-class Paraver timeline — per dispatch,
# DRAFTED == ACCEPTED + rejected (rejected is the visible gap between the
# two curves) and K is the adaptive span width the scheduler chose
EV_SPEC_DRAFTED = 42200016  # counter: draft tokens verified this dispatch
EV_SPEC_ACCEPTED = 42200017  # counter: draft tokens accepted this dispatch
EV_SPEC_K = 42200018  # counter: draft span width K in effect
# quantized KV block pool (serve/block_pool.py): storage dtype emitted once
# at pool init (BLOCK_DTYPE_IDS value), occupancy emitted next to the
# EV_BLOCKS_* gauges so equal-HBM concurrency is readable off the .prv
EV_BLOCK_DTYPE = 42200019  # counter: pool storage dtype (BLOCK_DTYPE_IDS)
EV_POOL_ACTIVE_KIB = 42200020  # counter: bytes held by active blocks (KiB)
# communication/compute overlap (core/comm_replay.py): per dispatch, per
# endpoint, the replayed collective time split by the HLO-schedule
# classification (hlo_comm.CollectiveOp.overlapped) — the pair always lands
# together so OVERLAP + BLOCKED == total modeled comm time for the dispatch
EV_COMM_OVERLAP_US = 42200021  # counter: collective us hidden behind compute
EV_COMM_BLOCKED_US = 42200022  # counter: collective us blocking compute
# multi-replica router (serve/router.py): per routed admission the router
# stamps the expected resident-prefix hit tokens that drove the affinity
# score, and per prefill->decode KV-block handoff (--disaggregate) the
# transfer size and wall time — all on the router's task-0 stream, so one
# merged .prv carries the cross-replica request story end to end
EV_ROUTE_PREFIX_HITS = 42200023  # counter: expected prefix-hit tokens routed
EV_KV_XFER_BYTES = 42200024  # counter: KV-block handoff wire bytes
EV_KV_XFER_US = 42200025  # counter: KV-block handoff wall time (us)
# copy-on-write decode forking (serve/block_pool.py fork + serve/step.py):
# SHARED counts blocks referenced by more than one request (ref >= 2) —
# emitted with every EV_BLOCKS_* gauge update, so the prefill amortisation
# of n-way sampling/beam/sessions is a first-class Paraver curve (shared
# stays high while the forks decode; it collapses as siblings retire)
EV_BLOCKS_SHARED = 42200026  # counter: KV blocks shared by >= 2 requests
BLOCK_DTYPE_IDS = {"fp16": 1, "int8": 2, "fp8": 3}
EV_REQ_ADMIT = 40000060  # value = request id + 1 when a request enters a slot
EV_REQ_RETIRE = 40000061  # value = request id + 1 when it completes
EV_EVICT = 40000062  # value = evicted KV block id (prefix cache eviction)
EV_REQ_PREEMPT = 40000063  # value = request id + 1 when evicted back to queue
# attention-kernel dispatch (kernels/attention/dispatch.py): which member of
# the kernel family a serve dispatch actually ran — value = the
# KERNEL_VARIANT_IDS entry for "{variant}:{backend}" (0 reserved)
EV_KERNEL_VARIANT = 40000064
# autotune layer (kernels/attention/autotune.py): SEARCH value = candidates
# measured before persisting; HIT value = 1 warm (persisted search result
# reused, no re-search) / 2 heuristic defaults (no search requested)
EV_AUTOTUNE_SEARCH = 40000065
EV_AUTOTUNE_HIT = 40000066
# router (serve/router.py): one punctual event per admitted request, value =
# the chosen replica's TASK id (replica r -> task r+1; the router itself is
# task 0) — so EV_ROUTE_DECISION count == admitted requests in the merged
# trace, and filtering by value isolates one replica's routed traffic
EV_ROUTE_DECISION = 40000067
# copy-on-write fork (serve/step.py): one punctual event per CHILD minted
# off a completing prompt (n_samples=4 -> 3 events, the parent keeps its
# slot) or per beam-search table reassignment, value = parent rid + 1 —
# so EV_FORK count == (n-1) * admitted fan-out requests in a sampling run
EV_FORK = 40000068
EV_SLOT_BASE = 40000100  # per-slot occupancy: code = base + slot,
                         # value = request id + 1 (0 = slot empty)
SERVE_CTR_LABELS = {
    EV_QUEUE_DEPTH: "Serve queue depth (requests)",
    EV_SLOTS_ACTIVE: "Serve slots active",
    EV_TOKENS_TOTAL: "Serve tokens decoded (cumulative)",
    EV_BLOCKS_FREE: "KV blocks free",
    EV_BLOCKS_CACHED: "KV blocks cached (evictable prefix entries)",
    EV_BLOCKS_ACTIVE: "KV blocks active (referenced)",
    EV_REQ_TTFT_US: "Request time-to-first-token (us)",
    EV_REQ_TPOT_US: "Request mean time-per-output-token (us)",
    EV_PREFIX_HIT_TOKENS: "Prefix-cache hit tokens (per admit)",
    EV_STEP_BUDGET: "Serve step tokens scheduled (of budget)",
    EV_CHUNK_TOKENS: "Serve step prefill-chunk tokens",
    EV_DECODE_TOKENS: "Serve step decode tokens",
    EV_SPEC_DRAFTED: "Spec draft tokens verified (per dispatch)",
    EV_SPEC_ACCEPTED: "Spec draft tokens accepted (per dispatch)",
    EV_SPEC_K: "Spec draft span width K",
    EV_BLOCK_DTYPE: "KV block pool storage dtype (1=fp16 2=int8 3=fp8)",
    EV_POOL_ACTIVE_KIB: "KV pool active-block bytes (KiB)",
    EV_COMM_OVERLAP_US: "Collective time overlapped with compute (us)",
    EV_COMM_BLOCKED_US: "Collective time blocking compute (us)",
    EV_ROUTE_PREFIX_HITS: "Router expected prefix-hit tokens (per admit)",
    EV_KV_XFER_BYTES: "KV handoff wire bytes (prefill -> decode replica)",
    EV_KV_XFER_US: "KV handoff wall time (us)",
    EV_BLOCKS_SHARED: "KV blocks shared by >= 2 requests (CoW forking)",
}

ROUTER_EVENT_LABELS = {
    EV_ROUTE_DECISION: "Router decision (value = chosen replica task id)",
}

KERNEL_EVENT_LABELS = {
    EV_KERNEL_VARIANT: "Attention kernel variant dispatched",
    EV_AUTOTUNE_SEARCH: "Attention autotune search (candidates measured)",
    EV_AUTOTUNE_HIT: "Attention autotune cache hit (1=warm 2=heuristic)",
}

# ---- sampler ----
EV_SAMPLE_FUNC = 45000100  # value = registered function id (callstack leaf)

# ---- user functions (@user_function analogue); value = func id, 0 = end ----
EV_USER_FUNC = 60000019

# ---- first code available to Extrae.register()-style user events ----
USER_EVENT_BASE = 80000000
