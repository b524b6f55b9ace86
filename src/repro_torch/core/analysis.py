"""Serve-trace analysis of the torch port: the TTFT/TPOT summary the
serve CLI prints at exit, copied from ``repro.core.analysis`` (with the
communication-overlap fold it calls).  It reads the in-memory
:class:`Trace` or a parsed ``.prv`` alike.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import events as ev
from repro_torch.core.records import Trace


def serve_latency_summary(trace: Trace) -> dict:
    """Fold the per-request ``EV_REQ_TTFT_US`` / ``EV_REQ_TPOT_US`` events
    (one each per retirement) into distribution statistics for the run.

    Returns ``{"ttft_us": {...}, "tpot_us": {...}, "per_task": {...},
    "spec": {...}, "forks": {...}, "comm": {...}}`` where the latency
    entries hold
    ``count`` / ``p50`` / ``p95`` / ``max`` (floats, microseconds; zeros
    when the trace carries no serve events), ``per_task`` breaks the same
    TTFT/TPOT distributions out per TASK when the trace has more than one
    (a merged replica-fleet ``.prv``: task 1 + r is replica r — empty
    tasks, like the router on task 0, are omitted), ``spec`` folds the per-dispatch ``EV_SPEC_DRAFTED`` /
    ``EV_SPEC_ACCEPTED`` counters into the run's draft-acceptance rate
    (zeros when the run was not speculative), and ``comm`` folds the
    per-dispatch ``EV_COMM_OVERLAP_US`` / ``EV_COMM_BLOCKED_US`` counters
    (core/comm_replay.py) into the run's communication overlap fraction —
    overlapped / (overlapped + blocked) modeled collective time, averaged
    over tasks so the merged multi-task ``.prv`` reads the same as one
    task's stream — the summary the serve CLI prints at exit and the
    mixed-load / sharded benches gate on.
    """
    def _dist(vals) -> dict:
        vals = vals.astype(float)
        if not len(vals):
            return {"count": 0, "p50": 0.0, "p95": 0.0, "max": 0.0}
        return {"count": int(len(vals)),
                "p50": float(np.percentile(vals, 50)),
                "p95": float(np.percentile(vals, 95)),
                "max": float(vals.max())}

    out: dict[str, dict] = {}
    for name, code in (("ttft_us", ev.EV_REQ_TTFT_US),
                       ("tpot_us", ev.EV_REQ_TPOT_US)):
        out[name] = _dist(trace.events[trace.events["type"] == code]["value"])
    # multi-task traces (a merged replica fleet: router = task 0, replica r
    # = task 1 + r) additionally break TTFT/TPOT out PER TASK, so the serve
    # CLI can print a per-replica table — aggregate percentiles hide a
    # slow replica entirely
    out["per_task"] = {}
    if trace.num_tasks > 1:
        evs = trace.events
        for t in range(trace.num_tasks):
            ttft = evs[(evs["type"] == ev.EV_REQ_TTFT_US) & (evs["task"] == t)]
            tpot = evs[(evs["type"] == ev.EV_REQ_TPOT_US) & (evs["task"] == t)]
            if len(ttft) or len(tpot):
                out["per_task"][t] = {"ttft_us": _dist(ttft["value"]),
                                      "tpot_us": _dist(tpot["value"])}
    drafted = trace.events[
        trace.events["type"] == ev.EV_SPEC_DRAFTED]["value"].astype(np.int64)
    accepted = trace.events[
        trace.events["type"] == ev.EV_SPEC_ACCEPTED]["value"].astype(np.int64)
    out["spec"] = {
        "dispatches": int(len(drafted)),
        "drafted": int(drafted.sum()),
        "accepted": int(accepted.sum()),
        "acceptance": (float(accepted.sum() / drafted.sum())
                       if drafted.sum() else 0.0),
    }
    # CoW fan-out: every forked child retires through the same
    # EV_REQ_TTFT_US / EV_REQ_TPOT_US path as its parent, so the latency
    # distributions above already cover the per-fork streams; this entry
    # adds the fork ledger itself — EV_FORK marks each minted child
    # (value = parent rid + 1) and the EV_BLOCKS_SHARED gauge's peak
    # proves the fan aliased the prompt blocks instead of copying them
    forks = trace.events[trace.events["type"] == ev.EV_FORK]
    shared = trace.events[
        trace.events["type"] == ev.EV_BLOCKS_SHARED]["value"].astype(np.int64)
    out["forks"] = {
        "count": int(len(forks)),
        "parents": int(len(np.unique(forks["value"]))),
        "peak_shared_blocks": int(shared.max()) if len(shared) else 0,
    }
    out["comm"] = comm_overlap_summary(trace)
    return out


def comm_overlap_summary(trace: Trace) -> dict:
    """Fold the per-dispatch EV_COMM_OVERLAP_US / EV_COMM_BLOCKED_US counter
    pairs into the run's overlap fraction.  Counters are injected once per
    (task, thread) endpoint per dispatch, so per-endpoint sums are equal by
    construction on a healthy trace; we average across endpoints to stay
    invariant to the mesh shape and the number of merged segment streams
    (the result matches the engine's own comm_overlap_us/comm_blocked_us
    stats, which accumulate once per dispatch)."""
    evs = trace.events
    ov = evs[evs["type"] == ev.EV_COMM_OVERLAP_US]
    bl = evs[evs["type"] == ev.EV_COMM_BLOCKED_US]
    nends = max(len(np.unique(ov[["task", "thread"]])), 1) if len(ov) else 1
    overlap_us = float(ov["value"].astype(np.int64).sum()) / nends
    blocked_us = float(bl["value"].astype(np.int64).sum()) / nends
    total = overlap_us + blocked_us
    return {
        "dispatches": int(len(ov)) // nends,
        "overlap_us": overlap_us,
        "blocked_us": blocked_us,
        "overlap_fraction": (overlap_us / total) if total > 0 else 0.0,
        "blocked_fraction": (blocked_us / total) if total > 0 else 0.0,
    }
