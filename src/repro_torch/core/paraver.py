"""Paraver trace format: .prv (records) + .pcf (semantics) + .row (labels).

Format per the Paraver reference manual (CEPBA-UPC, paper ref [9]):

  header:  #Paraver (date):ftime:nNodes(cpus,..):nAppl:nTasks(th:node,..)
  state:   1:cpu:appl:task:thread:begin:end:state
  event:   2:cpu:appl:task:thread:time:type:value[:type:value]...
  comm:    3:cpu:appl:task:thread:lsend:psend : cpu:appl:task:thread:lrecv:precv : size:tag

All object ids are 1-based in the files.  We write one APPLICATION.  The
parser is a full inverse of the writer (round-trip property-tested), which
doubles as the entry point for the paper's future-work item of reparsing
Paraver traces in-language.
"""
from __future__ import annotations

import heapq
import time as _time
from pathlib import Path

import numpy as np

from repro_torch.core import events as ev
from repro_torch.core.records import (
    COMM_DTYPE, EVENT_DTYPE, STATE_DTYPE, EventType, Trace, sort_trace,
)

_STATE_COLORS = {
    0: (117, 195, 255), 1: (0, 0, 255), 2: (255, 255, 255), 3: (255, 0, 0),
    4: (255, 0, 174), 5: (179, 0, 0), 9: (255, 144, 26), 10: (0, 224, 133),
    12: (189, 168, 100), 13: (266 % 256, 0, 255),
}


def _cpu_offsets(trace: Trace) -> list[int]:
    """First global cpu id (0-based) of each task; cpu = offset + thread."""
    off, acc = [], 0
    for t in range(trace.num_tasks):
        off.append(acc)
        acc += trace.threads_per_task[t]
    return off


def _record_lines(states, events, comms, offsets) -> list[tuple[int, str]]:
    """Format record arrays to sorted ``(time_key, prv_line)`` pairs."""

    def cpu(task, thread):
        return offsets[task] + thread + 1

    lines: list[tuple[int, str]] = []
    for r in states:
        lines.append(
            (int(r["begin"]),
             f"1:{cpu(r['task'], r['thread'])}:1:{r['task'] + 1}:{r['thread'] + 1}:"
             f"{r['begin']}:{r['end']}:{r['state']}")
        )
    for r in events:
        lines.append(
            (int(r["time"]),
             f"2:{cpu(r['task'], r['thread'])}:1:{r['task'] + 1}:{r['thread'] + 1}:"
             f"{r['time']}:{r['type']}:{r['value']}")
        )
    for r in comms:
        lines.append(
            (int(r["lsend"]),
             f"3:{cpu(r['stask'], r['sthread'])}:1:{r['stask'] + 1}:{r['sthread'] + 1}:"
             f"{r['lsend']}:{r['psend']}:"
             f"{cpu(r['rtask'], r['rthread'])}:1:{r['rtask'] + 1}:{r['rthread'] + 1}:"
             f"{r['lrecv']}:{r['precv']}:{r['size']}:{r['tag']}")
        )
    lines.sort(key=lambda x: x[0])
    return lines


def write_prv(trace: Trace, path: str | Path, *,
              segments: list[str | Path] | None = None) -> dict[str, Path]:
    """Write trace to <path>.prv/.pcf/.row; returns the three paths.

    ``segments`` are mid-run flush files produced by ``Tracer.flush`` (npz
    with states/events/comms arrays, timestamps already on the trace
    timebase).  They are merged with the final trace's records by timestamp.
    In the common case — segments' key ranges don't overlap, which holds
    whenever no record is retro-injected across a flush boundary — segments
    are written sequentially with only ONE segment's records in memory at a
    time (peak footprint = one flush window, not the whole run); overlapping
    segments fall back to a full k-way heap merge.  Resource-model metadata
    (task/thread/node structure, t_end, event types) always comes from
    ``trace``.
    """
    path = Path(path)
    base = path.with_suffix("") if path.suffix == ".prv" else path
    prv, pcf, row = base.with_suffix(".prv"), base.with_suffix(".pcf"), base.with_suffix(".row")

    offsets = _cpu_offsets(trace)
    # node cpu counts = sum of threads of tasks placed on each node
    node_cpus = [0] * trace.num_nodes
    for t in range(trace.num_tasks):
        node_cpus[trace.node_of_task[t]] += trace.threads_per_task[t]

    date = _time.strftime("%d/%m/%Y at %H:%M")
    nodes_str = f"{trace.num_nodes}({','.join(str(c) for c in node_cpus)})"
    appl_str = "{}({})".format(
        trace.num_tasks,
        ",".join(
            f"{trace.threads_per_task[t]}:{trace.node_of_task[t] + 1}"
            for t in range(trace.num_tasks)
        ),
    )
    header = f"#Paraver ({date}):{trace.t_end}:{nodes_str}:1:{appl_str}\n"

    final_lines = _record_lines(trace.states, trace.events, trace.comms, offsets)
    with open(prv, "w") as f:
        f.write(header)
        if segments:
            _write_merged(f, list(segments), final_lines, offsets)
        else:
            for _, s in final_lines:
                f.write(s)
                f.write("\n")

    _write_pcf(trace, pcf)
    _write_row(trace, row, offsets)
    return {"prv": prv, "pcf": pcf, "row": row}


def _segment_lines(seg_path, offsets) -> list[tuple[int, str]]:
    with np.load(seg_path) as z:
        return _record_lines(z["states"], z["events"], z["comms"], offsets)


def _segment_meta(seg_path) -> tuple[tuple[int, int] | None, int | None]:
    """(key range, owning task) of a flushed segment.  Single-stream flushes
    carry no task stamp (task None); per-task flushes (``split_tasks``) are
    stamped by ``Tracer.flush`` — the merge groups them into one chain per
    task, the mpi2prv per-rank-stream shape."""
    with np.load(seg_path) as z:
        task = int(z["task"]) if "task" in z.files else None
        if "key_range" in z.files:  # stamped by Tracer.flush
            lo, hi = z["key_range"]
            return (int(lo), int(hi)), task
        keys = [z[n][f] for n, f in (("states", "begin"), ("events", "time"),
                                     ("comms", "lsend")) if len(z[n])]
        if not keys:
            return None, task
        return (min(int(k.min()) for k in keys),
                max(int(k.max()) for k in keys)), task


def _chain_stream(chain, offsets):
    """Lazily yield one stream's sorted (key, line) pairs, loading ONE
    segment at a time.  Precondition: the chain's segments have pairwise
    ordered key ranges (checked by the caller)."""
    for seg, _rng in chain:
        yield from _segment_lines(seg, offsets)


def _write_merged(f, segments, final_lines, offsets):
    """mpi2prv-style k-way merge of flushed segment streams + the final
    trace's lines into ``f``.

    Segments are grouped into *chains* — one per task for per-task flushes
    (``Tracer.flush(split_tasks=True)``), a single chain for legacy
    whole-buffer flushes.  A chain whose segments' key ranges are pairwise
    ordered (the common case: no record is retro-injected across a flush
    boundary) streams lazily, ONE segment resident at a time; a disordered
    chain is pre-merged eagerly.  All chains + the final lines then merge
    through one k-way heap, so peak memory is ~one segment per task stream
    regardless of run length.
    """
    chains: dict[object, list] = {}
    for s in segments:
        rng, task = _segment_meta(s)
        if rng is None:
            continue
        chains.setdefault("legacy" if task is None else task, []).append((s, rng))
    streams = []
    for chain in chains.values():
        sequential = all(chain[i][1][1] <= chain[i + 1][1][0]
                         for i in range(len(chain) - 1))
        if sequential:
            streams.append(_chain_stream(chain, offsets))
        else:
            streams.append(heapq.merge(
                *(_segment_lines(seg, offsets) for seg, _ in chain),
                key=lambda x: x[0]))
    for _, line in heapq.merge(*streams, iter(final_lines),
                               key=lambda x: x[0]):
        f.write(line)
        f.write("\n")


def _write_pcf(trace: Trace, path: Path):
    out = [
        "DEFAULT_OPTIONS", "", "LEVEL               THREAD",
        "UNITS               NANOSEC", "LOOK_BACK           100",
        "SPEED               1", "FLAG_ICONS          ENABLED",
        "NUM_OF_STATE_COLORS 1000", "YMAX_SCALE          37", "",
        "DEFAULT_SEMANTIC", "", "THREAD_FUNC          State As Is", "",
        "STATES",
    ]
    for sid, label in sorted(ev.STATE_LABELS.items()):
        out.append(f"{sid}    {label}")
    out += ["", "STATES_COLOR"]
    for sid in sorted(ev.STATE_LABELS):
        r, g, b = _STATE_COLORS.get(sid, (128, 128, 128))
        out.append(f"{sid}    {{{r},{g},{b}}}")
    out.append("")
    for code in sorted(trace.event_types):
        et = trace.event_types[code]
        out += ["", "EVENT_TYPE", f"{et.gradient}    {code}    {et.desc}"]
        if et.values:
            out.append("VALUES")
            for v in sorted(et.values):
                out.append(f"{v}      {et.values[v]}")
    out.append("")
    path.write_text("\n".join(out))


def _write_row(trace: Trace, path: Path, offsets: list[int]):
    total_cpus = sum(trace.threads_per_task)
    out = [f"LEVEL CPU SIZE {total_cpus}"]
    for t in range(trace.num_tasks):
        for th in range(trace.threads_per_task[t]):
            out.append(f"{trace.node_of_task[t] + 1}.{offsets[t] + th + 1}")
    out.append(f"LEVEL NODE SIZE {trace.num_nodes}")
    out += [f"node{i + 1}" for i in range(trace.num_nodes)]
    out.append(f"LEVEL THREAD SIZE {total_cpus}")
    for t in range(trace.num_tasks):
        for th in range(trace.threads_per_task[t]):
            out.append(f"THREAD 1.{t + 1}.{th + 1}")
    path.write_text("\n".join(out) + "\n")


# ----------------------------------------------------------------------
# Parser (future-work item in the paper: reparse Paraver traces natively)
# ----------------------------------------------------------------------


def parse_prv(path: str | Path) -> Trace:
    path = Path(path)
    prv = path if path.suffix == ".prv" else path.with_suffix(".prv")
    with open(prv) as f:
        header = f.readline().rstrip("\n")
        body = f.read().splitlines()

    # header: #Paraver (date):ftime:nNodes(c1,c2):nAppl:nTasks(t:n,...)[,...]
    rest = header.split("):", 1)[1]
    ftime_s, rest = rest.split(":", 1)
    nodes_part, rest = rest.split(":", 1)
    nnodes = int(nodes_part.split("(", 1)[0])
    nappl_s, appl_part = rest.split(":", 1)
    tasks_part = appl_part.split("(", 1)
    ntasks = int(tasks_part[0])
    th_node = tasks_part[1].rstrip(")").split(",")
    threads_per_task, node_of_task = [], []
    for item in th_node[:ntasks]:
        th, node = item.split(":")
        threads_per_task.append(int(th))
        node_of_task.append(int(node) - 1)

    states, events, comms = [], [], []
    for line in body:
        if not line or line.startswith("#"):
            continue
        parts = line.split(":")
        kind = parts[0]
        if kind == "1":
            _, _cpu, _appl, task, thread, b, e, s = parts
            states.append((int(task) - 1, int(thread) - 1, int(b), int(e), int(s)))
        elif kind == "2":
            _, _cpu, _appl, task, thread, t = parts[:6]
            pairs = parts[6:]
            for i in range(0, len(pairs), 2):
                events.append(
                    (int(task) - 1, int(thread) - 1, int(t),
                     int(pairs[i]), int(pairs[i + 1]))
                )
        elif kind == "3":
            (_, _c1, _a1, st_, sth, ls, ps, _c2, _a2, rt, rth, lr, pr, size, tag) = parts
            comms.append(
                (int(st_) - 1, int(sth) - 1, int(rt) - 1, int(rth) - 1,
                 int(ls), int(ps), int(lr), int(pr), int(size), int(tag))
            )

    event_types = _parse_pcf(prv.with_suffix(".pcf"))
    trace = Trace(
        app_name=prv.stem,
        num_tasks=ntasks,
        threads_per_task=threads_per_task,
        node_of_task=node_of_task,
        states=np.array(states, STATE_DTYPE) if states else np.empty(0, STATE_DTYPE),
        events=np.array(events, EVENT_DTYPE) if events else np.empty(0, EVENT_DTYPE),
        comms=np.array(comms, COMM_DTYPE) if comms else np.empty(0, COMM_DTYPE),
        event_types=event_types,
        t_end=int(ftime_s),
    )
    return sort_trace(trace)


def _parse_pcf(path: Path) -> dict[int, EventType]:
    if not path.exists():
        return {}
    types: dict[int, EventType] = {}
    cur: EventType | None = None
    in_values = False
    for line in path.read_text().splitlines():
        stripped = line.strip()
        if stripped == "EVENT_TYPE":
            cur, in_values = None, False
            continue
        if stripped == "VALUES":
            in_values = True
            continue
        if not stripped or stripped.isupper() and " " not in stripped:
            if stripped == "":
                in_values = False
            continue
        if in_values and cur is not None:
            parts = stripped.split(None, 1)
            if parts[0].lstrip("-").isdigit():
                cur.values[int(parts[0])] = parts[1] if len(parts) > 1 else ""
            continue
        parts = stripped.split(None, 2)
        if len(parts) >= 3 and parts[0].isdigit() and parts[1].isdigit():
            cur = EventType(int(parts[1]), parts[2], {}, gradient=int(parts[0]))
            types[cur.code] = cur
    return types
