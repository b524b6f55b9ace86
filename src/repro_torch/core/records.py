"""Trace record model + growable numpy record buffers.

Paraver's three record types (paper section 3):

  * STATE          — a time interval [begin, end) in a given state on one
                     (task, thread);
  * EVENT          — a punctual 2-tuple (type, value) at one time point;
  * COMMUNICATION  — a message between two (task, thread) endpoints with
                     logical/physical send/recv times, size and tag.

Buffers are preallocated numpy arrays grown geometrically; appending is a
couple of array stores, which is what keeps ``emit()`` cheap (the paper's
low-overhead claim — measured in benchmarks/bench_tracer_overhead.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

STATE_DTYPE = np.dtype(
    [("task", np.int32), ("thread", np.int32),
     ("begin", np.int64), ("end", np.int64), ("state", np.int32)]
)
EVENT_DTYPE = np.dtype(
    [("task", np.int32), ("thread", np.int32),
     ("time", np.int64), ("type", np.int64), ("value", np.int64)]
)
COMM_DTYPE = np.dtype(
    [("stask", np.int32), ("sthread", np.int32),
     ("rtask", np.int32), ("rthread", np.int32),
     ("lsend", np.int64), ("psend", np.int64),
     ("lrecv", np.int64), ("precv", np.int64),
     ("size", np.int64), ("tag", np.int64)]
)


class RecordBuffer:
    """Append-only growable structured-array buffer."""

    def __init__(self, dtype: np.dtype, capacity: int = 4096):
        self._arr = np.empty(capacity, dtype)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def _grow(self):
        new = np.empty(len(self._arr) * 2, self._arr.dtype)
        new[: self._n] = self._arr[: self._n]
        self._arr = new

    def append(self, rec: tuple):
        if self._n == len(self._arr):
            self._grow()
        self._arr[self._n] = rec
        self._n += 1

    def extend(self, recs: np.ndarray):
        need = self._n + len(recs)
        while need > len(self._arr):
            self._grow()
        self._arr[self._n: need] = recs
        self._n = need

    def view(self) -> np.ndarray:
        return self._arr[: self._n]

    def take(self) -> np.ndarray:
        """Copy out all completed records and reset the buffer (capacity is
        kept).  Single-drainer discipline: call from the thread that owns the
        buffer, or between iterations when no appender is running."""
        n = self._n
        out = self._arr[:n].copy()
        self._n = 0
        return out


@dataclasses.dataclass
class EventType:
    code: int
    desc: str
    values: dict[int, str] = dataclasses.field(default_factory=dict)
    gradient: int = 9  # paraver .pcf GRADIENT_COLOR id


@dataclasses.dataclass
class Trace:
    """In-memory trace — the unit the Paraver writer/parser and every
    analysis consume."""

    app_name: str
    num_tasks: int
    threads_per_task: list[int]
    node_of_task: list[int]  # resource model: which NODE runs each TASK
    states: np.ndarray  # STATE_DTYPE, sorted by begin
    events: np.ndarray  # EVENT_DTYPE, sorted by time
    comms: np.ndarray  # COMM_DTYPE
    event_types: dict[int, EventType]
    t_end: int  # trace duration (ns, relative timebase)

    @property
    def num_nodes(self) -> int:
        return (max(self.node_of_task) + 1) if self.node_of_task else 1

    def summary(self) -> str:
        return (
            f"Trace({self.app_name!r}: tasks={self.num_tasks}, "
            f"nodes={self.num_nodes}, states={len(self.states)}, "
            f"events={len(self.events)}, comms={len(self.comms)}, "
            f"span={self.t_end / 1e6:.3f} ms)"
        )


def sort_trace(trace: Trace) -> Trace:
    if len(trace.states):
        trace.states = np.sort(trace.states, order=["begin", "task", "thread"])
    if len(trace.events):
        trace.events = np.sort(trace.events, order=["time", "task", "thread", "type"])
    if len(trace.comms):
        trace.comms = np.sort(trace.comms, order=["lsend", "stask"])
    return trace
