"""The tracer — Extrae.jl API surface (paper sections 3, 3.1), a copy of
``repro.core.tracer`` for the torch port.

API parity with the paper's listings:

  Listing 1:  ``tracer.init()`` / ``@tracer.user_function`` / ``tracer.finish()``
  Listing 2:  ``tracer.register(code, "Vector length")`` + ``tracer.emit(code, n)``
  Listing 3:  custom ``set_task_id_fn`` / ``set_num_tasks_fn`` (the JAX
              package's ``jax_process`` / ``mesh_data`` modes wait for the
              port's mesh)
  Listing 4:  explicit emit around task switches (works unchanged here)

Host-side records are captured live (ring-buffer appends, ~sub-µs);
``inject_event`` / ``inject_state`` / ``comm`` add records on other
(task, thread) endpoints.  The resource model is one node whose CPUs are
the visible CUDA devices (:func:`resource_model.from_torch_devices`).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np

from repro_torch.core import events as ev
from repro_torch.core.process_model import ProcessModel
from repro_torch.core.records import (
    COMM_DTYPE, EVENT_DTYPE, STATE_DTYPE, EventType, RecordBuffer, Trace,
    sort_trace,
)
from repro_torch.core import resource_model as rm


def _now() -> int:
    return time.perf_counter_ns()


class _ThreadBuffers:
    __slots__ = ("states", "events", "comms", "state_stack", "open_begin")

    def __init__(self):
        self.states = RecordBuffer(STATE_DTYPE)
        self.events = RecordBuffer(EVENT_DTYPE)
        self.comms = RecordBuffer(COMM_DTYPE)
        self.state_stack: list[int] = []
        self.open_begin: int | None = None


class Tracer:
    def __init__(self, app_name: str = "repro", mode: str = "single"):
        self.app_name = app_name
        self.pm = ProcessModel(mode)
        self._buffers: dict[int, _ThreadBuffers] = {}
        self._lock = threading.Lock()
        self._event_types: dict[int, EventType] = {}
        self._user_funcs: dict[str, int] = {}
        self._sample_funcs: dict[str, int] = {}
        self.t0: int | None = None
        self.t_end: int | None = None
        self._active = False
        self._sampler = None
        self._extra_tasks: set[int] = set()
        self._extra_threads: dict[int, int] = {}  # task -> max thread id seen
        self.segments: list[Path] = []  # streamed-out record segments
        self._register_builtin_types()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def init(self, mode: str | None = None, *, t0_ns: int | None = None):
        """``t0_ns`` pins the timebase origin (deterministic replay/tests);
        default is the current monotonic clock."""
        if mode is not None:
            self.pm.set_mode(mode)
        self.t0 = _now() if t0_ns is None else int(t0_ns)
        self._active = True
        self._open_state(ev.STATE_RUNNING)
        # anchor the base state exactly at t0 so states partition the
        # timeline with no startup gap (property-tested invariant)
        self._tb().open_begin = self.t0
        return self

    def finish(self, *, t_end_ns: int | None = None) -> Trace:
        if not self._active:
            raise RuntimeError("tracer not active")
        if self._sampler is not None:
            self._sampler.stop()
            self._sampler = None
        self.t_end = _now() if t_end_ns is None else int(t_end_ns)
        self._active = False
        return self._build_trace()

    def flush(self, base: str | Path, *, emit_marker: bool = True,
              split_tasks: bool = False) -> Path | list[Path] | None:
        """Segment full :class:`RecordBuffer`s to disk mid-run.

        Drains every completed record into ``<base>.seg####.npz`` (timestamps
        already normalized to the trace timebase) and resets the buffers, so a
        long-running serve loop never holds the whole trace in RAM.  Per the
        paper's Extrae discipline the I/O window is bracketed by ``EV_FLUSH``
        (begin lands in the drained segment, end opens the next one); pass
        ``emit_marker=False`` for marker-free segmentation (exact equivalence
        with an unflushed run).  The currently-open state intervals are NOT
        drained — they complete in a later segment or at ``finish()``.

        ``split_tasks=True`` writes one segment file PER TASK present in the
        drained window — ``<base>.task####.seg####.npz`` — the analogue of
        Extrae's per-rank ``.mpit`` intermediate files.  Communication
        records are owned by their *send* endpoint.  ``write_prv`` merges
        the per-task streams mpi2prv-style (k-way, one segment per stream
        resident at a time).

        Single-drainer discipline: call between loop iterations from the
        thread driving the run.  The built-in stack sampler is paused for the
        duration of the drain; any OTHER thread emitting concurrently must be
        quiesced by the caller — a record appended while its buffer is being
        drained can be lost.  Returns the segment path(s), or None if every
        buffer was empty.
        """
        if not self._active:
            raise RuntimeError("tracer not active")
        if emit_marker:
            self.emit(ev.EV_FLUSH, 1)
        sampler = self._sampler
        if sampler is not None:
            sampler.pause()
        try:
            with self._lock:
                buffers = list(self._buffers.items())
            states = [tb.states.take() for _, tb in buffers]
            events = [tb.events.take() for _, tb in buffers]
            comms = [tb.comms.take() for _, tb in buffers]
        finally:
            if sampler is not None:
                sampler.resume()
        st = np.concatenate(states) if states else np.empty(0, STATE_DTYPE)
        evs = np.concatenate(events) if events else np.empty(0, EVENT_DTYPE)
        cm = np.concatenate(comms) if comms else np.empty(0, COMM_DTYPE)
        if not (len(st) or len(evs) or len(cm)):
            return None
        for arr, fields in ((st, ("begin", "end")), (evs, ("time",)),
                            (cm, ("lsend", "psend", "lrecv", "precv"))):
            for f in fields:
                arr[f] -= self.t0
        if not split_tasks:
            out = self._write_segment(base, st, evs, cm)
        else:
            tasks = sorted(set(st["task"]) | set(evs["task"]) | set(cm["stask"]))
            out = [p for t in tasks
                   if (p := self._write_segment(
                       base, st[st["task"] == t], evs[evs["task"] == t],
                       cm[cm["stask"] == t], task=int(t))) is not None]
        if emit_marker:
            self.emit(ev.EV_FLUSH, 0)
        return out

    def _write_segment(self, base, st, evs, cm, *, task: int | None = None):
        if not (len(st) or len(evs) or len(cm)):
            return None
        keys = [a[f] for a, f in ((st, "begin"), (evs, "time"), (cm, "lsend"))
                if len(a)]
        key_range = np.array([min(int(k.min()) for k in keys),
                              max(int(k.max()) for k in keys)], np.int64)
        stem = f"{base}.seg{len(self.segments):04d}.npz" if task is None \
            else f"{base}.task{task:04d}.seg{len(self.segments):04d}.npz"
        seg = Path(stem)
        seg.parent.mkdir(parents=True, exist_ok=True)
        extra = {} if task is None else {"task": np.int64(task)}
        np.savez(seg, states=st, events=evs, comms=cm, key_range=key_range,
                 **extra)
        self.segments.append(seg)
        return seg

    @property
    def active(self) -> bool:
        return self._active

    # ------------------------------------------------------------------
    # identity customization (Extrae.jl set_taskid_function! parity)
    # ------------------------------------------------------------------
    def set_task_id_fn(self, fn: Callable[[], int]):
        self.pm.set_task_id_fn(fn)

    def set_num_tasks_fn(self, fn: Callable[[], int]):
        self.pm.set_num_tasks_fn(fn)

    def set_thread_id_fn(self, fn: Callable[[], int]):
        self.pm.set_thread_id_fn(fn)

    # ------------------------------------------------------------------
    # event registration / emission (Listing 2 parity)
    # ------------------------------------------------------------------
    def register(self, code: int, desc: str, values: dict[int, str] | None = None):
        et = self._event_types.get(code)
        if et is None:
            self._event_types[code] = EventType(code, desc, dict(values or {}))
        else:
            et.desc = desc
            if values:
                et.values.update(values)

    def emit(self, code: int, value: int, *, time_ns: int | None = None):
        if not self._active:
            return
        tb = self._tb()
        tb.events.append(
            (self.pm.task_id(), self.pm.thread_id(),
             time_ns if time_ns is not None else _now(), code, int(value))
        )

    def emit_many(self, pairs, *, time_ns: int | None = None):
        t = time_ns if time_ns is not None else _now()
        for code, value in pairs:
            self.emit(code, value, time_ns=t)

    # ------------------------------------------------------------------
    # states
    # ------------------------------------------------------------------
    def _tb(self) -> _ThreadBuffers:
        tid = self.pm.thread_id()
        tb = self._buffers.get(tid)
        if tb is None:
            with self._lock:
                tb = self._buffers.setdefault(tid, _ThreadBuffers())
        return tb

    def _open_state(self, state: int):
        tb = self._tb()
        now = _now()
        if tb.open_begin is not None and tb.state_stack:
            tb.states.append(
                (self.pm.task_id(), self.pm.thread_id(), tb.open_begin, now,
                 tb.state_stack[-1])
            )
        tb.state_stack.append(state)
        tb.open_begin = now

    def _close_state(self):
        tb = self._tb()
        now = _now()
        if tb.state_stack:
            tb.states.append(
                (self.pm.task_id(), self.pm.thread_id(), tb.open_begin, now,
                 tb.state_stack.pop())
            )
        tb.open_begin = now if tb.state_stack else None

    @contextlib.contextmanager
    def state(self, state_id: int):
        """Push a Paraver state for the duration of the block (stacked:
        the outer state resumes afterwards)."""
        self._open_state(state_id)
        try:
            yield
        finally:
            self._close_state()

    @contextlib.contextmanager
    def phase(self, phase_id: int, step: int | None = None):
        """Trainer phase events (EV_PHASE) + optional step-number event."""
        self.emit(ev.EV_PHASE, phase_id)
        if step is not None:
            self.emit(ev.EV_STEP_NUMBER, step)
        try:
            yield
        finally:
            self.emit(ev.EV_PHASE, ev.PHASE_END)

    # ------------------------------------------------------------------
    # user functions (Listing 1 parity)
    # ------------------------------------------------------------------
    def _func_id(self, name: str) -> int:
        fid = self._user_funcs.get(name)
        if fid is None:
            fid = len(self._user_funcs) + 1
            self._user_funcs[name] = fid
            self._event_types[ev.EV_USER_FUNC].values[fid] = name
        return fid

    def user_function(self, fn=None, *, name: str | None = None):
        """Decorator or context manager bracketing a user-code region."""
        if fn is None:
            return self._user_function_ctx(name or "region")
        fid = self._func_id(name or getattr(fn, "__name__", "fn"))

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            self.emit(ev.EV_USER_FUNC, fid)
            try:
                return fn(*a, **kw)
            finally:
                self.emit(ev.EV_USER_FUNC, 0)

        return wrapper

    @contextlib.contextmanager
    def _user_function_ctx(self, name: str):
        fid = self._func_id(name)
        self.emit(ev.EV_USER_FUNC, fid)
        try:
            yield
        finally:
            self.emit(ev.EV_USER_FUNC, 0)

    # ------------------------------------------------------------------
    # communications
    # ------------------------------------------------------------------
    def comm(self, *, src: tuple[int, int], dst: tuple[int, int],
             send_ns: int, recv_ns: int, size: int, tag: int = 0,
             logical_send_ns: int | None = None, logical_recv_ns: int | None = None):
        tb = self._tb()
        tb.comms.append(
            (src[0], src[1], dst[0], dst[1],
             logical_send_ns if logical_send_ns is not None else send_ns, send_ns,
             logical_recv_ns if logical_recv_ns is not None else recv_ns, recv_ns,
             int(size), int(tag))
        )
        self._note_endpoint(*src)
        self._note_endpoint(*dst)

    # ------------------------------------------------------------------
    # record injection (device-side replay; synthetic ranks)
    # ------------------------------------------------------------------
    def _note_endpoint(self, task: int, thread: int):
        self._extra_tasks.add(task)
        if thread > self._extra_threads.get(task, 0):
            self._extra_threads[task] = thread

    def inject_event(self, task: int, thread: int, time_ns: int, code: int, value: int):
        self._tb().events.append((task, thread, time_ns, code, int(value)))
        self._note_endpoint(task, thread)

    def inject_state(self, task: int, thread: int, begin_ns: int, end_ns: int, state: int):
        self._tb().states.append((task, thread, begin_ns, end_ns, state))
        self._note_endpoint(task, thread)

    # ------------------------------------------------------------------
    # sampler
    # ------------------------------------------------------------------
    def start_sampler(self, period_s: float = 0.001, jitter_s: float = 0.0002):
        from repro_torch.core.sampler import StackSampler

        if self._sampler is not None:
            return self._sampler
        self._sampler = StackSampler(self, period_s=period_s, jitter_s=jitter_s)
        self._sampler.start()
        return self._sampler

    def sample_func_id(self, name: str) -> int:
        fid = self._sample_funcs.get(name)
        if fid is None:
            fid = len(self._sample_funcs) + 1
            self._sample_funcs[name] = fid
            self._event_types[ev.EV_SAMPLE_FUNC].values[fid] = name
        return fid

    # ------------------------------------------------------------------
    # trace assembly
    # ------------------------------------------------------------------
    def _register_builtin_types(self):
        self.register(ev.EV_PHASE, "Trainer phase", dict(ev.PHASE_LABELS))
        self.register(ev.EV_STEP_NUMBER, "Global step")
        self.register(ev.EV_FLUSH, "Trace flushing")
        self.register(ev.EV_COLLECTIVE, "XLA collective", dict(ev.COLL_LABELS))
        for code, desc in ev.CTR_LABELS.items():
            self.register(code, desc)
        self.register(ev.EV_SAMPLE_FUNC, "Sampled function", {0: "End"})
        self.register(ev.EV_USER_FUNC, "User function", {0: "End"})

    def _build_trace(self) -> Trace:
        states, events, comms = [], [], []
        for tid, tb in sorted(self._buffers.items()):
            # close any dangling open state at finish time
            if tb.open_begin is not None and tb.state_stack:
                while tb.state_stack:
                    tb.states.append(
                        (self.pm.task_id(), tid, tb.open_begin, self.t_end,
                         tb.state_stack.pop())
                    )
            states.append(tb.states.view())
            events.append(tb.events.view())
            comms.append(tb.comms.view())
        st = np.concatenate(states) if states else np.empty(0, STATE_DTYPE)
        evs = np.concatenate(events) if events else np.empty(0, EVENT_DTYPE)
        cm = np.concatenate(comms) if comms else np.empty(0, COMM_DTYPE)

        # normalize the timebase to t0
        for arr, fields in ((st, ("begin", "end")), (evs, ("time",)),
                            (cm, ("lsend", "psend", "lrecv", "precv"))):
            for f in fields:
                arr[f] -= self.t0

        ntasks = max(self.pm.num_tasks(), max(self._extra_tasks, default=0) + 1,
                     int(st["task"].max()) + 1 if len(st) else 1,
                     int(evs["task"].max()) + 1 if len(evs) else 1)
        nthreads_local = self.pm.num_threads_seen()
        host_threads = self.pm.host_threads()
        threads_per_task = []
        for t in range(ntasks):
            extra = self._extra_threads.get(t, 0) + 1
            n = max(nthreads_local if t == self.pm.task_id() else 1, extra)
            if host_threads is not None:
                # host x device fleets likewise: every host task (router +
                # each replica) gets its declared device-thread rows
                n = max(n, host_threads)
            threads_per_task.append(n)

        res = rm.from_torch_devices()
        if ntasks > res.num_nodes * 64:
            res = rm.ResourceModel(num_nodes=max(ntasks // 4, 1), cpus_per_node=[4] * max(ntasks // 4, 1))
        trace = Trace(
            app_name=self.app_name,
            num_tasks=ntasks,
            threads_per_task=threads_per_task,
            node_of_task=rm.node_of_task(res, ntasks),
            states=st, events=evs, comms=cm,
            event_types={k: v for k, v in self._event_types.items()},
            t_end=max(self.t_end - self.t0, 1),
        )
        return sort_trace(trace)


# ----------------------------------------------------------------------
# module-level singleton (Extrae.init() style)
# ----------------------------------------------------------------------
_GLOBAL: Tracer | None = None


def get_tracer() -> Tracer | None:
    return _GLOBAL


def init(app_name: str = "repro", mode: str = "single") -> Tracer:
    global _GLOBAL
    _GLOBAL = Tracer(app_name, mode).init()
    return _GLOBAL


def finish() -> Trace:
    global _GLOBAL
    if _GLOBAL is None:
        raise RuntimeError("Tracer.init() was never called")
    trace = _GLOBAL.finish()
    _GLOBAL = None
    return trace


def emit(code: int, value: int):
    if _GLOBAL is not None:
        _GLOBAL.emit(code, value)


def register(code: int, desc: str, values: dict[int, str] | None = None):
    if _GLOBAL is not None:
        _GLOBAL.register(code, desc, values)
