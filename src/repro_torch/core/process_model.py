"""Paraver process model: WORKLOAD > APPLICATION > TASK > THREAD.

The paper's key design point: the process model is *virtual* and orthogonal
to the physical resource model, and the TASK/THREAD identity functions are
user-replaceable (``set_taskid_function!`` / ``set_threadid_function!`` in
Extrae.jl).  Mapping policies provided here:

  * "single"          — one task, threads = host threads (the default);
  * "jax_process" / "mesh_data" — the JAX package's multi-host and mesh
                        mappings; the port has no process mesh yet, so they
                        raise (ROADMAP item 3: tensor parallelism);
  * "host_device"     — host x device: TASK = a host-level process in a
                        multi-process serving fleet (the router is task 0,
                        engine replica r contributes its mesh-task extent at
                        base offset 1 + r * tasks_per_host), THREAD = the
                        device coordinate within that host.  Configured via
                        :meth:`ProcessModel.bind_host`; this is how N replica
                        subprocesses and the router merge into ONE .prv with
                        distinct rows per process (serve/router.py);
  * custom            — any callables via set_task_id_fn / set_num_tasks_fn.
"""
from __future__ import annotations

import threading
from typing import Callable


class ProcessModel:
    def __init__(self, mode: str = "single"):
        self._local = threading.local()
        self._thread_counter = 0
        self._lock = threading.Lock()
        self._task_id_fn: Callable[[], int] | None = None
        self._num_tasks_fn: Callable[[], int] | None = None
        self._thread_id_fn: Callable[[], int] | None = None
        self.set_mode(mode)

    # ---- identity-function customization (Extrae.jl API parity) ----
    def set_task_id_fn(self, fn: Callable[[], int]):
        self._task_id_fn = fn

    def set_num_tasks_fn(self, fn: Callable[[], int]):
        self._num_tasks_fn = fn

    def set_thread_id_fn(self, fn: Callable[[], int]):
        self._thread_id_fn = fn

    def set_mode(self, mode: str):
        self.mode = mode
        if mode == "single":
            self._task_id_fn = lambda: 0
            self._num_tasks_fn = lambda: 1
        elif mode in ("jax_process", "mesh_data"):
            raise NotImplementedError(
                f"process-model mode {mode!r} maps a multi-host or mesh "
                f"program; the torch port has no mesh yet (ROADMAP item 3)")
        elif mode == "host_device":
            # configured later via bind_host()
            self._task_id_fn = lambda: 0
            self._num_tasks_fn = lambda: 1
        else:
            raise ValueError(f"unknown process-model mode {mode!r}")

    def bind_host(self, host_task: int, num_tasks: int, *,
                  threads_per_task: int = 1):
        """host_device mode: pin THIS process's TASK id and the fleet-wide
        task extent.  The router binds ``host_task=0``; replica r (one
        local mesh task per replica at serve scale) binds
        ``host_task=1 + r``.  A replica that itself spans a mesh offsets
        its mesh-task coordinate by ``host_task`` instead via
        ``set_task_id_fn`` — the header/row structure only needs the total
        ``num_tasks`` and per-task thread extent declared here."""
        if self.mode != "host_device":
            raise ValueError("bind_host requires mode='host_device'")
        if not (0 <= host_task < num_tasks):
            raise ValueError(
                f"host_task {host_task} outside [0, {num_tasks})")
        self.host_task = int(host_task)
        self.host_num_tasks = int(num_tasks)
        self.host_threads_per_task = max(1, int(threads_per_task))
        self._task_id_fn = lambda: self.host_task
        self._num_tasks_fn = lambda: self.host_num_tasks

    def host_threads(self) -> int | None:
        """Declared device-thread extent per host task (host_device mode),
        or None elsewhere — the trace builder uses this so every fleet task
        gets its full thread rows even when only some threads produced
        records."""
        if self.mode != "host_device" or not hasattr(self, "host_task"):
            return None
        return self.host_threads_per_task

    # ---- queries ----
    def task_id(self) -> int:
        return int(self._task_id_fn())

    def num_tasks(self) -> int:
        return int(self._num_tasks_fn())

    def thread_id(self) -> int:
        """Stable small integer per host thread (auto-assigned on first use),
        unless a custom thread_id_fn was installed."""
        if self._thread_id_fn is not None:
            return int(self._thread_id_fn())
        tid = getattr(self._local, "tid", None)
        if tid is None:
            with self._lock:
                tid = self._thread_counter
                self._thread_counter += 1
            self._local.tid = tid
        return tid

    def num_threads_seen(self) -> int:
        return max(self._thread_counter, 1)
