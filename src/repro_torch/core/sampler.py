"""Statistical call-stack sampler (paper section 3: Extrae's sampler).

A background thread periodically snapshots the main thread's Python stack and
emits an EV_SAMPLE_FUNC event with the registered id of the innermost
application frame.  The period is jittered (uniform +-jitter) to avoid the
aliasing effects the paper calls out.  Overhead is one C-level
``sys._current_frames`` call per sample.
"""
from __future__ import annotations

import random
import sys
import threading
import time

from repro_torch.core import events as ev

_SKIP_FILES = ("sampler.py", "threading.py")


class StackSampler:
    def __init__(self, tracer, period_s: float = 0.001, jitter_s: float = 0.0002,
                 target_thread_ident: int | None = None):
        self.tracer = tracer
        self.period_s = period_s
        self.jitter_s = min(jitter_s, period_s * 0.9)
        self.target = target_thread_ident or threading.main_thread().ident
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._parked = threading.Event()
        self._interrupt = threading.Event()  # cuts the inter-sample sleep short
        self._thread: threading.Thread | None = None
        self.samples = 0

    def start(self):
        self._thread = threading.Thread(target=self._run, name="repro-sampler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._paused.clear()
        self._interrupt.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def pause(self):
        """Park the sampler thread (no emits) until :meth:`resume`.  Used by
        ``Tracer.flush`` so the buffer drain never races a sample append.
        The inter-sample sleep is interrupted, so the park acknowledgement
        arrives promptly regardless of ``period_s``."""
        if self._thread is None or not self._thread.is_alive():
            return
        self._paused.set()
        self._interrupt.set()
        self._parked.wait(timeout=2.0)

    def resume(self):
        self._parked.clear()
        self._paused.clear()

    def _run(self):
        rng = random.Random(0xE47)
        while not self._stop.is_set():
            delay = self.period_s + rng.uniform(-self.jitter_s, self.jitter_s)
            self._interrupt.wait(delay)
            self._interrupt.clear()
            if self._stop.is_set():
                break
            if self._paused.is_set():
                self._parked.set()
                while self._paused.is_set() and not self._stop.is_set():
                    time.sleep(0.0005)
                self._parked.clear()
                continue
            frame = sys._current_frames().get(self.target)
            if frame is None:
                continue
            # innermost application frame (skip sampler/threading internals)
            f = frame
            while f is not None and f.f_code.co_filename.endswith(_SKIP_FILES):
                f = f.f_back
            if f is None:
                continue
            name = f"{f.f_code.co_name} ({f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})"
            fid = self.tracer.sample_func_id(name)
            self.tracer.inject_event(
                self.tracer.pm.task_id(), 0, time.perf_counter_ns(),
                ev.EV_SAMPLE_FUNC, fid,
            )
            self.samples += 1
