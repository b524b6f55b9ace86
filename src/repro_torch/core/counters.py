"""Counter backends — the PAPI analogue (paper section 3).

Two sources, as in the JAX package:

  * :func:`rusage_counters` — host OS counters (RSS, user/sys time, faults);
  * :class:`StepCounters`   — deterministic per-step counters (FLOPs,
    bytes, collective bytes) emitted as Paraver counter events at each
    step boundary, the counters-per-region view Extrae gets from PAPI.
    The JAX package fills them from the compiled HLO's cost analysis;
    the port's caller passes the numbers.
"""
from __future__ import annotations

import resource

from repro_torch.core import events as ev


def rusage_counters() -> list[tuple[int, int]]:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return [
        (ev.EV_CTR_RSS, int(ru.ru_maxrss)),
        (ev.EV_CTR_UTIME, int(ru.ru_utime * 1e6)),
        (ev.EV_CTR_STIME, int(ru.ru_stime * 1e6)),
        (ev.EV_CTR_MINFLT, int(ru.ru_minflt)),
    ]


class StepCounters:
    """Per-step counter emission, configured once from a compiled artifact."""

    def __init__(self, flops_per_step: int = 0, bytes_per_step: int = 0,
                 coll_bytes_per_step: int = 0):
        self.flops = int(flops_per_step)
        self.bytes = int(bytes_per_step)
        self.coll = int(coll_bytes_per_step)

    def emit(self, tracer, *, include_rusage: bool = True):
        pairs = [
            (ev.EV_CTR_FLOPS, self.flops),
            (ev.EV_CTR_BYTES, self.bytes),
            (ev.EV_CTR_COLL_BYTES, self.coll),
        ]
        if include_rusage:
            pairs += rusage_counters()
        tracer.emit_many(pairs)
