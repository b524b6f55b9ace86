"""repro_torch.core — the Extrae/Paraver-style tracer of the torch port
(copies of ``repro.core``'s tracer modules, jax-free), plus sampling.

    from repro_torch import core as xtrace
    tracer = xtrace.init("myapp")
    xtrace.register(84210, "Vector length")
    xtrace.emit(84210, n)
    trace = xtrace.finish()
    xtrace.write_prv(trace, "out/myapp")
"""
from repro_torch.core import events  # noqa: F401
from repro_torch.core.analysis import serve_latency_summary  # noqa: F401
from repro_torch.core.paraver import parse_prv, write_prv  # noqa: F401
from repro_torch.core.records import Trace  # noqa: F401
from repro_torch.core.tracer import (  # noqa: F401
    Tracer, emit, finish, get_tracer, init, register,
)
