"""Torch port, tracer: the port's copy of the Extrae-style tracer
(``repro_torch.core``) against the JAX package's (``repro.core``), given
the same calls at explicit times.  The written ``.prv`` matches byte for
byte except the header's date, the ``.pcf`` and ``.row`` are identical,
flushing plus merging is identical, ``parse_prv`` round-trips, and
``serve_latency_summary`` agrees."""
from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import analysis as jax_analysis  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import paraver as jax_paraver  # noqa: E402
from repro.core.tracer import Tracer as JaxTracer  # noqa: E402
from repro_torch import core as xtrace  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core.process_model import ProcessModel  # noqa: E402
from repro_torch.core.tracer import Tracer  # noqa: E402

T0 = 1_000_000_000


def _script(tr, flush_base=None):
    """One deterministic run: registrations, events on the host thread,
    injected events/states on other (task, thread) endpoints, a comm, and
    optionally a mid-run flush (marker-free: markers carry wall time)."""
    tr.init(t0_ns=T0)
    tr.register(84_210, "Vector length", {1: "one", 2: "two"})
    tr.register(ev.EV_REQ_TTFT_US, ev.SERVE_CTR_LABELS[ev.EV_REQ_TTFT_US])
    tr.register(ev.EV_REQ_TPOT_US, ev.SERVE_CTR_LABELS[ev.EV_REQ_TPOT_US])
    segments = []
    for i in range(12):
        t = T0 + 1_000 * (i + 1)
        tr.emit(84_210, i % 3, time_ns=t)
        tr.emit(ev.EV_REQ_TTFT_US, 100 + 17 * i, time_ns=t + 1)
        tr.emit(ev.EV_REQ_TPOT_US, 40 + (i * 7) % 11, time_ns=t + 2)
        tr.inject_event(1, 2, t + 3, ev.EV_QUEUE_DEPTH, i)
        tr.inject_state(1, 0, t, t + 500, ev.STATE_RUNNING)
        if flush_base is not None and i in (3, 7):
            segments.append(tr.flush(flush_base, emit_marker=False))
    tr.comm(src=(0, 0), dst=(1, 1), send_ns=T0 + 2_000, recv_ns=T0 + 5_000,
            size=4096, tag=7)
    return tr.finish(t_end_ns=T0 + 20_000), segments


def _write_both(tmp_path, flush=False):
    out = {}
    for name, tr, write in (
            ("port", Tracer("app"), xtrace.write_prv),
            ("jax", JaxTracer("app"), jax_paraver.write_prv)):
        base = tmp_path / name / "trace"
        base.parent.mkdir(parents=True)
        trace, segments = _script(tr, base if flush else None)
        out[name] = (trace, write(trace, base, segments=segments))
    return out


def _body(path):
    """The file without the header's date: "#Paraver (<date>):<rest>"."""
    lines = path.read_text().splitlines()
    return lines[0].split(")", 1)[1], lines[1:]


@pytest.mark.parametrize("flush", [False, True], ids=["in-memory", "flushed"])
def test_prv_pcf_row_match_jax_tracer(tmp_path, flush):
    out = _write_both(tmp_path, flush=flush)
    (_, mine), (_, theirs) = out["port"], out["jax"]
    assert _body(mine["prv"]) == _body(theirs["prv"])
    assert len(_body(mine["prv"])[1]) > 50
    for ext in ("pcf", "row"):
        assert mine[ext].read_bytes() == theirs[ext].read_bytes()


def test_flushed_trace_equals_unflushed(tmp_path):
    flushed = _write_both(tmp_path / "a", flush=True)["port"][1]
    whole = _write_both(tmp_path / "b", flush=False)["port"][1]
    assert _body(flushed["prv"]) == _body(whole["prv"])


def test_parse_prv_round_trips_and_matches_jax(tmp_path):
    out = _write_both(tmp_path, flush=True)
    trace, paths = out["port"]
    mine = xtrace.parse_prv(paths["prv"])
    theirs = jax_paraver.parse_prv(out["jax"][1]["prv"])
    for field in ("states", "events", "comms"):
        np.testing.assert_array_equal(getattr(mine, field), getattr(theirs, field))
    assert (mine.num_tasks, mine.threads_per_task, mine.t_end) == \
        (theirs.num_tasks, theirs.threads_per_task, theirs.t_end)
    assert {c: e.desc for c, e in mine.event_types.items()} == \
        {c: e.desc for c, e in theirs.event_types.items()}
    again = xtrace.write_prv(mine, tmp_path / "again")
    assert _body(again["prv"]) == _body(paths["prv"])


def test_serve_latency_summary_matches_jax(tmp_path):
    out = _write_both(tmp_path)
    mine = xtrace.serve_latency_summary(xtrace.parse_prv(out["port"][1]["prv"]))
    theirs = jax_analysis.serve_latency_summary(
        jax_paraver.parse_prv(out["jax"][1]["prv"]))
    assert mine["ttft_us"]["count"] == 12
    assert mine == theirs


def test_event_ids_and_labels_match_jax():
    assert ev.SERVE_CTR_LABELS == jev.SERVE_CTR_LABELS
    assert ev.KERNEL_EVENT_LABELS == jev.KERNEL_EVENT_LABELS
    assert (ev.EV_FLUSH, ev.EV_USER_FUNC, ev.EV_PHASE) == \
        (jev.EV_FLUSH, jev.EV_USER_FUNC, jev.EV_PHASE)


@pytest.mark.parametrize("mode", ["jax_process", "mesh_data"])
def test_mesh_modes_wait_for_the_port_mesh(mode):
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        ProcessModel(mode)


def test_global_facade(tmp_path):
    tr = xtrace.init("facade")
    xtrace.register(84_211, "Things")
    with tr.user_function(name="work"):
        xtrace.emit(84_211, 5)
    trace = xtrace.finish()
    assert xtrace.get_tracer() is None
    paths = xtrace.write_prv(trace, tmp_path / "facade")
    parsed = xtrace.parse_prv(paths["prv"])
    assert 5 in parsed.events["value"][parsed.events["type"] == 84_211]
    assert parsed.event_types[ev.EV_USER_FUNC].values[1] == "work"
