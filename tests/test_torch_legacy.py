"""Torch port, grouped-prefill and fixed-batch engines on the CPU.

* ``DecoderLM.prefill`` / ``prefill_chunk`` caches and last logits, and
  the contiguous-cache ``decode_step``, against the JAX package's jitted
  functions on the same weights (float32, tolerance 1e-4);
* the legacy ``ContinuousServeEngine``'s greedy streams against a greedy
  full-recompute oracle built from the JAX ``forward``, and its host
  counters against the JAX ``ContinuousServeEngine`` on the same stream
  (no token comparison with the JAX engines: their tokens vary run to run
  on this jax CPU build, see ROADMAP.md Faults);
* legacy == unified == fixed-batch greedy, with and without a window;
* the legacy engine's trace ledger against the JAX engine's, each under
  its own package's tracer, and trace flushing merged into one ``.prv``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.engine import ContinuousServeEngine as JaxLegacyEngine  # noqa: E402
from repro_torch import core as xtrace  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine  # noqa: E402
from repro_torch.serve.step import UnifiedServeEngine  # noqa: E402
from test_torch_serve import _pressure_stream, _prompts, _setup  # noqa: E402

TOL = 1e-4  # float32, different op order (absolute; logits and K/V ~ O(1))
WINDOWS = [{}, {"attention_window": 6}]
WINDOW_IDS = ["full", "swa"]


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _jax_model(jcfg):
    from repro.models.model import build_model

    return build_model(jcfg)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _close(mine, theirs):
    np.testing.assert_allclose(mine.detach().float().numpy(), np.asarray(theirs),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("ring", [False, True], ids=["paged", "ring"])
@pytest.mark.parametrize("kw", WINDOWS, ids=WINDOW_IDS)
def test_prefill_matches_jax(kw, ring):
    jcfg, jparams, _, model, _ = _setup(**kw)
    jm = _jax_model(jcfg)
    toks = _tokens((2, 21))
    jc, jl = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, max_len=32,
                                             ring=ring))(jparams, jnp.asarray(toks))
    with torch.inference_mode():
        tc, tl = model.prefill(torch.from_numpy(toks), max_len=32, ring=ring)
    _close(tl, jl)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc["units"][name].shape
        _close(tc[name], jc["units"][name])


@pytest.mark.parametrize("kw", WINDOWS, ids=WINDOW_IDS)
def test_prefill_chunk_matches_jax(kw):
    """Tail prefill at q_offset 16 against the JAX prefix-hit path."""
    jcfg, jparams, _, model, _ = _setup(**kw)
    jm = _jax_model(jcfg)
    toks = _tokens((2, 29), seed=1)
    head, tail = toks[:, :16], toks[:, 16:]
    jpre, _ = jm.prefill(jparams, {"tokens": jnp.asarray(head)}, ring=False)
    jt, jl = jax.jit(lambda p, t, c: jm.prefill_chunk(p, {"tokens": t}, c,
                                                      start=16))(
        jparams, jnp.asarray(tail), jpre)
    with torch.inference_mode():
        pre, _ = model.prefill(torch.from_numpy(head), ring=False)
        tt, tl = model.prefill_chunk(torch.from_numpy(tail), pre, 16)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tt[name], jt["units"][name])


@pytest.mark.parametrize("per_row", [False, True], ids=["lockstep", "per-row"])
@pytest.mark.parametrize("kw", WINDOWS, ids=WINDOW_IDS)
def test_contiguous_decode_matches_jax(kw, per_row):
    """Full and ring caches: four decode steps at a scalar index (fixed
    batch) or per-row indices, logits and caches updated in place."""
    jcfg, jparams, _, model, _ = _setup(**kw)
    jm = _jax_model(jcfg)
    toks = _tokens((2, 9), seed=2)
    jc, jl = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=24)
    step = jax.jit(jm.decode_step)
    with torch.inference_mode():
        tc, _ = model.prefill(torch.from_numpy(toks), max_len=24)
        tok = np.argmax(np.asarray(jl)[:, :512], -1).astype(np.int32)
        for i in range(4):
            pos = np.int32(9 + i)
            idx = np.full((2,), pos, np.int32) if per_row else pos
            jc, jl = step(jparams, jc, jnp.asarray(tok), jnp.asarray(idx))
            tl = model.decode_step(tc, torch.from_numpy(tok),
                                   torch.tensor(idx))
            _close(tl, jl)
            tok = np.argmax(np.asarray(jl)[:, :512], -1).astype(np.int32)
    for name in ("k", "v"):
        _close(tc[name], jc["units"][name])


@pytest.mark.parametrize("kw", WINDOWS, ids=WINDOW_IDS)
def test_legacy_streams_match_full_recompute_oracle(kw):
    """Prompt lengths 7/16/21/30 cross block edges; two slots force
    queueing and slot reuse."""
    _, _, cfg, model, oracle = _setup(**kw)
    prompts = _prompts(cfg.vocab_size, [7, 16, 21, 30], seed=2)
    eng = ContinuousServeEngine(cfg, model, device="cpu", num_slots=2,
                                max_len=40, block_size=16)
    reqs = [eng.submit(p, 8) for p in prompts]
    out = eng.run()
    for p, r in zip(prompts, reqs):
        np.testing.assert_array_equal(out[r.rid], oracle(p, 8))
    st = eng.throughput_stats()
    assert st["kernel_dispatch"] == {"dense:torch": 4,
                                     "paged_decode:torch": st["decode_dispatches"]}
    assert st["prefills"] == 4 and st["host_syncs"] == 4 + st["decode_syncs"]
    assert st["decode_syncs"] == st["decode_dispatches"]
    assert st["prefill_seconds"] > 0


_PRESSURE = dict(num_slots=2, max_len=48, block_size=8, num_blocks=10)


def _legacy_counters(eng, prompts, gen=16):
    reqs = [eng.submit(p, gen) for p in prompts]
    out = eng.run()
    pool = eng.pool
    pool.check_invariants()  # FREE + ACTIVE + CACHED conservation
    counters = {k: eng.stats[k] for k in (
        "prefix_hit_tokens", "preemptions", "peak_blocks", "decode_dispatches",
        "prefills", "prefill_tokens", "tokens_decoded", "host_syncs",
        "iterations")}
    counters.update(kernel_dispatch=dict(eng.stats["kernel_dispatch"]),
                    free=pool.num_free(), cached=pool.num_cached(),
                    hits=pool.stats["hit_blocks"],
                    evictions=pool.stats["evictions"])
    return counters, [out[r.rid] for r in reqs]


def test_legacy_preemption_and_prefix_hits_match_oracle_and_jax_counters(setup):
    jcfg, jparams, cfg, model, oracle = setup
    prompts = _pressure_stream(cfg.vocab_size)
    mine, toks = _legacy_counters(
        ContinuousServeEngine(cfg, model, device="cpu", **_PRESSURE), prompts)
    theirs, _ = _legacy_counters(JaxLegacyEngine(jcfg, jparams, **_PRESSURE),
                                 prompts)
    theirs["kernel_dispatch"] = {k.replace(":xla", ":torch"): v for k, v in
                                 theirs["kernel_dispatch"].items()}
    assert mine["preemptions"] > 0 and mine["prefix_hit_tokens"] > 0
    assert mine == theirs
    for p, t in zip(prompts, toks):
        np.testing.assert_array_equal(t, oracle(p, 16))


@pytest.mark.parametrize("kw", WINDOWS, ids=WINDOW_IDS)
def test_legacy_unified_and_fixed_batch_agree(kw):
    """The paged engines' bit-exact contract, and the contiguous-cache
    fixed-batch oracle: one greedy stream per prompt from all three."""
    _, _, cfg, model, _ = _setup(**kw)
    prompts = _prompts(cfg.vocab_size, [7, 16, 21, 30], seed=4)
    streams = []
    for cls, extra in ((ContinuousServeEngine, {}),
                       (UnifiedServeEngine, {"chunk_size": 8})):
        eng = cls(cfg, model, device="cpu", num_slots=2, max_len=48,
                  block_size=16, **extra)
        reqs = [eng.submit(p, 12) for p in prompts]
        out = eng.run()
        streams.append([out[r.rid] for r in reqs])
    static = ServeEngine(cfg, model, device="cpu", max_len=48)
    streams.append([static.generate(p[None], num_tokens=12)[0] for p in prompts])
    assert static.host_syncs == 4 * 12
    for legacy, unified, fixed in zip(*streams):
        np.testing.assert_array_equal(legacy, unified)
        np.testing.assert_array_equal(legacy, fixed)


def test_serve_batch_and_fixed_batch_generate(setup):
    _, _, cfg, model, oracle = setup
    prompts = np.stack(_prompts(cfg.vocab_size, [11, 11, 11], seed=6))
    eng = ContinuousServeEngine(cfg, model, device="cpu", num_slots=2,
                                max_len=24)
    got = eng.serve_batch(prompts, num_tokens=6)
    static = ServeEngine(cfg, model, device="cpu", max_len=24)
    st = static.throughput_stats(prompts, num_tokens=6)
    assert st["tokens"] == 18 and st["host_syncs"] == 6
    np.testing.assert_array_equal(got, static.generate(prompts, num_tokens=6))
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, oracle(p, 6))


def _ledger(evs):
    keep = ~np.isin(evs["type"], [ev.EV_REQ_TTFT_US, ev.EV_REQ_TPOT_US])
    return np.stack([evs["type"][keep], evs["value"][keep]], 1)


def test_legacy_trace_ledger_matches_jax_engine(setup):
    """Each engine under its own package's tracer, on the same stream under
    pool pressure: the same event ledger value for value — admit/prefill/
    burst phases, block gauges, prefix hits, preemption and retirement
    order, kernel-variant ids — everything except wall-clock latencies."""
    from repro.core.tracer import Tracer as JaxTracer

    jcfg, jparams, cfg, model, _ = setup
    prompts = _pressure_stream(cfg.vocab_size)
    ledgers = []
    for tracer, make in (
            (xtrace.Tracer("ledger"), lambda tr: ContinuousServeEngine(
                cfg, model, device="cpu", tracer=tr, **_PRESSURE)),
            (JaxTracer("ledger"), lambda tr: JaxLegacyEngine(
                jcfg, jparams, tracer=tr, **_PRESSURE))):
        tracer.init()
        eng = make(tracer)
        for p in prompts:
            eng.submit(p, 16)
        eng.run()
        ledgers.append(_ledger(tracer.finish().events))
    mine, theirs = ledgers
    assert (mine[:, 0] == ev.EV_KERNEL_VARIANT).sum() > 4
    assert (mine[:, 0] == ev.EV_REQ_PREEMPT).sum() > 0
    np.testing.assert_array_equal(mine, theirs)


def test_legacy_flush_segments_merge_into_one_prv(setup, tmp_path):
    """flush_every streams record segments mid-run; write_prv merges them
    with the final records; the parsed .prv holds every retirement."""
    _, _, cfg, model, _ = setup
    prompts = _prompts(cfg.vocab_size, [7, 16, 21, 30], seed=2)
    tracer = xtrace.Tracer("flush").init()
    eng = ContinuousServeEngine(cfg, model, device="cpu", num_slots=2,
                                max_len=40, tracer=tracer, flush_every=2,
                                flush_base=tmp_path / "serve")
    for p in prompts:
        eng.submit(p, 8)
    eng.run()
    segments = list(tracer.segments)
    trace = tracer.finish()
    paths = xtrace.write_prv(trace, tmp_path / "serve", segments=segments)
    merged = xtrace.parse_prv(paths["prv"])
    assert len(segments) >= 2
    assert (merged.events["type"] == ev.EV_FLUSH).sum() == 2 * len(segments)
    lat = xtrace.serve_latency_summary(merged)
    assert lat["ttft_us"]["count"] == lat["tpot_us"]["count"] == 4
    with pytest.raises(ValueError, match="flush_base"):
        ContinuousServeEngine(cfg, model, device="cpu", num_slots=1,
                              max_len=40, flush_every=2)


def test_entry_points_default_to_cuda():
    cfg = reduced(get_config("granite-8b"), num_layers=1)
    if not torch.cuda.is_available():
        for make in (lambda: ContinuousServeEngine(cfg, num_slots=1, max_len=16),
                     lambda: ServeEngine(cfg, max_len=16)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    eng = ServeEngine(cfg, device="cpu", max_len=16)
    out = eng.generate(np.arange(10, dtype=np.int32).reshape(2, 5), num_tokens=3)
    assert out.shape == (2, 3)
