"""Torch port, unified serve engine on the CPU: greedy streams against a
greedy full-recompute oracle built from the JAX package's ``forward`` (the
JAX engines' token output is not a stable oracle on this jax CPU build —
see ROADMAP.md Faults), host counters and the trace ledger (each engine
under its own package's tracer) against the JAX ``UnifiedServeEngine`` on
the same request stream, and the CLI in every ported mode."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serve.step import UnifiedServeEngine as JaxUnifiedEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.step import UnifiedServeEngine  # noqa: E402

ORACLE_LEN = 64  # fixed forward length: causal logits ignore right padding


_SETUPS = {}


def _setup(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _SETUPS:
        _SETUPS[key] = _build_setup(**kw)
    return _SETUPS[key]


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _build_setup(**kw):
    jcfg = jax_reduced(jax_get_config("granite-8b"), num_layers=2, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("granite-8b"), num_layers=2, **kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    fwd = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t})[0])

    def oracle(prompt, n):
        """Greedy full recompute: re-run the whole context every token."""
        ctx = list(prompt)
        for _ in range(n):
            buf = np.zeros((1, ORACLE_LEN), np.int32)
            buf[0, :len(ctx)] = ctx
            logits = np.asarray(fwd(jparams, jnp.asarray(buf)))
            ctx.append(int(np.argmax(logits[0, len(ctx) - 1, :cfg.vocab_size])))
        return np.asarray(ctx[len(prompt):], np.int32)

    return jcfg, jparams, cfg, model, oracle


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("kw", [{}, {"attention_window": 6}],
                         ids=["full", "swa"])
def test_greedy_streams_match_full_recompute_oracle(kw):
    """Prompt lengths 7/16/21/30 with chunk_size 8 cross chunk AND block
    edges; two slots force queueing and slot reuse."""
    _, _, cfg, model, oracle = _setup(**kw)
    prompts = _prompts(cfg.vocab_size, [7, 16, 21, 30], seed=2)
    eng = UnifiedServeEngine(cfg, model, device="cpu", num_slots=2,
                             max_len=40, block_size=16, chunk_size=8)
    reqs = [eng.submit(p, 8) for p in prompts]
    out = eng.run()
    for p, r in zip(prompts, reqs):
        np.testing.assert_array_equal(out[r.rid], oracle(p, 8))
    st = eng.throughput_stats()
    assert st["kernel_dispatch"]["paged_decode:torch"] > 0
    assert st["kernel_dispatch"]["paged_span:torch"] > 0
    assert st["decode_syncs"] == st["decode_dispatches"]


def _pressure_stream(vocab):
    """Two pairs sharing block-aligned prefixes, submitted head-first so
    the second of each pair finds its prefix registered; a tight pool
    forces preemption and recompute resume."""
    a, x = _prompts(vocab, [20, 30], seed=5)
    b, y = _prompts(vocab, [5, 3], seed=6)
    return [a, x, np.concatenate([a[:16], b]), np.concatenate([x[:24], y])]


def _run_counters(eng, prompts):
    reqs = [eng.submit(p, 8) for p in prompts]
    out = eng.run()
    st = eng.stats
    pool = eng.pool
    pool.check_invariants()  # FREE + ACTIVE + CACHED conservation
    counters = {k: st[k] for k in ("prefix_hit_tokens", "preemptions",
                                   "peak_blocks", "decode_dispatches",
                                   "prefills", "prefill_tokens",
                                   "tokens_decoded")}
    counters.update(free=pool.num_free(), cached=pool.num_cached(),
                    active=pool.num_active(), hits=pool.stats["hit_blocks"],
                    evictions=pool.stats["evictions"])
    return counters, [out[r.rid] for r in reqs]


def test_preemption_and_prefix_hits_match_oracle_and_jax_counters(setup):
    jcfg, jparams, cfg, model, oracle = setup
    prompts = _pressure_stream(cfg.vocab_size)
    kw = dict(num_slots=2, max_len=48, block_size=8, num_blocks=9,
              chunk_size=8)
    mine, toks = _run_counters(
        UnifiedServeEngine(cfg, model, device="cpu", **kw), prompts)
    theirs, _ = _run_counters(JaxUnifiedEngine(jcfg, jparams, **kw), prompts)
    assert mine["preemptions"] > 0 and mine["prefix_hit_tokens"] > 0
    assert mine == theirs
    for p, t in zip(prompts, toks):
        np.testing.assert_array_equal(t, oracle(p, 8))


def test_trace_ledger_matches_jax_engine(setup):
    """The port's engine under the port's own tracer and the JAX engine
    under JAX's, on the same stream, stamp the same event ledger value for
    value — per-dispatch EV_STEP_BUDGET / CHUNK / DECODE triples, block
    gauges, admit/retire/preempt order, prefix hits, kernel-variant ids —
    everything except wall-clock latencies."""
    from repro.core.tracer import Tracer as JaxTracer
    from repro_torch.core import events as ev
    from repro_torch.core.tracer import Tracer

    jcfg, jparams, cfg, model, _ = setup
    prompts = _pressure_stream(cfg.vocab_size)
    kw = dict(num_slots=2, max_len=48, block_size=8, num_blocks=9,
              chunk_size=8)
    ledgers = []
    for tracer, make in (
            (Tracer("ledger"), lambda tr: UnifiedServeEngine(
                cfg, model, device="cpu", tracer=tr, **kw)),
            (JaxTracer("ledger"), lambda tr: JaxUnifiedEngine(
                jcfg, jparams, tracer=tr, **kw))):
        tracer.init()
        eng = make(tracer)
        for p in prompts:
            eng.submit(p, 8)
        eng.run()
        evs = tracer.finish().events
        keep = ~np.isin(evs["type"], [ev.EV_REQ_TTFT_US, ev.EV_REQ_TPOT_US])
        ledgers.append(np.stack([evs["type"][keep], evs["value"][keep]], 1))
    mine, theirs = ledgers
    budget = mine[mine[:, 0] == ev.EV_STEP_BUDGET]
    assert len(budget) > 10
    np.testing.assert_array_equal(mine, theirs)


def test_engine_guards():
    cfg = reduced(get_config("granite-8b"), num_layers=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            UnifiedServeEngine(cfg, num_slots=1, max_len=16)
    eng = UnifiedServeEngine(cfg, device="cpu", num_slots=1, max_len=16)
    with pytest.raises(NotImplementedError, match="fan-out"):
        eng.submit(np.arange(4), 2, n_samples=2)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(np.arange(12), 8)
    with pytest.raises(NotImplementedError, match="speculative"):
        UnifiedServeEngine(cfg, device="cpu", num_slots=1, max_len=16,
                           spec=object())


def test_cli_serves_on_cpu(capsys):
    assert serve_cli.main(["--device", "cpu", "--requests", "3",
                           "--prompt-len", "12", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "12 tokens" in out and "paged_span:torch" in out


@pytest.mark.parametrize("flags,expect", [
    (["--mode", "continuous"], ["dense:torch=", "paged_decode:torch="]),
    (["--mode", "static"], ["mode=static", "16 tokens"]),
    (["--trace", "--flush-every", "2"], ["merged", "latency over 4 requests"]),
    (["--mode", "continuous", "--trace"], ["serve.prv", "TTFT p50"]),
], ids=["continuous", "static", "trace-flush", "continuous-trace"])
def test_cli_modes_and_trace_on_cpu(capsys, tmp_path, flags, expect):
    assert serve_cli.main(["--device", "cpu", "--requests", "4",
                           "--prompt-len", "12", "--gen", "4",
                           "--out", str(tmp_path), *flags]) == 0
    out = capsys.readouterr().out
    assert all(e in out for e in expect), out
    if "--trace" in flags:
        assert (tmp_path / "serve.prv").exists()
        assert (tmp_path / "serve.pcf").exists()


@pytest.mark.parametrize("flag", [["--beam", "2"], ["--mp", "2"],
                                  ["--spec", "ngram"], ["--kv-dtype", "int8"],
                                  ["--replicas", "2"], ["--n", "2"],
                                  ["--flush-every", "2"]])
def test_cli_rejects_paths_not_ported(flag):
    with pytest.raises(SystemExit):
        serve_cli.main(["--device", "cpu", *flag])
