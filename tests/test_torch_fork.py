"""Torch port, copy-on-write forks on the unified engine, on the CPU: the
port's counterparts of JAX ``tests/test_serve_fork.py`` (all but the mp=2
case, which waits for tensor parallelism), on reduced granite and
mixtral (float32) loaded with the JAX package's weights.

* n-way fan-out: greedy siblings equal the unforked stream (native and
  int8 pools) and the greedy full-recompute oracle from the JAX
  ``forward`` (native pool); overflow children requeue and complete; a
  seeded fan is reproducible and fork 0 bit-exact against the unforked
  stream; forks compose with the spec lane;
* the host ledger against the JAX ``UnifiedServeEngine`` on the same
  stream, value for value (each under its own package's tracer):
  ``EV_FORK``, ``EV_BLOCKS_SHARED``, the budget triples, block gauges,
  prefix hits, and the pool's ``forks`` / ``cow_copies``;
* beam search: width 1 is greedy; wider beams equal a plain beam search
  over the JAX ``forward`` logits with the same stable-argsort prune,
  come back best-first and hand every block back; busy engines and bad
  widths are refused;
* sessions: turn k+1 prefix-hits turn k's pinned context, with the same
  hit tokens and ledger as the JAX engine; a later turn must extend the
  stored context; the exclusions are loud; the legacy and fixed-batch
  engines and a state-carrying family refuse fan-out.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.tracer import Tracer as JaxTracer  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serve.step import UnifiedServeEngine as JaxUnifiedEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core.tracer import Tracer  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serve.engine import ContinuousServeEngine  # noqa: E402
from repro_torch.serve.spec import make_proposer  # noqa: E402
from repro_torch.serve.step import UnifiedServeEngine  # noqa: E402
from test_torch_spec import ORACLE_LEN, _setup  # noqa: E402

SCORE_TOL = 1e-4  # summed float32 log-probs, absolute
ARCHS = ["granite-8b", "mixtral-8x22b"]  # mixtral at the drop-free cf 8


def _prompt(vocab, n, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(np.int32)


def _conserved(pool):
    pool.check_invariants()
    return pool.num_free() + pool.num_active() + pool.num_cached() \
        == pool.num_blocks - 1


def _engine(cfg, model, **kw):
    kw = {"num_slots": 4, "max_len": 96, "block_size": 16, "chunk_size": 16,
          **kw}
    return UnifiedServeEngine(cfg, model, device="cpu", **kw)


# ----------------------------------------------------------------------
# n-way fan-out
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_fork_streams_match_unforked_oracle(arch, kv_dtype):
    """All n greedy streams equal the unforked request: the CoW copy of
    the shared partial tail (45 tokens: two full blocks and 13 tokens) is
    exact, codes and scales on int8, and the aliased prompt blocks are
    read correctly; one prefill serves the fan."""
    kw = {} if kv_dtype == "fp16" else {"kv_dtype": kv_dtype}
    _, _, cfg, model, oracle = _setup(arch, **kw)
    prompt = _prompt(cfg.vocab_size, 45)
    solo = _engine(cfg, model)
    r0 = solo.submit(prompt, 4)
    want = solo.run()[r0.rid]
    if kv_dtype == "fp16":
        np.testing.assert_array_equal(want, oracle(prompt, 4))
    eng = _engine(cfg, model)
    rp = eng.submit(prompt, 4, n_samples=4)
    out = eng.run()
    assert len(rp.forks) == 3
    for req in [rp] + rp.forks:
        np.testing.assert_array_equal(out[req.rid], want,
                                      err_msg=f"fork {req.fork_index}")
    st = eng.throughput_stats()
    assert st["forks"] == 3 and st["cow_copies"] > 0
    assert st["prefills"] == 1 and st["peak_shared"] > 0
    # the fan shares its prompt blocks: less than n unforked residencies
    assert st["peak_blocks"] < 4 * solo.stats["peak_blocks"]
    assert _conserved(eng.pool) and eng.pool.num_active() == 0


def test_fork_overflow_requeues_and_all_streams_complete():
    """n_samples > free slots: the overflow children requeue at the front,
    re-admit through the prefix cache and finish, every stream greedy-equal
    to the oracle; one EV_FORK per minted child."""
    _, _, cfg, model, oracle = _setup("granite-8b")
    prompt = _prompt(cfg.vocab_size, 37)
    want = oracle(prompt, 6)
    tracer = Tracer("fork-overflow").init()
    eng = _engine(cfg, model, num_slots=2, tracer=tracer)
    rp = eng.submit(prompt, 6, n_samples=4)
    out = eng.run()
    evs = tracer.finish().events
    assert len(rp.forks) == 3 and len(out) == 4
    for req in [rp] + rp.forks:
        np.testing.assert_array_equal(out[req.rid], want,
                                      err_msg=f"fork {req.fork_index}")
    forks = evs[evs["type"] == ev.EV_FORK]
    assert len(forks) == 3 and set(forks["value"]) == {rp.rid + 1}
    assert all(k.prefix_hit_tokens >= 32 for k in rp.forks)
    assert _conserved(eng.pool)


def test_seeded_fan_reproducible_and_fork0_bit_exact():
    """temperature > 0: one seed reproduces the whole n=4 fan, fork 0 is
    bit-identical to the unforked request at that seed, and the siblings
    draw from their own streams (they part from fork 0)."""
    _, _, cfg, model, _ = _setup("granite-8b")
    prompt = _prompt(cfg.vocab_size, 37)
    kw = dict(temperature=0.8, seed=7)

    def fan():
        eng = _engine(cfg, model, **kw)
        rp = eng.submit(prompt, 6, n_samples=4)
        out = eng.run()
        return [out[r.rid] for r in [rp] + rp.forks]

    a, b = fan(), fan()
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"fork {i} not seeded")
    solo = _engine(cfg, model, **kw)
    rs = solo.submit(prompt, 6)
    np.testing.assert_array_equal(a[0], solo.run()[rs.rid],
                                  err_msg="fork 0 != unforked stream")
    assert any(not np.array_equal(a[0], s) for s in a[1:]), \
        "sibling streams collapsed onto fork 0 at temperature > 0"


def test_fork_composes_with_spec_lane():
    """Forked slots ride the speculative lane: the spec planner charges
    the CoW copies before the span writes, so the greedy fan still equals
    the unforked spec stream and the oracle."""
    _, _, cfg, model, oracle = _setup("granite-8b")
    prompt = _prompt(cfg.vocab_size, 40)

    def spec():
        return dict(spec=make_proposer("ngram", cfg, num_slots=4, max_len=96,
                                       device="cpu"), spec_k=4)

    solo = _engine(cfg, model, **spec())
    ro = solo.submit(prompt, 8)
    want = solo.run()[ro.rid]
    np.testing.assert_array_equal(want, oracle(prompt, 8))
    eng = _engine(cfg, model, **spec())
    rp = eng.submit(prompt, 8, n_samples=3)
    out = eng.run()
    for req in [rp] + rp.forks:
        np.testing.assert_array_equal(out[req.rid], want,
                                      err_msg=f"fork {req.fork_index}")
    assert eng.stats["spec_dispatches"] > 0 and eng.pool.stats["forks"] == 2
    assert _conserved(eng.pool)


def _ledger(evs):
    keep = ~np.isin(evs["type"], [ev.EV_REQ_TTFT_US, ev.EV_REQ_TPOT_US])
    return np.stack([evs["type"][keep], evs["value"][keep]], 1)


def _both_ledgers(arch, run, **kw):
    """(port ledger, JAX ledger, port engine, JAX engine) of ``run(eng)``
    on the same weights, each under its own package's tracer."""
    jcfg, jparams, cfg, model, _ = _setup(arch)
    out = []
    for tracer, make in (
            (Tracer("ledger"), lambda tr: _engine(cfg, model, tracer=tr, **kw)),
            (JaxTracer("ledger"), lambda tr: JaxUnifiedEngine(
                jcfg, jparams, tracer=tr,
                **{"num_slots": 4, "max_len": 96, "block_size": 16,
                   "chunk_size": 16, **kw}))):
        tracer.init()
        eng = make(tracer)
        run(eng, cfg.vocab_size)
        out.append((_ledger(tracer.finish().events), eng))
    (mine, eng), (theirs, jeng) = out
    return mine, theirs, eng, jeng


@pytest.mark.parametrize("slots", [4, 2], ids=["seated", "overflow"])
def test_fork_trace_ledger_and_budget_triples_match_jax(slots):
    """Two n=4 fans: EV_FORK == 3 per parent, EV_BLOCKS_SHARED peaks > 0,
    the budget triples and every block gauge, value for value against the
    JAX engine's ledger; the pool's forks and CoW copies likewise."""
    def run(eng, vocab):
        for s in (3, 4):
            eng.submit(_prompt(vocab, 40, seed=s), 4, n_samples=4)
        eng.run()

    mine, theirs, eng, jeng = _both_ledgers("granite-8b", run, num_slots=slots)
    assert (mine[:, 0] == ev.EV_FORK).sum() == 6
    shared = mine[mine[:, 0] == ev.EV_BLOCKS_SHARED][:, 1]
    assert len(shared) and shared.max() > 0
    for code in (ev.EV_STEP_BUDGET, ev.EV_CHUNK_TOKENS, ev.EV_DECODE_TOKENS):
        assert (mine[:, 0] == code).sum() > 0, code
    np.testing.assert_array_equal(mine, theirs)
    for k in ("forks", "cow_copies"):
        assert eng.pool.stats[k] == jeng.pool.stats[k], k
    assert eng.stats["prefix_hit_tokens"] == jeng.stats["prefix_hit_tokens"]
    assert _conserved(eng.pool)


# ----------------------------------------------------------------------
# beam search
# ----------------------------------------------------------------------
def _beam_oracle(jcfg, jparams, prompt, n, width):
    """Plain beam search over the JAX ``forward``: top-``width`` log-probs
    (``lax.top_k`` order) of every beam's last position, the [w, w]
    candidate sums ranked by a stable argsort, as the engine prunes."""
    fwd = jax.jit(lambda p, t: jax_build_model(jcfg).forward(
        p, {"tokens": t})[0])

    def top(ctx):
        buf = np.zeros((1, ORACLE_LEN), np.int32)
        buf[0, :len(ctx)] = ctx
        lp = jax.nn.log_softmax(fwd(jparams, jnp.asarray(buf))[0, len(ctx) - 1])
        val, ids = jax.lax.top_k(lp, width)
        return np.asarray(val, np.float64), np.asarray(ids)

    val, ids = top(list(prompt))
    scores, seqs = val, [[int(t)] for t in ids]
    for _ in range(1, n):
        cand = [top(list(prompt) + s) for s in seqs]
        total = scores[:, None] + np.stack([c[0] for c in cand])
        flat = np.argsort(-total, axis=None, kind="stable")[:width]
        src, pick = flat // width, flat % width
        seqs = [seqs[s] + [int(cand[s][1][p])] for s, p in zip(src, pick)]
        scores = total.reshape(-1)[flat]
    order = np.argsort(-scores, kind="stable")
    return [(np.asarray(seqs[r], np.int32), float(scores[r])) for r in order]


@pytest.mark.parametrize("arch", ARCHS)
def test_beam_width1_is_greedy_and_wider_beams_match_oracle(arch):
    jcfg, jparams, cfg, model, oracle = _setup(arch)
    prompt = _prompt(cfg.vocab_size, 24)
    tracer = Tracer("beam").init()
    eng = _engine(cfg, model, max_len=64, tracer=tracer)
    rg = eng.submit(prompt, 6)
    want = eng.run()[rg.rid]
    np.testing.assert_array_equal(want, oracle(prompt, 6))
    free0 = eng.pool.num_free()
    beams = eng.beam_search(prompt, 6, width=1)
    np.testing.assert_array_equal(beams[0][0], want,
                                  err_msg="width-1 beam != greedy")
    forks0 = (tracer.finish().events["type"] == ev.EV_FORK).sum()
    assert forks0 == 0
    for width in (2, 3):
        beams = eng.beam_search(prompt, 6, width=width)
        ref = _beam_oracle(jcfg, jparams, prompt, 6, width)
        assert len(beams) == width
        scores = [s for _, s in beams]
        assert scores == sorted(scores, reverse=True)
        for (toks, score), (rtoks, rscore) in zip(beams, ref):
            np.testing.assert_array_equal(toks, rtoks)
            assert abs(score - rscore) < SCORE_TOL
    assert eng.stats["peak_shared"] > 0 and eng.pool.stats["cow_copies"] > 0
    assert eng.pool.num_free() == free0  # beams hand every block back
    assert _conserved(eng.pool)


def test_beam_reseats_are_forks_in_the_ledger():
    """Every beam (width - 1 at the prefill) and every reseat is one
    EV_FORK, valued source beam + 1; the pool's forks count them all."""
    _, _, cfg, model, _ = _setup("granite-8b")
    tracer = Tracer("beam").init()
    eng = _engine(cfg, model, max_len=64, tracer=tracer)
    eng.beam_search(_prompt(cfg.vocab_size, 20), 8, width=4)
    forks = tracer.finish().events
    forks = forks[forks["type"] == ev.EV_FORK]["value"]
    assert (forks[:3] == 1).all() and len(forks) > 3
    assert forks.min() >= 1 and forks.max() <= 4
    assert eng.pool.stats["forks"] == len(forks)


def test_beam_search_needs_idle_engine_and_valid_width():
    _, _, cfg, model, _ = _setup("granite-8b")
    eng = _engine(cfg, model, num_slots=2, max_len=64)
    with pytest.raises(ValueError, match="width"):
        eng.beam_search(_prompt(cfg.vocab_size, 8), 4, width=3)
    with pytest.raises(ValueError, match="capacity"):
        eng.beam_search(_prompt(cfg.vocab_size, 60), 8, width=2)
    eng.submit(_prompt(cfg.vocab_size, 8), 4)
    with pytest.raises(RuntimeError, match="idle"):
        eng.beam_search(_prompt(cfg.vocab_size, 8), 4, width=2)


# ----------------------------------------------------------------------
# sessions
# ----------------------------------------------------------------------
def _three_turns(eng, vocab):
    """Two conversations of three turns; turn k+1 = the full turn-k
    context (this engine's own tokens) + 10 fresh ones."""
    hits = []
    for s in range(2):
        ctx = _prompt(vocab, 32, seed=10 + s)
        for turn in range(3):
            r = eng.submit(ctx, 6, session=f"s{s}")
            out = eng.run()
            hits.append(r.prefix_hit_tokens)
            ctx = np.concatenate([ctx, out[r.rid],
                                  _prompt(vocab, 10, seed=20 + 3 * s + turn)])
    eng.hits = hits
    eng.released = [eng.close_session(f"s{s}") for s in range(2)]


def test_session_turns_hit_the_pinned_context_like_jax():
    """Turns 2 and 3 hit every full block of the previous context (prompt
    ++ tokens[:-1]); the hit tokens, the released pins and the whole
    ledger equal the JAX engine's; closing conserves the pool."""
    mine, theirs, eng, jeng = _both_ledgers("granite-8b", _three_turns,
                                            num_slots=2, max_len=128,
                                            num_blocks=64)
    bs = eng.block_size
    for s in range(2):
        h = eng.hits[3 * s:3 * s + 3]
        assert h[0] == 0 and h[1] >= (32 + 6 - 1) // bs * bs and h[2] > h[1]
    assert eng.hits == jeng.hits and eng.released == jeng.released
    assert sum(eng.released) > 0 and eng.close_session("s0") == 0
    np.testing.assert_array_equal(mine, theirs)
    assert _conserved(eng.pool) and eng.pool.num_active() == 0


def test_session_turns_must_extend_and_exclusions_are_loud():
    _, _, cfg, model, _ = _setup("granite-8b")
    eng = _engine(cfg, model, num_slots=2)
    p = _prompt(cfg.vocab_size, 32)
    eng.submit(p, 4, session="a")
    eng.run()
    with pytest.raises(ValueError, match="extend"):
        eng.submit(_prompt(cfg.vocab_size, 40, seed=9), 4, session="a")
    with pytest.raises(ValueError, match="mutually exclusive"):
        eng.submit(_prompt(cfg.vocab_size, 16), 4, n_samples=2, session="b")
    nocache = _engine(cfg, model, num_slots=2, prefix_cache=False)
    with pytest.raises(ValueError, match="prefix"):
        nocache.submit(p, 4, session="c")
    assert eng.close_session("a") > 0


def test_fork_rejected_loudly_off_the_unified_path(capsys):
    """The legacy engine, the fixed-batch engine (CLI) and a state-carrying
    family refuse fan-out instead of serving n sequential requests."""
    _, _, cfg, model, _ = _setup("granite-8b")
    legacy = ContinuousServeEngine(cfg, model, device="cpu", num_slots=2,
                                   max_len=64, block_size=16)
    assert not legacy.supports_fork
    with pytest.raises(ValueError, match="n_samples"):
        legacy.submit(_prompt(cfg.vocab_size, 16), 4, n_samples=2)
    assert len(legacy.queue) == 0  # refused before it was queued
    ssm = UnifiedServeEngine(reduced(get_config("mamba2-370m"), num_layers=1),
                             device="cpu", num_slots=2, max_len=32)
    assert not ssm.supports_fork
    with pytest.raises(ValueError, match="n_samples"):
        ssm.submit(np.arange(8, dtype=np.int32), 4, n_samples=2)
    for mode in ("static", "continuous"):
        with pytest.raises(SystemExit):
            serve_cli.main(["--device", "cpu", "--mode", mode, "--n", "2"])


@pytest.mark.parametrize("flags,expect", [
    (["--n", "3"], ["CoW forking: ", "(n=3 per prompt)", "24 tokens"]),
    (["--n", "2", "--trace"], ["forks (from trace): 2 children off 2 parents"]),
    (["--best-of", "2", "--temperature", "0.8"], ["CoW forking: "]),
    (["--beam", "2", "--gen", "5"], ["beam prompt 1: width 2"]),
    (["--session", "--prompt-len", "20"], ["sessions: 2 turn-2 requests"]),
    (["--session", "--requests", "8", "--prompt-len", "32", "--gen", "32"],
     ["sessions: 8 turn-2 requests"]),
    (["--arch", "deepseek-moe-16b", "--n", "2"], ["deepseek-moe-16b", "CoW"]),
], ids=["n", "n-trace", "best-of", "beam", "session",
        "session-defaults", "moe-n"])
def test_cli_fork_beam_session_on_cpu(capsys, tmp_path, flags, expect):
    argv = ["--device", "cpu", "--requests", "2", "--prompt-len", "12",
            "--gen", "4", "--out", str(tmp_path)]
    assert serve_cli.main(argv + flags) == 0
    out = capsys.readouterr().out
    assert all(e in out for e in expect), out
