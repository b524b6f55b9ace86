"""Torch port, ssm family (mamba2) on the grouped-prefill
``ContinuousServeEngine`` and the fixed-batch ``ServeEngine``, on the CPU,
against the JAX package on the same weights (``model.init(PRNGKey(0))``
through ``convert.params_from_jax``).

* greedy tokens of both engines equal the port's unified engine, a greedy
  full-recompute oracle (the JAX ``forward`` over the whole context every
  token) and an incremental oracle from the JAX jitted ``prefill`` /
  ``decode_step``;
* a same-length group prefills as one batch and writes exactly each
  request's own state at its slot (no padding enters a state);
* the legacy engine's host counters and trace ledger equal the JAX legacy
  engine's, value for value (tokens are never taken from the JAX engines:
  ROADMAP.md Faults);
* a one-token request admitted first retires at its prefill: the legacy
  loop (JAX and port) goes on serving the rest, while the unified loop
  (JAX and port) stops with its stall error (ROADMAP.md Faults);
* the CLI's ``--mode continuous|static`` for mamba2."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.tracer import Tracer as JaxTracer  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import ContinuousServeEngine as JaxLegacyEngine  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.step import UnifiedServeEngine as JaxUnifiedEngine  # noqa: E402
from repro_torch import core as xtrace  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core.tracer import Tracer  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine  # noqa: E402
from repro_torch.serve.step import UnifiedServeEngine  # noqa: E402

ORACLE_LEN = 64  # fixed forward length: causal logits ignore right padding
STATE_TOL = 1e-5  # float32 state leaves, batched vs single prefill
LENS = [7, 16, 16, 21, 16, 30]  # three 16s: a same-length group of three
GEN = 8


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_get_config("mamba2-370m"), num_layers=2)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("mamba2-370m"), num_layers=2)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    fwd = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t})[0])
    pre = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}))
    dec = jax.jit(jmodel.decode_step)
    vocab = cfg.vocab_size

    def recompute(prompt, n):
        """Greedy full recompute: forward() over the whole context."""
        ctx = list(prompt)
        for _ in range(n):
            buf = np.zeros((1, ORACLE_LEN), np.int32)
            buf[0, :len(ctx)] = ctx
            logits = np.asarray(fwd(jparams, jnp.asarray(buf)))
            ctx.append(int(np.argmax(logits[0, len(ctx) - 1, :vocab])))
        return np.asarray(ctx[len(prompt):], np.int32)

    def incremental(prompt, n):
        """Greedy from the JAX jitted prefill, then decode_step."""
        caches, last = pre(jparams, jnp.asarray(prompt[None]))
        toks = [int(np.argmax(np.asarray(last)[0, :vocab]))]
        for i in range(n - 1):
            caches, lg = dec(jparams, caches, jnp.asarray([toks[-1]], jnp.int32),
                             jnp.asarray([len(prompt) + i], jnp.int32))
            toks.append(int(np.argmax(np.asarray(lg)[0, :vocab])))
        return np.asarray(toks, np.int32)

    return jcfg, jparams, cfg, model, recompute, incremental


@pytest.fixture(scope="module")
def stream(pair):
    *_, cfg, _, _, _ = pair
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def oracles(pair, stream):
    *_, recompute, incremental = pair
    return ([recompute(p, GEN) for p in stream],
            [incremental(p, GEN) for p in stream])


@pytest.fixture(scope="module")
def unified_tokens(pair, stream):
    *_, cfg, model, _, _ = pair
    eng = UnifiedServeEngine(cfg, model, device="cpu", num_slots=3, max_len=48)
    reqs = [eng.submit(p, GEN) for p in stream]
    out = eng.run()
    return [out[r.rid] for r in reqs]


def _legacy(cfg, model, prompts, gen=GEN, *, per_iter=1, tracer=None, **kw):
    eng = ContinuousServeEngine(cfg, model, device="cpu", num_slots=3,
                                max_len=48, max_prefills_per_iter=per_iter,
                                tracer=tracer, **kw)
    reqs = [eng.submit(p, g) for p, g in zip(
        prompts, gen if isinstance(gen, list) else [gen] * len(prompts))]
    out = eng.run()
    return eng, [out[r.rid] for r in reqs]


@pytest.mark.parametrize("per_iter", [1, 3], ids=["singles", "groups"])
def test_legacy_streams_match_unified_and_oracles(pair, stream, oracles,
                                                  unified_tokens, per_iter):
    """Three slots, six prompts: queueing and slot reuse; with three
    admissions an iteration the three 16-token prompts prefill as one
    batch."""
    *_, cfg, model, _, _ = pair
    eng, toks = _legacy(cfg, model, stream, per_iter=per_iter)
    for got, uni, rec, inc in zip(toks, unified_tokens, *oracles):
        np.testing.assert_array_equal(got, rec)
        np.testing.assert_array_equal(got, inc)
        np.testing.assert_array_equal(got, uni)
    st = eng.throughput_stats()
    assert eng.pool is None and st["kernel_dispatch"] == {}
    assert st["prefills"] == len(LENS) and st["tokens"] == len(LENS) * GEN
    assert st["decode_syncs"] == st["decode_dispatches"] > 0
    # one fetch a prefill group: a batched group saves fetches
    prefill_syncs = st["host_syncs"] - st["decode_syncs"]
    assert prefill_syncs == len(LENS) if per_iter == 1 \
        else prefill_syncs < len(LENS)


def test_static_batch_matches_unified_and_oracles(pair, stream, oracles,
                                                  unified_tokens):
    """The rectangular batch of the three 16-token prompts in lockstep,
    and each prompt alone."""
    *_, cfg, model, _, _ = pair
    eng = ServeEngine(cfg, model, device="cpu", max_len=48)
    same = [i for i, n in enumerate(LENS) if n == 16]
    batch = eng.generate(np.stack([stream[i] for i in same]), num_tokens=GEN)
    assert eng.host_syncs == GEN
    for row, i in zip(batch, same):
        np.testing.assert_array_equal(row, oracles[0][i])
    for p, uni, rec, inc in zip(stream, unified_tokens, *oracles):
        got = eng.generate(p[None], num_tokens=GEN)[0]
        np.testing.assert_array_equal(got, rec)
        np.testing.assert_array_equal(got, inc)
        np.testing.assert_array_equal(got, uni)


def test_static_matches_jax_fixed_batch_engine_syncs(pair, stream):
    """Host syncs and the output shape of the JAX ServeEngine on the same
    batch (one sync a token); tokens come from the oracles above."""
    jcfg, jparams, cfg, model, _, _ = pair
    batch = np.stack([p for p in stream if len(p) == 16])
    mine = ServeEngine(cfg, model, device="cpu", max_len=48)
    theirs = JaxServeEngine(jcfg, jparams, max_len=48)
    a = mine.throughput_stats(batch, num_tokens=5)
    b = theirs.throughput_stats(batch, num_tokens=5)
    assert (a["tokens"], a["host_syncs"]) == (b["tokens"], b["host_syncs"]) \
        == (15, 5)


def test_grouped_prefill_writes_each_state_at_its_slot(pair, stream):
    """A group of three 16-token prompts prefills in one batch; each slot
    then holds exactly the state of its own prompt prefilled alone."""
    *_, cfg, model, _, _ = pair
    same = [stream[i] for i, n in enumerate(LENS) if n == 16]
    eng = ContinuousServeEngine(cfg, model, device="cpu", num_slots=3,
                                max_len=48, max_prefills_per_iter=3)
    reqs = [eng.submit(p, 4) for p in same]
    admissions = eng.scheduler.admissions()
    groups = eng._prefill_groups(admissions)
    assert [len(g) for g in groups] == [3]
    with torch.inference_mode():
        eng._do_prefill(groups[0])
        for req, p in zip(reqs, same):
            alone, _ = model.prefill(torch.from_numpy(p[None]))
            for name, leaf in eng._caches.items():
                torch.testing.assert_close(leaf[:, req.slot], alone[name][:, 0],
                                           atol=STATE_TOL, rtol=0)
    assert eng.stats["host_syncs"] == 1 and eng.stats["prefills"] == 3


def _ledger(evs):
    keep = ~np.isin(evs["type"], [ev.EV_REQ_TTFT_US, ev.EV_REQ_TPOT_US])
    return np.stack([evs["type"][keep], evs["value"][keep]], 1)


_COUNTERS = ("prefills", "prefill_tokens", "tokens_decoded",
             "decode_dispatches", "decode_syncs", "host_syncs", "iterations",
             "preemptions", "prefix_hit_tokens", "peak_active")


@pytest.mark.parametrize("per_iter", [1, 3], ids=["singles", "groups"])
def test_legacy_counters_and_ledger_match_jax_legacy(pair, stream, per_iter):
    """Each engine under its own package's tracer, two runs (the second a
    two-request wave on the warm engine): admit/retire order, prefill
    phases and burst counters value for value; no pool gauges and no
    kernel-variant stamps (no attention)."""
    jcfg, jparams, cfg, model, _, _ = pair
    runs = [stream, stream[:2]]
    got = []
    for tracer, make in (
            (Tracer("ledger"), lambda tr: ContinuousServeEngine(
                cfg, model, device="cpu", num_slots=3, max_len=48,
                max_prefills_per_iter=per_iter, tracer=tr)),
            (JaxTracer("ledger"), lambda tr: JaxLegacyEngine(
                jcfg, jparams, num_slots=3, max_len=48,
                max_prefills_per_iter=per_iter, tracer=tr))):
        tracer.init()
        eng = make(tracer)
        for run in runs:
            for p in run:
                eng.submit(p, GEN)
            eng.run()
        got.append(({k: eng.stats[k] for k in _COUNTERS},
                    _ledger(tracer.finish().events)))
    (mine, mledger), (theirs, jledger) = got
    assert mine == theirs
    np.testing.assert_array_equal(mledger, jledger)
    assert (mledger[:, 0] == ev.EV_REQ_RETIRE).sum() == len(stream) + 2
    assert not np.isin(mledger[:, 0],
                       [ev.EV_KERNEL_VARIANT, ev.EV_BLOCKS_FREE]).any()


def _stall_stream(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (9, 12)]


@pytest.mark.parametrize("side", ["port", "jax"])
def test_legacy_serves_past_a_request_retiring_at_prefill(pair, side):
    """A one-token request admitted first finishes inside the prefill; the
    legacy loop admits the next request on its next iteration (no stall)
    and serves it as if alone."""
    jcfg, jparams, cfg, model, recompute, _ = pair
    prompts = _stall_stream(cfg.vocab_size)
    if side == "port":
        eng = ContinuousServeEngine(cfg, model, device="cpu", num_slots=2,
                                    max_len=32)
    else:
        eng = JaxLegacyEngine(jcfg, jparams, num_slots=2, max_len=32)
    reqs = [eng.submit(p, g) for p, g in zip(prompts, (1, 4))]
    out = eng.run()
    assert [len(out[r.rid]) for r in reqs] == [1, 4]
    assert eng.stats["prefills"] == 2 and eng.stats["tokens_decoded"] == 5
    if side == "port":
        np.testing.assert_array_equal(out[reqs[1].rid],
                                      recompute(prompts[1], 4))


@pytest.mark.parametrize("side", ["port", "jax"])
def test_unified_stalls_where_the_legacy_loop_does_not(pair, side):
    """The same stream through the unified loop: whole-prompt admission
    retires the one-token request at its prefill, nothing dispatches, and
    the loop raises its stall error; the port mirrors the JAX loop."""
    jcfg, jparams, cfg, model, _, _ = pair
    prompts = _stall_stream(cfg.vocab_size)
    if side == "port":
        eng = UnifiedServeEngine(cfg, model, device="cpu", num_slots=2,
                                 max_len=32)
    else:
        eng = JaxUnifiedEngine(jcfg, jparams, num_slots=2, max_len=32)
    for p, g in zip(prompts, (1, 4)):
        eng.submit(p, g)
    with pytest.raises(RuntimeError, match="serve loop stalled"):
        eng.run()


def test_legacy_sampling_is_seeded(pair, stream):
    """Temperature > 0 (a high one: the reduced model's logits spread
    wide): the same seed gives the same tokens, another seed other
    tokens, every token in the vocab."""
    *_, cfg, model, _, _ = pair
    runs = [_legacy(cfg, model, stream[:3], temperature=50.0, seed=s)[1]
            for s in (3, 3, 4)]
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_array_equal(a, b)
    assert any((a != c).any() for a, c in zip(runs[0], runs[2]))
    assert all(((t >= 0) & (t < cfg.vocab_size)).all() for t in runs[0])


def test_serve_batch_equals_fixed_batch(pair, stream):
    *_, cfg, model, recompute, _ = pair
    batch = np.stack([p for p in stream if len(p) == 16])
    eng = ContinuousServeEngine(cfg, model, device="cpu", num_slots=2,
                                max_len=32)
    got = eng.serve_batch(batch, num_tokens=5)
    static = ServeEngine(cfg, model, device="cpu", max_len=32)
    np.testing.assert_array_equal(got, static.generate(batch, num_tokens=5))
    for p, g in zip(batch, got):
        np.testing.assert_array_equal(g, recompute(p, 5))


@pytest.mark.parametrize("flags,expect", [
    (["--mode", "continuous"], ["mode=continuous", "16 tokens"]),
    (["--mode", "static"], ["mode=static", "16 tokens"]),
    (["--mode", "continuous", "--trace", "--flush-every", "2"],
     ["merged", "latency over 4 requests"]),
    (["--mode", "static", "--trace"], ["serve.prv", "16 tokens"]),
], ids=["continuous", "static", "continuous-trace", "static-trace"])
def test_cli_serves_mamba2_in_every_mode(capsys, tmp_path, flags, expect):
    """No pool (no pool or attention-kernel line) in any mode."""
    assert serve_cli.main(["--device", "cpu", "--arch", "mamba2-370m",
                           "--requests", "4", "--slots", "2",
                           "--prompt-len", "12", "--gen", "4",
                           "--out", str(tmp_path), *flags]) == 0
    out = capsys.readouterr().out
    assert all(e in out for e in expect), out
    assert "paged pool" not in out and "attention kernels" not in out, out
    if "--trace" in flags:
        merged = xtrace.parse_prv(tmp_path / "serve.prv")
        assert len(merged.events)


def test_cli_refuses_spec_for_mamba2(capsys):
    with pytest.raises(ValueError, match="speculative"):
        serve_cli.main(["--device", "cpu", "--arch", "mamba2-370m",
                        "--spec", "ngram", "--requests", "2"])
