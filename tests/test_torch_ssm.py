"""Torch port, ssm family (mamba2) on the CPU: the plain SSD scan against
the JAX package's chunked scan, its Pallas kernel in interpret mode and
the float64 sequential oracle; the Mamba-2 pieces, the model functions
and the unified engine against the JAX package on the same weights
(``model.init(PRNGKey(0))`` through ``convert.params_from_jax``).

Engine tokens are held against a greedy full-recompute oracle built from
the JAX ``forward``; the JAX engine is compared only by its host counters
and trace ledger, never by its tokens (ROADMAP.md Faults)."""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.tracer import Tracer as JaxTracer  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serve.step import UnifiedServeEngine as JaxUnifiedEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core.tracer import Tracer  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref, scan  # noqa: E402
from repro_torch.models import convert, params, ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine  # noqa: E402
from repro_torch.serve.step import UnifiedServeEngine  # noqa: E402

# tests/test_kernels_ssd.py: b, s, h, p, n, g, chunk (padding, groups)
CASES = [
    (2, 128, 2, 32, 16, 1, 32),
    (1, 256, 4, 64, 32, 1, 64),
    (1, 96, 2, 32, 16, 1, 32),
    (1, 100, 2, 32, 16, 2, 32),
    (2, 64, 8, 16, 8, 4, 16),
]
TOL = 2e-4  # the JAX kernel test's rtol = atol (float32)
BF16_TOL = 5e-2  # the JAX kernel test's bf16 tolerance
LOGIT_TOL = 1e-4  # float32 logits, different op order (absolute)
ORACLE_LEN = 64  # fixed forward length: causal logits ignore right padding


def _mk(b, s, h, p, n, g, *, seed=0, dt_shift=-1.0, a_max=8.0):
    """The JAX test's draws (normal x/B/C, dt = softplus(normal - 1),
    A ~ U[1, 8]) from numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)) + dt_shift, 0).astype(f32)
    a_log = np.log(rng.uniform(1.0, a_max, h)).astype(f32)
    bm = rng.standard_normal((b, s, g, n)).astype(f32)
    cm = rng.standard_normal((b, s, g, n)).astype(f32)
    return x, dt, a_log, bm, cm


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_plain_scan_matches_jax_scan_kernel_and_oracle(case):
    """The port's plain chunked scan against JAX ``ssd_chunked``, the JAX
    Pallas kernel (interpret mode) and the float64 recurrence."""
    b, s, h, p, n, g, chunk = case
    inputs = _mk(b, s, h, p, n, g)
    ops.reset_counts()
    y, state = ops.ssd_scan(*_t(inputs), chunk=chunk)
    assert scan.ssd_chunked_plain.calls == 1 and ops.ssd_scan.launches == 0
    jy, jstate = jax_ssm.ssd_chunked(*map(jnp.asarray, inputs), chunk)
    ky, kstate = jax_ssd_scan(*map(jnp.asarray, inputs), chunk=chunk,
                              interpret=True)
    ry, rstate = ref.ssd_sequential_ref(*_t(inputs))
    assert y.dtype == torch.float32 and state.shape == (b, h, n, p)
    for other_y, other_state in ((jy, jstate), (ky, kstate), (ry, rstate)):
        _close(y, other_y)
        _close(state, np.asarray(other_state).reshape(b, h, n, p))


def test_plain_scan_bf16_matches_jax():
    """bf16 x/B/C (the same rounded values on both sides), y in bf16."""
    x, dt, a_log, bm, cm = _mk(1, 128, 2, 32, 16, 1)
    j16 = [jnp.asarray(v, jnp.bfloat16) for v in (x, bm, cm)]
    t16 = [torch.from_numpy(v).to(torch.bfloat16) for v in (x, bm, cm)]
    y, _ = scan.ssd_chunked_plain(t16[0], torch.from_numpy(dt),
                                  torch.from_numpy(a_log), t16[1], t16[2], 64)
    jy, _ = jax_ssm.ssd_chunked(j16[0], jnp.asarray(dt), jnp.asarray(a_log),
                                j16[1], j16[2], 64)
    ry, _ = ref.ssd_sequential_ref(t16[0], torch.from_numpy(dt),
                                   torch.from_numpy(a_log), t16[1], t16[2])
    assert y.dtype == torch.bfloat16
    _close(y.float(), np.asarray(jy, np.float32), BF16_TOL)
    _close(y.float(), ry, BF16_TOL)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_plain_scan_is_chunk_length_independent(chunk):
    """One function for every chunk length (the kernel picks its own)."""
    inputs = _t(_mk(2, 100, 4, 32, 16, 2, seed=3))
    y, state = scan.ssd_chunked_plain(*inputs, chunk)
    y32, state32 = scan.ssd_chunked_plain(*inputs, 32)
    ry, rstate = ref.ssd_sequential_ref(*inputs)
    _close(y, ry)
    _close(state, rstate)
    _close(y, y32)
    _close(state, state32)


def test_plain_scan_has_no_nan_at_overflow_prone_decay():
    """dt * a = -48 a token: exp(cum_i - cum_j) is inf above the diagonal
    of every chunk; the decay is selected, never masked by a product."""
    x, _, _, bm, cm = _mk(1, 96, 2, 32, 16, 1, seed=5)
    dt = np.full((1, 96, 2), 3.0, np.float32)
    a_log = np.full((2,), math.log(16.0), np.float32)
    inputs = _t((x, dt, a_log, bm, cm))
    y, state = scan.ssd_chunked_plain(*inputs, 64)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    ry, rstate = ref.ssd_sequential_ref(*inputs)
    _close(y, ry)
    _close(state, rstate)


def test_kernel_launcher_and_dispatch_refuse_without_plain_fallback():
    """The launcher takes CUDA tensors only; the wrapper takes the plain
    version only for a CPU tensor (or kernel_mode xla); what the kernel
    cannot take is named."""
    inputs = _t(_mk(1, 8, 2, 16, 8, 1))
    ops.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        scan.ssd_scan_fwd(*inputs)
    assert scan.ssd_chunked_plain.calls == 0
    for mode in ("auto", "pallas", "xla"):
        assert ops.backend(mode, inputs[0], inputs[3]) == "torch"
    with pytest.raises(ValueError, match="kernel_mode"):
        ops.backend("cuda", inputs[0], inputs[3])
    x16 = inputs[0].half()
    assert "float16" in scan.unsupported(x16, inputs[3])
    assert "P 24" in scan.unsupported(torch.zeros(1, 8, 2, 24), inputs[3])
    assert "N 12" in scan.unsupported(inputs[0], torch.zeros(1, 8, 1, 12))
    assert scan.unsupported(inputs[0], inputs[3]) == ""


# ----------------------------------------------------------------------
# the model, against the JAX package on the same weights
# ----------------------------------------------------------------------
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

    def oracle(prompt, n):
        """Greedy full recompute: re-run the whole context every token."""
        ctx = list(prompt)
        for _ in range(n):
            buf = np.zeros((1, ORACLE_LEN), np.int32)
            buf[0, :len(ctx)] = ctx
            logits = np.asarray(fwd(jparams, jnp.asarray(buf)))
            ctx.append(int(np.argmax(logits[0, len(ctx) - 1, :cfg.vocab_size])))
        return np.asarray(ctx[len(prompt):], np.int32)

    return jcfg, jmodel, jparams, cfg, model, oracle


def test_mamba2_pieces_match_jax(pair):
    """_causal_conv, _conv_step, ssd_step and mamba2_block (prefill, then
    one decode step from its state) on layer 0's weights."""
    jcfg, _, jparams, cfg, model, _ = pair
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["units"]["mamba"])
    m = model.layers[0].mamba
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    _close(ssm._causal_conv(*_t((x, w, b))),
           jax_ssm._causal_conv(*map(jnp.asarray, (x, w, b))), 1e-5)
    for got, want in zip(
            ssm._conv_step(*_t((x[:, :1], x[:, 1:4], w, b))),
            jax_ssm._conv_step(*map(jnp.asarray, (x[:, :1], x[:, 1:4], w, b)))):
        _close(got, want, 1e-5)
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    st = rng.standard_normal((2, h, n, p)).astype(np.float32)
    xs = rng.standard_normal((2, h, p)).astype(np.float32)
    dts = rng.uniform(0.01, 0.2, (2, h)).astype(np.float32)
    a_log = np.log(rng.uniform(1, 16, h)).astype(np.float32)
    bv, cv = (rng.standard_normal((2, 1, n)).astype(np.float32) for _ in "bc")
    for got, want in zip(ssm.ssd_step(*_t((st, xs, dts, a_log, bv, cv))),
                         jax_ssm.ssd_step(*map(jnp.asarray,
                                               (st, xs, dts, a_log, bv, cv)))):
        _close(got, want, 1e-5)

    xin = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    y, state = ssm.mamba2_block(m, torch.from_numpy(xin), cfg)
    jy, jstate = jax_ssm.mamba2_block(jp, jnp.asarray(xin), jcfg)
    _close(y, jy, 1e-5)
    for k in jstate:
        _close(state[k], jstate[k], 1e-5)
    x1 = xin[:, :1]
    y1, state1 = ssm.mamba2_block(m, torch.from_numpy(x1), cfg, state=state)
    jy1, jstate1 = jax_ssm.mamba2_block(jp, jnp.asarray(x1), jcfg, state=jstate)
    _close(y1, jy1, 1e-5)
    for k in jstate1:
        _close(state1[k], jstate1[k], 1e-5)


def test_forward_prefill_decode_match_jax(pair):
    jcfg, jmodel, jparams, cfg, model, _ = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 37))
    toks = toks.astype(np.int32)
    jl = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t})[0])(
        jparams, jnp.asarray(toks))
    np.testing.assert_allclose(model(torch.from_numpy(toks)).numpy(),
                               np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    jcaches, jlast = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}))(
        jparams, jnp.asarray(toks))
    caches, last = model.prefill(torch.from_numpy(toks))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               atol=LOGIT_TOL, rtol=0)
    assert set(caches) == set(jcaches["units"])
    for k, leaf in caches.items():
        _close(leaf, jcaches["units"][k], 1e-5)
    dec = jax.jit(jmodel.decode_step)
    tok = np.asarray(jlast).argmax(-1).astype(np.int32)
    idx = np.full((2,), toks.shape[1], np.int32)
    for _ in range(3):
        jcaches, jlog = dec(jparams, jcaches, jnp.asarray(tok), jnp.asarray(idx))
        tlog = model.decode_step(caches, torch.from_numpy(tok),
                                 torch.from_numpy(idx))  # state in place
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=0)
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)
        idx = idx + 1
    for k, leaf in caches.items():
        _close(leaf, jcaches["units"][k], 1e-5)


def test_prefill_then_decode_equals_teacher_forced_forward(pair):
    """The chunked scan's final state, advanced token by token by the
    decode recurrence, gives forward()'s logits at every position."""
    *_, cfg, model, _ = pair
    full = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 30))
    full = torch.from_numpy(full.astype(np.int32))
    ref_logits = model(full)
    caches, last = model.prefill(full[:, :20])
    torch.testing.assert_close(last, ref_logits[:, 19], atol=LOGIT_TOL, rtol=0)
    for j in range(20, 30):
        lg = model.decode_step(caches, full[:, j],
                               torch.full((2,), j, dtype=torch.int32))
        torch.testing.assert_close(lg, ref_logits[:, j], atol=LOGIT_TOL, rtol=0)


def test_seeded_init_matches_jax_decls(pair):
    """Same tree, shapes and parameter count as the JAX model; the ssm
    inits draw A in [1, 16], dt = softplus(dt_bias) in [1e-3, 0.1] and
    the conv weights within +-1/sqrt(channels)."""
    jcfg, jmodel, jparams, cfg, model, _ = pair
    sd = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(model.state_dict())
    assert model.param_count() == jmodel.param_count() == params.param_count(cfg)
    full = get_config("mamba2-370m")
    assert params.param_count(full) == jax_build_model(
        jax_get_config("mamba2-370m")).param_count()
    a = build_model(cfg, device="cpu", seed=7).layers[1].mamba
    assert torch.equal(a.conv_x, build_model(cfg, device="cpu", seed=7)
                       .layers[1].mamba.conv_x)
    assert a.conv_x.shape == jparams["stack"]["units"]["mamba"]["conv_x"].shape[1:]
    A = a.A_log.exp()
    assert (A >= 1).all() and (A <= 16).all()
    dt = torch.nn.functional.softplus(a.dt_bias)
    assert (dt >= 1e-3 * 0.999).all() and (dt <= 0.1 * 1.001).all()
    bound = 1 / math.sqrt(cfg.ssm_d_inner)
    assert a.conv_x.abs().max() <= bound and a.conv_x.std() > bound / 3
    assert torch.equal(a.D, torch.ones(cfg.ssm_heads))


# ----------------------------------------------------------------------
# the unified engine
# ----------------------------------------------------------------------
def _stream(vocab):
    """Two runs: prompts 7 / 16 / 21 / 30 through two slots, then a lone
    one-token request (it retires at its prefill with nothing to decode:
    a triple of its own)."""
    rng = np.random.default_rng(2)
    lens, gens = [7, 16, 21, 30, 5], [8, 8, 8, 8, 1]
    reqs = [(rng.integers(0, vocab, (n,)).astype(np.int32), g)
            for n, g in zip(lens, gens)]
    return [reqs[:4], reqs[4:]]


def _serve(eng, tracer, stream):
    out, reqs = {}, []
    for run in stream:
        reqs += [eng.submit(p, g) for p, g in run]
        out.update(eng.run())
    evs = tracer.finish().events
    keep = ~np.isin(evs["type"], [ev.EV_REQ_TTFT_US, ev.EV_REQ_TPOT_US])
    counters = {k: eng.stats[k] for k in (
        "prefills", "prefill_tokens", "tokens_decoded", "decode_dispatches",
        "decode_syncs", "host_syncs", "iterations", "preemptions",
        "prefix_hit_tokens", "peak_active")}
    return ([out[r.rid] for r in reqs], counters,
            np.stack([evs["type"][keep], evs["value"][keep]], 1))


@pytest.fixture(scope="module")
def served(pair):
    jcfg, _, jparams, cfg, model, _ = pair
    stream = _stream(cfg.vocab_size)
    kw = dict(num_slots=2, max_len=48)
    tracer = Tracer("ledger").init()
    mine = _serve(UnifiedServeEngine(cfg, model, device="cpu", tracer=tracer,
                                     **kw), tracer, stream)
    jtracer = JaxTracer("ledger").init()
    theirs = _serve(JaxUnifiedEngine(jcfg, jparams, tracer=jtracer, **kw),
                    jtracer, stream)
    return stream, mine, theirs


def test_unified_greedy_streams_match_full_recompute_oracle(pair, served):
    *_, oracle = pair
    stream, (toks, counters, _), _ = served
    for (prompt, gen), got in zip(sum(stream, []), toks):
        np.testing.assert_array_equal(got, oracle(prompt, gen))
    assert counters["decode_syncs"] == counters["decode_dispatches"]
    assert counters["prefills"] == 5


def test_unified_counters_and_trace_ledger_match_jax_engine(served):
    """Host counters and the trace ledger value for value: admit/retire
    order, the per-dispatch EV_STEP_BUDGET / CHUNK / DECODE triples with
    each whole prompt folded into the next dispatch's triple (and the lone
    triple of a prompt that retires at its prefill); no pool gauges and no
    kernel-variant stamps (no attention)."""
    stream, (_, counters, ledger), (_, jcounters, jledger) = served
    assert counters == jcounters
    np.testing.assert_array_equal(ledger, jledger)
    by = {c: ledger[ledger[:, 0] == c, 1] for c in (
        ev.EV_STEP_BUDGET, ev.EV_CHUNK_TOKENS, ev.EV_DECODE_TOKENS)}
    assert len(by[ev.EV_STEP_BUDGET]) == 5  # one a prompt: 4 folded + 1 lone
    np.testing.assert_array_equal(
        by[ev.EV_STEP_BUDGET], by[ev.EV_CHUNK_TOKENS] + by[ev.EV_DECODE_TOKENS])
    assert by[ev.EV_CHUNK_TOKENS].sum() == sum(len(p) for p, _ in sum(stream, []))
    assert by[ev.EV_DECODE_TOKENS][-1] == 0  # the one-token request's triple
    assert by[ev.EV_STEP_BUDGET][-1] == len(stream[1][0][0])
    assert not np.isin(ledger[:, 0], [ev.EV_KERNEL_VARIANT, ev.EV_BLOCKS_FREE]).any()


def test_engines_without_a_pool_and_refusals(pair):
    *_, cfg, model, _ = pair
    eng = UnifiedServeEngine(cfg, model, device="cpu", num_slots=2, max_len=16)
    assert eng.pool is None and eng.kv_bytes_per_token == 0
    assert not eng.prefix_cache and not eng.chunkable
    assert not model.fully_paged() and not any(model.paged_leaf_mask().values())
    legacy = ContinuousServeEngine(cfg, model, device="cpu", num_slots=1,
                                   max_len=16)
    assert legacy.pool is None and legacy.kv_bytes_per_token == 0
    assert not legacy.prefix_cache
    req = legacy.submit(np.arange(5, dtype=np.int32), 3)
    assert len(legacy.run()[req.rid]) == 3
    static = ServeEngine(cfg, model, device="cpu", max_len=16)
    assert static.generate(np.arange(5, dtype=np.int32)[None],
                           num_tokens=3).shape == (1, 3)
    with pytest.raises(ValueError, match="attention-only"):
        model.span_step({}, torch.zeros((1, 2), dtype=torch.int32),
                        *(torch.zeros(1, dtype=torch.int32),) * 2,
                        torch.zeros((1, 1), dtype=torch.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            UnifiedServeEngine(cfg, num_slots=1, max_len=16)
