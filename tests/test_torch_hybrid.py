"""Torch port, the hybrid family (recurrentgemma-9b: RG-LRU layers beside
local-attention layers) on the CPU, on ``reduced(recurrentgemma-9b,
num_layers=5)``: one (rec, rec, attn) unit and a tail of two rec layers,
a 16-token attention window, against the JAX package on the same
weights (``model.init(PRNGKey(0))`` through ``convert.params_from_jax``).

* the flat layer list in the JAX run order (units, then the tail);
* ``forward`` / ``prefill`` / ``decode_step`` logits and caches against
  the JAX jitted functions within ``LOGIT_TOL``, prompts past the window;
* the mixed cache tree: attention K/V pooled, RG-LRU state slot-indexed;
* the unified, grouped-prefill and fixed-batch engines against a greedy
  full-recompute oracle (the JAX ``forward`` over the whole context each
  token), native and over int8/fp8 pools, and unified == legacy bit for
  bit inside the port;
* the unified and legacy engines' host counters and trace ledgers (admit
  / preempt / retire order, block gauges, budget triples) equal to the
  JAX engines' value for value (tokens never come from the JAX engines:
  ROADMAP.md Faults);
* the refusals the reference makes: fan-out, the spec lane, sessions,
  beam search and the chunk-resumable model paths."""
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
from repro.serve.step import UnifiedServeEngine as JaxUnifiedEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core.tracer import Tracer  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import convert, params, transformer  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine  # noqa: E402
from repro_torch.serve.spec import NGramProposer  # noqa: E402
from repro_torch.serve.step import UnifiedServeEngine  # noqa: E402

ARCH = "recurrentgemma-9b"
LOGIT_TOL = 1e-4  # float32 logits, scan vs associative scan (absolute)
STATE_TOL = 1e-5  # float32 cache leaves
ORACLE_LEN = 64  # fixed forward length: causal logits ignore right padding
LENS = [7, 20, 20, 33]  # two 20s: a same-length group; 20 and 33 > window
GEN = 8
ENGINES = {"unified": (UnifiedServeEngine, JaxUnifiedEngine),
           "legacy": (ContinuousServeEngine, JaxLegacyEngine)}


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_get_config(ARCH), num_layers=5)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(ARCH), num_layers=5)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    fwd = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t})[0])

    def oracle(prompt, n):
        """Greedy full recompute: forward() over the whole context."""
        ctx = list(prompt)
        for _ in range(n):
            buf = np.zeros((1, ORACLE_LEN), np.int32)
            buf[0, :len(ctx)] = ctx
            logits = np.asarray(fwd(jparams, jnp.asarray(buf)))
            ctx.append(int(np.argmax(logits[0, len(ctx) - 1, :cfg.vocab_size])))
        return np.asarray(ctx[len(prompt):], np.int32)

    return jcfg, jmodel, jparams, cfg, model, oracle


@pytest.fixture(scope="module")
def stream(pair):
    *_, cfg, _, _ = pair
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def want(pair, stream):
    *_, oracle = pair
    return [oracle(p, GEN) for p in stream]


def _rec_index(stack, sub, u):
    """The port's rec ordinal of the JAX rec leaf (stack, sub, u)."""
    return 2 * u + int(sub[3:]) if stack == "units" else 2 + int(sub[3:])


def test_params_from_jax_follow_the_run_order(pair):
    """Units then tail: layers 0, 1, 3, 4 are rec and 2 is attention;
    layers 3 and 4 hold the JAX tail's sub0 and sub1."""
    _, _, jparams, cfg, model, _ = pair
    assert [type(m).__name__ for m in model.layers] == \
        ["RecLayer", "RecLayer", "DenseLayer", "RecLayer", "RecLayer"]
    assert [k for k, *_ in params.layer_plan(cfg)] == \
        ["rec", "rec", "attn", "rec", "rec"]
    st = jparams["stack"]
    np.testing.assert_array_equal(model.layers[2].attn.wq.numpy(),
                                  np.asarray(st["units"]["sub2"]["attn"]["wq"]["w"][0]))
    for i, sub in ((3, "sub0"), (4, "sub1")):
        np.testing.assert_array_equal(
            model.layers[i].rec.lam.numpy(),
            np.asarray(st["tail"][sub]["rec"]["lam"][0]))
        np.testing.assert_array_equal(
            model.layers[i].mlp.w_down.numpy(),
            np.asarray(st["tail"][sub]["mlp"]["w_down"]["w"][0]))


def test_seeded_init_matches_jax_decls(pair):
    """The same tree and counts (reduced and full width), the RG-LRU's
    a = exp(-8 softplus(lam)) in [0.9, 0.999] and the conv weights within
    +-1/sqrt(lru)."""
    _, jmodel, jparams, cfg, model, _ = pair
    sd = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(model.state_dict())
    assert model.param_count() == jmodel.param_count() == params.param_count(cfg)
    full = params.param_count(get_config(ARCH))
    assert full == jax_build_model(jax_get_config(ARCH)).param_count() \
        == 8_578_519_040
    seeded = build_model(cfg, device="cpu", seed=3)
    rec = seeded.layers[4].rec
    a = torch.exp(-8.0 * torch.nn.functional.softplus(rec.lam))
    assert (a >= 0.9 - 1e-6).all() and (a <= 0.999 + 1e-6).all()
    assert rec.conv_w.abs().max() <= cfg.lru_width ** -0.5
    assert torch.equal(rec.rg_a_b, torch.zeros_like(rec.rg_a_b))


def test_forward_prefill_decode_match_jax(pair):
    """37-token prompts (past the 16-token window), then four decode steps
    from the prefilled caches: logits, attention K/V and RG-LRU state."""
    jcfg, jmodel, jparams, cfg, model, _ = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 37))
    toks = toks.astype(np.int32)
    jl = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t})[0])(
        jparams, jnp.asarray(toks))
    np.testing.assert_allclose(model(torch.from_numpy(toks)).numpy(),
                               np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    jc, jlast = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t},
                                                    max_len=48))(
        jparams, jnp.asarray(toks))
    caches, last = model.prefill(torch.from_numpy(toks), max_len=48)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               atol=LOGIT_TOL, rtol=0)
    assert sorted(caches) == ["conv", "k", "lru", "v"]
    assert caches["k"].shape == (1, 2, 16, 1, 32)  # the ring: the window
    assert caches["lru"].shape == (4, 2, cfg.lru_width)

    def check(caches, jc):
        for n in "kv":
            np.testing.assert_allclose(caches[n][0].numpy(),
                                       np.asarray(jc["units"]["sub2"][n][0]),
                                       atol=STATE_TOL, rtol=0)
        for stack, node in jc.items():
            for sub, leaves in node.items():
                if "lru" not in leaves:
                    continue
                for u in range(leaves["lru"].shape[0]):
                    r = _rec_index(stack, sub, u)
                    for n in ("lru", "conv"):
                        np.testing.assert_allclose(
                            caches[n][r].numpy(), np.asarray(leaves[n][u]),
                            atol=STATE_TOL, rtol=0)

    check(caches, jc)
    dec = jax.jit(jmodel.decode_step)
    tok = np.asarray(jlast).argmax(-1).astype(np.int32)
    for i in range(4):
        idx = np.full((2,), 37 + i, np.int32)
        jc, jlog = dec(jparams, jc, jnp.asarray(tok), jnp.asarray(idx))
        tlog = model.decode_step(caches, torch.from_numpy(tok),
                                 torch.from_numpy(idx))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=0)
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)
    check(caches, jc)


def test_prefill_then_decode_equals_teacher_forced_forward(pair):
    *_, cfg, model, _ = pair
    full = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    full = torch.from_numpy(full.astype(np.int32))
    ref_logits = model(full)
    caches, last = model.prefill(full[:, :22], max_len=40)
    torch.testing.assert_close(last, ref_logits[:, 21], atol=LOGIT_TOL, rtol=0)
    for j in range(22, 40):
        lg = model.decode_step(caches, full[:, j],
                               torch.full((2,), j, dtype=torch.int32))
        torch.testing.assert_close(lg, ref_logits[:, j], atol=LOGIT_TOL, rtol=0)


def test_paged_tree_is_mixed(pair):
    """K/V of the one attention layer pooled; the four rec layers' state
    slot-indexed; not fully paged, so no prefix cache and no chunks."""
    jcfg, jmodel, _, cfg, model, _ = pair
    spec = model.paged_cache_specs(3, 9, 8)
    assert spec["k"][0] == (1, 9, 8, 1, 32)
    assert spec["lru"] == ((4, 3, cfg.lru_width), torch.float32)
    assert spec["conv"][0] == (4, 3, cfg.conv_width - 1, cfg.lru_width)
    assert model.paged_leaf_mask() == {"k": True, "v": True, "lru": False,
                                       "conv": False}
    assert not model.fully_paged() and not jmodel.fully_paged()
    eng = UnifiedServeEngine(cfg, model, device="cpu", num_slots=2, max_len=32)
    assert not eng.chunkable and not eng.prefix_cache and eng.pool is not None


@pytest.mark.parametrize("kv_dtype,per_token", [
    ("fp16", 12_288), ("int8", 6_240), ("fp8", 6_240)])
def test_full_width_pool_bytes_per_token(kv_dtype, per_token):
    """12 attention layers x K, V x 256 x 2 B in bf16; 256 codes + one
    4 B scale a kv head quantized (the 26 rec layers pool nothing)."""
    cfg = get_config(ARCH).replace(kv_dtype=kv_dtype)
    spec = transformer.stack_paged_cache_spec(cfg, 1, 16, torch.bfloat16)
    block = sum(np.prod(s) * torch.empty((), dtype=dt).element_size()
                for s, dt in spec.values())
    assert spec["k"][0][0] == 12 and block // 16 == per_token


def _serve(eng, prompts, gen=GEN):
    reqs = [eng.submit(p, gen) for p in prompts]
    out = eng.run()
    return [out[r.rid] for r in reqs]


@pytest.mark.parametrize("engine", ["unified", "legacy", "static"])
def test_engines_match_full_recompute_oracle(pair, stream, want, engine):
    """Two slots, four prompts (7, 20, 20, 33 tokens; positions past the
    window on both the prefill and the decode side): queueing and slot
    reuse; the fixed-batch engine over its window ring, prompt by
    prompt."""
    *_, cfg, model, _ = pair
    if engine == "static":
        eng = ServeEngine(cfg, model, device="cpu", max_len=48)
        got = [eng.generate(p[None], num_tokens=GEN)[0] for p in stream]
    else:
        cls = ENGINES[engine][0]
        eng = cls(cfg, model, device="cpu", num_slots=2, max_len=48)
        got = _serve(eng, stream)
        assert eng.stats["prefix_hit_tokens"] == 0
        assert set(eng.stats["kernel_dispatch"]) == {"dense:torch",
                                                     "paged_decode:torch"}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_grouped_prefill_writes_blocks_and_slots(pair, stream):
    """The two 20-token prompts prefill as one B 2 group: each slot's
    RG-LRU state equals its prompt prefilled alone, and its blocks hold
    its own K/V."""
    *_, cfg, model, _ = pair
    same = [p for p in stream if len(p) == 20]
    eng = ContinuousServeEngine(cfg, model, device="cpu", num_slots=2,
                                max_len=48, block_size=8,
                                max_prefills_per_iter=2)
    reqs = [eng.submit(p, 4) for p in same]
    groups = eng._prefill_groups(eng.scheduler.admissions())
    assert [len(g) for g in groups] == [2]
    with torch.inference_mode():
        eng._do_prefill(groups[0])
        for req, p in zip(reqs, same):
            alone, _ = model.prefill(torch.from_numpy(p[None]), max_len=24,
                                     ring=False)
            for n in ("lru", "conv"):
                torch.testing.assert_close(eng._caches[n][:, req.slot],
                                           alone[n][:, 0], atol=STATE_TOL,
                                           rtol=0)
            blocks = eng._slot_blocks[req.slot]
            k = eng._caches["k"][:, blocks].reshape(1, -1, 1, 32)[:, :20]
            torch.testing.assert_close(k, alone["k"][:, 0, :20],
                                       atol=STATE_TOL, rtol=0)
    assert eng.stats["host_syncs"] == 1


def _pressure_stream(vocab):
    rng = np.random.default_rng(8)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (18, 22, 9)]


_PRESSURE = dict(num_slots=2, max_len=48, block_size=8, num_blocks=9)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_counters_and_ledger_match_jax_engine_under_pressure(pair, engine):
    """A pool of 8 usable blocks for two 16-token generations: a decode
    burst preempts, the victim re-prefills its prompt and tokens (state
    rebuilt). The host counters and the trace ledger (admit / preempt /
    retire, block gauges, prefill phases, kernel-variant stamps and, for
    the unified engine, each whole prompt folded into the next
    dispatch's budget triple) equal the JAX engine's value for value."""
    jcfg, _, jparams, cfg, model, oracle = pair
    prompts = _pressure_stream(cfg.vocab_size)
    mine_cls, jax_cls = ENGINES[engine]
    results = []
    for tracer, make in (
            (Tracer("hybrid"), lambda tr: mine_cls(
                cfg, model, device="cpu", tracer=tr, **_PRESSURE)),
            (JaxTracer("hybrid"), lambda tr: jax_cls(
                jcfg, jparams, tracer=tr, **_PRESSURE))):
        tracer.init()
        eng = make(tracer)
        toks = _serve(eng, prompts, 16)
        eng.pool.check_invariants()
        counters = {k: eng.stats[k] for k in (
            "prefills", "prefill_tokens", "tokens_decoded", "decode_dispatches",
            "decode_syncs", "host_syncs", "iterations", "preemptions",
            "prefix_hit_tokens", "peak_active", "peak_blocks")}
        evs = tracer.finish().events
        keep = ~np.isin(evs["type"], [ev.EV_REQ_TTFT_US, ev.EV_REQ_TPOT_US])
        results.append((toks, counters,
                        np.stack([evs["type"][keep], evs["value"][keep]], 1)))
    (toks, mine, ledger), (_, theirs, jledger) = results
    assert mine["preemptions"] > 0 and mine == theirs
    np.testing.assert_array_equal(ledger, jledger)
    assert (ledger[:, 0] == ev.EV_BLOCKS_FREE).any()
    if engine == "unified":
        by = {c: ledger[ledger[:, 0] == c, 1] for c in (
            ev.EV_STEP_BUDGET, ev.EV_CHUNK_TOKENS, ev.EV_DECODE_TOKENS)}
        np.testing.assert_array_equal(
            by[ev.EV_STEP_BUDGET],
            by[ev.EV_CHUNK_TOKENS] + by[ev.EV_DECODE_TOKENS])
        assert by[ev.EV_CHUNK_TOKENS].sum() == mine["prefill_tokens"]
    for p, t in zip(prompts, toks):
        np.testing.assert_array_equal(t, oracle(p, 16))


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "fp8"])
def test_unified_equals_legacy_bit_for_bit(pair, stream, kv_dtype):
    """Inside the port the two paged engines run the same prefill and
    decode bodies: identical streams on every pool dtype; a quantized pool
    tracks the native one (greedy match >= 0.75)."""
    *_, cfg, model, _ = pair
    c = cfg.replace(kv_dtype=kv_dtype)
    outs = [_serve(cls(c, model, device="cpu", num_slots=2, max_len=48),
                   stream) for cls, _ in ENGINES.values()]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    native = _serve(UnifiedServeEngine(cfg, model, device="cpu", num_slots=2,
                                       max_len=48), stream)
    match = np.mean([(a == b).mean() for a, b in zip(outs[0], native)])
    assert match >= 0.75, f"greedy token match {match:.2f}"


def test_int8_ledger_matches_jax_engine(pair):
    jcfg, _, jparams, cfg, model, _ = pair
    prompts = _pressure_stream(cfg.vocab_size)
    ledgers, per_token = [], []
    for tracer, make in (
            (Tracer("int8"), lambda tr: UnifiedServeEngine(
                cfg.replace(kv_dtype="int8"), model, device="cpu", tracer=tr,
                **_PRESSURE)),
            (JaxTracer("int8"), lambda tr: JaxUnifiedEngine(
                jcfg.replace(kv_dtype="int8"), jparams, tracer=tr,
                **_PRESSURE))):
        tracer.init()
        eng = make(tracer)
        _serve(eng, prompts, 16)
        evs = tracer.finish().events
        keep = ~np.isin(evs["type"], [ev.EV_REQ_TTFT_US, ev.EV_REQ_TPOT_US])
        ledgers.append(np.stack([evs["type"][keep], evs["value"][keep]], 1))
        per_token.append(eng.kv_bytes_per_token)
    np.testing.assert_array_equal(*ledgers)
    assert per_token[0] == per_token[1] == 2 * (32 + 4)  # one attn layer
    dtype_vals = ledgers[0][ledgers[0][:, 0] == ev.EV_BLOCK_DTYPE, 1]
    assert set(dtype_vals) == {ev.BLOCK_DTYPE_IDS["int8"]}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_preemption_resume_equals_solos(pair, engine):
    """The preempted request re-prefills prompt + tokens (its RG-LRU state
    rebuilt by the scan) and ends with the tokens it gets alone."""
    *_, cfg, model, _ = pair
    cls = ENGINES[engine][0]
    prompts = _pressure_stream(cfg.vocab_size)
    eng = cls(cfg, model, device="cpu", **_PRESSURE)
    got = _serve(eng, prompts, 16)
    assert eng.stats["preemptions"] > 0 and eng.pool.num_active() == 0
    for p, g in zip(prompts, got):
        solo = cls(cfg, model, device="cpu", num_slots=1, max_len=48)
        np.testing.assert_array_equal(g, _serve(solo, [p], 16)[0])


def test_refusals_mirror_the_reference(pair):
    """Fan-out, the spec lane, sessions and beam search need the
    chunk-resumable span path; the model's chunk paths need an
    attention-only stack (JAX: test_serve_fork / test_serve_spec)."""
    *_, cfg, model, _ = pair
    eng = UnifiedServeEngine(cfg, model, device="cpu", num_slots=2, max_len=64)
    p = np.arange(16, dtype=np.int32)
    assert not eng.supports_fork
    with pytest.raises(ValueError, match="n_samples"):
        eng.submit(p, 4, n_samples=2)
    with pytest.raises(ValueError, match="prefix"):
        eng.submit(p, 4, session="a")
    with pytest.raises(ValueError, match="beam_search"):
        eng.beam_search(p, 4, width=2)
    with pytest.raises(ValueError, match="speculative"):
        UnifiedServeEngine(cfg, model, device="cpu", num_slots=2, max_len=48,
                           spec=NGramProposer())
    for call in (lambda: model.prefill_chunk(p[None], {}, 0),
                 lambda: model.span_step({}, p[None], *(p[:1],) * 2, p[None]),
                 lambda: model.cache_specs(1, 8)):
        with pytest.raises(ValueError, match="attention-only"):
            call()


@pytest.mark.parametrize("mode", ["unified", "continuous", "static"])
def test_cli_serves_recurrentgemma(capsys, mode):
    assert serve_cli.main(["--device", "cpu", "--arch", ARCH, "--mode", mode,
                           "--requests", "3", "--slots", "2",
                           "--prompt-len", "20", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert f"mode={mode}" in out and "12 tokens" in out, out
    if mode != "static":
        assert "paged pool" in out and "0 prefix-hit tokens" in out, out
    if mode == "unified":
        assert "chunked prefill off — state-carrying family" in out, out
