"""Torch port, the vlm family (internvl2-2b: the dense decoder over
projected patch embeddings) on the CPU, on ``reduced(internvl2-2b)``: 2
layers, 8 patches of width 64 a request, against the JAX package on the
same weights (``model.init(PRNGKey(0))`` through
``convert.params_from_jax``).

* ``vision_proj`` and the patches concatenated before the tokens: every
  text position, decode index and capacity check shifted by
  ``num_patches``; ``forward`` / ``prefill`` / ``decode_step`` logits
  against the JAX jitted functions;
* request extras through the engines: grouped by their shapes, batched
  into one prefill, dropped at retirement, kept across a preemption;
  never a prefix hit, even for prompts that share their text;
* the unified, grouped-prefill and fixed-batch engines against a greedy
  full-recompute oracle (the JAX ``forward`` with the request's patches
  each token), native and over int8/fp8 pools, unified == legacy bit for
  bit, and the host counters and trace ledgers of the JAX engines value
  for value (tokens never come from the JAX engines: ROADMAP.md Faults);
* the refusals the reference makes (fan-out, the spec lane, sessions,
  beam search, the chunk paths)."""
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

ARCH = "internvl2-2b"
LOGIT_TOL = 1e-4  # float32 logits, different op order (absolute)
ORACLE_LEN = 48  # fixed text length: causal logits ignore right padding
GEN = 6
ENGINES = {"unified": (UnifiedServeEngine, JaxUnifiedEngine),
           "legacy": (ContinuousServeEngine, JaxLegacyEngine)}


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_get_config(ARCH))
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(ARCH))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    fwd = jax.jit(lambda p, t, e: jmodel.forward(
        p, {"tokens": t, "patch_embeds": e})[0])
    p0 = cfg.num_patches

    def oracle(prompt, patches, n):
        """Greedy full recompute: forward() over patches + context."""
        ctx = list(prompt)
        for _ in range(n):
            buf = np.zeros((1, ORACLE_LEN), np.int32)
            buf[0, :len(ctx)] = ctx
            logits = np.asarray(fwd(jparams, jnp.asarray(buf),
                                    jnp.asarray(patches[None])))
            ctx.append(int(np.argmax(
                logits[0, p0 + len(ctx) - 1, :cfg.vocab_size])))
        return np.asarray(ctx[len(prompt):], np.int32)

    return jcfg, jmodel, jparams, cfg, model, oracle


def _patches(cfg, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.num_patches, cfg.vision_dim)).astype(np.float32)


@pytest.fixture(scope="module")
def stream(pair):
    """Four requests in two pairs that share a 16-token text prefix (a
    whole block at block size 16), each with its own patches."""
    *_, cfg, _, _ = pair
    rng = np.random.default_rng(5)
    heads = [rng.integers(0, cfg.vocab_size, (16,)).astype(np.int32)
             for _ in range(2)]
    tails = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
             for n in (4, 9, 9, 14)]
    prompts = [np.concatenate([heads[i // 2], t]) for i, t in enumerate(tails)]
    return prompts, list(_patches(cfg, 4, seed=6))


@pytest.fixture(scope="module")
def want(pair, stream):
    *_, oracle = pair
    return [oracle(p, e, GEN) for p, e in zip(*stream)]


def _serve(eng, prompts, patches, gen=GEN):
    reqs = [eng.submit(p, gen, extras={"patch_embeds": e})
            for p, e in zip(prompts, patches)]
    out = eng.run()
    return [out[r.rid] for r in reqs], reqs


def test_params_from_jax_and_decls(pair):
    """``vision_proj.{w, b}`` (b f32) beside the dense tree; the same
    counts as JAX at reduced and full width."""
    _, jmodel, jparams, cfg, model, _ = pair
    sd = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(model.state_dict())
    assert {"vision_proj.w", "vision_proj.b"} <= set(sd)
    assert model.vision_proj["w"].shape == (cfg.vision_dim, cfg.d_model)
    assert model.vision_proj["b"].dtype == torch.float32
    assert model.param_count() == jmodel.param_count() == params.param_count(cfg)
    assert params.param_count(get_config(ARCH)) == jax_build_model(
        jax_get_config(ARCH)).param_count() == 1_891_733_504
    seeded = build_model(cfg.replace(dtype="bfloat16"), device="cpu", seed=2)
    assert seeded.vision_proj["b"].dtype == torch.float32
    assert not seeded.vision_proj["b"].any()


def test_forward_prefill_decode_match_jax(pair):
    """Patches prefill before 21 text tokens; decode runs at positions
    P + 21 onward."""
    jcfg, jmodel, jparams, cfg, model, _ = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 21))
    toks = toks.astype(np.int32)
    pe = _patches(cfg, 2, seed=1)
    batch = {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)}
    t, e = torch.from_numpy(toks), torch.from_numpy(pe)
    jl = jax.jit(lambda p, b: jmodel.forward(p, b)[0])(jparams, batch)
    logits = model(t, e)
    assert logits.shape == (2, cfg.num_patches + 21, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               atol=LOGIT_TOL, rtol=0)
    jc, jlast = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len=40))(
        jparams, batch)
    caches, last = model.prefill(t, max_len=40, patch_embeds=e)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               atol=LOGIT_TOL, rtol=0)
    for n in "kv":
        np.testing.assert_allclose(caches[n].numpy(),
                                   np.asarray(jc["units"][n]), atol=1e-5,
                                   rtol=0)
    dec = jax.jit(jmodel.decode_step)
    tok = np.asarray(jlast).argmax(-1).astype(np.int32)
    for i in range(3):
        idx = np.full((2,), cfg.num_patches + 21 + i, np.int32)
        jc, jlog = dec(jparams, jc, jnp.asarray(tok), jnp.asarray(idx))
        tlog = model.decode_step(caches, torch.from_numpy(tok),
                                 torch.from_numpy(idx))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=0)
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)


def test_patches_shift_every_text_position(pair):
    """Text token i sits at P + i: prefill then decode at P + S equals
    forward() at the same positions; other patches give other logits;
    a vlm without patches is refused."""
    *_, cfg, model, _ = pair
    p0 = cfg.num_patches
    full = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 20)).astype(np.int32))
    e = torch.from_numpy(_patches(cfg, 1, seed=4))
    ref = model(full, e)
    caches, last = model.prefill(full[:, :12], max_len=32, patch_embeds=e)
    torch.testing.assert_close(last, ref[:, p0 + 11], atol=LOGIT_TOL, rtol=0)
    for j in range(12, 20):
        lg = model.decode_step(caches, full[:, j],
                               torch.tensor([p0 + j], dtype=torch.int32))
        torch.testing.assert_close(lg, ref[:, p0 + j], atol=LOGIT_TOL, rtol=0)
    other = model(full, torch.from_numpy(_patches(cfg, 1, seed=5)))
    assert (other[:, p0:] - ref[:, p0:]).abs().max() > 1e-3
    with pytest.raises(ValueError, match="patch_embeds"):
        model(full)


@pytest.mark.parametrize("kv_dtype,per_token", [
    ("fp16", 98_304), ("int8", 50_688)])
def test_full_width_pool_bytes_per_token(kv_dtype, per_token):
    """24 layers x K, V x 8 kv heads x 128 x 2 B; int8: 128 codes + one
    4 B scale a kv head."""
    cfg = get_config(ARCH).replace(kv_dtype=kv_dtype)
    spec = transformer.stack_paged_cache_spec(cfg, 1, 16, torch.bfloat16)
    block = sum(np.prod(s) * torch.empty((), dtype=dt).element_size()
                for s, dt in spec.values())
    assert block // 16 == per_token


@pytest.mark.parametrize("engine", ["unified", "legacy", "static"])
def test_engines_match_full_recompute_oracle(pair, stream, want, engine):
    """Two slots, four requests: queueing, slot reuse and, with the
    prefix cache requested, no hit (patch prompts are off the token
    grid)."""
    *_, cfg, model, _ = pair
    prompts, patches = stream
    if engine == "static":
        eng = ServeEngine(cfg, model, device="cpu", max_len=48)
        got = [eng.generate(p[None], num_tokens=GEN,
                            extras={"patch_embeds": e[None]})[0]
               for p, e in zip(prompts, patches)]
    else:
        eng = ENGINES[engine][0](cfg, model, device="cpu", num_slots=2,
                                 max_len=48, prefix_cache=True)
        assert not eng.prefix_cache
        got, reqs = _serve(eng, prompts, patches)
        assert eng.stats["prefix_hit_tokens"] == 0
        assert all(r.prefix_hit_tokens == 0 and not r.extras for r in reqs)
        assert eng.pool.stats["hit_blocks"] == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_static_batch_takes_the_patch_offset(pair, stream, want):
    """A rectangular B 2 batch of the two 25-token prompts."""
    *_, cfg, model, _ = pair
    prompts, patches = stream
    eng = ServeEngine(cfg, model, device="cpu", max_len=48)
    got = eng.generate(np.stack(prompts[1:3]), num_tokens=GEN,
                       extras={"patch_embeds": np.stack(patches[1:3])})
    for g, w in zip(got, want[1:3]):
        np.testing.assert_array_equal(g, w)


def test_capacity_counts_the_patches(pair):
    """max_len 32 holds 32 positions: 20 text + 8 patches + 5 new - 1 =
    32 fits, one more token does not (it would without the patches)."""
    *_, cfg, model, _ = pair
    eng = UnifiedServeEngine(cfg, model, device="cpu", num_slots=1, max_len=32)
    p = np.arange(20, dtype=np.int32)
    e = {"patch_embeds": _patches(cfg, 1, seed=0)[0]}
    eng.submit(p, 5, extras=e)
    with pytest.raises(ValueError, match="capacity 33 > 32"):
        eng.submit(p, 6, extras=e)
    assert eng._start_index(eng.queue.peek()) == 20 + cfg.num_patches


def test_extras_sign_the_prefill_groups(pair, stream):
    """Same text length and patch shape: one B 2 group whose patches are
    stacked in one prefill; a request whose patches have another shape
    groups apart."""
    *_, cfg, model, _ = pair
    prompts, patches = stream
    eng = ContinuousServeEngine(cfg, model, device="cpu", num_slots=3,
                                max_len=48, num_blocks=16,
                                max_prefills_per_iter=3)
    eng.submit(prompts[1], 4, extras={"patch_embeds": patches[1]})
    eng.submit(prompts[2], 4, extras={"patch_embeds": patches[2]})
    eng.submit(prompts[2], 4, extras={"patch_embeds": patches[2][:4]})
    groups = eng._prefill_groups(eng.scheduler.admissions())
    assert [len(g) for g in groups] == [2, 1]
    seen = []
    real = eng._prefill_impl
    eng._prefill_impl = lambda t, ex, *a, **k: (
        seen.append((tuple(t.shape), {n: tuple(v.shape) for n, v in ex.items()}))
        or real(t, ex, *a, **k))
    with torch.inference_mode():
        eng._do_prefill(groups[0])
    assert seen == [((2, 25), {"patch_embeds": (2, cfg.num_patches,
                                                cfg.vision_dim)})]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_counters_and_ledger_match_jax_engine(pair, stream, engine):
    """The host counters and the trace ledger (admit / retire order, block
    gauges, prefix-hit events of 0, prefill phases, kernel-variant stamps
    and, unified, the whole prompts, patches included, folded into the
    budget triples) equal the JAX engine's value for value."""
    jcfg, _, jparams, cfg, model, _ = pair
    prompts, patches = stream
    mine_cls, jax_cls = ENGINES[engine]
    kw = dict(num_slots=2, max_len=48)
    results = []
    for tracer, make in (
            (Tracer("vlm"), lambda tr: mine_cls(cfg, model, device="cpu",
                                                tracer=tr, **kw)),
            (JaxTracer("vlm"), lambda tr: jax_cls(jcfg, jparams, tracer=tr,
                                                  **kw))):
        tracer.init()
        eng = make(tracer)
        _serve(eng, prompts, patches)
        counters = {k: eng.stats[k] for k in (
            "prefills", "prefill_tokens", "tokens_decoded", "decode_dispatches",
            "decode_syncs", "host_syncs", "iterations", "preemptions",
            "prefix_hit_tokens", "peak_active", "peak_blocks")}
        evs = tracer.finish().events
        keep = ~np.isin(evs["type"], [ev.EV_REQ_TTFT_US, ev.EV_REQ_TPOT_US])
        results.append((counters,
                        np.stack([evs["type"][keep], evs["value"][keep]], 1)))
    (mine, ledger), (theirs, jledger) = results
    assert mine == theirs
    assert mine["prefill_tokens"] == sum(len(p) for p in prompts) \
        + 4 * cfg.num_patches
    np.testing.assert_array_equal(ledger, jledger)
    hits = ledger[ledger[:, 0] == ev.EV_PREFIX_HIT_TOKENS, 1]
    assert len(hits) == 4 and not hits.any()
    if engine == "unified":
        by = {c: ledger[ledger[:, 0] == c, 1] for c in (
            ev.EV_STEP_BUDGET, ev.EV_CHUNK_TOKENS, ev.EV_DECODE_TOKENS)}
        np.testing.assert_array_equal(
            by[ev.EV_STEP_BUDGET],
            by[ev.EV_CHUNK_TOKENS] + by[ev.EV_DECODE_TOKENS])
        assert by[ev.EV_CHUNK_TOKENS].sum() == mine["prefill_tokens"]


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "fp8"])
def test_unified_equals_legacy_bit_for_bit(pair, stream, kv_dtype):
    *_, cfg, model, _ = pair
    prompts, patches = stream
    c = cfg.replace(kv_dtype=kv_dtype)
    outs = [_serve(cls(c, model, device="cpu", num_slots=2, max_len=48),
                   prompts, patches)[0] for cls, _ in ENGINES.values()]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_preemption_keeps_the_patches(pair, stream):
    """Under a tight pool the legacy engine preempts; the victim keeps its
    patches, re-prefills patches + prompt + tokens and ends with the
    tokens it gets alone; every request's extras are dropped at the
    end."""
    *_, cfg, model, _ = pair
    prompts, patches = stream
    eng = ContinuousServeEngine(cfg, model, device="cpu", num_slots=2,
                                max_len=64, block_size=8, num_blocks=12,
                                max_prefills_per_iter=2)
    got, reqs = _serve(eng, prompts[2:], patches[2:], gen=14)
    assert eng.stats["preemptions"] > 0 and not any(r.extras for r in reqs)
    for p, e, g in zip(prompts[2:], patches[2:], got):
        solo = ContinuousServeEngine(cfg, model, device="cpu", num_slots=1,
                                     max_len=64)
        np.testing.assert_array_equal(g, _serve(solo, [p], [e], gen=14)[0][0])


def test_refusals_mirror_the_reference(pair):
    *_, cfg, model, _ = pair
    eng = UnifiedServeEngine(cfg, model, device="cpu", num_slots=2, max_len=48)
    p = np.arange(16, dtype=np.int32)
    e = {"patch_embeds": _patches(cfg, 1, seed=0)[0]}
    assert not eng.chunkable and not eng.supports_fork
    with pytest.raises(ValueError, match="n_samples"):
        eng.submit(p, 4, extras=e, n_samples=2)
    with pytest.raises(ValueError, match="prefix"):
        eng.submit(p, 4, extras=e, session="a")
    with pytest.raises(ValueError, match="beam_search"):
        eng.beam_search(p, 4, width=2)
    with pytest.raises(ValueError, match="speculative"):
        UnifiedServeEngine(cfg, model, device="cpu", num_slots=2, max_len=48,
                           spec=NGramProposer())
    with pytest.raises(ValueError, match="attention-only"):
        model.span_step({}, p[None], *(p[:1],) * 2, p[None])


@pytest.mark.parametrize("mode", ["unified", "continuous", "static"])
def test_cli_serves_internvl2(capsys, mode):
    """The JAX CLI's seeded patches (default_rng(1)); max_len counts
    them."""
    assert serve_cli.main(["--device", "cpu", "--arch", ARCH, "--mode", mode,
                           "--requests", "3", "--slots", "2",
                           "--prompt-len", "12", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert f"mode={mode}" in out and "12 tokens" in out, out
    if mode != "static":
        assert "paged pool" in out and "0 prefix-hit tokens" in out, out
    if mode == "unified":
        assert "chunked prefill off — patch embeddings" in out, out
    extras = serve_cli._request_extras(reduced(get_config(ARCH)),
                                       np.random.default_rng(1), 3)
    assert extras["patch_embeds"].shape == (3, 8, 64)
