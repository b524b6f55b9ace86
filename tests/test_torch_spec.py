"""Torch port, the speculative decoding lane on the CPU, against the JAX
package on the same weights (``model.init(PRNGKey(0))`` through
``convert.params_from_jax``).

* ``core/sampling``: ``spec_accept`` at temperature 0 equals the JAX one
  exactly (ragged ``draft_len``, a padded vocab, inactive rows);
  ``target_log_probs`` within 1e-6; at temperature > 0 the rejection
  sampling keeps the target distribution (total variation below a stated
  bound over seeded trials, point-mass and draft-model proposals);
* ``serve/spec``: ``NGramProposer`` equals the JAX one on the same
  contexts; the draft-model proposer's contiguous cache layout;
* the engine: greedy spec decode (n-gram and draft model) equals the
  non-spec unified engine token for token, and the greedy full-recompute
  oracle from the JAX ``forward``; a self-draft accepts every draft;
  rejected drafts roll their blocks back and the pool is conserved; a
  spec-planned decode victim preempted by chunk planning; adaptive K;
  ``EV_SPEC_*`` in the merged ``.prv`` equal the engine's own stats (spec
  counters depend on token values, so they are never held to the JAX
  engine's); seeded sampling; the proposer factory and the refusals.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import sampling as jax_sampling  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serve import spec as jax_spec  # noqa: E402
from repro_torch import core as xtrace  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import sampling  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.spec import (DraftModelProposer, NGramProposer,  # noqa: E402
                                    make_proposer)
from repro_torch.serve.step import UnifiedServeEngine  # noqa: E402

ORACLE_LEN = 64  # fixed forward length: causal logits ignore right padding
LOGP_TOL = 1e-6  # target_log_probs, float32
# rejection sampling: total variation between the empirical distribution
# of N_TRIALS seeded draws and the target, on a vocab of 8.  The standard
# error of the TV is ~ sqrt(V / (2 pi N)) / 2 ~ 0.004 at N = 40000.
N_TRIALS = 40_000
TV_BOUND = 0.02

_SETUPS = {}


def _setup(arch="granite-8b", layers=2, seed=0, **kw):
    """(jax cfg, jax params, port cfg, port model on the same weights,
    greedy full-recompute oracle)."""
    key = (arch, layers, seed, tuple(sorted(kw.items())))
    if key in _SETUPS:
        return _SETUPS[key]
    jcfg = jax_reduced(jax_get_config(arch), num_layers=layers, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    cfg = reduced(get_config(arch), num_layers=layers, **kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    fwd = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t})[0])

    def oracle(prompt, n):
        ctx = list(prompt)
        for _ in range(n):
            buf = np.zeros((1, ORACLE_LEN), np.int32)
            buf[0, :len(ctx)] = ctx
            logits = np.asarray(fwd(jparams, jnp.asarray(buf)))
            ctx.append(int(np.argmax(logits[0, len(ctx) - 1, :cfg.vocab_size])))
        return np.asarray(ctx[len(prompt):], np.int32)

    _SETUPS[key] = (jcfg, jparams, cfg, model, oracle)
    return _SETUPS[key]


def _prompts(vocab, lens, seed=0, motif=None):
    """JAX ``tests/test_serve_spec.py``'s prompts: every other one tiled
    from a motif (drafts accepted), the rest random (drafts rejected)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, length in enumerate(lens):
        if motif is not None and i % 2 == 0:
            m = rng.integers(0, vocab, (motif,)).astype(np.int32)
            out.append(np.tile(m, -(-length // motif))[:length])
        else:
            out.append(rng.integers(0, vocab, (length,)).astype(np.int32))
    return out


def _serve(cfg, model, prompts, gen, **kw):
    kw = {"num_slots": 2, "max_len": 64, "block_size": 16, "chunk_size": 8,
          **kw}
    eng = UnifiedServeEngine(cfg, model, device="cpu", **kw)
    reqs = [eng.submit(p, g) for p, g in zip(
        prompts, gen if isinstance(gen, list) else [gen] * len(prompts))]
    out = eng.run()
    return eng, [out[r.rid] for r in reqs]


# ----------------------------------------------------------------------
# core/sampling
# ----------------------------------------------------------------------
def _accept_inputs(seed, b=6, k=4, vocab=40, vpad=48):
    """Seeded logits over a padded vocab (the pad columns hold the
    largest values, which the vocab slice must hide), drafts that follow
    the argmax for a random prefix, ragged draft_len with an inactive
    row."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, k + 1, vpad)).astype(np.float32)
    logits[..., vocab:] = 10.0
    tgt = logits[..., :vocab].argmax(-1)
    drafts = rng.integers(0, vocab, (b, k)).astype(np.int32)
    for i in range(b):
        n = rng.integers(0, k + 1)
        drafts[i, :n] = tgt[i, :n]
    draft_len = rng.integers(0, k + 1, (b,)).astype(np.int32)
    draft_len[0] = 0
    draft_len[1] = k
    drafts[1] = tgt[1, :k]  # a fully accepted row: the bonus position
    return logits, drafts, draft_len, vocab


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_accept_greedy_matches_jax(seed):
    logits, drafts, draft_len, vocab = _accept_inputs(seed)
    out, n_acc = sampling.spec_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(draft_len), None, None, 0.0, vocab)
    jout, jn = jax_sampling.spec_accept(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(draft_len), None,
        jax.random.PRNGKey(0), 0.0, vocab)
    assert out.dtype == n_acc.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jn))
    assert n_acc[0] == 0 and n_acc[1] == drafts.shape[1]
    assert (out.numpy() < vocab).all()


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.8),
                                         (7, 0.9)])
def test_target_log_probs_matches_jax(top_k, top_p):
    logits, _, _, vocab = _accept_inputs(3)
    got = sampling.target_log_probs(torch.from_numpy(logits), 0.7, vocab,
                                    top_k, top_p).numpy()
    want = np.asarray(jax_sampling.target_log_probs(
        jnp.asarray(logits), 0.7, vocab, top_k, top_p))
    assert got.shape == want.shape == logits.shape[:-1] + (vocab,)
    kept = want > -1e30
    np.testing.assert_array_equal(got > -1e30, kept)
    np.testing.assert_allclose(got[kept], want[kept], atol=LOGP_TOL, rtol=0)


def _tv(draws, p, vocab):
    freq = np.bincount(draws, minlength=vocab) / len(draws)
    return 0.5 * np.abs(freq - p).sum()


@pytest.mark.parametrize("proposal", ["point-mass", "draft-q", "q-equals-p"])
def test_rejection_sampling_keeps_the_target_distribution(proposal):
    """N_TRIALS rows share one target over a vocab of 8 at two span
    positions.  The first committed token must be distributed as p at
    position 0 whatever the proposal; with q == p every draft is accepted
    and the bonus token follows p at position K."""
    vocab, k = 8, 2
    rng = np.random.default_rng(11)
    lg = rng.standard_normal((k + 1, vocab)).astype(np.float32) * 1.5
    p = torch.softmax(torch.from_numpy(lg), -1).double().numpy()
    logits = torch.from_numpy(np.broadcast_to(lg, (N_TRIALS, k + 1, vocab)).copy())
    g = torch.Generator().manual_seed(5)
    if proposal == "point-mass":
        q = None
        drafts = torch.full((N_TRIALS, k), int(np.argsort(p[0])[-2]))
    else:
        qv = (np.full((k, vocab), 1.0 / vocab) if proposal == "draft-q"
              else p[:k])
        q = torch.from_numpy(np.broadcast_to(qv, (N_TRIALS, k, vocab)).copy()
                             ).float()
        drafts = torch.multinomial(q.reshape(-1, vocab), 1, generator=g
                                   ).reshape(N_TRIALS, k)
    draft_len = torch.full((N_TRIALS,), k, dtype=torch.int32)
    out, n_acc = sampling.spec_accept(logits, drafts, draft_len, q, g, 1.0,
                                      vocab)
    first = out[:, 0].numpy()
    assert _tv(first, p[0], vocab) < TV_BOUND
    if proposal == "q-equals-p":
        assert (n_acc == k).float().mean() > 0.99
        assert _tv(out[n_acc == k][:, k].numpy(), p[k], vocab) < TV_BOUND
    elif proposal == "point-mass":
        d = int(drafts[0, 0])
        assert abs((first == d).mean() - p[0, d]) < TV_BOUND


def test_spec_accept_draws_only_from_its_generator():
    logits, drafts, draft_len, vocab = _accept_inputs(4)
    args = (torch.from_numpy(logits), torch.from_numpy(drafts),
            torch.from_numpy(draft_len), None)
    runs = [sampling.spec_accept(*args, torch.Generator().manual_seed(s), 0.9,
                                 vocab)[0] for s in (1, 1)]
    torch.manual_seed(123)  # global state is not read
    again = sampling.spec_accept(*args, torch.Generator().manual_seed(1), 0.9,
                                 vocab)[0]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], again)


# ----------------------------------------------------------------------
# serve/spec: the proposers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ngram", [(3, 1), (2, 2), (4, 1)])
def test_ngram_proposer_matches_jax(ngram):
    rng = np.random.default_rng(9)
    motif = rng.integers(0, 50, (5,))
    contexts = [np.tile(motif, 4)[:17], rng.integers(0, 6, (23,)),
                np.array([7]), np.array([3, 3]), rng.integers(0, 50, (12,)),
                np.concatenate([rng.integers(0, 50, (9,)), motif[:2], [1],
                                motif[:2]])]
    for k in (1, 4, 6):
        mine = NGramProposer(*ngram).propose(list(range(6)), contexts, k)
        theirs = jax_spec.NGramProposer(*ngram).propose(list(range(6)),
                                                        contexts, k)
        assert mine[1] is None and theirs[1] is None
        np.testing.assert_array_equal(mine[0], theirs[0])
    with pytest.raises(ValueError, match="min_ngram"):
        NGramProposer(1, 2)


@pytest.mark.parametrize("kw", [{}, {"attention_window": 12}],
                         ids=["full", "swa"])
def test_cache_specs_match_jax(kw):
    jcfg, _, cfg, model, _ = _setup(**kw)
    mine = model.cache_specs(3, 40)
    theirs = jax_build_model(jcfg).cache_specs(3, 40)["units"]
    assert sorted(mine) == sorted(theirs) == ["k", "v"]
    for name, (shape, dt) in mine.items():
        assert shape == theirs[name].shape and dt == torch.float32
    ssm = build_model(reduced(get_config("mamba2-370m"), num_layers=1),
                      device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        ssm.cache_specs(1, 8)


# ----------------------------------------------------------------------
# the engine: greedy spec == non-spec == the oracle
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,kw", [
    ("granite-8b", {}),
    ("granite-8b", {"attention_window": 12}),
    ("yi-9b", {}),
], ids=["granite", "granite-swa", "yi"])
def test_spec_ngram_matches_non_spec_and_oracle(arch, kw):
    """Repetitive AND random prompts (acceptances and rejections), lengths
    crossing chunk and block edges (the JAX test's stream)."""
    _, _, cfg, model, oracle = _setup(arch, **kw)
    prompts = _prompts(cfg.vocab_size, [24, 7, 17, 30], seed=2, motif=6)
    _, ref = _serve(cfg, model, prompts, 10)
    eng, got = _serve(cfg, model, prompts, 10, spec=NGramProposer(), spec_k=4)
    for p, a, b in zip(prompts, ref, got):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, oracle(p, 10))
    st = eng.stats
    assert st["spec_dispatches"] > 0
    assert st["spec_drafted"] >= st["spec_accepted"] >= 0
    assert st["decode_syncs"] == st["decode_dispatches"] == st["spec_dispatches"]
    assert st["kernel_dispatch"] == {"paged_span:torch": st["host_syncs"]}


def test_spec_over_int8_pool_matches_non_spec():
    """A quantized pool: rejected drafts are quantized on write and
    overwritten before anything attends them, so the int8 spec stream is
    the int8 non-spec stream token for token."""
    _, _, base, model, _ = _setup()
    cfg = base.replace(kv_dtype="int8")
    prompts = _prompts(cfg.vocab_size, [24, 7, 17, 30], seed=2, motif=6)
    _, ref = _serve(cfg, model, prompts, 10)
    eng, got = _serve(cfg, model, prompts, 10, spec=NGramProposer(), spec_k=4)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    assert eng.stats["spec_drafted"] > eng.stats["spec_accepted"]
    assert eng.kv_storage == torch.int8


VERIFY_LOGIT_TOL = 1e-5  # float32 logits ~ O(1), BLAS summation order


def test_verify_row_logits_match_decode_rows_to_rounding():
    """A span row of one valid query against the paged decode path on the
    same pool: the logits agree to float32 rounding, NOT bit for bit (the
    CPU BLAS runs the projections of B rows and of B * Q rows through
    different kernels, so a product can move by an ulp).  So the spec
    tests hold every stream to the full-recompute oracle as well as to the
    non-spec engine."""
    _, _, cfg, model, _ = _setup()
    eng = UnifiedServeEngine(cfg, model, device="cpu", num_slots=2,
                             max_len=32, block_size=16)
    prompt = _prompts(cfg.vocab_size, [13], seed=6)[0]
    eng.submit(prompt, 2)
    eng.run()
    pool = eng._caches
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    tok = torch.tensor([5, 9], dtype=torch.int32)
    idx = torch.tensor([13, 4], dtype=torch.int32)
    with torch.inference_mode():
        snap = {n: t.clone() for n, t in pool.items()}
        dec = model.decode_step(pool, tok, idx, tables)
        after_decode = {n: t.clone() for n, t in pool.items()}
        for n, t in pool.items():
            t.copy_(snap[n])
        span = model.span_step(pool, torch.stack([tok, tok * 0], 1), idx,
                               torch.ones(2, dtype=torch.int32), tables)
    torch.testing.assert_close(span[:, 0], dec, atol=VERIFY_LOGIT_TOL, rtol=0)
    assert torch.equal(span[:, 0].argmax(-1), dec.argmax(-1))
    for n, t in pool.items():  # live blocks 1-4 (not NULL's padding)
        torch.testing.assert_close(t[:, 1:5], after_decode[n][:, 1:5],
                                   atol=VERIFY_LOGIT_TOL, rtol=0)


def test_spec_draft_model_matches_non_spec_and_oracle():
    """A one-layer draft with its own weights sharing the vocab: random
    weights reject nearly everything, and rejected drafts change
    nothing."""
    _, _, cfg, model, oracle = _setup()
    _, _, dcfg, dmodel, _ = _setup(layers=1, seed=7)
    prompts = _prompts(cfg.vocab_size, [7, 18, 25], seed=3)
    _, ref = _serve(cfg, model, prompts, 10)
    prop = DraftModelProposer(dcfg, dmodel, num_slots=2, max_len=64,
                              device="cpu")
    eng, got = _serve(cfg, model, prompts, 10, spec=prop, spec_k=3)
    for p, a, b in zip(prompts, ref, got):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, oracle(p, 10))
    assert eng.stats["spec_drafted"] > 0


def test_spec_self_draft_accepts_everything():
    """Drafting with the TARGET's own weights accepts every draft: any
    desync of the draft cache's prefill / catch-up / rewind breaks it."""
    _, _, cfg, model, _ = _setup()
    prompts = _prompts(cfg.vocab_size, [9, 22], seed=4)
    prop = DraftModelProposer(cfg, model, num_slots=2, max_len=64,
                              device="cpu")
    eng, got = _serve(cfg, model, prompts, 12, spec=prop, spec_k=4)
    _, ref = _serve(cfg, model, prompts, 12)
    assert eng.stats["spec_drafted"] > 0
    assert eng.stats["spec_accepted"] == eng.stats["spec_drafted"]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)


def test_rejected_drafts_rewind_and_pool_conserved():
    """Tight pool, wide spans, near-total rejection: blocks allocated for
    rejected positions roll back, outputs stay exact, and FREE + ACTIVE +
    CACHED is conserved after the drain."""
    _, _, cfg, model, oracle = _setup()
    prompts = _prompts(cfg.vocab_size, [9, 12], seed=5)
    kw = dict(max_len=40, block_size=8, chunk_size=8)
    _, ref = _serve(cfg, model, prompts, 16, **kw)
    eng, got = _serve(cfg, model, prompts, 16, num_blocks=12,
                      spec=NGramProposer(), spec_k=8, max_step_tokens=40, **kw)
    for p, a, b in zip(prompts, ref, got):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, oracle(p, 16))
    assert eng.stats["spec_rollback_blocks"] > 0
    eng.pool.check_invariants()
    assert eng.pool.num_active() == 0


def test_rollback_never_frees_a_block_another_holder_keeps():
    """Registered prompt blocks stay cached while spans roll back: the
    second request (queued behind the first on one slot) re-hits them."""
    _, _, cfg, model, oracle = _setup()
    head = _prompts(cfg.vocab_size, [16], seed=12)[0]
    tails = _prompts(cfg.vocab_size, [5, 9], seed=13)
    prompts = [np.concatenate([head, t]) for t in tails]
    eng, got = _serve(cfg, model, prompts, 12, num_slots=1, max_len=48,
                      block_size=8, spec=NGramProposer(), spec_k=6)
    for p, b in zip(prompts, got):
        np.testing.assert_array_equal(b, oracle(p, 12))
    assert eng.stats["prefix_hit_tokens"] >= 16
    assert eng.stats["spec_rollback_blocks"] > 0
    eng.pool.check_invariants()
    assert eng.pool.num_active() == 0 and eng.pool.num_cached() >= 2


def test_spec_decode_victim_preempted_by_chunk_planning():
    """Chunk planning runs after span planning and can preempt a
    spec-planned decode victim: its span is dropped (the budget never
    charges it), and every request equals its solo run."""
    _, _, cfg, model, _ = _setup()
    tracer = xtrace.Tracer("spec-preempt").init()
    prompts = _prompts(cfg.vocab_size, [16, 16], seed=8)
    gens = [24, 8]
    kw = dict(max_len=40, block_size=8, chunk_size=8, spec_k=6)
    eng, got = _serve(cfg, model, prompts, gens, num_blocks=7, chunk_rows=1,
                      spec=NGramProposer(), max_step_tokens=40, tracer=tracer,
                      **kw)
    evs = tracer.finish().events
    assert eng.stats["preemptions"] > 0
    tri = {c: evs[evs["type"] == c]["value"].astype(np.int64) for c in (
        ev.EV_STEP_BUDGET, ev.EV_CHUNK_TOKENS, ev.EV_DECODE_TOKENS)}
    np.testing.assert_array_equal(
        tri[ev.EV_STEP_BUDGET], tri[ev.EV_CHUNK_TOKENS] + tri[ev.EV_DECODE_TOKENS])
    assert (tri[ev.EV_STEP_BUDGET] <= eng.max_step_tokens).all()
    for p, g, b in zip(prompts, gens, got):
        assert len(b) == g
        _, solo = _serve(cfg, model, [p], g, num_slots=1,
                         spec=NGramProposer(), **kw)
        np.testing.assert_array_equal(b, solo[0])
    eng.pool.check_invariants()
    assert eng.pool.num_active() == 0


def test_spec_adaptive_k_shrinks_under_rejection():
    _, _, cfg, model, _ = _setup()
    prompts = _prompts(cfg.vocab_size, [16, 11], seed=6)
    _, ref = _serve(cfg, model, prompts, 24)
    eng, got = _serve(cfg, model, prompts, 24, spec=NGramProposer(), spec_k=6,
                      spec_adaptive=True, max_step_tokens=64)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    assert eng._spec_k == 1, f"K stayed at {eng._spec_k} under total rejection"


def test_spec_counters_in_merged_prv_equal_the_stats(tmp_path):
    _, _, cfg, model, _ = _setup()
    tracer = xtrace.Tracer("spec-counters").init()
    eng, _ = _serve(cfg, model, _prompts(cfg.vocab_size, [24, 15, 9], seed=7,
                                         motif=6), 12,
                    spec=NGramProposer(), spec_k=4, tracer=tracer,
                    flush_every=4, flush_base=tmp_path / "spec")
    segments = list(tracer.segments)
    assert segments, "flush cadence never fired"
    paths = xtrace.write_prv(tracer.finish(), tmp_path / "spec",
                             segments=segments)
    merged = xtrace.parse_prv(paths["prv"])
    evs = merged.events
    by = {c: evs[evs["type"] == c]["value"].astype(np.int64) for c in (
        ev.EV_SPEC_DRAFTED, ev.EV_SPEC_ACCEPTED, ev.EV_SPEC_K,
        ev.EV_STEP_BUDGET, ev.EV_CHUNK_TOKENS, ev.EV_DECODE_TOKENS)}
    st = eng.stats
    n = len(by[ev.EV_SPEC_DRAFTED])
    assert n == st["spec_dispatches"] > 0
    assert len(by[ev.EV_SPEC_ACCEPTED]) == len(by[ev.EV_SPEC_K]) == n
    assert (by[ev.EV_SPEC_DRAFTED] >= by[ev.EV_SPEC_ACCEPTED]).all()
    assert by[ev.EV_SPEC_DRAFTED].sum() == st["spec_drafted"]
    assert by[ev.EV_SPEC_ACCEPTED].sum() == st["spec_accepted"] > 0
    assert (by[ev.EV_SPEC_K] >= 1).all()
    np.testing.assert_array_equal(
        by[ev.EV_STEP_BUDGET], by[ev.EV_CHUNK_TOKENS] + by[ev.EV_DECODE_TOKENS])
    assert (by[ev.EV_STEP_BUDGET] <= eng.max_step_tokens).all()
    lat = xtrace.serve_latency_summary(merged)
    assert lat["spec"]["dispatches"] == n
    assert lat["ttft_us"]["count"] == 3


@pytest.mark.parametrize("make", ["ngram", "draft"])
def test_spec_sampling_same_seed_reproducible(make):
    _, _, cfg, model, _ = _setup()
    _, _, dcfg, dmodel, _ = _setup(layers=1, seed=7)
    prompts = _prompts(cfg.vocab_size, [9, 20], seed=8, motif=5)
    waves = []
    for _ in range(2):
        prop = (NGramProposer() if make == "ngram" else DraftModelProposer(
            dcfg, dmodel, num_slots=2, max_len=64, temperature=0.8, top_p=0.9,
            seed=11, device="cpu"))
        eng, got = _serve(cfg, model, prompts, 10, spec=prop, spec_k=3,
                          temperature=0.8, top_p=0.9, seed=11)
        waves.append(got)
        assert eng.stats["spec_drafted"] > 0
    for a, b in zip(*waves):
        np.testing.assert_array_equal(a, b)
        assert ((a >= 0) & (a < cfg.vocab_size)).all()


def test_make_proposer_factory():
    _, _, cfg, _, _ = _setup()
    assert isinstance(make_proposer("ngram", cfg, num_slots=2, max_len=32),
                      NGramProposer)
    prop = make_proposer("draft:granite-8b", cfg, num_slots=2, max_len=32,
                         device="cpu")
    assert isinstance(prop, DraftModelProposer)
    assert prop.cfg.vocab_size == cfg.vocab_size and prop.cfg.num_layers == 1
    assert prop.device.type == "cpu"
    assert prop._caches["k"].shape == (1, 2, 32, cfg.num_kv_heads, cfg.head_dim)
    seeded = build_model(prop.cfg, device="cpu", seed=1)
    assert torch.equal(prop.model.embedding, seeded.embedding)
    with pytest.raises(ValueError, match="unknown --spec"):
        make_proposer("nope", cfg, num_slots=2, max_len=32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_proposer("draft:granite-8b", cfg, num_slots=2, max_len=32)


def test_spec_refuses_state_carrying_families():
    ssm = reduced(get_config("mamba2-370m"), num_layers=1)
    with pytest.raises(ValueError, match="speculative"):
        UnifiedServeEngine(ssm, device="cpu", num_slots=2, max_len=48,
                           spec=NGramProposer())
    with pytest.raises(ValueError, match="attention-only"):
        DraftModelProposer(ssm, num_slots=2, max_len=32, device="cpu")


@pytest.mark.parametrize("spec", ["ngram", "draft:granite-8b"])
def test_cli_spec_lane_on_cpu(capsys, tmp_path, spec):
    assert serve_cli.main(["--device", "cpu", "--requests", "3",
                           "--prompt-len", "12", "--gen", "6", "--spec", spec,
                           "--spec-k", "3", "--spec-adaptive", "--trace",
                           "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "18 tokens" in out and f"speculative ({spec})" in out, out
    assert "spec (from trace)" in out and "paged_span:torch" in out, out
    assert "paged_decode" not in out, out
