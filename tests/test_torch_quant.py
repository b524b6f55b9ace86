"""Torch port, quantized (int8/fp8) KV block pool, on the CPU, against the
JAX package (reduced f32 configs, 2 layers, the JAX ``model.init`` weights
through ``convert.params_from_jax``, seeded numpy inputs):

* ``core.quant.kv_quantize`` codes and scales bit for bit;
* the pool spec (scale leaves) and the bytes per token of an engine;
* the plain dequant-gather decode/span functions against the JAX Pallas
  kernels' quantized bodies in interpret mode;
* ``span_step`` / ``decode_step`` logits and pool contents on int8 and
  fp8 pools against JAX's, and the port's own divergence from its native
  pool inside the JAX package's committed bounds;
* the legacy and unified int8 engines: prefix-hit warm == cold,
  preemption-resume == solos, greedy match against the native pool, host
  counters and trace ledger (EV_BLOCK_DTYPE, EV_POOL_ACTIVE_KIB) equal to
  the JAX engine's on the same stream;
* fp8 leaf copies (prefix gather, block copies) through ``uint8`` views.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import quant as jax_quant  # noqa: E402
from repro.core.tracer import Tracer as JaxTracer  # noqa: E402
from repro.kernels.attention import paged_attention, paged_span_attention  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import cache_utils as jax_cu  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import ContinuousServeEngine as JaxLegacyEngine  # noqa: E402
from repro.serve.step import UnifiedServeEngine as JaxUnifiedEngine  # noqa: E402
from repro_torch import core as xtrace  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels.attention import paged  # noqa: E402
from repro_torch.models import cache_utils as cu  # noqa: E402
from repro_torch.models import convert, transformer  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ContinuousServeEngine  # noqa: E402
from repro_torch.serve.step import UnifiedServeEngine  # noqa: E402

KV = ["int8", "fp8"]
PLAIN_TOL = 1e-5  # plain dequant-gather vs the Pallas interpret kernel, f32
LOGIT_TOL = 1e-4  # float32 model functions, different op order
# the JAX package's committed bounds for a quantized pool against the
# native one (tests/test_kv_quant.py)
MAX_ABS_LOGIT = {"int8": 0.05, "fp8": 0.30}
MAX_FLIP_RATE = 0.05
# share of pool codes one quantization step apart from JAX's after a span
# and two decode steps (f32 K/V differ in the last bits, so a value next
# to a rounding boundary may round the other way); measured 0 in both
# dtypes for this case on the CPU
MAX_CODE_DIFF_SHARE = 1e-3
ENGINES = {"legacy": (ContinuousServeEngine, JaxLegacyEngine),
           "unified": (UnifiedServeEngine, JaxUnifiedEngine)}

_SETUPS = {}


def _setup(arch="granite-8b", **kw):
    """(jax cfg, jax model, jax params, torch cfg, torch model): one set of
    weights, 2 layers, f32."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _SETUPS:
        jcfg = jax_reduced(jax_get_config(arch), num_layers=2, **kw)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = reduced(get_config(arch), num_layers=2, **kw)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(convert.params_from_jax(
            jax.tree.map(np.asarray, jparams)))
        _SETUPS[key] = (jcfg, jmodel, jparams, cfg, model)
    return _SETUPS[key]


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _np(t: torch.Tensor) -> np.ndarray:
    """A torch leaf as numpy; fp8 codes as their bytes."""
    return quant.raw(t).numpy()


def _jnp_bytes(x) -> np.ndarray:
    """A JAX leaf as numpy; fp8 codes as their bytes."""
    a = np.asarray(x)
    return a.view(np.uint8) if "float8" in a.dtype.name else a


def _torch_codes(x) -> torch.Tensor:
    """JAX int8/fp8 codes -> the same bits as a torch tensor."""
    a = np.asarray(x)
    if "float8" in a.dtype.name:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _ordinal(codes: np.ndarray, kv_dtype: str) -> np.ndarray:
    """Codes as integers whose neighbours are one quantization step apart
    (fp8 e4m3: sign-magnitude bytes, monotone per sign, +-0 both 0)."""
    if kv_dtype == "int8":
        return codes.astype(np.int32)
    b = codes.astype(np.int32)
    return np.where(b & 0x80, -(b & 0x7F), b & 0x7F)


# ----------------------------------------------------------------------
# the quantization primitive
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", KV)
def test_kv_quantize_bit_identical_to_jax(kv_dtype, dtype):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((5, 16, 3, 32)) * rng.uniform(
        0.01, 40, (5, 16, 3, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale 1e-12, codes 0
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    codes, scale = quant.kv_quantize(tx, kv_dtype)
    jcodes, jscale = jax_quant.kv_quantize(jx, kv_dtype)
    assert codes.dtype == quant.storage_dtype(kv_dtype)
    assert scale.dtype == torch.float32 and scale.shape == x.shape[:-1]
    np.testing.assert_array_equal(_np(codes), _jnp_bytes(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert scale[0, 0, 0].item() == np.float32(1e-12)
    back = quant.kv_dequantize(codes, scale, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_quant.kv_dequantize(jcodes, jscale,
                                                         jnp.float32)))


# ----------------------------------------------------------------------
# pool layout and bytes per token
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", ["fp16", *KV])
def test_pool_spec_matches_jax_layout(kv_dtype):
    _, _, _, cfg, _ = _setup()
    jcfg = jax_reduced(jax_get_config("granite-8b"),
                       num_layers=2).replace(kv_dtype=kv_dtype)
    spec = transformer.stack_paged_cache_spec(cfg.replace(kv_dtype=kv_dtype),
                                              8, 16, torch.float32)
    jspec = jax_attn.paged_cache_spec(jcfg, 8, 16, jnp.float32)
    assert sorted(spec) == sorted(jspec)
    assert sorted(spec) == (["k", "v"] if kv_dtype == "fp16"
                            else ["k", "k_scale", "v", "v_scale"])
    for name, (shape, dt) in spec.items():
        assert shape == (cfg.num_layers, *jspec[name].shape)
        assert str(dt).removeprefix("torch.") == jnp.dtype(jspec[name].dtype).name
    if kv_dtype == "fp16":  # the native pool is unchanged
        assert spec["k"][1] == torch.float32


def test_int8_engine_pool_is_smaller_per_token():
    jcfg, _, jparams, cfg, model = _setup()
    mk = lambda c: ContinuousServeEngine(  # noqa: E731
        c, model, device="cpu", num_slots=2, max_len=32, block_size=16)
    e16, e8 = mk(cfg), mk(cfg.replace(kv_dtype="int8"))
    assert e8.pool.kv_dtype == "int8" and e16.pool.kv_dtype == "fp16"
    assert e8.kv_bytes_per_token * 2 < e16.kv_bytes_per_token
    assert e8.pool.block_bytes * 2 < e16.pool.block_bytes
    for kv_dtype, eng in (("fp16", e16), ("int8", e8)):
        jeng = JaxLegacyEngine(jcfg.replace(kv_dtype=kv_dtype), jparams,
                               num_slots=2, max_len=32, block_size=16)
        assert eng.kv_bytes_per_token == jeng.kv_bytes_per_token
        assert eng.pool.block_bytes == jeng.pool.block_bytes


@pytest.mark.parametrize("kv_dtype,per_token", [
    ("fp16", 147_456),  # 36 layers x 8 kv heads x 128 x K,V x 2 bytes
    ("int8", 76_032),   # 73,728 B of codes + 36 x 8 x K,V x 4 B of scales
    ("fp8", 76_032),
])
def test_full_width_granite_bytes_per_token(kv_dtype, per_token):
    """The full-width granite-8b pool (bf16 model) from its spec alone:
    1.94x the tokens per byte for a quantized pool."""
    cfg = get_config("granite-8b").replace(kv_dtype=kv_dtype)
    nb, bs = 4, 16
    spec = transformer.stack_paged_cache_spec(cfg, nb, bs, torch.bfloat16)
    total = sum(int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
                for shape, dt in spec.values())
    assert total // (nb * bs) == per_token


# ----------------------------------------------------------------------
# plain dequant-gather vs the JAX Pallas kernels' quantized bodies
# ----------------------------------------------------------------------
def _quant_pool(rng, kv_dtype, nb, bs, hkv, d):
    """Seeded f32 K/V quantized on the JAX side: (jax entry, torch codes
    and scales in the engine layout)."""
    entry, tpool = {}, {}
    for name in ("k", "v"):
        x = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
        codes, scale = jax_quant.kv_quantize(jnp.asarray(x), kv_dtype)
        entry[name], entry[name + "_scale"] = codes, scale
        tpool[name] = _torch_codes(codes)
        tpool[name + "_scale"] = torch.from_numpy(np.asarray(scale).copy())
    return entry, tpool


def _tables(rng, b, w, nb, last, bs):
    bt = np.zeros((b, w), np.int32)
    ids = rng.permutation(np.arange(1, nb))[:b * w].reshape(b, w)
    for i in range(b):
        n = int(last[i]) // bs + 1
        bt[i, :n] = ids[i, :n]
    return bt


@pytest.mark.parametrize("window", [None, 9], ids=["full", "swa"])
@pytest.mark.parametrize("kv_dtype", KV)
def test_plain_quantized_decode_matches_jax_kernel(kv_dtype, window):
    rng = np.random.default_rng(21)
    b, w, bs, hkv, g, d, nb = 3, 4, 8, 2, 4, 16, 32
    entry, tpool = _quant_pool(rng, kv_dtype, nb, bs, hkv, d)
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    idx = rng.integers(0, w * bs, b).astype(np.int32)
    bt = _tables(rng, b, w, nb, idx, bs)
    out = paged.paged_decode_plain(
        torch.from_numpy(q), tpool["k"], tpool["v"], torch.from_numpy(bt),
        torch.from_numpy(idx), window=window, k_scales=tpool["k_scale"],
        v_scales=tpool["v_scale"])
    kern = paged_attention(entry, jnp.asarray(q), jnp.asarray(bt),
                           jnp.asarray(idx), window=window, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), atol=PLAIN_TOL,
                               rtol=PLAIN_TOL)


@pytest.mark.parametrize("window", [None, 9], ids=["full", "swa"])
@pytest.mark.parametrize("kv_dtype", KV)
def test_plain_quantized_span_matches_jax_kernel(kv_dtype, window):
    rng = np.random.default_rng(22)
    b, w, bs, hkv, g, d, nb, qlen = 3, 4, 8, 2, 4, 16, 32, 6
    entry, tpool = _quant_pool(rng, kv_dtype, nb, bs, hkv, d)
    q = rng.standard_normal((b, qlen, hkv * g, d)).astype(np.float32)
    ln = np.array([6, 3, 1], np.int32)
    st = np.array([int(rng.integers(0, w * bs - n)) for n in ln], np.int32)
    bt = _tables(rng, b, w, nb, st + ln - 1, bs)
    out = paged.paged_span_plain(
        torch.from_numpy(q), tpool["k"], tpool["v"], torch.from_numpy(bt),
        torch.from_numpy(st), torch.from_numpy(ln), window=window,
        k_scales=tpool["k_scale"], v_scales=tpool["v_scale"]).numpy()
    kern = np.asarray(paged_span_attention(
        entry, jnp.asarray(q), jnp.asarray(bt), jnp.asarray(st),
        jnp.asarray(ln), window=window, interpret=True))
    valid = np.arange(qlen)[None, :] < ln[:, None]
    np.testing.assert_allclose(out[valid], kern[valid], atol=PLAIN_TOL,
                               rtol=PLAIN_TOL)


# ----------------------------------------------------------------------
# model functions on a quantized pool
# ----------------------------------------------------------------------
def _pools(cfg, kv_dtype, nb, bs):
    """Zeroed port pool and JAX pool of the same quantized layout."""
    spec = transformer.stack_paged_cache_spec(cfg.replace(kv_dtype=kv_dtype),
                                              nb, bs, torch.float32)
    tpool = {n: quant.zeros(shape, dt, "cpu") for n, (shape, dt) in spec.items()}
    jdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kv_dtype]
    jpool = {"units": {n: jnp.zeros(shape, jnp.float32 if "scale" in n else jdt)
                       for n, (shape, _) in spec.items()}}
    return tpool, jpool


@pytest.mark.parametrize("kv_dtype", KV)
def test_span_then_decode_match_jax_on_quantized_pool(kv_dtype):
    """Two ragged span rows, then two decode steps, on int8/fp8 pools:
    logits within 1e-4 of JAX's; scales within rtol 1e-5; codes at most
    one quantization step apart (share bounded, see MAX_CODE_DIFF_SHARE)."""
    jcfg, _, jparams, cfg, model = _setup()
    jmodel = jax_build_model(jcfg.replace(kv_dtype=kv_dtype))
    cfg = cfg.replace(kv_dtype=kv_dtype)
    model = model.serving_view(cfg)  # the same weights, a quantized pool
    nb, bs = 10, 8
    tpool, jpool = _pools(cfg, kv_dtype, nb, bs)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    st = np.zeros((2,), np.int32)
    ln = np.array([12, 9], np.int32)
    diffs = []

    def check_pools():
        live = slice(1, None)  # NULL block 0: last-writer garbage
        for n in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tpool[n].numpy()[:, live],
                                       np.asarray(jpool["units"][n])[:, live],
                                       rtol=1e-5, atol=0)
        for n in ("k", "v"):
            a = _ordinal(_np(tpool[n])[:, live], kv_dtype)
            b_ = _ordinal(_jnp_bytes(jpool["units"][n])[:, live], kv_dtype)
            assert np.abs(a - b_).max() <= 1
            diffs.append((a != b_).mean())

    jpool, jl = jax.jit(jmodel.span_step)(
        jparams, jpool, jnp.asarray(toks), jnp.asarray(st),
        jnp.asarray(ln), jnp.asarray(bt))
    with torch.inference_mode():
        tl = model.span_step(tpool, torch.from_numpy(toks),
                             torch.from_numpy(st), torch.from_numpy(ln),
                             torch.from_numpy(bt))
    valid = np.arange(12)[None, :] < ln[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               atol=LOGIT_TOL, rtol=0)
    check_pools()
    dec = jax.jit(lambda p, c, t, i, b: jmodel.decode_step(
        p, c, t, i, block_tables=b))
    tok = np.asarray(jl)[[0, 1], ln - 1].argmax(-1).astype(np.int32)
    idx = ln.copy()
    for _ in range(2):
        jpool, jlog = dec(jparams, jpool, jnp.asarray(tok),
                          jnp.asarray(idx), jnp.asarray(bt))
        with torch.inference_mode():
            tlog = model.decode_step(tpool, torch.from_numpy(tok),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(bt))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=0)
        check_pools()
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)
        idx = idx + 1
    assert max(diffs) <= MAX_CODE_DIFF_SHARE, diffs


def _span_logits(model, tokens, bs=16):
    """Logits of full-length span rows over disjoint block tables (the
    JAX package's divergence harness)."""
    b, q = tokens.shape
    w = -(-64 // bs)
    spec = model.paged_cache_specs(b, 1 + b * w, bs)
    pool = {n: quant.zeros(shape, dt, "cpu") for n, (shape, dt) in spec.items()}
    bt = torch.arange(1, 1 + b * w, dtype=torch.int32).reshape(b, w)
    with torch.inference_mode():
        logits = model.span_step(pool, torch.from_numpy(tokens),
                                 torch.zeros(b, dtype=torch.int32),
                                 torch.full((b,), q, dtype=torch.int32), bt)
    return logits.double().numpy()


@pytest.mark.parametrize("arch,kw,kv_dtype", [
    ("granite-8b", {}, "int8"),
    ("granite-8b", {}, "fp8"),
    ("yi-9b", {}, "int8"),
    ("granite-8b", {"attention_window": 6}, "int8"),
    ("yi-9b", {"attention_window": 6}, "fp8"),
], ids=["granite-int8", "granite-fp8", "yi-int8", "granite-swa-int8",
        "yi-swa-fp8"])
def test_divergence_from_native_pool_within_jax_bounds(arch, kw, kv_dtype):
    _, _, _, cfg, model = _setup(arch, **kw)
    tokens = np.stack(_prompts(cfg.vocab_size, [24, 24], seed=3))
    ref = _span_logits(model, tokens)
    out = _span_logits(model.serving_view(cfg.replace(kv_dtype=kv_dtype)),
                       tokens)
    d = np.abs(out - ref).max()
    assert d <= MAX_ABS_LOGIT[kv_dtype], f"max|dlogit| {d:.4f}"
    flips = (out.argmax(-1) != ref.argmax(-1)).mean()
    assert flips <= MAX_FLIP_RATE, f"argmax flip rate {flips:.3f}"


# ----------------------------------------------------------------------
# engines: idempotence of quantized blocks, counters, trace
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", KV)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_prefix_hit_warm_equals_cold(engine, kv_dtype):
    """A warm run reads the quantized blocks the cold prefill wrote (the
    prefix gathered and dequantized, fp8 codes moved as bytes): the same
    tokens bit for bit, with real hits."""
    _, _, _, cfg, model = _setup()
    cfg = cfg.replace(kv_dtype=kv_dtype)
    cls = ENGINES[engine][0]
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, (32,)).astype(np.int32)
    prompts = [np.concatenate([shared, t])
               for t in _prompts(cfg.vocab_size, [6] * 3, seed=6)]
    outs = []
    for prefix_cache in (False, True):
        eng = cls(cfg, model, device="cpu", num_slots=1, max_len=64,
                  block_size=16, prefix_cache=prefix_cache)
        reqs = [eng.submit(p, 6) for p in prompts]
        out = eng.run()
        outs.append([out[r.rid] for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert [r.prefix_hit_tokens for r in reqs] == [0, 32, 32]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_int8_preemption_resume_equals_solos(engine):
    """Preempt-by-eviction and recompute re-quantize the same values to
    the same bits: a contended int8 run matches uncontended int8 solos."""
    _, _, _, cfg, model = _setup()
    cfg8 = cfg.replace(kv_dtype="int8")
    cls = ENGINES[engine][0]
    eng = cls(cfg8, model, device="cpu", num_slots=4, max_len=64,
              block_size=8, num_blocks=14, max_prefills_per_iter=4)
    prompts = _prompts(cfg.vocab_size, [16] * 4, seed=8)
    reqs = [eng.submit(p, 20) for p in prompts]
    out = eng.run()
    assert eng.stats["preemptions"] > 0
    for r, p in zip(reqs, prompts):
        solo = cls(cfg8, model, device="cpu", num_slots=1, max_len=64)
        s = solo.submit(p, 20)
        np.testing.assert_array_equal(out[r.rid], solo.run()[s.rid],
                                      err_msg=f"req {r.rid}")
    assert eng.pool.num_active() == 0


@pytest.mark.parametrize("engine", list(ENGINES))
def test_int8_greedy_tracks_native_pool(engine):
    _, _, _, cfg, model = _setup()
    cls = ENGINES[engine][0]
    prompts = np.stack(_prompts(cfg.vocab_size, [16] * 4, seed=9))
    streams = [cls(c, model, device="cpu", num_slots=4, max_len=64,
                   block_size=16).serve_batch(prompts, num_tokens=8)
               for c in (cfg, cfg.replace(kv_dtype="int8"))]
    match = (streams[0] == streams[1]).mean()
    assert match >= 0.75, f"greedy token match {match:.2f}"


def _pressure_stream(vocab):
    """Two pairs sharing block-aligned prefixes under a tight pool:
    prefix hits, preemption and recompute resume."""
    a, x = _prompts(vocab, [20, 30], seed=5)
    b, y = _prompts(vocab, [5, 3], seed=6)
    return [a, x, np.concatenate([a[:16], b]), np.concatenate([x[:24], y])]


# per engine: (engine kwargs, new tokens per request) under which the
# pressure stream preempts (the test_torch_serve / _legacy settings)
_PRESSURE = {
    "unified": (dict(num_slots=2, max_len=48, block_size=8, num_blocks=9,
                     chunk_size=8), 8),
    "legacy": (dict(num_slots=2, max_len=48, block_size=8, num_blocks=10), 16),
}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_int8_host_counters_and_ledger_match_jax(engine):
    """The port's int8 engine under its own tracer and the JAX int8 engine
    under JAX's, on one stream under pool pressure: the same host counters
    and the same event ledger value for value (block gauges with
    EV_BLOCK_DTYPE = int8 and EV_POOL_ACTIVE_KIB from the same block
    bytes, admit/preempt/retire order), latencies aside."""
    jcfg, _, jparams, cfg, model = _setup()
    mine_cls, jax_cls = ENGINES[engine]
    prompts = _pressure_stream(cfg.vocab_size)
    kw, gen = _PRESSURE[engine]
    results = []
    for tracer, make in (
            (xtrace.Tracer("int8"), lambda tr: mine_cls(
                cfg.replace(kv_dtype="int8"), model, device="cpu", tracer=tr,
                **kw)),
            (JaxTracer("int8"), lambda tr: jax_cls(
                jcfg.replace(kv_dtype="int8"), jparams, tracer=tr, **kw))):
        tracer.init()
        eng = make(tracer)
        for p in prompts:
            eng.submit(p, gen)
        eng.run()
        eng.pool.check_invariants()
        counters = {k: eng.stats[k] for k in (
            "prefix_hit_tokens", "preemptions", "peak_blocks", "prefills",
            "prefill_tokens", "tokens_decoded", "decode_dispatches")}
        counters.update(free=eng.pool.num_free(), cached=eng.pool.num_cached(),
                        evictions=eng.pool.stats["evictions"])
        evs = tracer.finish().events
        keep = ~np.isin(evs["type"], [ev.EV_REQ_TTFT_US, ev.EV_REQ_TPOT_US])
        results.append((counters, np.stack([evs["type"][keep],
                                            evs["value"][keep]], 1)))
    (mine, mine_ledger), (theirs, their_ledger) = results
    assert mine["preemptions"] > 0 and mine["prefix_hit_tokens"] > 0
    assert mine == theirs
    dtype_vals = mine_ledger[mine_ledger[:, 0] == ev.EV_BLOCK_DTYPE, 1]
    assert set(dtype_vals) == {ev.BLOCK_DTYPE_IDS["int8"]}
    np.testing.assert_array_equal(mine_ledger, their_ledger)


def test_int8_merged_prv_carries_dtype_and_occupancy(tmp_path):
    """A traced int8 run, flushed mid-run and merged into one .prv: the
    parsed trace holds EV_BLOCK_DTYPE = 2 (int8) and EV_POOL_ACTIVE_KIB."""
    _, _, _, cfg, model = _setup()
    tracer = xtrace.Tracer("serve-kv-quant").init()
    eng = ContinuousServeEngine(cfg.replace(kv_dtype="int8"), model,
                                device="cpu", num_slots=2, max_len=32,
                                block_size=16, tracer=tracer, flush_every=2,
                                flush_base=tmp_path / "serve")
    eng.serve_batch(np.stack(_prompts(cfg.vocab_size, [8] * 2, seed=10)),
                    num_tokens=6)
    segments = list(tracer.segments)
    paths = xtrace.write_prv(tracer.finish(), tmp_path / "serve",
                             segments=segments)
    trace = xtrace.parse_prv(paths["prv"])
    assert len(segments) >= 1
    dt = trace.events[trace.events["type"] == ev.EV_BLOCK_DTYPE]
    assert len(dt) and set(dt["value"]) == {ev.BLOCK_DTYPE_IDS["int8"]}
    occ = trace.events[trace.events["type"] == ev.EV_POOL_ACTIVE_KIB]
    assert len(occ) and occ["value"].max() > 0


def test_fp8_block_copies_through_byte_views():
    """Copy-on-write block copies of fp8 codes and their scales: the
    port's in-place copy equals JAX's ``copy_pool_blocks`` bit for bit,
    directly and through the engine's pending-copy flush."""
    rng = np.random.default_rng(12)
    codes, scale = jax_quant.kv_quantize(
        jnp.asarray(rng.standard_normal((2, 8, 4, 2, 16)).astype(np.float32)),
        "fp8")
    src, dst = np.array([1, 3], np.int32), np.array([5, 6], np.int32)
    for leaf in (codes, scale):
        ref = jax_cu.copy_pool_blocks(leaf, jnp.asarray(src), jnp.asarray(dst))
        t = _torch_codes(leaf) if leaf is codes else torch.from_numpy(
            np.asarray(leaf).copy())
        cu.copy_pool_blocks(t, torch.from_numpy(src).long(),
                            torch.from_numpy(dst).long())
        np.testing.assert_array_equal(_np(t), _jnp_bytes(ref))
    _, _, _, cfg, model = _setup()
    eng = UnifiedServeEngine(cfg.replace(kv_dtype="fp8"), model, device="cpu",
                             num_slots=1, max_len=32, block_size=8)
    eng.serve_batch(np.stack(_prompts(cfg.vocab_size, [12], seed=13)),
                    num_tokens=4)
    before = {n: _np(leaf).copy() for n, leaf in eng._caches.items()}
    eng._cow_pairs = [(1, 4), (2, 5)]
    eng._flush_cow()
    for n, leaf in eng._caches.items():
        after = _np(leaf)
        np.testing.assert_array_equal(after[:, [4, 5]], before[n][:, [1, 2]])
        np.testing.assert_array_equal(np.delete(after, [4, 5], 1),
                                      np.delete(before[n], [4, 5], 1))
